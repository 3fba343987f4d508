"""device_idle_pct: the share of the traced window in which no operation
(kernel, copy or set) runs on the device, from the union of the trace's
device events."""


def read(run: dict):
    tr = run.get("trace")
    if not tr or not tr["busy_s"] or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
