"""kernel_roofline: the least time the card could take for the
window's batches (roofline.py, from the inputs alone) as a share of the
kernel time the trace measured over them."""


def read(run: dict):
    tr = run.get("trace")
    least = run.get("least_s")
    if not tr or not tr["kernel_events"] or not least:
        return None
    return 100.0 * least / tr["kernel_s"]
