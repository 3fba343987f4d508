"""kernel_ms: device ms of kernels a batch, the sum of the kernel events
of the traced window over its batches."""


def read(run: dict):
    tr = run.get("trace")
    if not tr or not tr["kernel_events"] or not run["batches"]:
        return None
    return tr["kernel_s"] * 1e3 / run["batches"]
