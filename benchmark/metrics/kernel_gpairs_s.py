"""kernel_gpairs_s: (query, posting) pairs scored a second of kernel
time, in billions: the program's `step.pairs` counter summed over the
window (utils/prof.py; the pairs each batch's plan asks the kernels to
score), over the kernel events' sum in the traced window. None without a
trace, a kernel event or the counter. A program older than the counter
has no `prof.total`: the reader then gives None rather than raise, so
that its traced runs still report the other metrics."""
from document_search_engine_tpu_torch.utils import prof


def read(run: dict):
    tr = run.get("trace")
    total = getattr(prof, "total", None)
    pairs = total("step.pairs") if total is not None else None
    if not tr or not tr["kernel_events"] or not pairs:
        return None
    return pairs / tr["kernel_s"] / 1e9
