"""analyze_wait_ms: the main thread's ms a batch waiting for its
analysis, the mean of the program's `stream.wait_analysis` span over the
window's batches, read from the program's registry (utils/prof.py),
which the window's start reset; None where the program records no such
span."""
from document_search_engine_tpu_torch.utils import prof


def read(run: dict):
    return prof.mean_ms("stream.wait_analysis")
