"""analyze_ms: the frontend's host ms a batch, the mean of the program's
`stream.analyze` span (search_stream's analysis, on its worker thread)
over the window's batches, read from the program's registry
(utils/prof.py), which the window's start reset; None where the program
records no such span."""
from document_search_engine_tpu_torch.utils import prof


def read(run: dict):
    return prof.mean_ms("stream.analyze")
