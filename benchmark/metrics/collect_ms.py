"""collect_ms: the host ms a batch of assembling its results after the
read-back (slicing, piece and segment merges), the mean of the program's
`collect.assemble` span over the window's batches, read from the
program's registry (utils/prof.py), which the window's start reset; None
where the program records no such span."""
from document_search_engine_tpu_torch.utils import prof


def read(run: dict):
    return prof.mean_ms("collect.assemble")
