"""segment_merge_ms: the host ms a batch of merging several segments' top
k into the batch's answers (a query's S x k candidates ranked by score
desc, doc id asc), the mean of the program's `collect.merge_segments` span
over the window's batches, read from the program's registry
(utils/prof.py), which the window's start reset. The span lies inside
`collect.assemble` (collect_ms). None where the program records no such
span: an index of one segment merges nothing, and a program older than the
span has none."""
from document_search_engine_tpu_torch.utils import prof


def read(run: dict):
    return prof.mean_ms("collect.merge_segments")
