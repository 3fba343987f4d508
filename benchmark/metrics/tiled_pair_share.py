"""tiled_pair_share: the share, in %, of the window's (query, posting)
pairs that the program scored by its tiled kernels: the `step.tiled_pairs`
counter over the `step.pairs` counter, each summed over the window
(utils/prof.py). None where either counter is missing (a program older
than the tiled kernels counts no `step.tiled_pairs`) or no pair was
counted."""
from document_search_engine_tpu_torch.utils import prof


def read(run: dict):
    total = getattr(prof, "total", None)
    if total is None:
        return None
    pairs, tiled = total("step.pairs"), total("step.tiled_pairs")
    if not pairs or tiled is None:
        return None
    return 100.0 * tiled / pairs
