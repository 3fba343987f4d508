"""dead_pair_share: the share, in %, of the window's (query, posting) pairs
that the program asked its kernels to score although the posting's
document is tombstoned (a live index keeps dead documents' postings in
their rows until a merge): the `step.dead_pairs` counter over the
`step.pairs` counter, each summed over the window (utils/prof.py). None
where either counter is missing (a program older than the counter counts
no `step.dead_pairs`) or no pair was counted."""
from document_search_engine_tpu_torch.utils import prof


def read(run: dict):
    total = getattr(prof, "total", None)
    if total is None:
        return None
    pairs, dead = total("step.pairs"), total("step.dead_pairs")
    if not pairs or dead is None:
        return None
    return 100.0 * dead / pairs
