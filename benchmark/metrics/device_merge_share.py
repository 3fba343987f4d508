"""device_merge_share: the share, in %, of the window's queries over
several segments whose segments the program merged on the card, inside
the batch step, rather than on the host: the `step.device_merge_queries`
counter over the `step.segment_merge_queries` counter, each summed over the
window (utils/prof.py). None where either counter is missing (a program
older than the device merge counts neither) or no query ran over several
segments (an index of one segment merges nothing)."""
from document_search_engine_tpu_torch.utils import prof


def read(run: dict):
    total = getattr(prof, "total", None)
    if total is None:
        return None
    merged = total("step.device_merge_queries")
    queries = total("step.segment_merge_queries")
    if not queries or merged is None:
        return None
    return 100.0 * merged / queries
