"""enqueue_ms: the step graph's host ms a batch (staging, copies, the
graph's replay, the copy-out), the mean of the program's
`dispatch.enqueue` span over the window's batches (utils/prof.py)."""


def read(run: dict):
    return run["spans"].get("dispatch.enqueue")
