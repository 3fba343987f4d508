"""plan_ms: the planner's host ms a batch, the mean of the program's
`dispatch.plan` span over the window's batches (utils/prof.py)."""


def read(run: dict):
    return run["spans"].get("dispatch.plan")
