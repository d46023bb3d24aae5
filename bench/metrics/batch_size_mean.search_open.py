"""The front door's mean micro-batch (``serve/batcher.py``): the query
rows the engine received over the batches the batcher sent it in the
window, both the program's own counters."""


def read(run):
    w = run.window
    if not w.get("batches"):
        return None
    return w["requests"] / w["batches"]
