"""The engine's host time a batch (``serve/engine.py``), in every search
cell that names it (``engine_host_ms.<kind>``): the mean of its
``cache_lookup`` and ``pad`` spans over the engine calls of the profiled
stretch, the engine's tracer sampling every request there."""


def read(run):
    s = run.window.get("engine_spans")
    if not s or not s["calls"]:
        return None
    return 1e3 * s["host_s"] / s["calls"]
