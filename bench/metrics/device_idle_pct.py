"""The device's idle share at the window's own pace: 1 - (device busy a
unit of work in the profiled stretch, the union of its kernel, copy and
set intervals) / (host seconds a unit outside that stretch). A unit is
a training step, or a query answered. The profiler slows the host, so
its stretch alone would read the device idler than the window runs it.
One reader for every cell that names it (``device_idle_pct.<kind>``)."""


def units(w):
    """(units in the window, units in its profiled stretch)."""
    if "steps" in w:
        return w["steps"], w["traced_steps"]
    return w["answered"], w["answered_traced"]


def read(run):
    t, w = run.trace, run.window
    if t is None:
        return None
    done, traced = units(w)
    done -= traced
    secs = w["seconds"] - w["traced_s"]
    if not traced or done <= 0 or secs <= 0:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / traced) / (secs / done))
