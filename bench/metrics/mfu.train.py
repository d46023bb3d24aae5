"""mfu.train: the PS step's share of the card's peak, over the window.

Work a step, from shapes: each of the P workers projects its B pairs'
differences through L (2 B d_in d_out FLOP) and forms dL (2 B d_in d_out
FLOP), 4 P B d_in d_out in all. Over the window's steps and seconds on
the host clock, leaving out the profiled stretch, against the peak of an
f32 product (bench/harness/device.py).
"""


def step_flop(cfg: dict, traffic: dict) -> float:
    return 4.0 * traffic["workers"] * cfg["batch_size"] * cfg["feat_dim"] \
        * cfg["proj_dim"]


def read(run):
    w, peak = run.window, run.peak
    steps = w["steps"] - w["traced_steps"]
    secs = w["seconds"] - w["traced_s"]
    if peak is None or steps <= 0 or secs <= 0:
        return None
    return 100.0 * steps * step_flop(run.config, run.traffic) \
        / (secs * peak["f32_product_flops"])
