"""The whole search's share of the card's peak, over the window, in every
search cell that names it (``mfu.search_<kind>``).

Work a query answered, from shapes: its projection (2 d_in d_out FLOP)
and its distances to every gallery row (2 M d_out). Over the queries
answered in the window and its seconds on the host clock, leaving out
the profiled stretch, against the peak of an f32 product.
"""


def query_flop(cfg: dict) -> float:
    return 2.0 * cfg["feat_dim"] * cfg["proj_dim"] \
        + 2.0 * cfg["n_samples"] * cfg["proj_dim"]


def read(run):
    w, peak = run.window, run.peak
    answered = w["answered"] - w["answered_traced"]
    secs = w["seconds"] - w["traced_s"]
    if peak is None or answered <= 0 or secs <= 0:
        return None
    return 100.0 * answered * query_flop(run.config) \
        / (secs * peak["f32_product_flops"])
