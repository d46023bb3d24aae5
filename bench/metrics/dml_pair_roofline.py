"""dml_pair_roofline: the Eq. 4 forward's share of its roofline.

The least time of one worker's forward, from its shapes: z = x - y
(B d_in), the projection z L^T (2 B d_in d_out FLOP), ||Lz||^2 and the
hinge (about 3 B d_out); reading xs, ys, L and sim once and writing the
loss, d2 and the projection once. Over the device time a call of the
loss range (``bench.loss_fwd``) in the profiled stretch: the kernels and
copies that its calls launched, summed from the trace.
"""

from bench.harness.device import least_seconds


def forward_work(cfg: dict):
    B, d, k = cfg["batch_size"], cfg["feat_dim"], cfg["proj_dim"]
    ops = 2.0 * B * d * k + B * d + 3.0 * B * k
    nbytes = 4.0 * (2 * B * d + k * d + B) + 4.0 * (1 + B + B * k)
    return ops, nbytes


def read(run):
    if run.peak is None or run.trace is None:
        return None
    r = run.trace["ranges"].get("bench.loss_fwd")
    if not r or not r["calls"] or r["device_s"] <= 0:
        return None
    least = least_seconds(*forward_work(run.config), run.peak)
    return 100.0 * least / (r["device_s"] / r["calls"])
