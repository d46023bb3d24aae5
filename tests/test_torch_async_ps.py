"""The port's asynchronous parameter server (``repro_torch/core/ps/
simulator.py``) held against the JAX reference's, on the CPU.

A threaded run has no bit-level parity, so it is held to the reference
piece by piece, at the small shapes of tests/test_ps_sync.py (d 24, k 12):
  * one worker's gradient message against the reference's ``grad_fn`` on
    the same L and batch (rtol 1e-5);
  * the server's update rule on the same fixed messages, queued before it
    starts (rtol 1e-6): final L, update count, every inbox's broadcast;
  * a whole run with P = 1 and one step, which is deterministic (rtol
    1e-5);
  * the reference's own convergence checks, every worker contributing, a
    worker's exception raised by ``run_async_dml``, and a stress run with
    more workers than cores and a short switch interval.
"""

import os
import queue
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import dml as jax_dml
from repro.core.ps import simulator as jax_sim
from repro.data import loader as jax_loader
from repro.data import pairs as jax_pairs

from repro_torch.core import dml
from repro_torch.core.ps import simulator
from repro_torch.core.ps.trainer import make_worker_streams
from repro_torch.data import pairs

CPU = "cpu"


def _close(ours, theirs, rtol, atol=1e-7):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def setup():
    cfg = pairs.PairDatasetConfig(n_samples=400, feat_dim=24, n_classes=4,
                                  noise=1.0, seed=0)
    train_pairs, eval_pairs = pairs.train_eval_split(cfg, 1500, 1500, 400,
                                                     400)
    dcfg = jax_dml.DMLConfig(feat_dim=24, proj_dim=12)
    L0 = np.asarray(jax_dml.init_params(dcfg, jax.random.PRNGKey(0)))
    return train_pairs, eval_pairs, L0


def test_worker_message_matches_reference_grad_fn(setup):
    train_pairs, _, L0 = setup
    cfg = simulator.AsyncPSConfig(n_workers=2, lr=5e-2, batch_size=64,
                                  steps_per_worker=1, seed=3)
    wid = 1
    streams = make_worker_streams(train_pairs, cfg.n_workers,
                                  cfg.batch_size, seed=cfg.seed + 1000,
                                  device=CPU)
    L = torch.from_numpy(L0.copy())
    server = simulator._Server(L, cfg, [])
    trace, lock = [], threading.Lock()
    worker = simulator._Worker(wid, L, streams[wid], cfg, server,
                               queue.Queue(maxsize=1),
                               simulator._make_grad_fn(cfg.lam, cfg.margin),
                               trace, lock, 0.0)
    worker.start()
    worker.join()
    assert worker.error is None and not worker.thread.is_alive()
    g = simulator._receive(server.inbound.get_nowait(), None)

    shard = jax_loader.partition_pairs(train_pairs, cfg.n_workers)[wid]
    b = next(jax_pairs.pair_batches(shard, cfg.batch_size,
                                    seed=cfg.seed + 1000 + wid))
    loss_r, g_r = jax_sim._make_grad_fn(cfg.lam, cfg.margin)(
        jnp.asarray(L0), b["xs"], b["ys"], b["sim"])
    _close(g.numpy(), g_r, rtol=1e-5)
    assert len(trace) == 1 and trace[0][1] == wid
    _close(trace[0][2], float(loss_r), rtol=1e-5)


@pytest.mark.parametrize("n_msgs,server_batch", [(10, 4), (3, 1), (4, 8)])
def test_server_rule_matches_reference(n_msgs, server_batch):
    rng = np.random.RandomState(n_msgs + server_batch)
    L0 = rng.randn(12, 24).astype(np.float32)
    msgs = [rng.randn(12, 24).astype(np.float32) for _ in range(n_msgs)]
    cfg = simulator.AsyncPSConfig(n_workers=3, lr=3e-2,
                                  server_batch=server_batch)
    jcfg = jax_sim.AsyncPSConfig(n_workers=3, lr=3e-2,
                                 server_batch=server_batch)

    def run(module, c, L, wrap, unwrap):
        inboxes = [queue.Queue(maxsize=1) for _ in range(3)]
        server = module._Server(L, c, inboxes)
        for m in msgs:
            server.inbound.put(wrap(m))
        server.start()
        server.stop()
        assert not server.thread.is_alive()
        return (np.asarray(server.L), server.n_updates,
                [np.asarray(unwrap(q.get_nowait())) for q in inboxes])

    L, n, casts = run(simulator, cfg, torch.from_numpy(L0.copy()),
                      lambda m: simulator._send(torch.from_numpy(m), None),
                      lambda msg: simulator._receive(msg, None))
    L_r, n_r, casts_r = run(jax_sim, jcfg, L0, lambda m: m, lambda m: m)
    assert n == n_r == -(-n_msgs // server_batch)
    _close(L, L_r, rtol=1e-6)
    for a, b in zip(casts, casts_r):
        _close(a, b, rtol=1e-6)
        _close(a, L, rtol=0.0, atol=0.0)


def test_one_worker_one_step_matches_reference(setup):
    train_pairs, _, L0 = setup
    kw = dict(n_workers=1, lr=5e-2, batch_size=128, steps_per_worker=1,
              seed=2)
    L, trace = simulator.run_async_dml(simulator.AsyncPSConfig(**kw),
                                       train_pairs, L0, device=CPU)
    L_r, trace_r = jax_sim.run_async_dml(jax_sim.AsyncPSConfig(**kw),
                                         train_pairs, L0)
    _close(L.numpy(), L_r, rtol=1e-5, atol=1e-7)
    assert [t[1] for t in trace] == [t[1] for t in trace_r] == [0]
    _close(trace[0][2], trace_r[0][2], rtol=1e-5)


def test_async_ps_converges(setup):
    train_pairs, eval_pairs, L0 = setup
    cfg = simulator.AsyncPSConfig(n_workers=3, lr=5e-2, batch_size=128,
                                  steps_per_worker=80)
    stats = {}
    L, trace = simulator.run_async_dml(cfg, train_pairs, L0, device=CPU,
                                       stats=stats)
    assert len(trace) == 3 * 80 == stats["messages"]
    assert 1 <= stats["n_updates"] <= stats["messages"]
    assert stats["max_queue"] >= 1
    early = np.mean([t[2] for t in trace[:30]])
    late = np.mean([t[2] for t in trace[-30:]])
    assert late < 0.5 * early
    ev = {k: torch.from_numpy(v) for k, v in eval_pairs.items()}
    ap = float(dml.average_precision(
        dml.pair_scores(L, ev["xs"], ev["ys"]), ev["sim"]))
    ap_e = float(dml.average_precision(
        dml.pair_scores_euclidean(ev["xs"], ev["ys"]), ev["sim"]))
    assert ap > ap_e


def test_all_workers_contribute(setup):
    train_pairs, _, L0 = setup
    cfg = simulator.AsyncPSConfig(n_workers=4, lr=2e-2, batch_size=64,
                                  steps_per_worker=20)
    _, trace = simulator.run_async_dml(cfg, train_pairs, L0, device=CPU)
    assert {t[1] for t in trace} == {0, 1, 2, 3}


class _FailingSource:
    """A pair source whose worker 1 raises at its first batch (the warm-up
    stream, seeded below 1000, is fine)."""

    def __init__(self, pair_dict):
        self.pairs = pair_dict

    def worker_streams(self, n_workers, batch_size, seed):
        streams = make_worker_streams(self.pairs, n_workers, batch_size,
                                      seed, device=CPU)
        if seed >= 1000:
            streams[1] = self._boom()
        return streams

    @staticmethod
    def _boom():
        raise ValueError("worker 1 failed")
        yield


def test_worker_exception_is_raised(setup):
    train_pairs, _, L0 = setup
    cfg = simulator.AsyncPSConfig(n_workers=2, batch_size=32,
                                  steps_per_worker=3)
    with pytest.raises(ValueError, match="worker 1 failed"):
        simulator.run_async_dml(cfg, _FailingSource(train_pairs), L0,
                                device=CPU)


def test_stress_more_workers_than_cores(setup):
    """No lost trace entry or message with more workers than cores and a
    short switch interval: every message lands in the trace and every
    update consumed at least one and at most server_batch messages."""
    train_pairs, _, L0 = setup
    P = (os.cpu_count() or 2) + 2
    cfg = simulator.AsyncPSConfig(n_workers=P, lr=1e-2, batch_size=16,
                                  steps_per_worker=6, server_batch=3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stats = {}
        L, trace = simulator.run_async_dml(cfg, train_pairs, L0, device=CPU,
                                           stats=stats)
    finally:
        sys.setswitchinterval(old)
    assert len(trace) == stats["messages"] == P * 6
    assert sorted(w for _, w, _ in trace) == sorted(list(range(P)) * 6)
    assert -(-P * 6 // 3) <= stats["n_updates"] <= P * 6
    assert bool(torch.isfinite(L).all())
