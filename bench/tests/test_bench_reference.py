"""The plain reference against direct formulas at tiny widths, and its
frozen copy of the pair draws against the port's pair source today."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _tiny  # noqa: F401  (puts the repository on the path)
from bench.harness import data, judge
from bench.reference import dml, knn, precision


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 2 ** -12, one + 3 * 2 ** -11,
                      -(one + 2 ** -11), 3.0], dtype=torch.float32)
    got = precision.tf32(x)
    want = torch.tensor([one + 2 ** -10, one, one + 2 * 2 ** -10,
                         -(one + 2 ** -10), 3.0])
    assert torch.equal(got, want)


def _pairs(seed=0, n=40, d=12, k=5):
    g = torch.Generator().manual_seed(seed)
    xs = torch.rand((n, d), generator=g, dtype=torch.float64)
    ys = torch.rand((n, d), generator=g, dtype=torch.float64)
    sim = (torch.arange(n) % 2 == 0).to(torch.int32)
    L = 0.4 * torch.randn((k, d), generator=g, dtype=torch.float64)
    return L, xs, ys, sim


def test_eq4_against_the_formula_and_autograd():
    L, xs, ys, sim = _pairs()
    loss, grad = dml.eq4(L, xs, ys, sim, 1.3, 1.0, "f64")
    direct = []
    for b in range(len(xs)):
        d2 = float(torch.sum((L @ (xs[b] - ys[b])) ** 2))
        direct.append(d2 if sim[b] else 1.3 * max(0.0, 1.0 - d2))
    assert float(loss) == pytest.approx(np.mean(direct), rel=1e-12)
    Lv = L.clone().requires_grad_(True)
    z = xs - ys
    d2 = torch.sum((z @ Lv.T) ** 2, dim=1)
    s = sim.double()
    f = torch.mean(s * d2 + (1 - s) * 1.3 * torch.clamp_min(1.0 - d2, 0.0))
    (g,) = torch.autograd.grad(f, Lv)
    assert torch.allclose(grad, g, rtol=1e-12, atol=1e-14)


def test_bsp_sgd_is_the_mean_gradient_step():
    feats = torch.rand((50, 12), dtype=torch.float64)
    pairs = {"a": np.arange(40) % 50, "b": (np.arange(40) * 7 + 3) % 50,
             "sim": (np.arange(40) % 2).astype(np.int32)}
    L0 = 0.3 * torch.randn((5, 12), dtype=torch.float64)
    out = dml.bsp_sgd(feats, pairs, L0, 2, 8, 5, 0.1, 0.01, 2, 1.0, 1.0)
    plan = dml.worker_batches(pairs, 2, 8, 5, 2)
    L = L0
    for t in range(2):
        gs = [dml.eq4(L, feats[pairs["a"][r]], feats[pairs["b"][r]],
                      torch.from_numpy(pairs["sim"][r]), 1.0, 1.0, "f64")[1]
              for r in plan[t]]
        L = L - dml.lr_at(0.1, 0.01, t + 1) * (gs[0] + gs[1]) / 2
        assert torch.allclose(out["params"][t], L, rtol=1e-14)
    assert dml.lr_at(0.1, 0.01, 1) == pytest.approx(0.1 / 1.01, rel=1e-7)


def test_pair_draws_equal_the_port_s_pair_source():
    from repro_torch.core.ps.trainer import make_worker_streams
    from bench.harness.drivers.train_ps import IndexPairs
    feats = torch.arange(300 * 3, dtype=torch.float32).reshape(300, 3)
    labels = torch.arange(300) % 7
    pairs = data.pair_indices(3, labels, 500, 500)
    streams = make_worker_streams(IndexPairs(feats, pairs, "cpu"), 4, 16,
                                  41, device="cpu")
    plan = dml.worker_batches(pairs, 4, 16, 41, 3)
    for t in range(3):
        for p, s in enumerate(streams):
            batch = next(s)
            rows = plan[t][p]
            assert torch.equal(batch["xs"], feats[pairs["a"][rows]])
            assert torch.equal(batch["ys"], feats[pairs["b"][rows]])
            assert np.array_equal(batch["sim"].numpy(), pairs["sim"][rows])


def test_pair_indices_draw_what_they_say():
    labels = torch.randint(0, 9, (400,), generator=torch.Generator()
                           .manual_seed(1))
    p = data.pair_indices(5, labels, 300, 200)
    lab = labels.numpy()
    s = p["sim"] == 1
    assert s.sum() == 300 and (~s).sum() == 200
    assert (lab[p["a"][s]] == lab[p["b"][s]]).all()
    assert (p["a"][s] != p["b"][s]).all()
    assert (lab[p["a"][~s]] != lab[p["b"][~s]]).all()
    again = data.pair_indices(5, labels, 300, 200)
    assert all(np.array_equal(p[k], again[k]) for k in p)


def _gallery(seed=2, m=700, d=16):
    g = torch.Generator().manual_seed(seed)
    G = torch.rand((m, d), generator=g)
    L = torch.randn((6, d), generator=g) / 4
    q = G[:20] + 0.05 * torch.randn((20, d), generator=g)
    return L, G, q


def _blocks(G, step=256):
    for r0 in range(0, len(G), step):
        yield r0, G[r0:r0 + step]


def test_knn_exact_against_brute_force():
    L, G, q = _gallery()
    Ld, Gd, qd = L.double(), G.double(), q.double()
    d = torch.cdist(qd @ Ld.T, Gd @ Ld.T) ** 2
    want = torch.sort(d, dim=1).values[:, :5]
    ids = torch.argsort(d, dim=1)[:, :5]
    top, named = knn.exact(L, _blocks(G), q, ids, 5)
    assert torch.allclose(top, want, rtol=1e-10)
    assert torch.allclose(named, want, rtol=1e-10)
    bad = ids.clone()
    bad[:, 0] = -1
    _, named = knn.exact(L, _blocks(G), q, bad, 5)
    assert torch.isinf(named[:, 0]).all()


def test_answers_and_the_judge():
    L, G, q = _gallery()
    d, i = knn.answers(L, _blocks(G), q, 5, "f64")
    top, named = knn.exact(L, _blocks(G), q, i, 5)
    sound = judge.search_numbers(d.numpy(), i.numpy(), top, named, len(G))
    assert sound["bad_answers"] == 0
    assert sound["dist_gap"] < 1e-12 and sound["rank_gap"] < 1e-12
    wrong = i.clone()
    wrong[:, 0] = i[:, 4]
    _, named = knn.exact(L, _blocks(G), q, wrong, 5)
    out = judge.search_numbers(d.numpy(), wrong.numpy(), top, named, len(G))
    assert out["bad_answers"] == len(q)         # a row named twice
    lower = knn.answers(L, _blocks(G), q, 5, "tf32")
    _, named = knn.exact(L, _blocks(G), q, lower[1], 5)
    low = judge.search_numbers(lower[0].numpy(), lower[1].numpy(), top,
                               named, len(G))
    assert low["dist_gap"] > 100 * sound["dist_gap"]


def test_judge_limits():
    ok, checks = judge.judge({"a": 1e-6, "b": 0}, {"a": 1e-5, "b": 0})
    assert ok and checks["a"] == {"value": 1e-6, "limit": 1e-5}
    assert not judge.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not judge.judge({}, {"a": 1.0})[0]
