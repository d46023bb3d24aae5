"""The port's index snapshots, in-package and across packages, on the CPU.

Six kinds (the three frozen indexes and a MutableIndex over each) round
trip bit for bit in the port. A snapshot written by the JAX reference
loads in the port with ``device="cpu"`` and answers as the reference did
(ids equal, distances within atol + rtol * (||qp||² + ||gp||²), rtol =
atol = 1e-5), and the reverse; the two packages fingerprint one L alike.
Then the guards: fingerprint, rank mismatch, a missing manifest, a
re-save that retracts the manifest first, and a stored scan knob the
device cannot serve.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.serve import ExactIndex as JaxExactIndex
from repro.serve import IVFIndex as JaxIVFIndex
from repro.serve import IVFPQIndex as JaxIVFPQIndex
from repro.serve import MutableIndex as JaxMutableIndex
from repro.serve import load_index as jax_load_index
from repro.serve import save_index as jax_save_index
from repro.serve.snapshot import l_fingerprint as jax_l_fingerprint

from repro_torch.obs import MetricsRegistry
from repro_torch.serve import (ExactIndex, IVFIndex, IVFPQIndex,
                               MutableIndex, has_snapshot, l_fingerprint,
                               load_index, save_index)
from repro_torch.serve import snapshot

CPU = "cpu"
D, K = 24, 12
TOL = 1e-5
KINDS = ["exact", "ivf", "ivfpq", "mutable_exact", "mutable_ivf",
         "mutable_ivfpq"]
BASE_KW = {"exact": {}, "ivf": dict(n_clusters=8, nprobe=8),
           "ivfpq": dict(n_clusters=8, nprobe=8, n_subspaces=4, bits=4,
                         rerank_depth=10_000)}


def _data(M=400, seed=0, n_blobs=12):
    rng = np.random.RandomState(seed)
    centers = 3.0 * rng.randn(n_blobs, D).astype(np.float32)
    G = centers[rng.randint(0, n_blobs, M)] \
        + 0.3 * rng.randn(M, D).astype(np.float32)
    L = (0.3 * rng.randn(K, D)).astype(np.float32)
    q = G[rng.randint(0, M, 9)] + 0.1 * rng.randn(9, D).astype(np.float32)
    return L, G, q, rng


def _port_index(kind, L, G, rng):
    base = kind.replace("mutable_", "")
    if kind.startswith("mutable"):
        mut = MutableIndex.build(L, G, base=base, retain_raw=True,
                                 auto_compact_delta=0, auto_compact_dead=0,
                                 device=CPU, **BASE_KW[base])
        mut.upsert(rng.randn(17, D).astype(np.float32))
        mut.delete(np.arange(9))
        return mut
    cls = {"exact": ExactIndex, "ivf": IVFIndex, "ivfpq": IVFPQIndex}[base]
    return cls.build(L, G, device=CPU, **BASE_KW[base])


def _jax_index(kind, L, G, rng):
    base = kind.replace("mutable_", "")
    if kind.startswith("mutable"):
        mut = JaxMutableIndex.build(L, G, base=base, retain_raw=True,
                                    auto_compact_delta=0,
                                    auto_compact_dead=0, **BASE_KW[base])
        mut.upsert(rng.randn(17, D).astype(np.float32))
        mut.delete(np.arange(9))
        return mut
    cls = {"exact": JaxExactIndex, "ivf": JaxIVFIndex,
           "ivfpq": JaxIVFPQIndex}[base]
    return cls.build(L, jnp.asarray(G), **BASE_KW[base])


def _assert_answers_close(L, q, gp_rows, d, i, d_ref, i_ref):
    """Ids equal; distances within atol + rtol * (||qp||² + ||gp||²)."""
    np.testing.assert_array_equal(i, i_ref)
    qp = q.astype(np.float64) @ L.T.astype(np.float64)
    qn = np.sum(qp ** 2, axis=1)[:, None]
    gn = np.sum(gp_rows.astype(np.float64) ** 2, axis=-1)
    err = np.abs(d.astype(np.float64) - np.asarray(d_ref, np.float64))
    assert (err <= TOL + TOL * (qn + gn)).all(), err.max()


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_bit_for_bit(kind, tmp_path):
    L, G, q, rng = _data()
    index = _port_index(kind, L, G, rng)
    d_ref, i_ref = index.topk(torch.from_numpy(q), 10)
    manifest = save_index(index, str(tmp_path))
    assert has_snapshot(str(tmp_path))
    assert manifest["type"] == type(index).__name__
    restored = load_index(str(tmp_path), expect_L=L, device=CPU)
    assert type(restored) is type(index)
    assert restored.version == index.version
    assert restored.size == index.size
    d, i = restored.topk(torch.from_numpy(q), 10)
    assert torch.equal(i, i_ref) and torch.equal(d, d_ref)


def _raw_rows(L, G, ids, extra):
    """Raw rows of external ids: the first len(G) from G, the rest in
    upsert order from ``extra``."""
    table = np.concatenate([G, extra])
    return table[ids]


@pytest.mark.parametrize("kind", KINDS)
def test_reference_snapshot_loads_in_the_port(kind, tmp_path):
    L, G, q, rng = _data()
    extra = np.random.RandomState(5).randn(17, D).astype(np.float32)
    jidx = _jax_index(kind, L, G, np.random.RandomState(5))
    d_ref, i_ref = jidx.topk(jnp.asarray(q), 10)
    jax_save_index(jidx, str(tmp_path))
    port = load_index(str(tmp_path), expect_L=L, device=CPU)
    assert type(port).__name__ == type(jidx).__name__
    assert port.version == jidx.version and port.size == jidx.size
    d, i = port.topk(torch.from_numpy(q), 10)
    i = i.numpy()
    rows = _raw_rows(L, G, i, extra) @ L.T
    _assert_answers_close(L, q, rows, d.numpy(), i, d_ref, i_ref)
    if kind.startswith("mutable"):
        np.testing.assert_array_equal(port.live_ids(), jidx.live_ids())
        np.testing.assert_array_equal(port.delta_gp.numpy(), jidx.delta_gp)
        assert port._next_id == jidx._next_id
        np.testing.assert_array_equal(port.raw_delta, jidx.raw_delta)


@pytest.mark.parametrize("kind", KINDS)
def test_port_snapshot_loads_in_the_reference(kind, tmp_path):
    L, G, q, rng = _data()
    extra = np.random.RandomState(5).randn(17, D).astype(np.float32)
    index = _port_index(kind, L, G, np.random.RandomState(5))
    d_ref, i_ref = index.topk(torch.from_numpy(q), 10)
    save_index(index, str(tmp_path))
    jidx = jax_load_index(str(tmp_path), expect_L=L)
    assert type(jidx).__name__ == type(index).__name__
    assert jidx.version == index.version and jidx.size == index.size
    d, i = jidx.topk(jnp.asarray(q), 10)
    i = np.asarray(i)
    rows = _raw_rows(L, G, i, extra) @ L.T
    _assert_answers_close(L, q, rows, np.asarray(d), i, d_ref.numpy(),
                          i_ref.numpy())
    if kind.startswith("mutable"):
        more = np.ones((3, D), np.float32)     # both keep mutating alike
        np.testing.assert_array_equal(jidx.upsert(more), index.upsert(more))


def test_fingerprints_agree_across_packages():
    L, _, _, _ = _data()
    assert l_fingerprint(L) == jax_l_fingerprint(L)
    assert l_fingerprint(torch.from_numpy(L)) == jax_l_fingerprint(L)
    assert l_fingerprint(torch.from_numpy(L).T.contiguous().T) == \
        jax_l_fingerprint(L)                   # C order, whatever the strides
    assert l_fingerprint(L + 0.1) != l_fingerprint(L)


def test_fingerprint_and_rank_guards(tmp_path):
    L, G, q, rng = _data()
    save_index(ExactIndex.build(L, G, device=CPU), str(tmp_path))
    load_index(str(tmp_path), expect_L=L, device=CPU)
    with pytest.raises(ValueError, match="fingerprint"):
        load_index(str(tmp_path), expect_L=L + 0.1, device=CPU)
    with pytest.raises(ValueError, match="rank-mismatched"):
        load_index(str(tmp_path), expect_L=L[:6], device=CPU)


def test_missing_manifest_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_index(str(tmp_path), device=CPU)
    assert not has_snapshot(str(tmp_path))


def test_resave_retracts_the_manifest_first(tmp_path, monkeypatch):
    L, G, q, rng = _data()
    index = _port_index("mutable_exact", L, G, rng)
    save_index(index, str(tmp_path))
    assert has_snapshot(str(tmp_path))

    def crash(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(snapshot.np, "savez", crash)
    with pytest.raises(OSError):
        save_index(index, str(tmp_path))
    assert not has_snapshot(str(tmp_path))      # no stale manifest
    with pytest.raises(FileNotFoundError):
        load_index(str(tmp_path), device=CPU)


def test_manifest_keys_and_json_base_kwargs(tmp_path):
    L, G, q, rng = _data()
    index = _port_index("mutable_ivfpq", L, G, rng)
    save_index(index, str(tmp_path))
    with open(os.path.join(tmp_path, snapshot.MANIFEST)) as f:
        manifest = json.load(f)
    assert set(manifest["base"]) == {
        "base_type", "cap", "n_clusters", "nprobe", "n_rows", "block_q",
        "pq_dim", "rerank_depth", "store", "scan_impl"}
    assert manifest["segments"] == {"base": "base.npz",
                                    "mutable": "mutable.npz",
                                    "raw": "raw.npz"}
    assert manifest["mutable"]["base_kwargs"] == BASE_KW["ivfpq"]
    assert not os.path.exists(os.path.join(tmp_path,
                                           snapshot.MANIFEST + ".tmp"))


def test_stored_scan_impl_is_checked_against_the_device(tmp_path):
    L, G, q, rng = _data()
    save_index(IVFIndex.build(L, G, device=CPU, **BASE_KW["ivf"]),
               str(tmp_path))
    path = os.path.join(tmp_path, snapshot.MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    manifest["base"]["scan_impl"] = "pallas"     # the kernel: needs a card
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="needs a CUDA index"):
        load_index(str(tmp_path), device=CPU)


def test_mutate_save_load_mutate(tmp_path):
    L, G, q, rng = _data()
    mut = _port_index("mutable_ivf", L, G, rng)
    save_index(mut, str(tmp_path))
    restored = load_index(str(tmp_path), device=CPU)
    more = rng.randn(5, D).astype(np.float32)
    np.testing.assert_array_equal(mut.upsert(more), restored.upsert(more))
    for m in (mut, restored):
        m.delete(np.asarray([20, 21]))
    d_a, i_a = mut.topk(torch.from_numpy(q), 10)
    d_b, i_b = restored.topk(torch.from_numpy(q), 10)
    assert torch.equal(i_a, i_b) and torch.equal(d_a, d_b)
    mut.compact()
    restored.compact()
    np.testing.assert_array_equal(mut.base.ids_pad.numpy(),
                                  restored.base.ids_pad.numpy())
    assert torch.equal(mut.topk(torch.from_numpy(q), 10)[1],
                       restored.topk(torch.from_numpy(q), 10)[1])


def test_snapshot_events(tmp_path):
    L, G, q, rng = _data()
    reg = MetricsRegistry()
    save_index(ExactIndex.build(L, G, device=CPU), str(tmp_path),
               registry=reg)
    load_index(str(tmp_path), registry=reg, device=CPU)
    assert [e["event"] for e in reg.events()] == ["index_snapshot_save",
                                                  "index_snapshot_load"]
