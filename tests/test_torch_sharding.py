"""The sharding plan (``repro_torch.sharding.partition``,
``repro_torch.launch.mesh``, the families' ``logical_axes``, the
sharding specs of ``repro_torch.launch.steps``) against the reference's
on the same meshes, exactly.

The reference runs on ``jax.sharding.AbstractMesh`` (no devices) and
its trees come from ``jax.eval_shape``; the port's models are built on
``meta``. The reference stacks the blocks on a leading "layers" axis,
which the tests strip; the port keeps a list of per-layer trees. Decode
caches are planned in the reference's stacked layout on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config, get_shape as ref_shape
from repro.configs.base import RunConfig as RefRunConfig
from repro.launch import steps as ref_steps
from repro.models.transformer import build_model
from repro.sharding import partition as ref_partition

from repro_torch.configs import SHAPES, get_config, get_shape, list_configs
from repro_torch.launch import dryrun, mesh as mesh_lib, steps
from repro_torch.models import Model
from repro_torch.sharding import partition

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PRODUCTION = ("16x16", "2x16x16")
PORT_MESHES = {"16x16": "16x16", "2x16x16": "pod2x16x16"}    # mesh.MESHES


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), mesh_lib.Mesh(names, sizes)


def test_mesh_shapes():
    single = mesh_lib.make_production_mesh()
    multi = mesh_lib.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    assert mesh_lib.make_local_mesh().shape == {"data": 1, "model": 1}
    assert mesh_lib.make_local_mesh().size == 1
    assert list(multi.shape) == ["pod", "data", "model"]
    assert mesh_lib.MESHES == {"h100": mesh_lib.make_local_mesh(),
                               "16x16": single, "pod2x16x16": multi}


def test_rule_table_is_the_reference_s():
    assert partition.DEFAULT_RULES == ref_partition.DEFAULT_RULES


_NAMES = sorted(partition.DEFAULT_RULES) + [None, "not_a_rule"]
_DIMS = [1, 2, 3, 4, 8, 9, 16, 24, 32, 48, 54, 64, 96, 128, 512, 4096]


@settings(max_examples=300, deadline=None)
@given(logical=st.lists(st.sampled_from(_NAMES), min_size=0, max_size=5),
       dims=st.lists(st.sampled_from(_DIMS), min_size=5, max_size=5),
       mesh_name=st.sampled_from(sorted(MESHES)),
       with_shape=st.booleans(),
       override=st.sampled_from([None, {"embed": None},
                                 {"heads": ("data", "model")},
                                 {"seq": "model", "batch": "data"}]))
def test_logical_to_physical_equals_reference(logical, dims, mesh_name,
                                              with_shape, override):
    ref_mesh, mesh = _meshes(mesh_name)
    shape = tuple(dims[:len(logical)]) if with_shape else None
    ref = ref_partition.logical_to_physical(logical, ref_mesh, override,
                                            shape=shape)
    got = partition.logical_to_physical(logical, mesh, override,
                                        shape=shape)
    assert got == tuple(ref)


def test_local_shape_divides_each_sharded_dim():
    _, mesh = _meshes("2x16x16")
    spec = partition.logical_to_physical(("batch", "heads", None, "ffn"),
                                         mesh, shape=(64, 32, 7, 48))
    assert spec == (("pod", "data"), "model", None, None)
    assert partition.local_shape((64, 32, 7, 48), spec, mesh) == \
        (2, 2, 7, 48)
    assert partition.local_shape((5,), (), mesh) == (5,)


def test_placement_raises_citing_item_8():
    _, mesh = _meshes("16x16")
    with pytest.raises(NotImplementedError, match="fake_world"):
        partition.constrain(np.zeros(3), ("batch",), mesh)
    with pytest.raises(NotImplementedError, match="fake_world"):
        partition.shard_map(lambda x: x, mesh, None, None)


# --------------------------------------------------------------------------
# logical axes and the steps' specs, every arch of the registry
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref(arch):
    model = build_model(ref_config(arch))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return model, params


@functools.lru_cache(maxsize=None)
def _port(arch):
    model = Model(get_config(arch), device="meta")
    return model, model.param_tree()


def _strip_layers(tree, n_layers):
    """The reference's stacked block tree as the port's list of layers:
    each leaf's leading entry dropped (it must be the layers axis's)."""
    def strip(x):
        assert x[0] in ("layers", None), x
        return tuple(x[1:])
    one = jax.tree.map(strip, tree, is_leaf=lambda x: isinstance(x, tuple))
    return [one] * n_layers


def _as_port(ref_tree, n_layers):
    out = dict(ref_tree)
    out["blocks"] = _strip_layers(ref_tree["blocks"], n_layers)
    return out


def _specs(tree):
    return jax.tree.map(lambda s: tuple(s.spec), tree)


@pytest.mark.parametrize("arch", list_configs())
def test_model_logical_axes_equal_reference(arch):
    ref_model, ref_params = _ref(arch)
    model, params = _port(arch)
    ref_axes = ref_model.logical_axes(jax.tree.map(lambda x: None,
                                                   ref_params))
    assert jax.tree.all(jax.tree.map(
        lambda lg: lg[0] == "layers", ref_axes["blocks"],
        is_leaf=lambda x: isinstance(x, tuple)))
    got = model.logical_axes()
    assert got == _as_port(ref_axes, model.cfg.n_layers)
    # one tuple a leaf, one name a dimension
    partition.map_axes(lambda lg, t: None if len(lg) == t.ndim else
                       pytest.fail(f"{lg} for {tuple(t.shape)}"),
                       got, params)


@pytest.mark.parametrize("mesh_name", PRODUCTION)
@pytest.mark.parametrize("arch", list_configs())
def test_param_and_state_shardings_equal_reference(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    ref_model, ref_params = _ref(arch)
    model, params = _port(arch)
    L = model.cfg.n_layers
    ref_p = ref_steps.param_shardings(ref_model, ref_params, ref_mesh)
    pshard = steps.param_shardings(model, params, mesh)
    assert pshard == _as_port(_specs(ref_p), L)

    run = RefRunConfig(arch=arch, shape="train_4k")
    opt = ref_steps.make_optimizer(run)
    ref_state = jax.eval_shape(lambda p: ref_steps.TrainState(
        p, opt.init(p), jnp.zeros((), jnp.int32)), ref_params)
    ref_s = ref_steps.make_state_shardings(ref_state, ref_params, ref_p,
                                           ref_mesh)
    state = steps.init_train_state(model, steps.make_optimizer(run))
    sshard = steps.make_state_shardings(state, params, pshard, mesh)
    assert sshard.params == pshard and sshard.step == ()
    ref_opt = _specs(ref_s.opt_state)
    assert sshard.opt_state.step == ref_opt.step
    for field in ("m", "v"):
        assert getattr(sshard.opt_state, field) == \
            _as_port(getattr(ref_opt, field), L)


_COMBOS = [(a, s) for a in list_configs() for s in SHAPES]


@pytest.mark.parametrize("mesh_name", PRODUCTION)
@pytest.mark.parametrize("arch,shape_name", _COMBOS)
def test_input_and_cache_shardings_equal_reference(arch, shape_name,
                                                   mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    ref_cfg = ref_steps.effective_config(ref_config(arch),
                                         ref_shape(shape_name))
    cfg = steps.effective_config(get_config(arch), get_shape(shape_name))
    shape = get_shape(shape_name)
    ref_in = ref_steps.input_shardings(
        ref_steps.input_specs(ref_cfg, ref_shape(shape_name)), ref_mesh)
    got = steps.input_shardings(steps.input_specs(cfg, shape), mesh)
    assert got == _specs(ref_in)
    if shape.mode != "decode" or not cfg.has_decode:
        return
    ref_model = build_model(ref_cfg)
    ref_c = ref_steps.cache_shardings(ref_model, ref_cfg,
                                      ref_shape(shape_name), ref_mesh)
    model = Model(cfg, device="meta")
    got_c = steps.cache_shardings(model, cfg, shape, mesh)
    assert jax.tree.structure(got_c, is_leaf=lambda x: isinstance(
        x, tuple) and not hasattr(x, "_fields")).num_leaves == \
        len(jax.tree.leaves(ref_c))
    assert {k: tuple(v) for k, v in got_c.items()} == \
        {k: tuple(tuple(s.spec) for s in v) for k, v in ref_c.items()}
    # the stacked shapes are the reference's cache's
    ref_structs = ref_steps.cache_shape_structs(ref_model,
                                                ref_shape(shape_name))
    stacked = steps.stacked_cache_shapes(
        steps.cache_shape_structs(model, shape))
    assert {k: tuple(v) for k, v in stacked.items()} == \
        {k: tuple(tuple(s.shape) for s in v)
         for k, v in ref_structs.items()}


def _ref_argument_bytes(arch, shape_name, ref_mesh):
    """Per-rank bytes of the reference's step arguments, summed from its
    specs and shapes (``NamedSharding.shard_shape``)."""
    ref_model, ref_params = _ref(arch)
    shape = ref_shape(shape_name)
    cfg = ref_steps.effective_config(ref_config(arch), shape)
    ref_model = build_model(cfg)
    pshard = ref_steps.param_shardings(ref_model, ref_params, ref_mesh)
    specs = ref_steps.input_specs(cfg, shape)
    args = [(ref_params, pshard),
            (specs, ref_steps.input_shardings(specs, ref_mesh))]
    if shape.mode == "train":
        opt = ref_steps.make_optimizer(RefRunConfig(arch=arch,
                                                    shape=shape_name))
        state = jax.eval_shape(lambda p: ref_steps.TrainState(
            p, opt.init(p), jnp.zeros((), jnp.int32)), ref_params)
        sshard = ref_steps.make_state_shardings(state, ref_params, pshard,
                                                ref_mesh)
        args = [(state, sshard), args[1]]
    elif shape.mode == "decode":
        args.append((ref_steps.cache_shape_structs(ref_model, shape),
                     ref_steps.cache_shardings(ref_model, cfg, shape,
                                               ref_mesh)))
    total = 0
    for tree, shard in args:
        for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(shard)):
            total += int(np.prod(sh.shard_shape(leaf.shape))) * \
                leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh_name", PRODUCTION)
@pytest.mark.parametrize("arch,shape_name", _COMBOS)
def test_plan_argument_bytes_equal_reference(arch, shape_name, mesh_name):
    # the plan's record, traced nothing (a dense arch's dryrun_one record
    # traces rank 0's program and holds its arguments to this one)
    rec = dryrun.plan_record(arch, shape_name, PORT_MESHES[mesh_name])
    if not get_config(arch).has_decode and \
            get_shape(shape_name).mode == "decode":
        assert rec["status"] == "skipped"
        return
    ref_mesh, _ = _meshes(mesh_name)
    assert rec["status"] == "plan"
    assert rec["n_chips"] == (512 if mesh_name == "2x16x16" else 256)
    assert rec["memory"]["argument_size"] == \
        _ref_argument_bytes(arch, shape_name, ref_mesh)
