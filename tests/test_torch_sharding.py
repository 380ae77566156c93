"""The port's sharding planners against the reference's, with ``==``.

``repro_torch.parallel.sharding`` and ``repro_torch.launch.mesh`` keep the
reference's rule tables, drop rule, local-shape planners and spatial halo
planner as pure Python; their results are held equal to the reference's
over fixed grids of shapes and meshes (the reference gets a
``jax.sharding.AbstractMesh`` of the same axes, the port a layout-only
:class:`Mesh`).  Also here: the engine's local plans under a mesh, the
column-parallel placement of a transformer's parameters, and the float
GEMM's k order, which a shard's local plan must keep (the split-k route
sizes its k slices from n, so a plan made at the local n would sum in
another order).
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.template import default_template as j_template
from repro.launch import mesh as jmesh
from repro.models import transformer as JT
from repro.parallel import sharding as JS
from repro_torch.configs import get_config, reduced
from repro_torch.core import dse
from repro_torch.core.engine import Engine
from repro_torch.core.template import TemplateConfig, default_template
from repro_torch.core.tiling import H100
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as S

import torch_shard_cases

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((1, 2), ("data", "model")), ((4,), ("model",)), ((8,), ("data",))]
RULES = {"train": "TRAIN_RULES", "serve": "SERVE_RULES", "decode": "DECODE_RULES"}


def _outcome(fn, *args, **kw):
    """fn's result, or the ValueError it raises (the halo planner's
    rejections must agree too)."""
    try:
        return fn(*args, **kw)
    except ValueError as err:
        return ("ValueError", str(err))


def _meshes(sizes, names):
    return AbstractMesh(sizes, names), tmesh.Mesh(sizes, names)


@pytest.mark.parametrize("name", sorted(RULES))
def test_rule_tables_equal(name):
    ref, port = getattr(JS, RULES[name]), getattr(S, RULES[name])
    assert port.rules == ref.rules
    assert port.with_overrides(heads=None, batch="data").rules == \
        ref.with_overrides(heads=None, batch="data").rules
    for logical, _ in ref.rules:
        assert port.get(logical) == ref.get(logical)


def test_production_and_test_meshes():
    for multi in (False, True):
        for make in ("make_production_mesh", "make_test_mesh"):
            port = getattr(tmesh, make)(multi_pod=multi)
            want = dict(zip(*{("make_production_mesh", False): (("data", "model"), (16, 16)),
                              ("make_production_mesh", True): (("pod", "data", "model"),
                                                               (2, 16, 16)),
                              ("make_test_mesh", False): (("data", "model"), (2, 2)),
                              ("make_test_mesh", True): (("pod", "data", "model"),
                                                         (2, 2, 2))}[make, multi]))
            assert port.shape == want and not port.has_groups
            ref = AbstractMesh(tuple(want.values()), tuple(want))
            assert tmesh.mesh_name(port) == jmesh.mesh_name(ref)
            assert tmesh.mesh_chips(port) == jmesh.mesh_chips(ref)
            assert tuple(tmesh.gemm_partition(port)) == tuple(jmesh.gemm_partition(ref))


LOGICALS = [("batch", "seq_act", "act_embed"), ("batch", None, "act_heads", None),
            ("embed", "qkv"), ("qkv", "embed"), ("vocab", "embed"), ("batch", "seq_act",
                                                                     "vocab"),
            ("batch", None, "seq_kv", None), ("embed", "mlp"), ("mlp",), (None, "heads"),
            ("batch", "seq_act", "seq_kv")]
SIZES = [(8, 16, 64), (3, 5, 7), (16, 896, 4864), (256, 512, 1024), (1, 2, 151936)]


@pytest.mark.parametrize("sizes,names", MESHES)
def test_logical_to_spec_and_local_dims_equal(sizes, names):
    ref_mesh, port_mesh = _meshes(sizes, names)
    for name in RULES.values():
        jr, tr = getattr(JS, name), getattr(S, name)
        for logical in LOGICALS:
            for dims in SIZES:
                dims = (dims * 2)[:len(logical)]
                want = JS.logical_to_spec(logical, mesh=ref_mesh, rules=jr, dim_sizes=dims)
                got = S.logical_to_spec(logical, mesh=port_mesh, rules=tr, dim_sizes=dims)
                assert tuple(got) == tuple(want), (name, logical, dims)
            assert tuple(S.logical_to_spec(logical, mesh=port_mesh, rules=tr)) == \
                tuple(JS.logical_to_spec(logical, mesh=ref_mesh, rules=jr))
    for axes in (None, "data", "model", ("pod", "data"), ("data", "model"), "pod"):
        assert S.axis_size(port_mesh, axes) == JS.axis_size(ref_mesh, axes)
        for dim in (1, 2, 3, 16, 17, 32, 896, 4864):
            assert S.local_dim(dim, port_mesh, axes) == JS.local_dim(dim, ref_mesh, axes)


@pytest.mark.parametrize("sizes,names", MESHES)
def test_local_gemm_and_conv_shapes_equal(sizes, names):
    ref_mesh, port_mesh = _meshes(sizes, names)
    parts = [None, ("data", "model"), ("model", None), (None, "model", "data")]
    for (m, n, k), part in itertools.product(
            [(8, 4864, 896), (4, 896, 896), (1, 151936, 896), (6272, 64, 27), (3, 7, 5),
             (64, 96, 64), (2048, 256, 1152)], parts):
        if part is not None and any(a not in names for a in part if a):
            continue
        jp = None if part is None else jax.sharding.PartitionSpec(*part)
        tp = None if part is None else S.PartitionSpec(*part)
        assert S.local_gemm_shape(m, n, k, mesh=port_mesh, partition=tp) == \
            JS.local_gemm_shape(m, n, k, mesh=ref_mesh, partition=jp)
    for x_shape, w_shape, stride, pad in [((8, 224, 224, 3), (3, 3, 3, 64), 1, 1),
                                          ((8, 224, 224, 3), (11, 11, 3, 64), 4, 2),
                                          ((3, 27, 9, 4), (3, 3, 4, 10), 2, 1)]:
        assert S.local_conv_shapes(x_shape, w_shape, mesh=port_mesh) == \
            JS.local_conv_shapes(x_shape, w_shape, mesh=ref_mesh)
        for spatial in (2, 3) + (("data",) if "data" in names else ()):
            kw = dict(spatial=spatial, stride=stride, padding=pad)
            assert _outcome(S.local_conv_shapes, x_shape, w_shape, mesh=port_mesh, **kw) \
                == _outcome(JS.local_conv_shapes, x_shape, w_shape, mesh=ref_mesh, **kw)


@pytest.mark.parametrize("sizes,names", MESHES[:4])
def test_engine_local_plans_equal(sizes, names):
    """plan_gemm / plan_conv under a mesh plan the reference's local shapes
    (and record the same logical shape); the blocks are each package's
    hardware's, under the TPU spec the reference's own."""
    ref_mesh, port_mesh = _meshes(sizes, names)
    jeng = j_template("pallas").engine
    for backend in ("cuda", "q16"):
        teng = default_template(backend, device="cpu").engine
        for m, n, k in [(8, 4864, 896), (4, 896, 128), (1, 151936, 896), (512, 4864, 896)]:
            want = jeng.plan_gemm(m, n, k, mesh=ref_mesh)
            got = teng.plan_gemm(m, n, k, mesh=port_mesh)
            assert (got.m, got.n, got.k, got.logical) == (want.m, want.n, want.k,
                                                          want.logical)
        for x_shape, w_shape in [((8, 56, 56, 64), (3, 3, 64, 128)),
                                 ((8, 224, 224, 3), (3, 3, 3, 64))]:
            want = jeng.plan_conv(x_shape, w_shape, padding=1, mesh=ref_mesh)
            got = teng.plan_conv(x_shape, w_shape, padding=1, mesh=port_mesh)
            assert got.gemm == want.gemm and got.pad == want.pad
    teng = Engine(TemplateConfig(backend="cuda", hw=dse.TPU_V5E, device="cpu"))
    for m, n, k in [(8, 4864, 896), (512, 4864, 896)]:
        want = jeng.plan_gemm(m, n, k, mesh=ref_mesh)
        got = teng.plan_gemm(m, n, k, mesh=port_mesh)
        assert (got.block.bm, got.block.bn, got.block.bk) == \
            (want.block.bm, want.block.bn, want.block.bk)


def test_param_and_cache_axes_equal():
    cfg_j = j_reduced(j_get_config("qwen2-0.5b"))
    cfg = reduced(get_config("qwen2-0.5b"))
    assert T.param_axes(cfg) == JT.param_axes(cfg_j)
    full_j, full = j_get_config("qwen2-0.5b"), get_config("qwen2-0.5b")
    assert T.param_axes(full) == JT.param_axes(full_j)
    for per_slot in (False, True):
        cj = JT.init_cache(cfg_j, 4, 16, per_slot=per_slot)
        ct = T.init_cache(cfg, 4, 16, per_slot=per_slot)
        assert T.cache_axes(cfg, ct) == JT.cache_axes(cfg_j, cj)


def _specs(tree):
    """A placement tree's specs as plain tuples (either package's)."""
    if isinstance(tree, (S.NamedSharding, JNamedSharding)):
        return tuple(tree.spec)
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_specs(v) for v in tree)
    raise TypeError(tree)


@pytest.mark.parametrize("sizes,names", [((2, 2), ("data", "model")),
                                         ((1, 4), ("data", "model")),
                                         ((2, 2, 2), ("pod", "data", "model"))])
def test_column_parallel_and_tree_shardings_equal(sizes, names):
    ref_mesh, port_mesh = _meshes(sizes, names)
    cfg_j = j_reduced(j_get_config("qwen2-0.5b"))
    cfg = reduced(get_config("qwen2-0.5b"))
    params_j = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    import torch

    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    axes_j, axes = JT.param_axes(cfg_j), T.param_axes(cfg)
    for rules in ("DECODE_RULES", "SERVE_RULES", "TRAIN_RULES"):
        want = JS.column_parallel_shardings(ref_mesh, getattr(JS, rules), params_j, axes_j)
        got = S.column_parallel_shardings(port_mesh, getattr(S, rules), params, axes)
        assert _specs(got) == jax.tree_util.tree_map(
            lambda s: tuple(s.spec), want, is_leaf=lambda x: isinstance(x, JNamedSharding))
        want = JS.tree_shardings(ref_mesh, getattr(JS, rules), params_j, axes_j)
        got = S.tree_shardings(port_mesh, getattr(S, rules), params, axes)
        assert _specs(got) == jax.tree_util.tree_map(
            lambda s: tuple(s.spec), want, is_leaf=lambda x: isinstance(x, JNamedSharding))


def test_constrain_and_use_mesh_without_ranks():
    import torch

    x = torch.ones(2, 3, 8)
    assert S.constrain(x, "batch", None, "mlp") is x  # no mesh: a no-op
    mesh = tmesh.make_test_mesh()
    with S.use_mesh(mesh, S.DECODE_RULES):
        assert S.active_mesh() is mesh and S.active_rules() is S.DECODE_RULES
        assert S.constrain(x, "batch", None, "mlp") is x  # nothing marked as a shard
        assert S.spatial_shards("data") == (2, "data")
    assert S.active_mesh() is None
    with pytest.raises(ValueError):
        S.spatial_shards("data")  # an axis name without an active mesh
    with pytest.raises(ValueError):
        S.shard_tree({"w": x}, {"w": S.NamedSharding(mesh, S.PartitionSpec("data"))})


# ---------------------------------------------------------------------------
# the float GEMM's k order under a column split
# ---------------------------------------------------------------------------


def _decode_shapes(cfg):
    d, h, kv, hd, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           cfg.d_ff, cfg.vocab)
    return {"wq": (d, h * hd), "wk": (d, kv * hd), "gate_up": (d, ff), "down": (ff, d),
            "wo": (h * hd, d), "head": (d, v)}


@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_local_float_plans_keep_the_logical_k_order(dtype_bytes):
    """qwen2-0.5b's decode GEMMs at n / 2 (a 2-way "model" axis) and at the
    local rows of a 2-way data axis: the local plan keeps the logical plan's
    route, bk and splits, so each output column is summed in the same order
    as on one device (the head at n / 2 would otherwise take twice the k
    slices)."""
    import torch

    cfg = get_config("qwen2-0.5b")
    dtype = torch.float32 if dtype_bytes == 4 else torch.bfloat16
    eng = Engine(TemplateConfig(backend="cuda", device="cpu"))
    mesh = tmesh.Mesh((2, 2), ("data", "model"))
    for name, (k, n) in _decode_shapes(cfg).items():
        for m in (1, 2, 4, 8, 16, 64, 512):
            want = dse.default_fp_block_for(m, n, k, H100, dtype_bytes=dtype_bytes)
            plan = eng.plan_gemm(m, n, k, mesh=mesh)
            local = eng.block_for(plan.m, plan.n, plan.k, dtype=dtype,
                                  logical=plan.logical)
            assert (local.route, local.bk, local.splits) == \
                (want.route, want.bk, want.splits), (name, m, local, want)
            assert dse.fp_block_legal(local, plan.m, plan.n, plan.k,
                                      dtype_bytes=dtype_bytes, spec=H100)
            if dtype_bytes == 4:
                assert plan.block == local


def test_local_float_plan_is_keyed_and_stored_apart(tmp_path):
    from repro_torch.core.engine import PlanRegistry

    reg = PlanRegistry()
    a = reg.block_for(4, 75968, 896, H100, kernel="matmul_fp")
    b = reg.block_for(4, 75968, 896, H100, kernel="matmul_fp", logical=(4, 151936, 896))
    assert (a.bk, a.splits) != (b.bk, b.splits) and reg.misses == 2
    assert reg.gemm_shapes(H100) == [(4, 75968, 896)]
    path = reg.save(str(tmp_path / "store.json"))
    back = PlanRegistry()
    assert back.load(path) == 2
    assert back.block_for(4, 75968, 896, H100, kernel="matmul_fp",
                          logical=(4, 151936, 896)) == b
    assert back.misses == 0


# ---------------------------------------------------------------------------
# the spatial halo planner, field for field
# ---------------------------------------------------------------------------


def _halo(mod, *args, **kw):
    out = _outcome(mod.plan_spatial_halo, *args, **kw)
    return out if isinstance(out, tuple) else dataclasses.asdict(out)


def test_plan_spatial_halo_equal_over_a_grid():
    n = 0
    for h, kh, stride, pad, shards in itertools.product(
            (1, 2, 5, 8, 13, 26, 27, 28, 56, 224), (1, 2, 3, 5, 7, 11), (1, 2, 4),
            (0, 1, 2, 3), (1, 2, 3, 4, 8)):
        for lx in (None, -(-h // shards) + 1):
            args = (h, kh, stride, pad, shards)
            assert _halo(S, *args, lx=lx) == _halo(JS, *args, lx=lx), (args, lx)
            assert _halo(S, *args, axis="data", lx=lx) == \
                _halo(JS, *args, axis="data", lx=lx)
            n += 1
    assert n > 1000


def test_the_drawn_geometry_that_the_planner_rejects():
    """The reference property's draw for seed 28658 (its
    ``_conv_case``), which ``plan_spatial_halo`` rejects: both packages
    raise the same ``ValueError``."""
    rng = np.random.default_rng(28658)
    kh = int(rng.choice([1, 3, 5]))
    stride = int(rng.choice([1, 2]))
    pad = int(rng.choice([0, 1, kh // 2]))
    shards = int(rng.choice([2, 3]))
    h = int(rng.integers(max(kh + stride, 3 * shards), 30))
    for mod in (S, JS):
        with pytest.raises(ValueError, match="single-hop"):
            mod.plan_spatial_halo(h, kh, stride, pad, shards)
    assert _halo(S, h, kh, stride, pad, shards) == _halo(JS, h, kh, stride, pad, shards)


def test_byte_models_equal():
    for args in [(56, 3, 1, 1, 4), (224, 3, 1, 1, 2), (27, 3, 2, 1, 2), (55, 3, 2, 0, 2)]:
        hs, jhs = S.plan_spatial_halo(*args), JS.plan_spatial_halo(*args)
        for n, w, c, item in [(8, 56, 64, 2), (8, 224, 64, 4), (2, 9, 3, 1)]:
            assert S.spatial_halo_bytes(hs, n, w, c, item) == \
                JS.spatial_halo_bytes(jhs, n, w, c, item)
            assert S.spatial_gather_bytes(args[0], n, w, c, args[4], item) == \
                JS.spatial_gather_bytes(args[0], n, w, c, args[4], item)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("payload,match", [
    ({"rank": 1}, "rank 1 fails on purpose"),
    ({"rank": 0, "exit": True}, "exited with code 3"),
])
def test_spawn_ranks_raises_a_failing_rank(payload, match):
    """A rank that raises (its traceback), or dies without a report (its
    exit code), makes the parent raise; the ranks left waiting in a
    collective are stopped, not waited for."""
    import functools

    with pytest.raises(RuntimeError, match=match):
        tmesh.spawn_ranks(functools.partial(torch_shard_cases.failing_case, payload), 2,
                          device="cpu", timeout=120)
