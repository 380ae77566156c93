"""The port's dry-run cells (``launch/steps.py``, ``launch/dryrun.py``) held
against the reference's functions on ``jax.sharding.AbstractMesh``: one CPU
device, no compile (the reference's own ``tests/test_dryrun_mini.py`` needs
several devices).

* ``iter_cells``: every (arch, shape) pair's applicability and skip text;
* ``input_specs``, ``abstract_cache``: shapes and dtypes of every kind;
  ``batch_shardings``, ``cache_shardings``: specs on the meshes (16, 16),
  (2, 16, 16), (2, 2) and (2, 2, 2);
* ``cell_gemm_plans`` under ``TPU_V5E`` field for field, over the backend
  pairs xla / torch, pallas / cuda and q16 / q16;
* a cell's argument bytes a device equal the sum of the reference's
  ``shard_shape`` bytes over ``step_and_specs``' arguments;
* ``make_prefill_step`` / ``make_decode_step`` on reduced configs equal the
  reference's on one device, weights carried through ``convert.py``;
* ``dryrun.main`` writes one record a cell that ran and exits 1 when a
  cell fails.
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding

from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_configs as j_all_configs
from repro.configs import get_config as j_get_config
from repro.core.template import Template as JTemplate
from repro.core.template import TemplateConfig as JTemplateConfig
from repro.core.template import default_template as j_template
from repro.core.tiling import TPU_V5E as J_TPU_V5E
from repro.launch import dryrun as jdry
from repro.launch import steps as jsteps
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.template import Template, TemplateConfig, default_template
from repro_torch.core.tiling import TPU_V5E
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as tmesh
from repro_torch.parallel import sharding as S

from torch_family_cases import DECODE_TOL, S as SEQ, _j, _t, _tok, setup_of

ARCHS = sorted(j_all_configs())
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
BACKENDS = [("xla", "torch"), ("pallas", "cuda"), ("q16", "q16")]


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), tmesh.Mesh(sizes, axes)


def _rules(arch, shape):
    kind = SHAPES[shape].kind
    return jdry.rules_for(kind, j_get_config(arch)), dryrun.rules_for(kind, get_config(arch))


def _specs(tree, leaf_type):
    return jax.tree_util.tree_map(lambda s: tuple(s.spec), tree,
                                  is_leaf=lambda x: isinstance(x, leaf_type))


def _shapes(tree):
    return jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                                  tree, is_leaf=lambda x: hasattr(x, "shape"))


def test_iter_cells_equal_the_reference():
    got = list(dryrun.iter_cells(ARCHS, list(SHAPES)))
    want = list(jdry.iter_cells(ARCHS, list(J_SHAPES)))
    assert got == want
    assert any(not ok for _, _, (ok, _) in got) and any(ok for _, _, (ok, _) in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_shardings_equal_the_reference(arch):
    """Every shape's inputs, caches and their shardings on the four meshes."""
    cfg_j, cfg = j_get_config(arch), get_config(arch)
    for shape in SHAPES:
        spec, spec_j = SHAPES[shape], J_SHAPES[shape]
        assert _shapes(steps.input_specs(cfg, spec)) == _shapes(jsteps.input_specs(cfg_j, spec_j))
        caches = None
        if spec.kind != "train":
            c = steps.abstract_cache(cfg, spec.global_batch, spec.seq_len)
            c_j = jsteps.abstract_cache(cfg_j, spec.global_batch, spec.seq_len)
            assert _shapes(c) == _shapes(c_j)
            caches = (c, c_j)
        rules_j, rules = _rules(arch, shape)
        for name in MESHES:
            jm, tm = _meshes(name)
            b = steps.batch_shardings(cfg, spec, tm, rules)
            b_j = jsteps.batch_shardings(cfg_j, spec_j, jm, rules_j)
            assert _specs(b, S.NamedSharding) == _specs(b_j, JNamedSharding), (shape, name)
            if caches is not None:
                cs = steps.cache_shardings(cfg, caches[0], tm, rules)
                cs_j = jsteps.cache_shardings(cfg_j, caches[1], jm, rules_j)
                assert _specs(cs, S.NamedSharding) == _specs(cs_j, JNamedSharding), (shape, name)


def _plan_fields(plan):
    blk = plan.block
    return (plan.m, plan.n, plan.k, tuple(plan.logical),
            None if blk is None else (blk.bm, blk.bn, blk.bk))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: f"{b[0]}-{b[1]}")
def test_cell_gemm_plans_equal_the_reference_under_tpu_v5e(backends, mesh):
    tpl_j = JTemplate(JTemplateConfig(backend=backends[0], hw=J_TPU_V5E))
    tpl = Template(TemplateConfig(backend=backends[1], hw=TPU_V5E, device="cpu"))
    jm, tm = _meshes(mesh)
    for arch in ARCHS:
        cfg_j, cfg = j_get_config(arch), get_config(arch)
        for shape in SHAPES:
            rules_j, rules = _rules(arch, shape)
            got = steps.cell_gemm_plans(cfg, SHAPES[shape], tm, rules, tpl)
            want = jsteps.cell_gemm_plans(cfg_j, J_SHAPES[shape], jm, rules_j, tpl_j)
            assert list(got) == list(want)
            for k in want:
                assert _plan_fields(got[k]) == _plan_fields(want[k]), (arch, shape, k)
                if backends[1] == "torch":
                    assert got[k].block is None


def _reference_bytes(cell) -> int:
    total = 0

    def add(sharding, sub):
        nonlocal total
        for leaf in jax.tree_util.tree_leaves(sub):
            local = sharding.shard_shape(leaf.shape)
            total += math.prod(local) * np.dtype(leaf.dtype).itemsize

    jax.tree_util.tree_map(add, cell.in_shardings, cell.args,
                           is_leaf=lambda x: isinstance(x, JNamedSharding))
    return total


@pytest.mark.parametrize("cell", [("qwen2.5-32b", "decode_32k", "16x16"),
                                  ("qwen2-0.5b", "decode_32k", "16x16"),
                                  ("qwen2-0.5b", "train_4k", "2x2"),
                                  ("whisper-medium", "prefill_32k", "2x2x2"),
                                  ("mamba2-1.3b", "long_500k", "2x16x16"),
                                  ("recurrentgemma-9b", "train_4k", "2x16x16"),
                                  ("llama-3.2-vision-90b", "decode_32k", "2x2")],
                         ids=lambda c: "-".join(c))
def test_argument_bytes_equal_the_reference(cell):
    arch, shape, mesh = cell
    cfg_j, cfg = j_get_config(arch), get_config(arch)
    rules_j, rules = _rules(arch, shape)
    jm, tm = _meshes(mesh)
    kind = SHAPES[shape].kind
    tpl = default_template("torch" if kind == "train" else "cuda", device="cpu")
    got = sum(a["local_bytes"] for a in dryrun.argument_shards(
        steps.step_and_specs(cfg, SHAPES[shape], tm, rules, tpl=tpl)))
    want = _reference_bytes(jsteps.step_and_specs(cfg_j, J_SHAPES[shape], jm, rules_j))
    assert got == want
    if cell == ("qwen2.5-32b", "decode_32k", "16x16"):
        # 4.008 GiB of cache and 250.4 MiB of params a device
        assert got == 4_303_355_904 + 262_588_416 + 128 * 4 // 16 + 4


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "whisper-medium", "mamba2-1.3b"])
def test_prefill_and_decode_steps_equal_the_reference(name):
    cfg_j, cfg, params_j, params, tokens, ctx = setup_of(name)
    k = 2
    tpl, tpl_j = default_template("torch", device="cpu"), j_template("xla")
    batch = {"tokens": _tok(tokens[:, :SEQ - k])}
    batch_j = {"tokens": jnp.asarray(tokens[:, :SEQ - k])}
    if ctx is not None:
        batch["ctx"], batch_j["ctx"] = _t(ctx), _j(ctx)
    lg, cache = steps.make_prefill_step(cfg, tpl, cache_len=SEQ)(params, batch)
    lg_j, cache_j = jsteps.make_prefill_step(cfg_j, tpl_j, cache_len=SEQ)(params_j, batch_j)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), atol=DECODE_TOL, rtol=DECODE_TOL)
    decode, decode_j = steps.make_decode_step(cfg, tpl), jsteps.make_decode_step(cfg_j, tpl_j)
    for t in range(SEQ - k, SEQ):
        lg, cache = decode(params, cache, {"token": _tok(tokens[:, t:t + 1]),
                                           "t": torch.tensor(t, dtype=torch.int32)})
        lg_j, cache_j = decode_j(params_j, cache_j, {"token": jnp.asarray(tokens[:, t:t + 1]),
                                                     "t": jnp.int32(t)})
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), atol=DECODE_TOL,
                                   rtol=DECODE_TOL, err_msg=f"{name} step {t}")


def test_main_writes_a_record_per_cell(tmp_path):
    dryrun.main(["--arch", "qwen2-0.5b", "--mesh", "single", "--device", "cpu",
                 "--out", str(tmp_path)])
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(f"qwen2-0.5b_{s}_16x16.json"
                           for s in ("train_4k", "prefill_32k", "decode_32k"))
    rec = json.loads((tmp_path / "qwen2-0.5b_decode_32k_16x16.json").read_text())
    assert rec["memory"]["argument_size_in_bytes"] == sum(
        a["local_bytes"] for a in rec["arguments"])
    assert {"ops", "cost", "roofline", "model_flops", "useful_ratio",
            "roofline_fraction"} <= set(rec) and "hlo" not in rec
    assert rec["gemm_plans"]["qkv"]["m"] == 8 and rec["template"]["hw"] == "h100_sxm"


def test_main_exits_1_when_a_cell_fails(tmp_path, monkeypatch, capsys):
    def broken(*a, **kw):
        raise RuntimeError("no plan")

    monkeypatch.setattr(dryrun, "step_and_specs", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    assert "2 FAILURES" in capsys.readouterr().out
    assert os.listdir(tmp_path) == []
