"""The port's roofline (``core/roofline.py``) and op analyzer
(``core/op_analysis.py``) held exactly against the reference's
``repro.core.roofline`` and ``repro.core.hlo_analysis``.

* ``model_flops`` with ``==``, training and inference, at several N and D;
* the ring model (``wire_bytes``) with ``==`` against
  ``parse_collective_bytes`` on one-line HLO texts of the same collective:
  all five kinds, f32 / bf16 / s8, groups 2 to 16, both ``replica_groups``
  syntaxes;
* ``RooflineReport``'s ``dominant``, ``bound_s``, ``roofline_fraction`` and
  ``row()`` against the reference's ``roofline_from_compiled`` at H100's
  rates, on HLO lines made from a recording rank's collectives;
* the analyzer's flops against ``analyze_hlo``'s on the reference's own
  unit cases (``tests/test_hlo_attention.py``) and on reduced configs'
  prefill, decode and train steps (the port's ``torch`` template, the
  reference's jitted ``xla`` steps, one device).
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core import roofline as jroof
from repro.core.hlo_analysis import analyze_hlo
from repro.core.template import default_template as j_template
from repro.core.tiling import TpuSpec
from repro.launch import steps as jsteps
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import roofline as roof
from repro_torch.core.op_analysis import analyze_step
from repro_torch.core.template import default_template
from repro_torch.core.tiling import H100
from repro_torch.launch import dryrun, steps
from repro_torch.launch import scheduler as S
from repro_torch.launch.mesh import Mesh, make_test_mesh
from repro_torch.parallel import sharding as sh

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
DTYPES = {"f32": 4, "bf16": 2, "s8": 1}
#: the reference's TPU spec carrying H100's three roofline rates
H100_AS_TPU = TpuSpec(name="h100_sxm", peak_bf16_flops=H100.peak_bf16_flops,
                      hbm_bw=H100.hbm_bw, ici_bw=H100.link_bw)


def _tpl():
    return default_template("torch", device="cpu")


@pytest.mark.parametrize("training", [True, False])
def test_model_flops_equal_the_reference(training):
    for n in (1, 494_032_768, 32.5e9, 6.6e9 + 0.5):
        for d in (1, 128, 4096 * 256, 32768 * 32):
            assert roof.model_flops(n, d, training) == jroof.model_flops(n, d, training)


def _hlo_line(kind: str, dtype: str, shape: tuple, group: int, syntax: str, i: int = 0) -> str:
    dims = ",".join(map(str, shape))
    groups = (f"replica_groups=[{32 // group},{group}]<=[32]" if syntax == "iota" else
              "replica_groups={{" + ",".join(map(str, range(group))) + "},{"
              + ",".join(map(str, range(group, 2 * group))) + "}}")
    return (f"  %{kind}.{i} = {dtype}[{dims}]{{1,0}} {kind}({dtype}[{dims}]{{1,0}} %p.{i}), "
            f"channel_id={i + 1}, {groups}, use_global_device_ids=true")


@pytest.mark.parametrize("syntax", ["iota", "list"])
@pytest.mark.parametrize("kind", KINDS)
def test_ring_model_equals_parse_collective_bytes(kind, syntax):
    for dtype, width in DTYPES.items():
        for group in (2, 4, 8, 16):
            for shape in ((64, 128), (3, 896), (1, 151936)):
                line = _hlo_line(kind, dtype, shape, group, syntax)
                size = shape[0] * shape[1] * width
                want = jroof.parse_collective_bytes(line, total_devices=32)
                got = roof.wire_bytes(kind, size, group)
                assert got == want.wire_bytes, (line, got, want.wire_bytes)
                assert want.counts == {kind: 1} and want.operand_bytes == size


@functools.lru_cache(maxsize=None)
def _recorded_train_collectives():
    """A recording rank's collectives of reduced qwen2's train step on the
    reference's (2, 2) test mesh."""
    cfg = reduced(get_config("qwen2-0.5b"))
    st, _, _ = dryrun.analyze_cell(cfg, ShapeSpec("t", 32, 8, "train"), make_test_mesh(),
                                   dryrun.rules_for("train", cfg))
    return tuple(st.collectives)


@pytest.mark.parametrize("flops,byts", [(3.2e15, 1e9), (1e9, 4e12), (1e6, 1e6), (0.0, 0.0)],
                         ids=["compute", "memory", "collective", "empty"])
def test_roofline_report_equals_the_reference(flops, byts):
    colls = _recorded_train_collectives()
    assert {c.kind for c in colls} == {"all-gather", "reduce-scatter", "all-reduce"}
    # each recorded collective as one HLO line: u8 bytes, its group
    hlo = "\n".join(_hlo_line(c.kind, "u8", (1, c.bytes), c.group, "iota", i)
                    for i, c in enumerate(colls))
    kw = dict(arch="qwen2-0.5b", shape="train_4k", mesh_name="2x2", chips=4,
              n_params_active=494_032_768, tokens=4096 * 256, training=True)
    got = roof.roofline_from_counts(flops=flops, bytes_accessed=byts, collectives=colls, **kw)
    want = jroof.roofline_from_compiled(cost_analysis={"flops": flops, "bytes accessed": byts},
                                        hlo_text=hlo, spec=H100_AS_TPU, **kw)
    assert got.dominant == want.dominant
    assert got.bound_s == want.bound_s
    assert got.roofline_fraction == want.roofline_fraction
    renamed = {k.replace("op_", "hlo_", 1) if k.startswith("op_") else k: v
               for k, v in got.row().items()}
    assert renamed == want.row()
    assert roof.collective_stats(colls).wire_bytes == jroof.parse_collective_bytes(
        hlo, total_devices=4).wire_bytes


# ---------------------------------------------------------------------------
# the analyzer's flops on the reference's unit cases
# ---------------------------------------------------------------------------


def _hlo_flops(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())


def _count(fn, *shapes):
    return analyze_step(fn, *(torch.empty(s) for s in shapes), tpl=_tpl())


def test_dot_flops_equal_the_reference():
    m, k, n = 128, 320, 64
    assert _count(torch.matmul, (m, k), (k, n)).flops == \
        _hlo_flops(jnp.matmul, (m, k), (k, n)).flops == 2 * m * k * n


def test_batched_dot_flops_equal_the_reference():
    shapes = ((4, 32, 16), (4, 16, 8))
    got = _count(lambda a, b: torch.einsum("bik,bkj->bij", a, b), *shapes).flops
    assert got == _hlo_flops(lambda a, b: jnp.einsum("bik,bkj->bij", a, b), *shapes).flops
    assert got == 2 * 4 * 32 * 16 * 8


@pytest.mark.parametrize("layers", [2, 8])
def test_layer_loop_flops_equal_the_reference(layers):
    """The reference's scan over ``tanh(h @ w)`` (its trip count) against the
    port's loop over the same layers."""
    def jf(x, ws):
        return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, ws)[0]

    def tf(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    shapes = ((256, 256), (layers, 256, 256))
    assert _count(tf, *shapes).flops == _hlo_flops(jf, *shapes).flops == \
        layers * 2 * 256 ** 3


def test_matmul_bytes_in_the_reference_range():
    n = 512
    st = _count(torch.matmul, (n, n), (n, n))
    assert 3 * n * n * 4 <= st.bytes <= 4 * 3 * n * n * 4
    assert st.bytes_by_group["gemm"] == st.bytes == 3 * n * n * 4


# ---------------------------------------------------------------------------
# reduced configs: the analyzer against analyze_hlo on the jitted xla steps
# ---------------------------------------------------------------------------

SEQ, BATCH = 64, 2


def _reference_flops(arch: str, kind: str) -> float:
    cfg = j_reduced(j_get_config(arch))
    tpl = j_template("xla")
    shape = JShapeSpec(kind, SEQ, BATCH, kind)
    batch = jsteps.input_specs(cfg, shape)
    params = jsteps.abstract_params(cfg)
    if kind == "train":
        step = jsteps.make_train_step(cfg, tpl)
        args = (params, jsteps.abstract_opt_state(cfg), batch)
    elif kind == "prefill":
        step = jsteps.make_prefill_step(cfg, tpl, cache_len=SEQ)
        args = (params, batch)
    else:
        step = jsteps.make_decode_step(cfg, tpl)
        args = (params, jsteps.abstract_cache(cfg, BATCH, SEQ), batch)
    return analyze_hlo(jax.jit(step).lower(*args).compile().as_text()).flops


def _port_flops(arch: str, kind: str) -> float:
    cfg = reduced(get_config(arch))
    tpl = _tpl()
    batch = steps.input_specs(cfg, ShapeSpec(kind, SEQ, BATCH, kind))
    params = steps.abstract_params(cfg)
    if kind == "train":
        fn, args = steps.make_train_step(cfg, tpl), (params, steps.abstract_opt_state(cfg, params),
                                                     batch)
    elif kind == "prefill":
        fn, args = steps.make_prefill_step(cfg, tpl, cache_len=SEQ), (params, batch)
    else:
        fn = steps.make_decode_step(cfg, tpl)
        args = (params, steps.abstract_cache(cfg, BATCH, SEQ), batch)
    return analyze_step(fn, *args, tpl=tpl).flops


@pytest.mark.parametrize("arch,kind", [
    ("qwen2-0.5b", "prefill"), ("qwen2-0.5b", "decode"), ("qwen2-0.5b", "train"),
    ("granite-moe-3b-a800m", "prefill"), ("granite-moe-3b-a800m", "decode"),
    ("mamba2-1.3b", "prefill"), ("mamba2-1.3b", "decode"),
])
def test_reduced_step_flops_equal_the_reference(arch, kind):
    assert _port_flops(arch, kind) == _reference_flops(arch, kind)


def test_reduced_qwen2_flops_are_the_analytic_dot_count():
    """The table of the analyzer's reduced qwen2 counts: projections, dense
    attention over the whole 64 positions (no causal skip) and the tied
    head on the last position; decode the same at one token over the
    64-slot ring; the train step three times the forward with the head
    over every token."""
    cfg = reduced(get_config("qwen2-0.5b"))
    d, ff, L, hd = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.head_dim
    qkv = (cfg.eff_heads + 2 * cfg.n_kv_heads) * hd
    proj = 2 * (d * qkv + cfg.eff_heads * hd * d + 3 * d * ff) * L
    attn = 4 * BATCH * cfg.eff_heads * SEQ * hd * L
    head = 2 * d * cfg.vocab
    assert _port_flops("qwen2-0.5b", "prefill") == \
        BATCH * SEQ * proj + SEQ * attn + BATCH * head == 19_955_712
    assert _port_flops("qwen2-0.5b", "decode") == BATCH * proj + attn + BATCH * head == 344_064
    assert _port_flops("qwen2-0.5b", "train") == \
        3 * (BATCH * SEQ * (proj + head) + SEQ * attn) == 66_060_288


def _ranks_decode_flops(arch: str) -> list:
    """Each recording rank's flops of a decode step on (1, 2) under the
    dry-run's decode rules (``SERVE_RULES``: the ring's sequence over
    "model", wo and down row-parallel), as ``dryrun.analyze_cell`` counts
    a decode cell."""
    cfg = reduced(get_config(arch))
    tpl = _tpl()
    rules = dryrun.rules_for("decode", cfg)
    batch = steps.input_specs(cfg, ShapeSpec("decode", SEQ, BATCH, "decode"))
    out = []
    for rank in range(2):
        rec = Mesh((1, 2), ("data", "model")).recording(rank)
        params = sh.shard_tree(steps.abstract_params(cfg),
                               S.serve_shardings(cfg, rec, rules, full=True))
        cache = S.shard_cache(cfg, steps.abstract_cache(cfg, BATCH, SEQ), rec, rules)
        fns = S.compiled_steps(tpl, cfg, SEQ, mesh=rec, rules=rules)
        out.append(analyze_step(fns.decode, params, batch["token"], batch["t"], cache,
                                tpl=tpl, mesh=rec, rules=rules).flops)
    return out


def test_serve_rules_decode_flops_sum_to_one_device():
    """Reduced qwen2's decode under ``SERVE_RULES`` on (1, 2): each rank
    counts half the matmul-class flops (its heads' columns, its rows of wo
    and down, its half of the ring's slots for every head, its vocab half),
    and the two ranks' counts sum exactly to the single-device count and to
    ``analyze_hlo``'s count of the reference's jitted decode."""
    ranks = _ranks_decode_flops("qwen2-0.5b")
    assert ranks[0] == ranks[1]
    assert sum(ranks) == _port_flops("qwen2-0.5b", "decode") == \
        _reference_flops("qwen2-0.5b", "decode")
