"""The port's planner: reference parity under TPU_V5E, kernel legality under H100.

Under the reference's TPU spec the port's search must return exactly the
reference's choices — GEMM blocks and (τ, 𝒯, ℭ, halo_mode) conv configs —
over every conv and FC shape of the zoo at batches 1 and 8, and its engine
must build the same network plans.  Under the H100 spec every plan of the
zoo must be one the CUDA kernels take: a compiled GEMM tile, a τ the conv
kernel supports, and a shared-memory footprint under a block's limit.
"""
import dataclasses

import pytest

from repro.core import dse as jdse
from repro.core.engine import reset_plan_caches as j_reset
from repro.core.template import default_template as j_template
from repro.core.tiling import TPU_V5E as J_TPU
from repro.models import cnn as jcnn
from repro_torch.core import dse as tdse
from repro_torch.core.engine import PlanRegistry
from repro_torch.core.template import TemplateConfig, Template, default_template
from repro_torch.core.tiling import H100, TPU_V5E, MatmulBlock
from repro_torch.kernels.conv2d import conv_launch_geometry
from repro_torch.models import cnn as tcnn
from repro_torch.models.cnn import reset_plans as t_reset

NETS = ["lenet", "alexnet", "vgg16"]


def _layers(spec, batch):
    """(conv geometries, im2col GEMM shapes, FC GEMM shapes) of one net."""
    convs, gemms, fcs = [], [], []
    hh = ww = spec.input_hw
    ch = spec.input_ch
    for cout, k, stride, pad, pool in spec.convs:
        hp, wp = hh + 2 * pad, ww + 2 * pad
        ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
        convs.append((hp, wp, ch, k, k, ho, wo, cout, stride))
        gemms.append((batch * ho * wo, cout, ch * k * k))
        hh, ww = ho, wo
        if pool:
            hh //= pool
            ww //= pool
        ch = cout
    fan = hh * ww * ch
    for wd in (*spec.fcs, spec.n_classes):
        fcs.append((batch, wd, fan))
        fan = wd
    return convs, gemms, fcs


def _choice(c):
    return None if c is None else dataclasses.asdict(c)


@pytest.mark.parametrize("in_bytes", [4, 2])
@pytest.mark.parametrize("net", NETS)
def test_tpu_conv_choices_equal_reference(net, in_bytes):
    convs, _, _ = _layers(jcnn.CNN_ZOO[net], 1)
    for geo in convs:
        want = _choice(jdse.default_conv_tile_for(*geo, J_TPU, in_bytes))
        got = _choice(tdse.default_conv_tile_for(*geo, TPU_V5E, in_bytes))
        assert got.pop("cin_chunk") == 0
        assert got == want, geo
        # the top-5 ranking, not only the winner
        want5 = [_choice(c) for c in jdse.explore_conv_spatial(*geo, J_TPU, in_bytes)]
        got5 = [_choice(c) for c in tdse.explore_conv_spatial(*geo, TPU_V5E, in_bytes)]
        for g in got5:
            g.pop("cin_chunk")
        assert got5 == want5, geo


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("net", NETS)
def test_tpu_gemm_blocks_equal_reference(net, batch):
    _, gemms, fcs = _layers(jcnn.CNN_ZOO[net], batch)
    for m, n, k in gemms + fcs:
        want = jdse.default_block_for(m, n, k, J_TPU)
        got = tdse.default_block_for(m, n, k, TPU_V5E)
        assert (got.bm, got.bn, got.bk) == (want.bm, want.bn, want.bk), (m, n, k)
        wr = [(b.bm, b.bn, b.bk, s) for b, s in jdse.explore_tpu_block(m, n, k, J_TPU)]
        gr = [(b.bm, b.bn, b.bk, s) for b, s in tdse.explore_tpu_block(m, n, k, TPU_V5E)]
        assert gr == wr


def test_tpu_vmem_and_traffic_models_equal_reference():
    for mode, tr, tc in [("none", 0, 0), ("two_block", 8, 0), ("dma", 16, 32)]:
        args = (226, 226, 64, 3, 3, 224, 224)
        assert tdse.direct_conv_vmem(*args, 64, 4, stride=1, tile_rows=tr,
                                     tile_cols=tc, halo_mode=mode) == \
            jdse.direct_conv_vmem(*args, 64, 4, stride=1, tile_rows=tr,
                                  tile_cols=tc, halo_mode=mode)
        for fn in ("direct_conv_hbm_traffic", "direct_conv_input_traffic"):
            assert getattr(tdse, fn)(*args, 64, 1, 64, 4, tile_rows=tr, tile_cols=tc,
                                     halo_mode=mode) == \
                getattr(jdse, fn)(*args, 64, 1, 64, 4, tile_rows=tr, tile_cols=tc,
                                  halo_mode=mode)


@pytest.mark.parametrize("backend", ["cuda", "q16"])
@pytest.mark.parametrize("net", NETS)
def test_tpu_network_plans_equal_reference(net, backend):
    """The port's engine, fed the reference's spec, builds the reference's
    plan for every layer (routes, τ, tiles, regimes, GEMM blocks)."""
    j_reset()
    t_reset()
    jb = {"cuda": "pallas", "q16": "q16"}[backend]
    spec_j, spec_t = jcnn.CNN_ZOO[net], tcnn.CNN_ZOO[net]
    shape = (8, spec_j.input_hw, spec_j.input_hw, spec_j.input_ch)
    want = jcnn.plan_cnn(j_template(jb), spec_j, shape)
    got = tcnn.plan_cnn(Template(TemplateConfig(backend=backend, hw=TPU_V5E,
                                                device="cpu")), spec_t, shape)
    for jp, tp in zip(want.convs, got.convs):
        for f in ("route", "stride", "pad", "tau", "gemm", "vmem_bytes",
                  "tile_rows", "spatial_tiles", "tile_cols", "col_tiles",
                  "halo_mode"):
            assert getattr(tp, f) == getattr(jp, f), (f, jp, tp)
    for jp, tp in zip(want.fcs, got.fcs):
        assert (tp.m, tp.n, tp.k) == (jp.m, jp.n, jp.k)
        assert (tp.block.bm, tp.block.bn, tp.block.bk) == (
            jp.block.bm, jp.block.bn, jp.block.bk)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("backend", ["cuda", "q16"])
@pytest.mark.parametrize("net", NETS)
def test_h100_plans_are_legal_for_the_kernels(net, backend, batch):
    t_reset()
    spec = tcnn.CNN_ZOO[net]
    tpl = default_template(backend, device="cpu")
    shape = (batch, spec.input_hw, spec.input_hw, spec.input_ch)
    plan = tcnn.plan_cnn(tpl, spec, shape)
    hh = ww = spec.input_hw
    ch = spec.input_ch
    for cp, (cout, k, stride, pad, pool) in zip(plan.convs, spec.convs):
        assert cp.route == "direct"
        assert cp.tau in H100.conv_taus and 1 <= cp.cin_chunk <= ch
        assert cp.vmem_bytes <= H100.smem_per_block
        geo = conv_launch_geometry(
            (batch, hh, ww, ch), (k, k, ch, cout), stride=stride, padding=pad,
            tau=cp.tau, cin_chunk=cp.cin_chunk, tile_rows=cp.tile_rows,
            tile_cols=cp.tile_cols, halo_mode=cp.halo_mode,
        )
        assert geo.smem_bytes == cp.vmem_bytes
        hh, ww = geo.ho // (pool or 1), geo.wo // (pool or 1)
        ch = cout
    for gp in plan.fcs:
        assert (gp.block.bm, gp.block.bn, gp.block.bk) in H100.gemm_tiles
        assert gp.block.smem_bytes() <= H100.smem_per_block


def test_h100_conv_search_prefers_real_channels_and_fits_smem():
    # LeNet conv0 (Cout 6) may only take the smallest τ
    ranked = tdse.explore_conv_spatial(32, 32, 1, 5, 5, 28, 28, 6, 1, H100)
    assert {c.tau for c in ranked} == {8}
    # AlexNet conv0 (k11, s4, Cin 3): the whole Cin fits one chunk
    best = tdse.default_conv_tile_for(228, 228, 3, 11, 11, 55, 55, 64, 4, H100)
    assert best.cin_chunk == 3 and best.vmem_bytes <= H100.smem_per_block
    for tau in H100.conv_taus:
        c = tdse.gpu_conv_max_chunk(3, 3, 1, tau, 512, H100.smem_per_block)
        assert 1 <= c <= 32
        assert tdse.gpu_conv_smem(3, 3, 1, tau, c) <= H100.smem_per_block


def test_h100_gemm_picks_small_tile_for_batch8_fc():
    assert tdse.default_block_for(8, 4096, 25088, H100) == MatmulBlock(16, 64, 16)
    assert tdse.default_block_for(401408, 64, 576, H100).bm >= 64
    with pytest.raises(ValueError):
        tdse.default_block_for(8, 8, 8, dataclasses.replace(H100, gemm_tiles=()))


def test_registry_memoizes_each_shape_once():
    reg = PlanRegistry()
    for _ in range(3):
        reg.block_for(8, 4096, 25088, H100)
        reg.conv_tile_for(226, 226, 64, 3, 3, 224, 224, 64, 1, 4, H100)
    assert reg.stats() == {"gemm_blocks": 1, "conv_tiles": 1, "hits": 4, "misses": 2}
    with reg.scope() as d:
        reg.block_for(8, 4096, 25088, H100)
        reg.block_for(8, 1000, 4096, H100)
    assert d == {"hits": 1, "misses": 1}
    reg.clear()
    assert len(reg) == 0 and reg.misses == 0


def test_plan_cnn_is_memoized_and_warm_plans_nothing():
    t_reset()
    tpl = default_template("cuda", device="cpu")
    reg = tpl.engine.plan_cache
    shape = (8, 224, 224, 3)
    p1 = tcnn.plan_cnn(tpl, tcnn.VGG16, shape)
    cold = reg.misses
    assert cold > 0
    with reg.scope() as d:
        p2 = tcnn.plan_cnn(tpl, tcnn.VGG16, shape)
    assert p2 is p1 and d == {"hits": 0, "misses": 0}
    lines = p1.describe()
    assert len(lines) == 16 and lines[0].startswith("conv0: route=direct")
    forced = tcnn.plan_cnn(tpl, tcnn.LENET, (2, 32, 32, 1), force_route="im2col")
    assert all(cp.route == "im2col" and cp.block is not None for cp in forced.convs)


def test_sharded_plans_are_not_ported():
    tpl = default_template("cuda", device="cpu")
    with pytest.raises(NotImplementedError):
        tcnn.plan_cnn(tpl, tcnn.LENET, (2, 32, 32, 1), spatial=2)
    with pytest.raises(NotImplementedError):
        tpl.engine.plan_gemm(8, 8, 8, mesh=object())
