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
import torch

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


#: ConvTileChoice fields only the GPU search fills, and their TPU values
_GPU_ONLY = {"cin_chunk": 0, "route": "", "splits": 1, "sub_rows": 0, "sub_cols": 0}


def _tpu_fields(choice: dict) -> dict:
    """The reference's fields of a port choice; the GPU-only ones must hold
    their TPU values."""
    for name, value in _GPU_ONLY.items():
        assert choice.pop(name) == value, name
    return choice


@pytest.mark.parametrize("in_bytes", [4, 2])
@pytest.mark.parametrize("net", NETS)
def test_tpu_conv_choices_equal_reference(net, in_bytes):
    convs, _, _ = _layers(jcnn.CNN_ZOO[net], 1)
    for geo in convs:
        want = _choice(jdse.default_conv_tile_for(*geo, J_TPU, in_bytes))
        got = _tpu_fields(_choice(tdse.default_conv_tile_for(*geo, TPU_V5E, in_bytes)))
        assert got == want, geo
        # the top-5 ranking, not only the winner
        want5 = [_choice(c) for c in jdse.explore_conv_spatial(*geo, J_TPU, in_bytes)]
        got5 = [_tpu_fields(_choice(c))
                for c in tdse.explore_conv_spatial(*geo, TPU_V5E, in_bytes)]
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
    # a q16 plan does not see the raws' widths: it is legal for every mix,
    # and its shared memory is the most any mix takes
    mixes = ((16, 16), (16, 8), (8, 16), (8, 8)) if backend == "q16" else (None,)
    for cp, (cout, k, stride, pad, pool) in zip(plan.convs, spec.convs):
        assert cp.route == "direct"
        taus = H100.conv_tc_taus if cp.conv_route == "tc" else H100.conv_taus
        assert cp.tau in taus and 1 <= cp.cin_chunk <= ch
        assert cp.vmem_bytes <= H100.smem_per_block
        smem = []
        for widths in mixes:
            geo = conv_launch_geometry(
                (batch, hh, ww, ch), (k, k, ch, cout), stride=stride, padding=pad,
                tau=cp.tau, cin_chunk=cp.cin_chunk, tile_rows=cp.tile_rows,
                tile_cols=cp.tile_cols, halo_mode=cp.halo_mode, conv_route=cp.conv_route,
                sub_rows=cp.sub_rows, sub_cols=cp.sub_cols, splits=cp.splits, widths=widths,
            )
            smem.append(geo.smem_bytes)
        assert max(smem) == cp.vmem_bytes
        hh, ww = geo.ho // (pool or 1), geo.wo // (pool or 1)
        ch = cout
    for gp in plan.fcs:
        if backend == "q16":  # the q16 GEMM streams them on its split-k route too,
            # with one plan for every width mix
            assert gp.block.route == "splitk"
            for xbits, wbits in ((16, 16), (16, 8), (8, 16), (8, 8)):
                assert tdse.q16_block_legal(gp.block, gp.m, gp.n, gp.k, xbits=xbits,
                                            wbits=wbits, spec=H100)
        else:  # the float GEMM streams the FC weights on its split-k route
            assert gp.block.route == "splitk"
            assert tdse.fp_block_legal(gp.block, gp.m, gp.n, gp.k, dtype_bytes=4, spec=H100)


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


# -- the float GEMM's routes (csrc/matmul_fp.cu) ------------------------------

QWEN = dict(d=896, q=1024, kv=128, ff=4864, vocab=151936)


def _qwen_gemms(m):
    """(n, k) of qwen2-0.5b's seven per-layer GEMMs: q, k, v, o, gate, up, down."""
    d, q, kv, ff = QWEN["d"], QWEN["q"], QWEN["kv"], QWEN["ff"]
    return [(q, d), (kv, d), (kv, d), (d, q), (ff, d), (ff, d), (d, ff)]


@pytest.mark.parametrize("net", NETS)
def test_fp_route_cnn_fcs_stream_on_splitk(net):
    """Batch-8 FC layers (f32) take route S, spread over the card."""
    _, gemms, fcs = _layers(tcnn.CNN_ZOO[net], 8)
    for m, n, k in fcs:
        blk = tdse.default_fp_block_for(m, n, k, H100, dtype_bytes=4)
        assert blk.route == "splitk" and blk.bm == 8 and blk.bn == H100.splitk_cols
        assert blk.splits == -(-k // blk.bk) and blk.bk % 64 == 0
        assert blk.bm * blk.bk * 4 <= 32 * 1024  # x's slice fits the reduction's room
        assert tdse.fp_block_legal(blk, m, n, k, dtype_bytes=4, spec=H100)
    # im2col GEMMs (f32, large m) stay on the CUDA-core tile: the q16 choice
    for m, n, k in gemms:
        blk = tdse.default_fp_block_for(m, n, k, H100, dtype_bytes=4)
        assert blk == tdse.default_block_for(m, n, k, H100) and blk.route == "tile"


def test_fp_route_vgg16_fc0_covers_the_card():
    blk = tdse.default_fp_block_for(8, 4096, 25088, H100, dtype_bytes=4)
    assert blk == MatmulBlock(8, 256, 768, route="splitk", splits=33)
    assert (4096 // blk.bn) * blk.splits >= 2 * H100.sms


def test_fp_route_qwen2_prefill_takes_wgmma_decode_takes_splitk():
    for n, k in _qwen_gemms(16384):
        blk = tdse.default_fp_block_for(16384, n, k, H100, dtype_bytes=2)
        assert blk.route == "wgmma" and (blk.bm, blk.bn, blk.bk) in H100.wgmma_tiles
        assert tdse.fp_block_legal(blk, 16384, n, k, dtype_bytes=2, spec=H100)
    # n = 128 (k / v) would waste half a 256-wide tile
    assert tdse.default_fp_block_for(16384, 128, 896, H100, dtype_bytes=2).bn == 128
    assert tdse.default_fp_block_for(16384, 4864, 896, H100, dtype_bytes=2).bn == 256
    for n, k in _qwen_gemms(4):
        blk = tdse.default_fp_block_for(4, n, k, H100, dtype_bytes=2)
        assert blk.route == "splitk" and blk.bm == 4
    down = tdse.default_fp_block_for(4, 896, 4864, H100, dtype_bytes=2)
    assert (-(-896 // down.bn)) * down.splits >= H100.sms


def test_fp_route_tied_head_streams_the_table_in_place():
    """embed.T (the same plan as a row-major w): route S, whole rows, no
    split needed, 594 blocks of 256 columns."""
    for db in (2, 4):
        blk = tdse.default_fp_block_for(4, QWEN["vocab"], QWEN["d"], H100, dtype_bytes=db)
        assert blk == MatmulBlock(4, H100.splitk_cols, 896, route="splitk", splits=1)
        assert tdse.fp_block_legal(blk, 4, QWEN["vocab"], QWEN["d"], dtype_bytes=db, spec=H100)
        assert -(-QWEN["vocab"] // blk.bn) >= 4 * H100.sms
    # the full-sequence head (forward) has large m: the tensor cores, K-major B
    blk = tdse.default_fp_block_for(4096, QWEN["vocab"], QWEN["d"], H100, dtype_bytes=2)
    assert blk.route == "wgmma"


@pytest.mark.parametrize("m,n,k,db,route", [
    (16, 64, 64, 2, "splitk"),      # the split-k bound is inclusive
    (17, 64, 64, 2, "wgmma"),       # bf16 above it: the tensor cores
    (64, 64, 64, 4, "tile"),        # f32 above it: the CUDA-core tile
    (200, 60, 64, 2, "tile"),       # n not a multiple of 8: TMA cannot address it
    (200, 64, 60, 2, "tile"),       # k not a multiple of 8
    (4096, 512, 4608, 4, "tile"),   # f32 never takes the tensor cores (no TF32)
])
def test_fp_route_bounds(m, n, k, db, route):
    blk = tdse.default_fp_block_for(m, n, k, H100, dtype_bytes=db)
    assert blk.route == route
    assert tdse.fp_block_legal(blk, m, n, k, dtype_bytes=db, spec=H100)


def test_fp_routes_leave_q16_and_tpu_choices_unchanged():
    """default_block_for (route "tile"'s search, which the q16 GEMM takes
    when a plan names it) keeps its compiled tiles; under the TPU spec the
    float planner is the reference's block search."""
    for m, n, k in [(8, 4096, 25088), (16384, 4864, 896), (4, 896, 4864), (6272, 512, 4608)]:
        assert tdse.default_block_for(m, n, k, H100).route == "tile"
        assert (tdse.default_fp_block_for(m, n, k, TPU_V5E, dtype_bytes=2)
                == tdse.default_block_for(m, n, k, TPU_V5E))


def test_fp_block_legality_refuses_what_the_kernel_does_not_take():
    wg = MatmulBlock(128, 256, 64, route="wgmma")
    assert not tdse.fp_block_legal(wg, 256, 256, 256, dtype_bytes=4, spec=H100)
    assert not tdse.fp_block_legal(wg, 256, 260, 256, dtype_bytes=2, spec=H100)
    sk = MatmulBlock(4, 256, 128, route="splitk", splits=2)
    assert tdse.fp_block_legal(sk, 4, 300, 256, dtype_bytes=2, spec=H100)
    assert not tdse.fp_block_legal(sk, 5, 300, 256, dtype_bytes=2, spec=H100)
    assert not tdse.fp_block_legal(sk, 4, 300, 300, dtype_bytes=2, spec=H100)
    assert not tdse.fp_block_legal(MatmulBlock(16, 64, 16, route="nope"), 4, 4, 4,
                                   dtype_bytes=4, spec=H100)
    assert tdse.fp_block_legal(MatmulBlock(16, 64, 16), 300, 300, 300, dtype_bytes=2,
                               spec=H100)
    assert not tdse.fp_block_legal(MatmulBlock(128, 64, 64, route="wgmma"), 300, 64, 64,
                                   dtype_bytes=2, spec=H100)


def test_registry_key_separates_the_two_gemm_kernels():
    """One shape planned for the float and the q16 GEMM: two entries, each
    the kernel's own choice, so neither receives the other's tile."""
    reg = PlanRegistry()
    q = reg.block_for(16384, 4864, 896, H100)
    f = reg.block_for(16384, 4864, 896, H100, kernel="matmul_fp", dtype_bytes=2)
    assert q == MatmulBlock(128, 64, 128, route="wgmma")
    assert f == MatmulBlock(128, 256, 64, route="wgmma")
    assert reg.block_for(16384, 4864, 896, H100, kernel="matmul_q16") is q
    # the float plan is keyed by dtype as well
    f2 = reg.block_for(16384, 4864, 896, H100, kernel="matmul_fp", dtype_bytes=2)
    f4 = reg.block_for(16384, 4864, 896, H100, kernel="matmul_fp", dtype_bytes=4)
    assert f2 is f and f4.route == "tile"
    assert reg.block_for(16384, 4864, 896, H100, kernel="matmul_fp", dtype_bytes=2) is f
    assert reg.stats()["gemm_blocks"] == 3 and reg.misses == 3 and reg.hits == 3
    with pytest.raises(ValueError):
        reg.block_for(8, 8, 8, H100, kernel="matmul")


def test_engines_plan_their_own_kernel():
    """A cuda and a q16 engine sharing the H100 registry get different plans
    for one FC shape; a template's block override still wins."""
    from repro_torch.core.engine import reset_plan_caches

    reset_plan_caches()
    fp = default_template("cuda", device="cpu").engine
    q16 = default_template("q16", device="cpu").engine
    assert fp.plan_cache is q16.plan_cache
    assert fp.plan_gemm(8, 4096, 25088).block.route == "splitk"
    assert q16.plan_gemm(8, 4096, 25088).block.route == "splitk"
    assert fp.block_for(16384, 4864, 896, dtype=torch.bfloat16).bn == 256
    assert q16.plan_gemm(16384, 4864, 896).block == MatmulBlock(128, 64, 128, route="wgmma")
    pinned = Template(TemplateConfig(backend="cuda", device="cpu",
                                     block=MatmulBlock(64, 64, 16)))
    assert pinned.engine.plan_gemm(8, 4096, 25088).block == MatmulBlock(64, 64, 16)


# ---------------------------------------------------------------------------
# the float conv's routes: tensor cores (3xTF32) or CUDA cores
# ---------------------------------------------------------------------------

#: convs on route "tc" and on "cudacore" in one float forward of each net
CONV_ROUTE_COUNTS = {"vgg16": (12, 1), "alexnet": (4, 1), "lenet": (0, 2)}


def _plan(net, backend, batch=8):
    t_reset()
    spec = tcnn.CNN_ZOO[net]
    tpl = default_template(backend, device="cpu")
    return spec, tcnn.plan_cnn(tpl, spec, (batch, spec.input_hw, spec.input_hw,
                                           spec.input_ch))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("net", NETS)
def test_conv_routes_of_the_zoo(net, batch):
    """Float: every conv whose Cin and Cout are multiples of 8 on the tensor
    cores, the first layers (Cin 1, 3, 6) on the CUDA cores; fixed point the
    same convs (VGG16 12 of 13, AlexNet 4 of 5, LeNet 0 of 2): every conv
    whose Cin is a multiple of 16 (16 bytes of the narrowest raws, int8) and
    Cout of 8 on the tensor cores, at the τ every width mix takes."""
    tc, cc = CONV_ROUTE_COUNTS[net]
    for backend, chan_mult in (("cuda", 8), ("q16", 16)):
        spec, plan = _plan(net, backend, batch)
        routes = [cp.conv_route for cp in plan.convs]
        assert routes.count("tc") == tc and routes.count("cudacore") == cc, routes
        ch = spec.input_ch
        for cp, (cout, *_rest) in zip(plan.convs, spec.convs):
            legal = ch % chan_mult == 0 and cout % 8 == 0
            assert cp.conv_route == ("tc" if legal else "cudacore")
            if cp.conv_route == "tc" and backend == "q16":
                assert cp.tau == 64 and cp.cin_chunk == tdse.TC_Q16_CHUNK
            ch = cout


@pytest.mark.parametrize("net", ["alexnet", "vgg16"])
def test_q16_tc_plans_take_every_width_mix(net):
    """A fixed-point plan does not see the raws' widths, so its "tc" choice
    is one every mix takes: τ 64 (int16 x int16 keeps three accumulators),
    the 64-channel chunk, the most shared memory any mix takes, a sub-tile whose
    window fits TMA's box, and a Cin split of the 64-channel chunks."""
    spec, plan = _plan(net, "q16")
    hh, ch = spec.input_hw, spec.input_ch
    for cp, (cout, k, stride, pad, pool) in zip(plan.convs, spec.convs):
        ho = (hh + 2 * pad - k) // stride + 1
        if cp.conv_route == "tc":
            assert (cp.tau, cp.cin_chunk) == (tdse.TC_Q16_TAU, tdse.TC_Q16_CHUNK) == (64, 64)
            assert cp.vmem_bytes == max(
                tdse.gpu_conv_q16_tc_smem(k, k, stride, 64, cp.sub_rows, cp.sub_cols, xb, wb)
                for xb in (1, 2) for wb in (1, 2))
            assert cp.vmem_bytes <= H100.smem_per_block
            assert max((cp.sub_rows - 1) * stride + k, (cp.sub_cols - 1) * stride + k) \
                <= tdse.TC_MAX_BOX
            blocks = tdse.gpu_conv_tc_blocks(8, ho, ho, cout, 64, cp.sub_rows, cp.sub_cols)
            assert cp.splits == tdse.gpu_conv_tc_splits(blocks, ch, H100, tdse.TC_Q16_CHUNK)
        hh, ch = ho // (pool or 1), cout
    # τ 64 whatever Cout, where the float route would take 128
    assert all(tdse.gpu_conv_tc_tau(c, H100, b) == 64 for c in (128, 384) for b in (1, 2))
    assert tdse.gpu_conv_tc_tau(384, H100, 4) == 128


def test_q16_tc_legality_is_cin_bytes():
    """Route "tc" takes fixed point where Cin·bytes is a multiple of 16 and
    Cout of 8; the planner, blind to the widths, takes a conv only where
    int8 raws qualify too (Cin a multiple of 16), so an int16 Cin of 8 is
    legal for the launch and planned on the CUDA cores."""
    assert tdse.gpu_conv_tc_legal(8, 16, 2) and not tdse.gpu_conv_tc_legal(8, 16, 1)
    assert tdse.gpu_conv_tc_legal(16, 16, 1) and not tdse.gpu_conv_tc_legal(16, 12, 2)
    assert not tdse.gpu_conv_tc_legal(12, 16, 2) and tdse.gpu_conv_tc_legal(8, 16, 4)
    t_reset()
    q16 = default_template("q16", device="cpu").engine
    assert q16.plan_conv((1, 16, 16, 8), (3, 3, 8, 16), padding=1).conv_route == "cudacore"
    assert q16.plan_conv((1, 16, 16, 16), (3, 3, 16, 16), padding=1).conv_route == "tc"
    fp = default_template("cuda", device="cpu").engine
    assert fp.plan_conv((1, 16, 16, 8), (3, 3, 8, 16), padding=1).conv_route == "tc"


@pytest.mark.parametrize("net", ["alexnet", "vgg16"])
def test_tc_plans_fit_shared_memory_and_the_box(net):
    spec, plan = _plan(net, "cuda")
    hh = spec.input_hw
    for cp, (cout, k, stride, pad, pool) in zip(plan.convs, spec.convs):
        ho = (hh + 2 * pad - k) // stride + 1
        if cp.conv_route == "tc":
            assert cp.tau in H100.conv_tc_taus and cp.cin_chunk == tdse.TC_CHUNK
            assert cp.sub_rows * cp.sub_cols <= tdse.TC_PIXELS
            assert max((cp.sub_rows - 1) * stride + k, (cp.sub_cols - 1) * stride + k) \
                <= tdse.TC_MAX_BOX
            assert cp.vmem_bytes == tdse.gpu_conv_tc_smem(k, k, stride, cp.tau, cp.sub_rows,
                                                          cp.sub_cols)
            assert cp.vmem_bytes <= H100.smem_per_block
        hh = ho // (pool or 1)


def test_vgg16_14x14_layers_fill_the_card():
    """VGG16's 14² layers (8·196 pixels x 512 channels) have 64 blocks of
    128 pixels x 128 channels; their Cin is split so the grid covers the
    SMs in one wave, and the other layers' grids are not split."""
    spec, plan = _plan("vgg16", "cuda")
    for i, cp in enumerate(plan.convs):
        if cp.conv_route != "tc":
            continue
        n_pix = cp.gemm[0] // 8
        ho = int(round(n_pix ** 0.5))
        blocks = tdse.gpu_conv_tc_blocks(8, ho, ho, cp.gemm[1], cp.tau, cp.sub_rows,
                                         cp.sub_cols)
        if ho == 14:
            assert blocks < H100.sms and cp.splits > 1
            assert blocks * cp.splits >= 0.9 * H100.sms, (i, blocks, cp.splits)
            assert blocks * cp.splits <= H100.sms  # one wave
        else:
            assert blocks >= H100.sms and cp.splits == 1, (i, blocks, cp.splits)


def test_tc_split_never_leaves_a_split_empty():
    for blocks in (1, 8, 16, 24, 64, 72, 131):
        for cin in (8, 32, 40, 64, 192, 384, 512):
            s = tdse.gpu_conv_tc_splits(blocks, cin, H100)
            chunks = -(-cin // tdse.TC_CHUNK)
            assert 1 <= s <= chunks and (s - 1) * -(-chunks // s) < chunks
    assert tdse.gpu_conv_tc_splits(H100.sms, 512, H100) == 1


def test_tc_route_refusals_raise_before_the_cpu_branch():
    """A launch route "tc" does not take raises on CPU tensors too (the
    checks run before the plain version), so nothing moves to the other
    route silently."""
    from repro_torch.kernels.conv2d import conv2d_cuda

    def call(cin=16, cout=16, **kw):
        x, w = torch.zeros(1, 8, 8, cin), torch.zeros(3, 3, cin, cout)
        return conv2d_cuda(x, w, padding=1, conv_route="tc", **kw)

    assert call().shape == (1, 8, 8, 16)
    for bad in (dict(cin=3), dict(cin=12), dict(cout=6), dict(tau=256), dict(tau=32),
                dict(cin_chunk=16), dict(splits=2), dict(sub_rows=16, sub_cols=16),
                dict(cin=64, splits=3)):
        with pytest.raises(ValueError):
            call(**bad)
    with pytest.raises(ValueError):
        conv2d_cuda(torch.zeros(1, 8, 8, 16), torch.zeros(3, 3, 16, 16), conv_route="wgmma")
    # the two-block regime keeps its legality rule on either route
    with pytest.raises(ValueError, match="too small"):
        call(tile_rows=1, halo_mode="two_block")


def test_tc_subtile_covers_the_zoo_widths():
    """Sub-tiles of at most 128 pixels: exact on VGG16's 224 / 112 widths,
    one output row group per sub-tile at 28 and 14, AlexNet's 18² in 3."""
    assert tdse.gpu_conv_tc_subtile(224, 224, 3, 3, 1, 64, H100) == (8, 16)
    assert tdse.gpu_conv_tc_subtile(112, 112, 3, 3, 1, 128, H100) == (8, 16)
    th, tw = tdse.gpu_conv_tc_subtile(28, 28, 3, 3, 1, 128, H100)
    assert -(-28 // th) * -(-28 // tw) == 7
    th, tw = tdse.gpu_conv_tc_subtile(14, 14, 3, 3, 1, 128, H100)
    assert -(-14 // th) * -(-14 // tw) == 2
    th, tw = tdse.gpu_conv_tc_subtile(18, 18, 5, 5, 1, 64, H100)
    assert -(-18 // th) * -(-18 // tw) == 3 and th * tw <= 128


#: (x shape, w shape, stride, pad) of convs whose 128-pixel sub-tiles all miss
#: shared memory or TMA's box: a ResNet-style 3x3 stride-2 downsampling and
#: an 11x11 stride-1 conv
_SHORT_SUBTILE_CONVS = [
    ((8, 112, 112, 64), (3, 3, 64, 128), 2, 1),
    ((2, 56, 56, 64), (11, 11, 64, 256), 1, 5),
]


@pytest.mark.parametrize("x_shape,w_shape,stride,pad", _SHORT_SUBTILE_CONVS)
def test_tc_plans_a_shorter_subtile_when_128_pixels_miss(x_shape, w_shape, stride, pad):
    """The planner and the engine plan such convs on route "tc" with a
    sub-tile of fewer than 128 pixels that fits, and the launch geometry
    takes that plan."""
    kh, kw, cin, cout = w_shape
    ho = (x_shape[1] + 2 * pad - kh) // stride + 1
    tau = tdse.gpu_conv_tc_tau(cout, H100)
    for tw in {min(w, ho) for w in tdse._TC_WIDTHS}:
        th = min(tdse.TC_PIXELS // tw, ho)
        assert (max((th - 1) * stride + kh, (tw - 1) * stride + kw) > tdse.TC_MAX_BOX
                or tdse.gpu_conv_tc_smem(kh, kw, stride, tau, th, tw) > H100.smem_per_block)
    t_reset()
    cp = default_template("cuda", device="cpu").engine.plan_conv(
        x_shape, w_shape, stride=stride, padding=pad)
    assert cp.route == "direct" and cp.conv_route == "tc"
    assert cp.sub_rows * cp.sub_cols < tdse.TC_PIXELS
    assert max((cp.sub_rows - 1) * stride + kh, (cp.sub_cols - 1) * stride + kw) \
        <= tdse.TC_MAX_BOX
    assert cp.vmem_bytes == tdse.gpu_conv_tc_smem(kh, kw, stride, cp.tau, cp.sub_rows,
                                                  cp.sub_cols)
    assert cp.vmem_bytes <= H100.smem_per_block
    geo = conv_launch_geometry(x_shape, w_shape, stride=stride, padding=pad, tau=cp.tau,
                               cin_chunk=cp.cin_chunk, tile_rows=0, tile_cols=0,
                               halo_mode="none", conv_route="tc", splits=cp.splits)
    assert geo.geom[16:] == (cp.sub_rows, cp.sub_cols)


def test_conv_no_tc_subtile_fits_plans_cudacore():
    """A conv whose every tensor-core window misses the limits (23x23 taps
    on 8 output columns) is planned on the CUDA cores from its shape; the
    tensor-core route forced on it raises."""
    from repro_torch.kernels.conv2d import conv2d_cuda

    x_shape, w_shape = (1, 30, 30, 16), (23, 23, 16, 16)
    assert tdse.gpu_conv_tc_subtile(8, 8, 23, 23, 1, 64, H100) is None
    t_reset()
    cp = default_template("cuda", device="cpu").engine.plan_conv(x_shape, w_shape)
    assert cp.route == "direct" and cp.conv_route == "cudacore"
    with pytest.raises(ValueError, match="no tensor-core conv sub-tile fits"):
        conv2d_cuda(torch.zeros(x_shape), torch.zeros(w_shape), conv_route="tc", tau=64)


# ---------------------------------------------------------------------------
# flash attention's routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("d,route", [(16, "simt"), (32, "simt"), (64, "wgmma"),
                                     (128, "wgmma")])
def test_flash_plan_route_by_head_dim(d, route, dtype_bytes):
    """The models' head dims (qwen2 64; internlm2, mistral-nemo, qwen2.5 128)
    on the tensor cores, the reduced configs' (16, 32) on the CUDA cores;
    each plan's shared memory inside the 227 KB a block may take."""
    plan = tdse.plan_flash(d, dtype_bytes, H100)
    assert plan.route == route
    assert plan.smem == tdse.gpu_flash_smem(route, d, dtype_bytes)
    assert plan.smem <= H100.smem_per_block == 232_448
    assert plan.bk == {16: 64, 32: 64, 64: 128, 128: 64}[d]


def test_flash_wgmma_smem_is_the_headers_layout():
    """Q hi+lo and two stages of K and V hi+lo in bf16: 160 KB at D 64 with
    128-key tiles, 192 KB at D 128 with 64-key tiles (plus 1024 bytes of
    alignment slack and five barriers); one plane for bf16."""
    assert tdse.plan_flash(64, 4, H100).smem == 160 * 1024 + 1024 + 40
    assert tdse.plan_flash(128, 4, H100).smem == 192 * 1024 + 1024 + 40
    assert tdse.plan_flash(64, 2, H100).smem == 80 * 1024 + 1024 + 40


def test_flash_plan_refuses_what_no_route_takes():
    for d in (8, 24, 48, 96, 256):
        with pytest.raises(ValueError, match="head dims"):
            tdse.plan_flash(d, 4, H100)
    with pytest.raises(ValueError):
        tdse.plan_flash(64, 1, H100)
    with pytest.raises(TypeError):
        tdse.plan_flash(64, 4, TPU_V5E)


def test_flash_planner_leaves_tpu_plans_unchanged():
    """Adding flash's routes to the GPU spec changes no TPU plan: the GEMM
    blocks of the qwen2-0.5b prefill and decode shapes are still the
    reference's."""
    shapes = [(m, n, k) for m in (4, 16384) for n, k in _qwen_gemms(m)]
    for m, n, k in shapes:
        want = jdse.default_block_for(m, n, k, J_TPU)
        got = tdse.default_block_for(m, n, k, TPU_V5E)
        assert (got.bm, got.bn, got.bk) == (want.bm, want.bn, want.bk)
        assert tdse.default_fp_block_for(m, n, k, TPU_V5E, dtype_bytes=2) == got


Q16_MIXES = [(16, 16), (16, 8), (8, 16), (8, 8)]


@pytest.mark.parametrize("xbits,wbits", Q16_MIXES)
@pytest.mark.parametrize("m,n,k", [
    (1, 4096, 25088), (8, 4096, 25088), (16, 33, 130), (4, 151936, 896),
    (17, 4864, 896), (16384, 4864, 896), (6272, 512, 4608), (40, 3, 5), (300, 1001, 77),
])
def test_q16_route_bounds(m, n, k, xbits, wbits):
    """The q16 planner: m <= 16 streams w on route "splitk" (one plan for
    every width mix), every larger m takes route "wgmma" at any k and n,
    BN 64 for int16 x int16 (three s32 accumulators); each plan is legal
    for its widths and the 16 x 16 plan for every mix."""
    blk = tdse.default_q16_block_for(m, n, k, H100, xbits=xbits, wbits=wbits)
    assert blk.route == ("splitk" if m <= 16 else "wgmma")
    assert tdse.q16_block_legal(blk, m, n, k, xbits=xbits, wbits=wbits, spec=H100)
    if blk.route == "splitk":
        assert blk == tdse.default_q16_block_for(m, n, k, H100)
    elif (xbits, wbits) == (16, 16):
        assert (blk.bm, blk.bn, blk.bk) == (128, 64, 128)
    wide = tdse.default_q16_block_for(m, n, k, H100)
    for xb, wb in Q16_MIXES:
        assert tdse.q16_block_legal(wide, m, n, k, xbits=xb, wbits=wb, spec=H100)


def test_q16_block_legality_refuses_what_the_kernel_does_not_take():
    wg128 = MatmulBlock(128, 128, 128, route="wgmma")
    assert not tdse.q16_block_legal(wg128, 300, 300, 300, xbits=16, wbits=16, spec=H100)
    assert tdse.q16_block_legal(wg128, 300, 300, 300, xbits=16, wbits=8, spec=H100)
    assert not tdse.q16_block_legal(MatmulBlock(128, 64, 64, route="wgmma"), 300, 300, 300,
                                    xbits=8, wbits=8, spec=H100)
    assert not tdse.q16_block_legal(MatmulBlock(128, 64, 128, route="wgmma", splits=2), 300,
                                    300, 300, xbits=8, wbits=8, spec=H100)
    sk = MatmulBlock(4, 256, 128, route="splitk", splits=2)
    assert tdse.q16_block_legal(sk, 4, 300, 256, xbits=16, wbits=16, spec=H100)
    assert not tdse.q16_block_legal(sk, 5, 300, 256, xbits=16, wbits=16, spec=H100)
    assert tdse.q16_block_legal(MatmulBlock(16, 64, 16), 300, 300, 300, xbits=16, wbits=16,
                                spec=H100)
    assert not tdse.q16_block_legal(MatmulBlock(32, 32, 32), 300, 300, 300, xbits=16,
                                    wbits=16, spec=H100)
    with pytest.raises(ValueError):
        tdse.q16_limb_products(32, 16)
    assert [tdse.q16_limb_products(*mix) for mix in Q16_MIXES] == [4, 2, 2, 1]


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("net", NETS)
def test_q16_planner_leaves_tpu_plans_unchanged(net, batch):
    """Under TPU_V5E the q16 planner is the reference's block search, for
    every width mix, over the zoo's and qwen2's GEMM shapes."""
    _, gemms, fcs = _layers(jcnn.CNN_ZOO[net], batch)
    shapes = gemms + fcs + [(m, n, k) for m in (4, 16384) for n, k in _qwen_gemms(m)]
    for m, n, k in shapes:
        want = jdse.default_block_for(m, n, k, J_TPU)
        for xbits, wbits in Q16_MIXES:
            got = tdse.default_q16_block_for(m, n, k, TPU_V5E, xbits=xbits, wbits=wbits)
            assert (got.bm, got.bn, got.bk, got.route) == (want.bm, want.bn, want.bk, "tile")
