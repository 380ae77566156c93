"""The paper's case-study networks (AlexNet / VGG16 / LeNet) on the unified
compute unit, in the port.

Conv and FC layers run on the template's compute unit (the CUDA direct conv
/ im2col GEMM / fixed point), with bias and ReLU fused into the write-back;
pooling and flatten are plain tensor ops.  :func:`plan_cnn` compiles the
network's routes and tiles once per (template config, spec, input shape),
and every :func:`cnn_forward` reuses that plan.

Layouts are the reference's at every public function: NHWC activations,
(K, K, Cin, Cout) conv weights, (k, n) FC weights, and the conv -> FC
flatten is ``h.reshape(N, -1)`` over NHWC, in (H, W, C) order — so weights
carried over from the JAX package multiply the same features.

:func:`calibrate_cnn_precision` is the drift-aware per-layer precision DSE:
it measures each layer's solo-flip drift onto the int8 rung, picks the
plan (``core/dse.py:choose_precision``), and pins it in the plan registry,
from which a second call rebuilds it with no forward.

``plan_cnn(spatial=)`` shards the feature maps by H slabs across shards
(a shard count: the slab-major simulation on one device; a mesh axis name:
one slab per rank of that axis, under ``use_mesh``): every conv and pool
exchanges only its halo rows with the neighbour slabs, and the conv -> FC
flatten gathers the slabs.  ``plan_cnn(mesh=)`` plans each layer's local
shape under a batch / Cout partition.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import dse
from repro_torch.core.engine import reset_plan_caches, validate_policy
from repro_torch.core.quantization import (
    NumericsPolicy,
    Q2_14,
    QFormat,
    QTensor,
    fake_quant_fmt,
    int8_rung,
)
from repro_torch.core.template import Template
from repro_torch.parallel import sharding as sh

__all__ = [
    "CNNSpec",
    "ALEXNET",
    "VGG16",
    "LENET",
    "CNN_ZOO",
    "NetworkPlan",
    "init_cnn",
    "fit_cnn_activations",
    "plan_cnn",
    "reset_plans",
    "cnn_layer_names",
    "quantize_cnn_params",
    "calibrate_cnn_policy",
    "calibrate_cnn_precision",
    "cnn_forward",
]


@dataclasses.dataclass(frozen=True)
class CNNSpec:
    name: str
    input_hw: int
    input_ch: int
    n_classes: int
    # conv stages: (out_ch, k, stride, pad, pool) — pool is the maxpool window (0 = none)
    convs: tuple
    # fc widths (excluding the final classifier)
    fcs: tuple


ALEXNET = CNNSpec(
    "alexnet", 224, 3, 1000,
    convs=(
        (64, 11, 4, 2, 3),
        (192, 5, 1, 2, 3),
        (384, 3, 1, 1, 0),
        (256, 3, 1, 1, 0),
        (256, 3, 1, 1, 3),
    ),
    fcs=(4096, 4096),
)

VGG16 = CNNSpec(
    "vgg16", 224, 3, 1000,
    convs=(
        (64, 3, 1, 1, 0), (64, 3, 1, 1, 2),
        (128, 3, 1, 1, 0), (128, 3, 1, 1, 2),
        (256, 3, 1, 1, 0), (256, 3, 1, 1, 0), (256, 3, 1, 1, 2),
        (512, 3, 1, 1, 0), (512, 3, 1, 1, 0), (512, 3, 1, 1, 2),
        (512, 3, 1, 1, 0), (512, 3, 1, 1, 0), (512, 3, 1, 1, 2),
    ),
    fcs=(4096, 4096),
)

LENET = CNNSpec(
    "lenet", 32, 1, 10,
    convs=((6, 5, 1, 0, 2), (16, 5, 1, 0, 2)),
    fcs=(120, 84),
)

CNN_ZOO = {c.name: c for c in (ALEXNET, VGG16, LENET)}


def _maxpool(x, w: int):
    """NHWC max pool, window w, stride w, VALID.

    Crops to whole windows, then reshapes and takes ``amax``: exact for every
    dtype, the int16 and int8 raws of a QTensor included (dequantization is
    monotone, so max-of-raw == raw-of-max and pooling stays on the grid).
    ``F.max_pool2d`` is not relied on for integer tensors on CUDA.
    """
    if isinstance(x, QTensor):
        return QTensor(_maxpool(x.raw, w), x.fmt)
    n, h, wd, c = x.shape
    ho, wo = h // w, wd // w
    v = x[:, :ho * w, :wo * w, :].reshape(n, ho, w, wo, w, c)
    return v.amax(dim=(2, 4))


# -- spatial (H-slab) sharding helpers ----------------------------------------


def _on_raw(x, f):
    """Apply ``f`` to a float tensor or to a QTensor's raws (layout ops are
    grid-transparent)."""
    return QTensor(f(x.raw), x.fmt) if isinstance(x, QTensor) else f(x)


def _to_slabs(x, shards: int, axis: Optional[str] = None):
    """NHWC -> slab-major (S, N, lx, W, C) with ``lx = ceil(H / S)`` and a
    zero tail (buffer row ``r`` of slab ``s`` holds global row ``s·lx + r``,
    zero beyond H).  On a mesh axis this rank keeps its own slab, (1, N,
    lx, W, C)."""

    def f(v):
        n, h, w, c = v.shape
        lx = -(-h // shards)
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, shards * lx - h))
        slabs = vp.reshape(n, shards, lx, w, c).movedim(1, 0)
        mesh = sh.mesh_over(axis)
        if mesh is not None:
            i = mesh.coords[axis]
            slabs = slabs[i:i + 1]
        return slabs.contiguous()

    return _on_raw(x, f)


def _gather_slabs(x, h: int, axis: Optional[str] = None):
    """Slab-major (S, N, l, W, C) -> NHWC (N, h, W, C): the conv -> FC
    flatten seam (on a mesh axis, an all-gather of the ranks' slabs first).
    Correct for a ragged tail shard by the slab invariant: the buffer rows
    past the global extent are zeros and land past row ``h``."""

    def f(v):
        if sh.mesh_over(axis) is not None:
            v = sh.gather(v, 0, axis)
        s, n, l = v.shape[0], v.shape[1], v.shape[2]
        return v.movedim(0, 1).reshape(n, s * l, *v.shape[3:])[:, :h].contiguous()

    return _on_raw(x, f)


def _maxpool_spatial(x, w: int, ph):
    """Spatially-sharded max pool: a halo op with ``kh = stride = w``,
    ``pad = 0``: exchange the (up, dn) rows the seam needs, pool each
    shard's window, and re-zero the ragged tail rows."""

    def f(v):
        v = sh.constrain_slabs(v, ph.axis)
        ext = sh.halo_exchange(v, ph)  # (S, N, win, W, C)
        s, n = ext.shape[0], ext.shape[1]
        out = _maxpool(ext.reshape(s * n, *ext.shape[2:]), w)
        out = out.reshape(s, n, *out.shape[1:])
        return sh.constrain_slabs(sh.mask_slab_rows(out, ph), ph.axis)

    return _on_raw(x, f)


def init_cnn(gen: torch.Generator, spec: CNNSpec, dtype=torch.float32,
             scale: float = 0.5, device="cpu"):
    """He-style init, scaled into the Q2.14 representable range [-2, 2).

    Draws from ``gen`` on the CPU (the same numbers whatever the device),
    then moves the tree to ``device``.
    """
    params = {"convs": [], "fcs": []}
    ch = spec.input_ch
    hw = spec.input_hw

    def leaf(shape, fan):
        w = torch.randn(shape, generator=gen) * (scale * fan ** -0.5)
        return {"w": w.to(device=device, dtype=dtype),
                "b": torch.zeros(shape[-1], device=device, dtype=dtype)}

    for (cout, k, stride, pad, pool) in spec.convs:
        params["convs"].append(leaf((k, k, ch, cout), k * k * ch))
        hw = (hw + 2 * pad - k) // stride + 1
        if pool:
            hw //= pool
        ch = cout
    fan = hw * hw * ch
    for wd in (*spec.fcs, spec.n_classes):
        params["fcs"].append(leaf((fan, wd), fan))
        fan = wd
    return params


def fit_cnn_activations(tpl: Template, spec: CNNSpec, params, x: torch.Tensor,
                        limit: float = 0.5):
    """Rescale each hidden layer of a random net onto the activation grid.

    The grid-resident forward quantizes once, so :func:`calibrate_cnn_policy`
    sees only the input, and a random net's hidden activations (He scale
    keeps them near the input's size, with longer tails) would saturate the
    grid that the input picked.  In forward order, this scales each hidden
    conv / FC layer's weight and bias by ``limit / max|y|``, where ``y`` is
    its float output (ReLU applied) on ``x``: ReLU is positively
    homogeneous, so the layer's output on ``x`` then peaks at exactly
    ``limit``.  The classifier, read out wide, keeps its scale.  Returns a
    new tree.
    """
    h = x
    nc, last = len(spec.convs), len(spec.fcs)
    out = {"convs": [], "fcs": []}
    for i, p in enumerate(params["convs"] + params["fcs"]):
        if i < nc:
            cout, k, stride, pad, pool = spec.convs[i]
            y = tpl.conv2d(h, p["w"], stride=stride, padding=pad, bias=p["b"], relu=True)
        else:
            if i == nc:
                h = h.reshape(h.shape[0], -1)
            if i - nc == last:
                out["fcs"].append(dict(p))
                break
            y = tpl.linear(h, p["w"], p["b"], relu=True)
        s = limit / float(y.abs().max())
        out["convs" if i < nc else "fcs"].append({"w": p["w"] * s, "b": p["b"] * s})
        h = y * s
        if i < nc and pool:
            h = _maxpool(h, pool)
    return out


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """Compiled per-layer execution plan for one CNN (plan-then-execute)."""

    convs: tuple  # ConvPlan per conv stage
    fcs: tuple  # GemmPlan per FC layer
    # spatial (H-slab) sharding; shards == 1 means unsharded
    spatial: int = 1  # H-slab shard count S
    spatial_axis: Optional[str] = None  # mesh axis the slab dim shards over
    pool_halos: tuple = ()  # per conv stage: SpatialHalo of its pool, or None
    feat_h: int = 0  # global H entering the conv -> FC flatten gather

    def describe(self) -> list[str]:
        """One line per layer: route, τ, Cin chunk, tiles, on-chip bytes,
        and a spatial seam's halo (``halo=S2(up1,dn1,win114)``)."""
        lines = []
        for i, cp in enumerate(self.convs):
            if cp.spatial_tiles > 1 or cp.col_tiles > 1:
                dims = f"{cp.tile_rows}r"
                if cp.col_tiles > 1:
                    dims += f"x{cp.tile_cols}c"
                tiling = (f"tiles={cp.spatial_tiles}x{cp.col_tiles}"
                          f"({dims},{cp.halo_mode})")
            else:
                tiling = "untiled"
            chunk = f" cin_chunk={cp.cin_chunk}" if cp.cin_chunk else ""
            if cp.conv_route:
                chunk = f" kernel={cp.conv_route}{chunk}"
            if cp.conv_route == "tc":
                chunk += f" sub={cp.sub_rows}x{cp.sub_cols} splits={cp.splits}"
            halo = ""
            if cp.halo is not None:
                halo = (f" halo=S{cp.halo.shards}"
                        f"(up{cp.halo.up},dn{cp.halo.dn},win{cp.halo.win})")
            lines.append(
                f"conv{i}: route={cp.route} tau={cp.tau}{chunk} {tiling} "
                f"smem={cp.vmem_bytes / 2**10:.1f}KiB gemm={cp.gemm}{halo}"
            )
        for i, gp in enumerate(self.fcs):
            blk = (gp.block.bm, gp.block.bn, gp.block.bk) if gp.block else None
            route = ""
            if gp.block is not None and gp.block.route != "tile":
                route = f" route={gp.block.route}"
                if gp.block.splits > 1:
                    route += f" splits={gp.block.splits}"
            lines.append(f"fc{i}: m={gp.m} n={gp.n} k={gp.k} block={blk}{route}")
        return lines


_NETWORK_PLANS: dict = {}


def reset_plans() -> None:
    """Forget every network plan and every engine's planned shapes, so the
    next :func:`plan_cnn` plans cold."""
    _NETWORK_PLANS.clear()
    reset_plan_caches()


def plan_cnn(
    tpl: Template,
    spec: CNNSpec,
    input_shape: Sequence[int],
    *,
    force_route: Optional[str] = None,
    mesh=None,
    partition=None,
    spatial=None,
) -> NetworkPlan:
    """Compile the network's kernel routes and tiles once.

    Memoized per (template config, spec, input shape, forced route, mesh
    topology and partition, spatial (shards, axis)): every later call
    returns the same plan object, so the DSE runs at most once per distinct
    layer shape.  ``force_route`` overrides conv routing (e.g. "im2col").
    With ``mesh`` every layer is planned at its local shape (batch over the
    partition's M axes, Cout / FC widths over its N axes).

    ``spatial`` (a shard count, or a mesh axis name under ``use_mesh``)
    plans the H-slab partition instead: each conv and pool at its
    halo-augmented local slab, the seams chained (each layer's slab layout
    is the previous layer's per-shard output rows), batch and Cout whole,
    and the FCs at the logical shape (the flatten seam gathers the slabs).
    """
    spatial_n, spatial_ax = 1, None
    if spatial is not None:
        spatial_n, spatial_ax = sh.spatial_shards(spatial, mesh)
    mesh_key = None
    if mesh is not None:
        mesh_key = (tuple((a, mesh.shape[a]) for a in mesh.axis_names), partition)
    key = (tpl.config, spec, tuple(input_shape), force_route, mesh_key,
           (spatial_n, spatial_ax))
    plan = _NETWORK_PLANS.get(key)
    if plan is not None:
        return plan
    eng = tpl.engine
    n, hh, ww, ch = input_shape
    if spatial_n > 1:
        lx = -(-hh // spatial_n)  # the _to_slabs layout of the input
        convs, pool_halos = [], []
        for cout, k, stride, pad, pool in spec.convs:
            hs = sh.plan_spatial_halo(hh, k, stride, pad, spatial_n, axis=spatial_ax,
                                      lx=lx)
            convs.append(eng.plan_conv((n, hh, ww, ch), (k, k, ch, cout), stride=stride,
                                       padding=pad, route=force_route, spatial=hs))
            lx = hs.lo
            hh = (hh + 2 * pad - k) // stride + 1
            ww = (ww + 2 * pad - k) // stride + 1
            if pool:
                ph = sh.plan_spatial_halo(hh, pool, pool, 0, spatial_n, axis=spatial_ax,
                                          lx=lx)
                pool_halos.append(ph)
                lx = ph.lo
                hh //= pool
                ww //= pool
            else:
                pool_halos.append(None)
            ch = cout
        fan = hh * ww * ch
        fcs = []
        for wd in (*spec.fcs, spec.n_classes):
            fcs.append(eng.plan_gemm(n, wd, fan))
            fan = wd
        plan = NetworkPlan(convs=tuple(convs), fcs=tuple(fcs), spatial=spatial_n,
                           spatial_axis=spatial_ax, pool_halos=tuple(pool_halos),
                           feat_h=hh)
        _NETWORK_PLANS[key] = plan
        return plan
    convs = []
    for cout, k, stride, pad, pool in spec.convs:
        cp = eng.plan_conv((n, hh, ww, ch), (k, k, ch, cout), stride=stride,
                           padding=pad, route=force_route, mesh=mesh, partition=partition)
        convs.append(cp)
        hh = (hh + 2 * cp.pad - k) // stride + 1
        ww = (ww + 2 * cp.pad - k) // stride + 1
        if pool:
            hh //= pool
            ww //= pool
        ch = cout
    fan = hh * ww * ch
    fcs = []
    for wd in (*spec.fcs, spec.n_classes):
        fcs.append(eng.plan_gemm(n, wd, fan, mesh=mesh, partition=partition))
        fan = wd
    plan = NetworkPlan(convs=tuple(convs), fcs=tuple(fcs))
    _NETWORK_PLANS[key] = plan
    return plan


def cnn_layer_names(spec: CNNSpec) -> tuple:
    """Per-layer names, forward order: conv0.. then fc0.. (the last is the
    classifier).  A name keys its layer's *input* grid in
    ``NumericsPolicy.layer_fmts``."""
    return tuple(f"conv{i}" for i in range(len(spec.convs))) + tuple(
        f"fc{i}" for i in range(len(spec.fcs) + 1)
    )


def quantize_cnn_params(tpl: Template, spec: CNNSpec, params,
                        policy: NumericsPolicy):
    """Quantize-once parameter preparation.

    Conv and FC weights become per-tensor max-abs QTensors under the
    accumulator-headroom rule, calibrated against each layer's own input
    grid (``policy.fmt_for``); biases pin to that grid.  Memoized by
    parameter-tree identity and policy in the engine's qparam cache.
    """
    policy = validate_policy(tpl.config, policy)
    if not policy.quantized:
        return params
    eng = tpl.engine
    names = cnn_layer_names(spec)

    def build():
        def qdense(leaf, name):
            axes = tuple(range(leaf["w"].ndim - 1))
            fmt = policy.fmt_for(name)
            return {
                "w": eng.quantize_weight(leaf["w"], policy, contraction_axes=axes,
                                         fused_bias=True, act_fmt=fmt,
                                         total_bits=fmt.total_bits),
                "b": eng.quantize_weight(leaf["b"], policy, fmt=fmt),
            }

        nc = len(params["convs"])
        return {
            "convs": [qdense(p, names[i]) for i, p in enumerate(params["convs"])],
            "fcs": [qdense(p, names[nc + i]) for i, p in enumerate(params["fcs"])],
        }

    return eng.qparams_for(params, policy, build)


def calibrate_cnn_policy(tpl: Template, spec: CNNSpec, params, x,
                         base: Optional[NumericsPolicy] = None) -> NumericsPolicy:
    """Max-abs activation calibration: one eager forward over a calibration
    batch picks the activation grid."""
    base = base or NumericsPolicy("q16")
    probe_qp = quantize_cnn_params(tpl, spec, params, base)
    fmt = tpl.engine.calibrate_activation_format(
        lambda: cnn_forward(tpl, spec, probe_qp, x, policy=base)
    )
    policy = dataclasses.replace(base, fmt=fmt)
    if policy != base:
        tpl.engine.drop_qparams(params, base)  # release the probe tree
    return policy


def calibrate_cnn_precision(tpl: Template, spec: CNNSpec, params, x, *,
                            budget: float = 0.99,
                            policy: Optional[NumericsPolicy] = None,
                            drift: Optional[dict] = None, ref=None) -> NumericsPolicy:
    """The drift-aware per-layer precision DSE for a CNN.

    Warm path: when the plan registry holds a pin for *every* layer of
    ``spec`` under the template's spec, the mixed policy is rebuilt from
    the pins: no forward, no search, each layer a registry hit.

    Cold path (:func:`repro_torch.core.dse.search_precision`): measure each
    layer's *solo-flip* drift (the network run with only that layer's input
    activations on the int8 rung of the calibrated grid, its argmax
    agreement with the reference; ``drift`` skips the sweep with rows
    measured elsewhere), assign int8 wherever the agreement meets
    ``budget``, revert the int8 layer of lowest agreement until the
    *composed* network meets the budget, and pin every choice with
    ``source="measured"``.

    ``ref`` overrides the reference class predictions, an (N,) argmax
    array; the default is the forward of the float ``params`` on ``tpl``
    (on a q16 template, the per-op fixed-point forward).
    """
    policy = policy or calibrate_cnn_policy(tpl, spec, params, x)
    eng = tpl.engine
    names = cnn_layer_names(spec)
    low = int8_rung(policy.fmt)
    if low is None:
        return policy  # the calibrated range has no int8 rung
    fmts = dse.pinned_precision(eng.plan_cache, spec.name, names, tpl.config.hw)
    if fmts is None:
        if ref is None:
            ref = torch.argmax(cnn_forward(tpl, spec, params, x), dim=-1)
        ref = torch.as_tensor(ref, device=x.device)

        def probe_agreement(fmts):
            probe = dataclasses.replace(policy, name="mixed", layer_fmts=fmts)
            qp = quantize_cnn_params(tpl, spec, params, probe)
            got = torch.argmax(cnn_forward(tpl, spec, qp, x, policy=probe), dim=-1)
            eng.drop_qparams(params, probe)  # release the probe tree
            return float((got == ref).float().mean())

        fmts = dse.search_precision(eng.plan_cache, spec.name, names, tpl.config.hw,
                                    policy.fmt, low, budget, probe_agreement, drift)
    return dataclasses.replace(policy, name="mixed", layer_fmts=fmts)


def cnn_forward(
    tpl: Template,
    spec: CNNSpec,
    params,
    x: torch.Tensor,
    *,
    quantized: bool = False,
    fmt: QFormat = Q2_14,
    plan: Optional[NetworkPlan] = None,
    policy: Optional[NumericsPolicy] = None,
) -> torch.Tensor:
    """x: (N, H, W, C) -> logits (N, n_classes).

    ``quantized``: fake-quantize weights and activations to ``fmt`` around
    every GEMM (the deployed numerics, simulated in float).  ``policy``: a
    quantized :class:`NumericsPolicy` with a :func:`quantize_cnn_params`
    tree runs the whole network grid-resident — the input is quantized
    once, every conv / FC (ReLU fused) and maxpool stays on the integer
    grid, each layer writes its successor's input grid in-kernel, and the
    only dequantization is the classifier's exact int32 read-out.

    A spatial ``plan`` (``plan_cnn(spatial=)``) runs the conv stack on H
    slabs: the input is cut into slabs, every conv and pool exchanges its
    halo rows, and the flatten gathers the slabs back; on a mesh axis each
    rank computes its own slab and every rank returns the whole logits.
    """
    plan = plan or plan_cnn(tpl, spec, tuple(x.shape))
    halos = plan.pool_halos or (None,) * len(plan.convs)

    def pool_of(h, pool, ph):
        return _maxpool_spatial(h, pool, ph) if ph is not None else _maxpool(h, pool)

    if policy is not None and policy.quantized and isinstance(
        params["convs"][0]["w"], QTensor
    ):
        names = cnn_layer_names(spec)
        h = tpl.quant(x, policy.fmt_for(names[0]))
        if plan.spatial > 1:
            h = _to_slabs(h, plan.spatial, plan.spatial_axis)
        nc = len(plan.convs)
        for i, (p, (cout, k, stride, pad, pool), cp, ph) in enumerate(
            zip(params["convs"], spec.convs, plan.convs, halos)
        ):
            h = tpl.conv2d(h, p["w"], stride=stride, padding=pad, bias=p["b"],
                           relu=True, qout=policy.fmt_for(names[i + 1]), plan=cp)
            if pool:
                h = pool_of(h, pool, ph)
        if plan.spatial > 1:
            h = _gather_slabs(h, plan.feat_h, plan.spatial_axis)
        h = h.reshape(h.shape[0], -1)
        last = len(params["fcs"]) - 1
        for i, (p, gp) in enumerate(zip(params["fcs"], plan.fcs)):
            if i < last:
                h = tpl.linear(h, p["w"], p["b"], relu=True,
                               qout=policy.fmt_for(names[nc + i + 1]), plan=gp)
            else:
                h = tpl.linear(h, p["w"], p["b"], wide=True, plan=gp)
        return h
    fq = (lambda a: fake_quant_fmt(a, fmt)) if quantized else (lambda a: a)
    qo = fmt if quantized else None
    h = fq(x)
    if plan.spatial > 1:
        h = _to_slabs(h, plan.spatial, plan.spatial_axis)
    for p, (cout, k, stride, pad, pool), cp, ph in zip(params["convs"], spec.convs,
                                                       plan.convs, halos):
        h = tpl.conv2d(h, fq(p["w"]), stride=stride, padding=pad,
                       bias=fq(p["b"]), relu=True, qout=qo, plan=cp)
        if pool:
            h = pool_of(h, pool, ph)
    if plan.spatial > 1:
        h = _gather_slabs(h, plan.feat_h, plan.spatial_axis)
    h = h.reshape(h.shape[0], -1)
    last = len(params["fcs"]) - 1
    for i, (p, gp) in enumerate(zip(params["fcs"], plan.fcs)):
        h = tpl.linear(h, fq(p["w"]), fq(p["b"]), relu=i < last,
                       qout=qo if i < last else None, plan=gp)
    return h
