"""The paper's case-study networks (AlexNet / VGG16 / LeNet) on the unified
compute unit, in the port (single device).

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
from which a second call rebuilds it with no forward.  Spatial and mesh
sharding are not ported yet (ROADMAP queue 1 item 5).
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

    def describe(self) -> list[str]:
        """One line per layer: route, τ, Cin chunk, tiles, on-chip bytes."""
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
            lines.append(
                f"conv{i}: route={cp.route} tau={cp.tau}{chunk} {tiling} "
                f"smem={cp.vmem_bytes / 2**10:.1f}KiB gemm={cp.gemm}"
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

    Memoized per (template config, spec, input shape, forced route): every
    later call returns the same plan object, so the DSE runs at most once
    per distinct layer shape.  ``force_route`` overrides conv routing (e.g.
    "im2col").  ``mesh`` / ``partition`` / ``spatial`` are not ported yet
    and raise ``NotImplementedError``.
    """
    if mesh is not None or partition is not None or spatial is not None:
        raise NotImplementedError("sharded CNN plans are not ported yet")
    key = (tpl.config, spec, tuple(input_shape), force_route)
    plan = _NETWORK_PLANS.get(key)
    if plan is not None:
        return plan
    eng = tpl.engine
    n, hh, ww, ch = input_shape
    convs = []
    for cout, k, stride, pad, pool in spec.convs:
        cp = eng.plan_conv((n, hh, ww, ch), (k, k, ch, cout), stride=stride,
                           padding=pad, route=force_route)
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
        fcs.append(eng.plan_gemm(n, wd, fan))
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
    """
    plan = plan or plan_cnn(tpl, spec, tuple(x.shape))
    if policy is not None and policy.quantized and isinstance(
        params["convs"][0]["w"], QTensor
    ):
        names = cnn_layer_names(spec)
        h = tpl.quant(x, policy.fmt_for(names[0]))
        nc = len(plan.convs)
        for i, (p, (cout, k, stride, pad, pool), cp) in enumerate(
            zip(params["convs"], spec.convs, plan.convs)
        ):
            h = tpl.conv2d(h, p["w"], stride=stride, padding=pad, bias=p["b"],
                           relu=True, qout=policy.fmt_for(names[i + 1]), plan=cp)
            if pool:
                h = _maxpool(h, pool)
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
    for p, (cout, k, stride, pad, pool), cp in zip(params["convs"], spec.convs,
                                                   plan.convs):
        h = tpl.conv2d(h, fq(p["w"]), stride=stride, padding=pad,
                       bias=fq(p["b"]), relu=True, qout=qo, plan=cp)
        if pool:
            h = _maxpool(h, pool)
    h = h.reshape(h.shape[0], -1)
    last = len(params["fcs"]) - 1
    for i, (p, gp) in enumerate(zip(params["fcs"], plan.fcs)):
        h = tpl.linear(h, fq(p["w"]), fq(p["b"]), relu=i < last,
                       qout=qo if i < last else None, plan=gp)
    return h
