"""The transformer LM, every family, in the port.

The port's copy of ``repro.models.transformer``, one model definition for
every config:

    dense   — qwen2.5-32b, internlm2-1.8b, mistral-nemo-12b, qwen2-0.5b
    moe     — granite-moe-3b-a800m, phi3.5-moe-42b-a6.6b
    hybrid  — recurrentgemma-9b (RG-LRU + local attention, pattern 2:1)
    ssm     — mamba2-1.3b (attention-free SSD)
    encdec  — whisper-medium (encoder + cross-attending decoder)
    vlm     — llama-3.2-vision-90b (gated cross-attention image layers)

Every layer is described by a :class:`LayerPlan` (its sequence mixer, a
cross-attention sub-layer or not, an MoE FFN or not); a model is a
repeating pattern of plans, each mixer and FFN behind a pre-norm with a
residual add.  The parameter tree keeps
the reference's stacked layout, ``params["blocks"]`` a tuple over pattern
positions whose leaves carry a leading layer axis, plus ``params["tail"]``
for leftover layers, so trees carry across from the JAX package one to one
(``repro_torch.convert``).  The reference scans the stacked axis with
``lax.scan``; the port loops over it in Python.

Entry points: :func:`forward` (teacher-forced logits), :func:`prefill` (the
prompt, returning the decode cache), :func:`decode_step` (one token against
the ring cache, at one shared position or, on the slot-indexed cache of
``init_cache(per_slot=True)``, at a position per row) and
:func:`prefill_chunk_step` (a prompt chunk per slot), in float or, with a
:func:`quantize_params` tree and a quantized policy, grid-resident fixed
point.  The serve scheduler's cache maintenance (:func:`insert_cache_slot`,
:func:`insert_cache_rows`, :func:`clear_cache_rows`) is memory only, bit for
bit the reference's.

Context inputs (``ctx``): whisper's encoder runs once over the frame
embeddings at each forward / prefill; the cross-attention layers attend to
its output (or to the VLM's image embeddings), and their decode caches
hold the context's keys and values, static across decode steps.  Grid-
resident fixed point runs the dense full-attention stack only (the
reference's rule).

Training: :func:`loss_fn` runs :func:`forward` in ``mode="train"``, the
same stack as ``"fwd"`` with, when ``cfg.remat`` is set, each stacked layer
group (and each encoder layer) recomputed in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as the reference wraps each
scanned group in ``jax.checkpoint``.  Under ``remat_policy="attn_out"``
each attention sub-layer and the rest of its layer are two regions, so
the backward keeps the residual stream with each attention output added in
and recomputes everything else.  Recomputation changes no number: the
backward graph is the same, only its saved tensors are made again.

Sharding: :func:`param_axes` and :func:`cache_axes` name each leaf's logical
axes, and the layers pass the reference's ``constrain`` seams
(``parallel.sharding``).  On a rank of a column-parallel mesh
(``DECODE_RULES``) the entry points return whole logits: a vocab-sharded
head's output is gathered before it is read.  Under tensor-parallel
training (``TRAIN_RULES`` with "model" above 1) the residual stream holds
this rank's shard of the sequence: the embedding's masked lookup of its
vocab range is reduce-scattered onto it, each sub-layer gathers the
sequence whole for its column-parallel projections and reduce-scatters its
row-parallel output back, absolute positions are added at the shard's
global offsets, and the head gathers the vocab so the logits stay
sequence-sharded.
:func:`calibrate_precision` is the drift-aware precision DSE over the
precision groups (:func:`precision_group_names`): a group on the int8 rung
gets int8 weights and an int8 KV cache.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import dse
from repro_torch.core.engine import validate_policy
from repro_torch.core.quantization import NumericsPolicy, QTensor, int8_rung
from repro_torch.core.template import Template
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import constrain

from . import moe as moe_mod
from . import rglru as rec_mod
from . import ssm as ssm_mod
from .attention import (
    attention,
    attention_axes,
    attention_islands,
    decode_attention,
    decode_positions,
    init_attention,
    init_layer_cache,
)
from .layers import (
    cross_entropy_loss,
    init_mlp,
    init_norm,
    init_normal,
    mlp,
    mlp_axes,
    mlp_islands,
    norm,
    sinusoidal_positions,
)

__all__ = [
    "LayerPlan",
    "plan_pattern",
    "init_params",
    "param_axes",
    "cache_axes",
    "quantize_params",
    "calibrate_policy",
    "precision_group_names",
    "calibrate_precision",
    "q16_island_counts",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "prefill_chunk_step",
    "init_cache",
    "insert_cache_slot",
    "insert_cache_rows",
    "clear_cache_rows",
    "copy_cache_",
]

class LayerPlan(NamedTuple):
    mixer: str  # "attn" | "local" | "attn_nc" | "rec" | "ssm"
    cross: bool  # followed by a cross-attention sub-layer
    moe: bool  # FFN is a mixture of experts


#: whisper's encoder layers: non-causal self-attention and an MLP
_ENC_PLAN = LayerPlan("attn_nc", False, False)


def plan_pattern(cfg) -> tuple:
    """One pattern period of layer plans."""
    if cfg.family == "ssm":
        return (LayerPlan("ssm", False, False),)
    if cfg.family == "hybrid":
        return tuple(LayerPlan("local" if m == "attn" else "rec", False, False)
                     for m in cfg.pattern)
    if cfg.family == "vlm":
        p = cfg.cross_attn_period
        return tuple(LayerPlan("attn", i == p - 1, False) for i in range(p))
    if cfg.family == "encdec":
        return (LayerPlan("attn", True, False),)
    return (LayerPlan("attn", False, cfg.family == "moe"),)


def _split(cfg):
    pattern = plan_pattern(cfg)
    period = len(pattern)
    return pattern, cfg.n_layers // period, cfg.n_layers % period


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def _keeper(shardings):
    """``keep(name, subtree)``: the subtree cut to this rank's shard by
    ``shardings[name]`` (identity without shardings)."""
    if shardings is None:
        return lambda name, sub: sub
    return lambda name, sub: sh.shard_tree(sub, shardings[name])


def _init_layer(gen, cfg, plan: LayerPlan, dtype, lead: tuple = (), shardings=None):
    dev = gen.device
    keep = _keeper(shardings)

    def sub(name):
        return sh.subtree(shardings, name)

    p = {"norm": keep("norm", init_norm(cfg, dtype, device=dev, lead=lead))}
    if plan.mixer in ("attn", "local", "attn_nc"):
        p["attn"] = keep("attn", init_attention(gen, cfg, dtype=dtype, lead=lead,
                                                shardings=sub("attn")))
    elif plan.mixer == "rec":
        p["rec"] = keep("rec", rec_mod.init_rglru(gen, cfg, dtype=dtype, lead=lead))
    elif plan.mixer == "ssm":
        p["ssm"] = keep("ssm", ssm_mod.init_ssm(gen, cfg, dtype=dtype, lead=lead))
    else:  # pragma: no cover
        raise ValueError(plan.mixer)
    if plan.cross:
        p["cross_norm"] = keep("cross_norm", init_norm(cfg, dtype, device=dev, lead=lead))
        p["cross"] = keep("cross", init_attention(gen, cfg, bias=False, dtype=dtype,
                                                  lead=lead, shardings=sub("cross")))
        if cfg.family == "vlm":
            p["cross_gate"] = keep("cross_gate", torch.zeros(lead, dtype=dtype, device=dev))
    if plan.mixer != "ssm":  # a mamba2 block has no FFN of its own
        p["ffn_norm"] = keep("ffn_norm", init_norm(cfg, dtype, device=dev, lead=lead))
        init_ffn = moe_mod.init_moe if plan.moe else init_mlp
        p["ffn"] = keep("ffn", init_ffn(gen, cfg, dtype=dtype, lead=lead,
                                        shardings=sub("ffn")))
    return p


def init_params(gen: torch.Generator, cfg, dtype=None, *, shardings=None):
    """Random parameters in the config's dtype, drawn from ``gen`` on its own
    device; the reference's initializers and scales, not its numbers (a
    VLM's ``cross_gate`` starts at 0, as there).

    ``shardings`` (the params' :class:`~repro_torch.parallel.sharding.NamedSharding`
    tree on a mesh with ranks, ``launch.steps.state_shardings`` or
    ``sharding.column_parallel_shardings``): the GEMM weights, the
    embedding table and the head are drawn one stacked layer at a time and
    each layer is cut to this rank's shard as it is drawn
    (``layers.init_normal``), the rest cut a sub-module at a time, so the
    whole tree never exists on the rank and its peak holds its shards and
    one layer's f32 draw; the shards equal the unsharded draw cut."""
    dtype = _dtype(dtype or cfg.dtype)
    pattern, g, r = _split(cfg)
    d, v = cfg.d_model, cfg.vocab
    dev = gen.device
    shs = shardings or {}
    keep = _keeper(shardings)

    def table(shape, sharding):
        return init_normal(gen, shape, d ** -0.5, dtype, sharding=sharding)

    params = {"embed": table((v, d), sh.subtree(shardings, "embed")),
              "final_norm": keep("final_norm", init_norm(cfg, dtype, device=dev))}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": table((d, v), sh.subtree(
            sh.subtree(shardings, "lm_head"), "w"))}
    params["blocks"] = tuple(
        _init_layer(gen, cfg, p, dtype, lead=(g,),
                    shardings=shs["blocks"][i] if shardings else None)
        for i, p in enumerate(pattern))
    params["tail"] = tuple(
        _init_layer(gen, cfg, pattern[j], dtype,
                    shardings=shs["tail"][j] if shardings else None) for j in range(r))
    if cfg.family == "encdec":
        enc = shs.get("encoder") if shardings else None
        params["encoder"] = {
            "blocks": (_init_layer(gen, cfg, _ENC_PLAN, dtype, lead=(cfg.n_encoder_layers,),
                                   shardings=enc["blocks"][0] if enc else None),),
            "final_norm": _keeper(enc)("final_norm", init_norm(cfg, dtype, device=dev)),
        }
    return params


def _layer_axes(cfg, plan: LayerPlan) -> dict:
    ax = {"norm": None}
    if plan.mixer in ("attn", "local", "attn_nc"):
        ax["attn"] = attention_axes(cfg)
    elif plan.mixer == "rec":
        ax["rec"] = rec_mod.rglru_axes(cfg)
    elif plan.mixer == "ssm":
        ax["ssm"] = ssm_mod.ssm_axes(cfg)
    if plan.cross:
        ax["cross_norm"] = None
        ax["cross"] = attention_axes(cfg, bias=False)
        if cfg.family == "vlm":
            ax["cross_gate"] = None
    if plan.mixer != "ssm":
        ax["ffn_norm"] = None
        ax["ffn"] = moe_mod.moe_axes(cfg) if plan.moe else mlp_axes(cfg)
    return ax


def _stack_axes(ax):
    """Prepend the (unsharded) stacked-layer axis to every logical-axes leaf."""
    if sh.is_axes_leaf(ax):
        return None if ax is None else (None, *ax)
    return {k: _stack_axes(v) for k, v in ax.items()}


def param_axes(cfg) -> dict:
    """Logical axes tree of :func:`init_params`'s tree (a None leaf
    replicates its whole subtree)."""
    pattern, g, r = _split(cfg)
    ax = {"embed": ("vocab", "embed"), "final_norm": None}
    if not cfg.tie_embeddings:
        ax["lm_head"] = {"w": ("embed", "vocab")}
    ax["blocks"] = tuple(_stack_axes(_layer_axes(cfg, p)) for p in pattern)
    ax["tail"] = tuple(_layer_axes(cfg, pattern[j]) for j in range(r))
    if cfg.family == "encdec":
        ax["encoder"] = {"blocks": (_stack_axes(_layer_axes(cfg, _ENC_PLAN)),),
                         "final_norm": None}
    return ax


def _at(tree, j: int):
    """Layer ``j`` of a stacked tree (a shard keeps its marks)."""
    if isinstance(tree, dict):
        return {k: _at(v, j) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return sh.carry_marks(tree, QTensor(tree.raw[j], tree.fmt))
    return sh.carry_marks(tree, tree[j])


def _stack(trees: list):
    """The stacked tree of per-layer trees (inverse of :func:`_at`; a
    shard keeps its marks, which count dims from the end)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return sh.carry_marks(first, torch.stack(trees))


def _depth(tree) -> int:
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return (leaf.raw if isinstance(leaf, QTensor) else leaf).shape[0]


# ---------------------------------------------------------------------------
# fixed-point residency: quantize-once parameter preparation
# ---------------------------------------------------------------------------


def quantize_params(tpl: Template, cfg, params, policy: NumericsPolicy):
    """The quantized parameter tree for a grid-resident pass.

    Every GEMM weight (attention projections, FFN, LM head — the tied head
    gets its own (d, vocab) raw copy so the float lookup table stays as it
    is) becomes a :class:`QTensor` with a per-tensor max-abs format under the
    accumulator-headroom rule; biases pin to the activation grid; norms and
    the embedding table stay float.  Memoized by tree identity in the
    engine's qparam cache, so weights are quantized once per (tree, policy).
    """
    policy = validate_policy(tpl.config, policy)
    if not policy.quantized:
        return params
    pattern = plan_pattern(cfg)
    bad = [lp.mixer for lp in pattern if lp.mixer != "attn"]
    if bad or any(lp.cross or lp.moe for lp in pattern):
        raise ValueError(f"NumericsPolicy('q16') supports dense full-attention stacks "
                         f"only; {cfg.name} ({cfg.family}) has "
                         f"{bad or 'cross-attention / MoE layers'}")
    eng = tpl.engine

    def build():
        def qdense(leaf, fmt):
            out = {"w": eng.quantize_weight(leaf["w"], policy, contraction_axes=(-2,),
                                            fused_bias="b" in leaf, act_fmt=fmt,
                                            total_bits=fmt.total_bits)}
            if "b" in leaf:
                out["b"] = eng.quantize_weight(leaf["b"], policy, fmt=fmt)
            return out

        def qlayer(lp, name):
            fmt = policy.fmt_for(name)
            out = dict(lp)  # norms pass through (float islands)
            out["attn"] = {k: qdense(v, fmt) for k, v in lp["attn"].items()}
            out["ffn"] = {k: qdense(v, fmt) for k, v in lp["ffn"].items()}
            return out

        qp = dict(params)
        qp["blocks"] = tuple(qlayer(b, f"g{i}") for i, b in enumerate(params["blocks"]))
        qp["tail"] = tuple(qlayer(tc, f"tail{j}") for j, tc in enumerate(params["tail"]))
        head_w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]["w"]
        hf = policy.fmt_for("head")
        head = eng.quantize_weight(head_w, policy, contraction_axes=(-2,), act_fmt=hf,
                                   total_bits=hf.total_bits)
        # a quantized transposed view keeps its strides: store it row-major
        qp["lm_head"] = {"w": QTensor(head.raw.contiguous(), head.fmt)}
        return qp

    return eng.qparams_for(params, policy, build)


def calibrate_policy(tpl: Template, cfg, params, tokens,
                     base: Optional[NumericsPolicy] = None) -> NumericsPolicy:
    """The max-abs calibration pass: one prefill over ``tokens`` with every
    island exit recording the magnitude it snaps, then ``base`` with the
    smallest Qm.n covering it.  Quantize the final tree after calibration:
    :func:`quantize_params` keys its cache by policy."""
    base = base or NumericsPolicy("q16")
    probe_qp = quantize_params(tpl, cfg, params, base)
    fmt = tpl.engine.calibrate_activation_format(
        lambda: prefill(tpl, cfg, probe_qp, tokens, cache_len=tokens.shape[1],
                        policy=base))
    policy = dataclasses.replace(base, fmt=fmt)
    if policy != base:
        tpl.engine.drop_qparams(params, base)  # release the probe tree
    return policy


def precision_group_names(cfg) -> tuple:
    """Names of the precision groups of ``cfg``'s stack: "g{i}" for pattern
    position i (every layer stacked there), "tail{j}" for the j-th leftover
    layer, and "head" for the post-norm quantize feeding the logits."""
    pattern, _, r = _split(cfg)
    return (tuple(f"g{i}" for i in range(len(pattern)))
            + tuple(f"tail{j}" for j in range(r)) + ("head",))


def calibrate_precision(tpl: Template, cfg, params, tokens, *, budget: float = 0.99,
                        policy: Optional[NumericsPolicy] = None,
                        drift: Optional[dict] = None, ref=None) -> NumericsPolicy:
    """The drift-aware per-group precision DSE for a transformer.

    Warm path: when the plan registry holds a pin for *every* group of
    ``cfg`` under the template's spec, the mixed policy is rebuilt from the
    pins: no forward, no search, each group a registry hit.

    Cold path (:func:`repro_torch.core.dse.search_precision`): measure each
    group's *solo-flip* drift (the teacher-forced forward over ``tokens``
    with only that group on the int8 rung of the calibrated grid, its argmax
    agreement with the reference; ``drift`` skips the sweep), assign int8
    wherever the agreement meets ``budget``, revert the int8 group of lowest
    agreement until the composed network meets the budget, and pin every
    choice with ``source="measured"``.

    ``ref`` overrides the reference predictions, a (B, S) argmax array; the
    default is the forward of the float ``params`` on ``tpl`` (on a q16
    template, the per-op fixed-point forward).
    """
    policy = policy or calibrate_policy(tpl, cfg, params, tokens)
    eng = tpl.engine
    names = precision_group_names(cfg)
    low = int8_rung(policy.fmt)
    if low is None:
        return policy  # the calibrated range has no int8 rung
    fmts = dse.pinned_precision(eng.plan_cache, cfg.name, names, tpl.config.hw)
    if fmts is None:
        if ref is None:
            ref = torch.argmax(forward(tpl, cfg, params, tokens)[0], dim=-1)
        ref = torch.as_tensor(ref, device=tokens.device)

        def probe_agreement(fmts):
            probe = dataclasses.replace(policy, name="mixed", layer_fmts=fmts)
            qp = quantize_params(tpl, cfg, params, probe)
            got = torch.argmax(forward(tpl, cfg, qp, tokens, policy=probe)[0], dim=-1)
            eng.drop_qparams(params, probe)  # release the probe tree
            return float((got == ref).float().mean())

        fmts = dse.search_precision(eng.plan_cache, cfg.name, names, tpl.config.hw,
                                    policy.fmt, low, budget, probe_agreement, drift)
    return dataclasses.replace(policy, name="mixed", layer_fmts=fmts)


def q16_island_counts(cfg, *, mode: str = "decode") -> dict:
    """The residency law: designated float islands of one q16 step.

    The per-sublayer counts (:func:`attention_islands`, :func:`mlp_islands`)
    summed over the layers, plus the head (one quantize of the post-norm
    hidden, one exact logits read-out).  The port's counters tick each time
    a layer runs, so every layer counts; the reference's tick while
    ``lax.scan`` traces, once per pattern position and tail layer.  Either
    way an extra float hop inside a layer breaks the law.
    """
    att = attention_islands(cfg, mode=mode, cached=(mode == "prefill"))
    ffn = mlp_islands(cfg)
    return {
        "quantize": cfg.n_layers * (att["quantize"] + ffn["quantize"]) + 1,
        "dequantize": cfg.n_layers * (att["dequantize"] + ffn["dequantize"]) + 1,
    }


def _group_policy(policy, name: str):
    """Rebind a mixed policy to one layer group's activation grid (identity
    for single-grid policies)."""
    if policy is None or not policy.layer_fmts:
        return policy
    return dataclasses.replace(policy, fmt=policy.fmt_for(name), layer_fmts=())


# ---------------------------------------------------------------------------
# layers and the stack
# ---------------------------------------------------------------------------


def _run_layer(tpl, cfg, plan: LayerPlan, p, h, *, positions, mode, cache=None, ctx=None,
               cache_len: int = 0, t=None, policy=None, n_valid=None, inplace=False,
               part: str = "all"):
    """One layer.  Returns (h, new_cache_or_None, aux): aux is the MoE FFN's
    load-balancing loss (0 for any other FFN).  ``mode``: "fwd", "train",
    "prefill" or "decode"; ``inplace`` (decode) writes the layer's new cache
    entries into the tensors of ``cache``.  ``part`` "mixer" runs only the
    sequence mixer's sub-layer, "rest" only what follows it (the
    ``attn_out`` rematerialization's two regions)."""
    newc = {}
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if mode != "decode":  # the residual stream on its shard (whisper's encoder enters whole)
        h = constrain(h, "batch", "seq_act", "act_embed")

    if part == "rest":
        pass
    elif plan.mixer in ("attn", "local", "attn_nc"):
        window = cfg.window if plan.mixer == "local" else 0
        a_in = norm(cfg, p["norm"], h)
        if mode == "decode":
            out, c = decode_attention(tpl, p["attn"], a_in, cache["attn"], cfg=cfg, t=t,
                                      window=window, policy=policy, n_valid=n_valid,
                                      inplace=inplace)
            newc["attn"] = c
        else:
            a_in = constrain(a_in, "batch", "seq_act", "act_embed")
            clen = 0
            if mode == "prefill":
                clen = min(window, cache_len) if window else cache_len
            out, c = attention(tpl, p["attn"], a_in, cfg=cfg, positions=positions,
                               causal=plan.mixer != "attn_nc", window=window,
                               cache_len=clen, policy=policy)
            if mode == "prefill":
                newc["attn"] = c
        # a column shard of the residual width (wo's columns under embed
        # over "model") is gathered here, in decode too
        out = constrain(out, "batch", "seq_act", "act_embed")
        h = _add(h, out)
    else:  # the recurrent mixers: RG-LRU ("rec") and Mamba2 SSD ("ssm")
        mod, block, step = ((rec_mod, rec_mod.rglru_block, rec_mod.rglru_decode_step)
                            if plan.mixer == "rec" else
                            (ssm_mod, ssm_mod.ssm_block, ssm_mod.ssm_decode_step))
        a_in = norm(cfg, p["norm"], h)
        if mode == "decode":
            out, c = step(tpl, cfg, p[plan.mixer], a_in, cache[plan.mixer], inplace=inplace)
            newc[plan.mixer] = c
        elif mode == "prefill":
            out, c = block(tpl, cfg, p[plan.mixer], a_in, return_cache=True)
            newc[plan.mixer] = c
        else:
            out = block(tpl, cfg, p[plan.mixer], a_in)
        out = constrain(out, "batch", "seq_act", "act_embed")
        h = _add(h, out)
    if part == "mixer":
        return h, (newc or None), aux

    if plan.cross:
        c_in = norm(cfg, p["cross_norm"], h)
        if mode == "decode":
            out, _ = decode_attention(tpl, p["cross"], c_in, cache["cross"], cfg=cfg, t=t,
                                      cross=True)
            newc["cross"] = cache["cross"]  # static across decode steps
        else:
            clen = ctx.shape[1] if mode == "prefill" else 0
            out, c = attention(tpl, p["cross"], c_in, cfg=cfg, positions=positions,
                               kv_source=ctx, cache_len=clen)
            if mode == "prefill":
                newc["cross"] = c
        if "cross_gate" in p:
            out = sh.carry_marks(out, torch.tanh(p["cross_gate"]).to(out.dtype) * out)
        out = constrain(out, "batch", "seq_act", "act_embed")
        h = _add(h, out)

    if plan.mixer != "ssm":
        f_in = norm(cfg, p["ffn_norm"], h)
        if mode != "decode":
            f_in = constrain(f_in, "batch", "seq_act", "act_embed")
        if plan.moe:
            out, aux = moe_mod.moe_ffn(tpl, cfg, p["ffn"], f_in)
        else:
            out = mlp(tpl, cfg, p["ffn"], f_in, policy=policy)
        out = constrain(out, "batch", "seq_act", "act_embed")
        h = _add(h, out)
    h = constrain(h, "batch", "seq_act", "act_embed")
    return h, (newc or None), aux


def _add(h, out):
    """The residual add; a sequence shard stays marked."""
    return sh.carry_marks(h, h + out)


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass, under
    the mesh state of the forward (a CUDA backward recomputes on the
    autograd engine's thread, where the FSDP gathers and the MoE groups
    would otherwise find no mesh)."""
    state = sh.mesh_state()

    def region(*a):
        with sh.use_mesh_state(state):
            return fn(*a)

    return checkpoint(region, *args, use_reentrant=False)


def _train_groups(tpl, cfg, blocks, h, aux, *, pattern, depth, positions, ctx, policy):
    """The stacked groups of a ``mode="train"`` forward under ``cfg.remat``:
    one recomputed region per group (layer j of every pattern position), or
    under ``remat_policy="attn_out"`` two per layer (the mixer's sub-layer,
    then the rest).  aux accumulates layer by layer, as the reference's scan
    carries it."""
    attn_out = getattr(cfg, "remat_policy", "") == "attn_out"

    def layer(i, j, part):
        def fn(hh):
            # FSDP shards are gathered here, inside the recomputed region:
            # the whole weights live only while the region runs
            return _run_layer(tpl, cfg, pattern[i], sh.gather_fsdp(_at(blocks[i], j)), hh,
                              positions=positions, mode="train", ctx=ctx,
                              policy=_group_policy(policy, f"g{i}"), part=part)
        return fn

    for j in range(depth):
        if attn_out:
            for i in range(len(pattern)):
                h = _remat(lambda hh, f=layer(i, j, "mixer"): f(hh)[0], h)
                h, a = _remat(lambda hh, f=layer(i, j, "rest"): f(hh)[::2], h)
                aux = aux + a
        else:
            def group(hh, acc, j=j):
                for i in range(len(pattern)):
                    hh, _, a = layer(i, j, "all")(hh)
                    acc = acc + a
                return hh, acc

            h, aux = _remat(group, h, aux)
    return h, aux


def _run_stack(tpl, cfg, params, h, *, pattern, mode, positions, cache=None, ctx=None,
               cache_len: int = 0, t=None, policy=None, n_valid=None, inplace=False,
               remat: bool = False):
    """Run the stacked groups layer by layer (layer j of every pattern
    position in turn, as the reference's scan does), then the tail layers.
    Returns (h, cache' or None, aux summed over the layers); with
    ``inplace`` a decode writes into the cache passed in (each layer's
    entries are views of its stacked leaves) and returns it.  ``remat``
    (mode "train") recomputes each group in the backward pass; the tail
    layers run plainly, as the reference's do."""
    blocks = params["blocks"]
    depth = _depth(blocks[0]) if blocks else 0
    block_caches = [[] for _ in pattern]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if remat:
        h, aux = _train_groups(tpl, cfg, blocks, h, aux, pattern=pattern, depth=depth,
                               positions=positions, ctx=ctx, policy=policy)
        depth = 0
    for j in range(depth):
        for i, plan in enumerate(pattern):
            c = None if cache is None else _at(cache["blocks"][i], j)
            h, c, a = _run_layer(tpl, cfg, plan, sh.gather_fsdp(_at(blocks[i], j)), h,
                                 positions=positions,
                                 mode=mode, cache=c, ctx=ctx, cache_len=cache_len, t=t,
                                 policy=_group_policy(policy, f"g{i}"), n_valid=n_valid,
                                 inplace=inplace)
            block_caches[i].append(c)
            aux = aux + a
    tail_caches = []
    for j, lp in enumerate(params["tail"]):
        c = None if cache is None else cache["tail"][j]
        h, c, a = _run_layer(tpl, cfg, pattern[j], sh.gather_fsdp(lp), h,
                             positions=positions, mode=mode,
                             cache=c, ctx=ctx, cache_len=cache_len, t=t,
                             policy=_group_policy(policy, f"tail{j}"), n_valid=n_valid,
                             inplace=inplace)
        tail_caches.append(c)
        aux = aux + a
    if mode not in ("prefill", "decode"):
        return h, None, aux
    if inplace:
        return h, cache, aux
    return h, {"blocks": tuple(_stack(cs) for cs in block_caches),
               "tail": tuple(tail_caches)}, aux


def _encode(tpl, cfg, enc_params, frames, *, remat: bool = False):
    """Whisper's encoder over precomputed frame embeddings (the stub
    frontend): sinusoidal positions, non-causal layers, a final norm;
    ``remat`` recomputes each layer in the backward pass."""
    nf = frames.shape[1]
    h = frames + sinusoidal_positions(nf, cfg.d_model, frames.dtype, frames.device)[None]
    h = constrain(h, "batch", "ctx", "act_embed")
    blocks = enc_params["blocks"][0]
    positions = torch.arange(nf, device=h.device)
    for j in range(_depth(blocks)):
        def body(hh, j=j):
            return _run_layer(tpl, cfg, _ENC_PLAN, sh.gather_fsdp(_at(blocks, j)), hh,
                              positions=positions, mode="fwd")[0]

        h = _remat(body, h) if remat else body(h)
    return norm(cfg, enc_params["final_norm"], h)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _embed_tokens(cfg, params, tokens):
    """The token rows of the table; a vocab-sharded table's lookup is a
    partial sum, reduce-scattered onto the sequence by the seam."""
    rows = sh.embedding_lookup(sh.gather_fsdp(params["embed"]), tokens)
    return constrain(rows, "batch", "seq_act", "act_embed")


def _abs_pos(cfg, h, s: int):
    """``h`` plus the sinusoidal positions 0..s-1, cut to ``h``'s rows of the
    sequence by the seam (a sequence shard adds its global positions)."""
    pe = sinusoidal_positions(s, cfg.d_model, h.dtype, h.device)[None]
    return _add(h, constrain(pe, "batch", "seq_act", "act_embed"))


def _head(tpl, cfg, params, h, *, policy=None):
    h = norm(cfg, params["final_norm"], h)
    head = params.get("lm_head", {}).get("w")
    if policy is not None and policy.quantized and isinstance(head, QTensor):
        # the logits boundary: quantize the post-norm hidden once, read the
        # int32 accumulator out exactly (logits never saturate on the grid)
        hq = tpl.quant(h, policy.fmt_for("head"))
        logits = tpl.matmul(hq, head, wide=True)
    else:
        # the tied head multiplies by embed's transposed view: the float GEMM
        # kernel reads it in place.  Under sequence-parallel rules the
        # logits keep the sequence's shard, so the vocab's shard over the
        # same axis is gathered (a weight gather: backward reduce-scatter)
        w = sh.gather_fsdp(params["embed"] if cfg.tie_embeddings else head)
        w = sh.gather_params(w, sh.mark_axes(h))
        if cfg.tie_embeddings:  # a table cut along embed: the head contracts it whole
            w = sh.replicated(w, dims=(-1,))
            # its vocab shard (the rules' layout) makes column-parallel logits
            w = sh.mark_shard(w.T, tuple((-1, a, n) for d, a, n in sh.shard_marks(w)
                                         if d % 2 == 0))
        logits = tpl.matmul(h, w)
    # a vocab-sharded head's logits stay sharded at the seam; the entry
    # points gather them whole before they are read.  Only the vocab dim:
    # a rank's batch rows stay its own (gathered, every rank would take the
    # loss over every row)
    return sh.replicated(constrain(logits, "batch", "seq_act", "vocab"), dims=(-1,))


def _context(tpl, cfg, params, ctx, *, remat: bool = False):
    """The context the cross-attention layers read: whisper's encoder output
    over ``ctx`` (frame embeddings), else ``ctx`` itself (image embeddings,
    or None)."""
    if cfg.family == "encdec":
        return _encode(tpl, cfg, params["encoder"], ctx, remat=remat)
    return ctx


def _sinusoid_at(t, d: int, dtype):
    """Sinusoidal position rows at positions ``t`` (a device tensor of any
    shape): (*t.shape, d), the rows of :func:`sinusoidal_positions`."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=t.device)
    angle = t.to(torch.float32)[..., None] / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def forward(tpl: Template, cfg, params, tokens, *, ctx=None, mode: str = "fwd",
            policy: Optional[NumericsPolicy] = None):
    """Teacher-forced full-sequence forward.  tokens: (B, S) -> (logits
    (B, S, V), aux, the MoE layers' load-balancing loss summed, 0 without
    MoE).  ``ctx``: whisper's frame embeddings (B, n_frames, d) or the VLM's
    image embeddings (B, n_image_tokens, d).  A quantized ``policy`` runs
    the stack grid-resident on the matching :func:`quantize_params` tree.
    ``mode`` "fwd", or "train": the same numbers, with each layer group
    recomputed in the backward pass when ``cfg.remat`` is set and autograd
    records (see the module docstring)."""
    if mode not in ("fwd", "train"):
        raise ValueError(f"forward(mode={mode!r}): want 'fwd' or 'train'")
    remat = mode == "train" and bool(cfg.remat) and torch.is_grad_enabled()
    if mode == "train":  # an FSDP embedding gathered once for its lookup and a tied head
        params = {**params, "embed": sh.gather_fsdp(params["embed"])}
    s = tokens.shape[1]
    h = _embed_tokens(cfg, params, tokens)
    if cfg.abs_pos:
        h = _abs_pos(cfg, h, s)
    ctx = _context(tpl, cfg, params, ctx, remat=remat)
    pattern, _, _ = _split(cfg)
    positions = torch.arange(s, device=h.device)
    h, _, aux = _run_stack(tpl, cfg, params, h, pattern=pattern, mode=mode,
                           positions=positions, ctx=ctx, policy=policy, remat=remat)
    return _head(tpl, cfg, params, h, policy=policy), aux


def loss_fn(tpl: Template, cfg, params, batch, aux_weight: float = 0.01):
    """batch: {"tokens": (B, S) int [, "labels": (B, S), "ctx": (B, T, d)]}.

    Without labels, the next-token targets are the tokens shifted by one
    (the last position masked); labels < 0 are masked out.  The forward runs
    in ``mode="train"``.  Returns (scalar loss = ce + aux_weight * aux,
    {"ce", "aux"}).

    On a rank whose rows are a part of the logical batch (a training step
    under ``sharding.batch_split``) ce is this rank's ``sum(nll * mask)``
    over the mask count of the whole batch (summed over the batch axes, no
    gradient), and aux the MoE layers' sum over this rank's groups over the
    batch's group count: summed over the ranks, the loss and its gradients
    are the single-device ones.  Under sequence-parallel rules the logits
    are this rank's shard of the sequence: the labels are shifted on the
    whole token row, then cut to the same positions (a shard's last target
    is the next shard's first token), and the count is summed over the
    sequence's axes too (logits the drop rule kept whole count once a
    rank, each its share)."""
    tokens = batch["tokens"]
    logits, aux = forward(tpl, cfg, params, tokens, ctx=batch.get("ctx"), mode="train")
    labels = batch.get("labels")
    if labels is None:
        labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
    for d, axes, n in sh.shard_marks(logits):
        if d % logits.ndim == logits.ndim - 2:  # the sequence
            lo, hi = sh.local_rows(n, sh.active_mesh(), axes)
            labels = labels[:, lo:hi]
    mask = (labels >= 0).to(torch.float32)
    axes = sh.split_batch_axes() + sh.seq_parallel_axes()
    count = sh.psum(mask.sum(), axes) if axes else None
    ce = cross_entropy_loss(logits, torch.clamp(labels, min=0), mask, count=count)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


def prefill(tpl: Template, cfg, params, tokens, *, ctx=None,
            cache_len: Optional[int] = None, last_pos=None,
            policy: Optional[NumericsPolicy] = None):
    """Process the prompt (and ``ctx``, as :func:`forward`); return (logits
    (B, V) at ``last_pos`` — default the final position; a scalar or a (B,)
    vector — and the decode cache)."""
    s = tokens.shape[1]
    cache_len = cache_len or s
    h = _embed_tokens(cfg, params, tokens)
    if cfg.abs_pos:
        h = _abs_pos(cfg, h, s)
    ctx = _context(tpl, cfg, params, ctx)
    pattern, _, _ = _split(cfg)
    h, cache, _ = _run_stack(tpl, cfg, params, h, pattern=pattern, mode="prefill",
                             positions=torch.arange(s, device=h.device), ctx=ctx,
                             cache_len=cache_len, policy=policy)
    if last_pos is None:
        h_last = h[:, -1:]
    else:
        lp = torch.as_tensor(last_pos, device=h.device).to(torch.int64)
        lp = lp.expand(h.shape[0]) if lp.ndim == 0 else lp
        h_last = h[torch.arange(h.shape[0], device=h.device), lp][:, None]
    logits = _head(tpl, cfg, params, h_last, policy=policy)
    return logits[:, 0], cache


def decode_step(tpl: Template, cfg, params, token, t, cache,
                policy: Optional[NumericsPolicy] = None, *, inplace: bool = False):
    """One decode step.  token: (B, 1) int; t: the position, an int or a 0-d
    tensor shared by every row, or a (B,) tensor of per-row positions on a
    slot-indexed cache (``init_cache(per_slot=True)``; t[b] < 0 turns lane b
    off).  Returns (logits (B, V), new_cache); the cache passed in is left
    as it was, unless ``inplace`` (the caller gives it up: the step writes
    into it, recurrent states included, and returns it).  ``t`` stays on
    the device: nothing here reads it back to the host.  Under a quantized
    ``policy`` the step is grid-resident end to end."""
    t = decode_positions(t, token.device)
    h = _embed_tokens(cfg, params, token)
    if cfg.abs_pos:
        pe = _sinusoid_at(t.reshape(-1), cfg.d_model, h.dtype)  # (1 or B, d)
        h = h + pe[:, None]
    pattern, _, _ = _split(cfg)
    h, cache, _ = _run_stack(tpl, cfg, params, h, pattern=pattern, mode="decode",
                             positions=t, t=t, cache=cache, policy=policy, inplace=inplace)
    logits = _head(tpl, cfg, params, h, policy=policy)
    return logits[:, 0], cache


def prefill_chunk_step(tpl: Template, cfg, params, tokens, t, n_valid, cache,
                       policy: Optional[NumericsPolicy] = None, *, inplace: bool = False):
    """Advance a slot-indexed cache by one prefill chunk per row.

    tokens: (B, S) — row b holds the prompt slice at positions t[b] ..
    t[b]+n_valid[b]-1, right-padded to the chunk width S; t: (B,), t[b] < 0
    an inactive lane whose cache row stays byte for byte as it was;
    n_valid: (B,) real token counts.  Returns (logits (B, V) read at each
    row's last valid token — meaningful only for rows that finish their
    prompt with this chunk — and the cache, as :func:`decode_step` does).
    """
    dev = tokens.device
    t = decode_positions(t, dev).reshape(-1)
    nv = decode_positions(n_valid, dev).reshape(-1)
    s = tokens.shape[1]
    h = _embed_tokens(cfg, params, tokens)
    if cfg.abs_pos:
        h = h + _sinusoid_at(t[:, None] + torch.arange(s, device=dev), cfg.d_model, h.dtype)
    pattern, _, _ = _split(cfg)
    h, cache, _ = _run_stack(tpl, cfg, params, h, pattern=pattern, mode="decode",
                             positions=t, t=t, cache=cache, policy=policy, n_valid=nv,
                             inplace=inplace)
    last = torch.clamp(nv - 1, 0, s - 1)
    h_last = h[torch.arange(h.shape[0], device=dev), last][:, None]
    logits = _head(tpl, cfg, params, h_last, policy=policy)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# decode-cache construction and the scheduler's cache maintenance
# ---------------------------------------------------------------------------


def _ctx_len(cfg) -> int:
    if cfg.family == "encdec":
        return cfg.n_frames
    if cfg.family == "vlm":
        return cfg.n_image_tokens
    return 0


def _init_layer_cache(cfg, plan: LayerPlan, batch, cache_len, dtype, per_slot=False,
                      device="cpu"):
    c = {}
    if plan.mixer in ("attn", "local"):
        clen = (min(cfg.window, cache_len) if plan.mixer == "local" and cfg.window
                else cache_len)
        c["attn"] = init_layer_cache(batch, cfg.n_kv_heads, clen, cfg.head_dim, dtype,
                                     per_slot=per_slot, device=device)
    elif plan.mixer == "rec":
        c["rec"] = rec_mod.init_rglru_cache(cfg, batch, dtype, device=device)
    elif plan.mixer == "ssm":
        c["ssm"] = ssm_mod.init_ssm_cache(cfg, batch, dtype, device=device)
    if plan.cross:
        tctx = _ctx_len(cfg)
        cc = init_layer_cache(batch, cfg.n_kv_heads, tctx, cfg.head_dim, dtype,
                              device=device)
        cc["pos"] = torch.arange(tctx, dtype=torch.int32, device=device)  # as if prefilled
        c["cross"] = cc
    return c


def init_cache(cfg, batch: int, cache_len: int, dtype=None, *, per_slot: bool = False,
               policy=None, device="cpu"):
    """Zero decode cache with the prefill cache's structure: a k / v ring per
    attention layer (a sliding-window layer's of ``min(window, cache_len)``
    slots), an RG-LRU's state ``h`` (f32) and conv history, an SSD's state
    (f32) and conv history, a cross layer's context k / v (every position
    valid, as if prefilled).  ``per_slot`` builds the slot-indexed layout
    (each self-attention pos vector (B, C)) of the continuous-batching
    scheduler.  A quantized ``policy`` stores each group's k / v as its
    grid's raws (int16, or int8 on the int8 rung); an explicit ``dtype``
    overrides it."""
    pattern, g, r = _split(cfg)

    def group_dtype(name):
        if dtype is None and policy is not None and policy.quantized:
            return policy.fmt_for(name).storage_dtype
        return _dtype(dtype or cfg.dtype)

    def one(plan, name):
        return _init_layer_cache(cfg, plan, batch, cache_len, group_dtype(name),
                                 per_slot=per_slot, device=device)

    return {
        "blocks": tuple(_stack([one(p, f"g{i}")] * g) for i, p in enumerate(pattern)),
        "tail": tuple(one(pattern[j], f"tail{j}") for j in range(r)),
    }


def cache_axes(cfg, cache_shapes) -> dict:
    """Logical axes tree of a cache tree (mirrors :func:`init_cache`): the
    k / v rings (batch, kv_heads, seq, head_dim) shard (batch, seq_kv);
    pos vectors replicate.  Stacked leaves get a None prefix."""

    def by_name(name, stacked):
        pre = (None,) if stacked else ()
        if name in ("k", "v"):
            return pre + ("batch", None, "seq_kv", None)
        if name == "pos":
            return None
        if name == "h":
            return pre + ("batch", "rec")
        if name == "state":
            return pre + ("batch", "act_heads", None, None)
        if name == "conv":
            return pre + ("batch", None, "ssm_inner")
        return None

    def walk(tree, stacked):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out[k] = walk(v, stacked)
                elif isinstance(v, tuple):
                    out[k] = tuple(walk(x, stacked) for x in v)
                else:
                    out[k] = by_name(k, stacked)
            return out
        if isinstance(tree, tuple):
            return tuple(walk(x, stacked) for x in tree)
        return None

    return {"blocks": tuple(walk(b, True) for b in cache_shapes["blocks"]),
            "tail": tuple(walk(tc, False) for tc in cache_shapes["tail"])}


def _map_pos(tree, fn):
    """``tree`` with every self-attention "pos" leaf replaced by fn(pos)."""
    if isinstance(tree, dict):
        return {k: ({**v, "pos": fn(v["pos"])} if k == "attn" and isinstance(v, dict)
                    and "pos" in v else _map_pos(v, fn))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_pos(x, fn) for x in tree)
    return tree


def _map_leaves(fn, dst, src):
    """fn(dst_leaf, src_leaf) over two trees of the same structure."""
    if isinstance(dst, dict):
        return {k: _map_leaves(fn, dst[k], src[k]) for k in dst}
    if isinstance(dst, tuple):
        return tuple(_map_leaves(fn, d, s_) for d, s_ in zip(dst, src))
    return fn(dst, src)


def _map_rows(fn, dst, src):
    """:func:`_map_leaves` over the leaves that hold batch rows: a cross
    layer's "pos" (the context positions every row shares) keeps ``dst``'s."""
    if isinstance(dst, dict):
        return {k: ({**_map_rows(fn, {n: v for n, v in dst[k].items() if n != "pos"},
                                 src[k]), "pos": dst[k]["pos"]}
                    if k == "cross" else _map_rows(fn, dst[k], src[k]))
                for k in dst}
    if isinstance(dst, tuple):
        return tuple(_map_rows(fn, d, s_) for d, s_ in zip(dst, src))
    return fn(dst, src)


def copy_cache_(cache, new):
    """Copy every leaf of ``new`` into the same leaf of ``cache``, a cache of
    the same structure and shapes (an in-place update of the caller's
    tensors; a leaf the two share is left alone); returns ``cache``."""
    _map_leaves(lambda d, n: d if n is d else d.copy_(n), cache, new)
    return cache


def _device_of(tree) -> torch.device:
    while not isinstance(tree, torch.Tensor):
        tree = next(iter(tree.values() if isinstance(tree, dict) else tree))
    return tree.device


def _trim_cache_positions(cache_part, valid_len):
    """Invalidate self-attention cache entries at positions >= valid_len
    (pos := -1): a bucket-padded prefill filled ring slots for its pad
    positions, which must not become visible to decode."""
    return _map_pos(cache_part, lambda pos: torch.where(pos < valid_len, pos, -1))


def insert_cache_slot(cache, slot: int, row_cache, *, valid_len=None):
    """Write a batch-1 prefill cache into row ``slot`` of a batched cache.

    ``row_cache`` comes from a batch-1 :func:`prefill` with the cache's
    cache_len; ``valid_len`` (the real prompt length) invalidates the pad
    positions a bucket-padded prefill filled.  Leaves stack the batch at
    axis 1 under "blocks" and axis 0 under "tail"; a per-slot pos row, (C,)
    in the row cache and (B, C) batched, is told apart by its rank.  A
    recurrent state or conv history is a batched leaf like k / v; a cross
    layer's context positions are shared and stay as they are.
    Returns the new cache (the one passed in is left as it was)."""
    if valid_len is not None:
        row_cache = _trim_cache_positions(row_cache, valid_len)

    def ins(batch_axis):
        def put(dst, src):
            if src.ndim == dst.ndim:  # a batched leaf: drop its size-1 batch dim
                src = src.squeeze(batch_axis)
            out = dst.clone()
            out.select(batch_axis, slot).copy_(src.to(dst.dtype))
            return out
        return put

    return {"blocks": _map_rows(ins(1), cache["blocks"], row_cache["blocks"]),
            "tail": _map_rows(ins(0), cache["tail"], row_cache["tail"])}


def _as_index(x, device, dtype=torch.int64):
    return torch.as_tensor(x, device=device).to(dtype)


def insert_cache_rows(cache, rows_cache, *, src_rows, sel, valid_lens, inplace: bool = False):
    """Scatter rows of a batched (B_pre, L) prefill cache into cache slots.

    For every slot j with ``sel[j]``, source row ``src_rows[j]`` of
    ``rows_cache`` (same cache_len) is written into slot j and its pad
    positions >= ``valid_lens[j]`` invalidated (pos = -1); unselected slots
    keep their bytes.  ``src_rows`` / ``sel`` / ``valid_lens`` are
    (n_slots,) vectors (src_rows of unselected slots: any row in range).
    The prefill's shared pos, (C,) per group, is expanded per slot; a cross
    layer's context positions stay as they are.  Returns the new cache;
    ``inplace`` writes it into the tensors of ``cache``."""
    dev = _device_of(cache)
    src = _as_index(src_rows, dev)
    selb = _as_index(sel, dev, torch.bool)
    vl = _as_index(valid_lens, dev, torch.int32)
    n = selb.shape[0]

    def ins(batch_axis):
        def put(dst, src_leaf):
            if src_leaf.ndim < dst.ndim:
                # shared prefill pos (..., C) -> per-slot rows (..., n, C),
                # pad positions trimmed to each slot's real length
                pos = src_leaf.unsqueeze(-2)
                pos = torch.where(pos < vl[:, None], pos, -1)
                return torch.where(selb[:, None], pos, dst)
            gathered = src_leaf.index_select(batch_axis, src)
            shape = [1] * dst.ndim
            shape[batch_axis] = n
            return torch.where(selb.reshape(shape), gathered.to(dst.dtype), dst)
        return put

    new = {"blocks": _map_rows(ins(1), cache["blocks"], rows_cache["blocks"]),
           "tail": _map_rows(ins(0), cache["tail"], rows_cache["tail"])}
    return copy_cache_(cache, new) if inplace else new


def clear_cache_rows(cache, sel, *, inplace: bool = False):
    """Invalidate the self-attention pos rows of the selected slots (pos :=
    -1), before chunked admission streams a prompt into a slot that still
    holds its previous occupant's entries; k / v bytes are left as they are
    (pos = -1 hides them).  ``sel``: (n_slots,) bool.  Returns the new
    cache; ``inplace`` writes it into the tensors of ``cache``."""
    selb = _as_index(sel, _device_of(cache), torch.bool)
    new = _map_pos(cache, lambda pos: torch.where(selb[:, None], -1, pos))
    return copy_cache_(cache, new) if inplace else new
