"""The transformer LM, dense family, in the port.

The port's copy of ``repro.models.transformer`` for the dense GQA stack
(qwen2-0.5b and its relatives): every layer is attention followed by an
MLP, each behind a pre-norm with a residual add.  The parameter tree keeps
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

The other families (MoE, recurrent, SSM, cross-attention, encoder-decoder,
VLM) raise ``NotImplementedError`` (ROADMAP queue 1 item 6).

Sharding: :func:`param_axes` and :func:`cache_axes` name each leaf's logical
axes, and the layers pass the reference's ``constrain`` seams
(``parallel.sharding``).  On a rank of a column-parallel mesh
(``DECODE_RULES``) the entry points return whole logits: a vocab-sharded
head's output is gathered before it is read.
:func:`calibrate_precision` is the drift-aware precision DSE over the
precision groups (:func:`precision_group_names`): a group on the int8 rung
gets int8 weights and an int8 KV cache.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import dse
from repro_torch.core.engine import validate_policy
from repro_torch.core.quantization import NumericsPolicy, QTensor, int8_rung
from repro_torch.core.template import Template
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import constrain

from .attention import (
    attention,
    attention_axes,
    attention_islands,
    decode_attention,
    decode_positions,
    init_attention,
    init_layer_cache,
)
from .layers import init_mlp, init_norm, mlp, mlp_axes, mlp_islands, norm

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
    "prefill",
    "decode_step",
    "prefill_chunk_step",
    "init_cache",
    "insert_cache_slot",
    "insert_cache_rows",
    "clear_cache_rows",
    "copy_cache_",
]

_NOT_PORTED = "ROADMAP queue 1 item 6: the other model families"


class LayerPlan(NamedTuple):
    mixer: str  # "attn" (the dense family's only mixer in the port)
    cross: bool  # followed by a cross-attention sub-layer
    moe: bool  # FFN is a mixture of experts


def plan_pattern(cfg) -> tuple:
    """One pattern period of layer plans (dense: one full-attention layer)."""
    if cfg.family != "dense" or cfg.abs_pos:
        what = (f"the {cfg.family!r} family" if cfg.family != "dense"
                else "absolute sinusoidal positions")
        raise NotImplementedError(f"{cfg.name}: {what} not ported yet ({_NOT_PORTED})")
    return (LayerPlan("attn", False, False),)


def _split(cfg):
    pattern = plan_pattern(cfg)
    period = len(pattern)
    return pattern, cfg.n_layers // period, cfg.n_layers % period


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def _init_layer(gen, cfg, plan: LayerPlan, dtype, lead: tuple = ()):
    return {
        "norm": init_norm(cfg, dtype, device=gen.device, lead=lead),
        "attn": init_attention(gen, cfg, dtype=dtype, lead=lead),
        "ffn_norm": init_norm(cfg, dtype, device=gen.device, lead=lead),
        "ffn": init_mlp(gen, cfg, dtype=dtype, lead=lead),
    }


def init_params(gen: torch.Generator, cfg, dtype=None):
    """Random parameters in the config's dtype, drawn from ``gen`` on its own
    device; the reference's initializers and scales, not its numbers."""
    dtype = _dtype(dtype or cfg.dtype)
    pattern, g, r = _split(cfg)
    d, v = cfg.d_model, cfg.vocab
    dev = gen.device

    def table(shape):
        return (torch.randn(shape, generator=gen, device=dev) * d ** -0.5).to(dtype)

    params = {"embed": table((v, d)), "final_norm": init_norm(cfg, dtype, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": table((d, v))}
    params["blocks"] = tuple(_init_layer(gen, cfg, p, dtype, lead=(g,)) for p in pattern)
    params["tail"] = tuple(_init_layer(gen, cfg, pattern[j], dtype) for j in range(r))
    return params


def _layer_axes(cfg, plan: LayerPlan) -> dict:
    return {"norm": None, "attn": attention_axes(cfg), "ffn_norm": None,
            "ffn": mlp_axes(cfg)}


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
    return ax


def _at(tree, j: int):
    """Layer ``j`` of a stacked tree (a shard keeps its marks)."""
    if isinstance(tree, dict):
        return {k: _at(v, j) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return sh.carry_marks(tree, QTensor(tree.raw[j], tree.fmt))
    return sh.carry_marks(tree, tree[j])


def _stack(trees: list):
    """The stacked tree of per-layer trees (inverse of :func:`_at`)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


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
    _split(cfg)  # the dense family only
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


def _run_layer(tpl, cfg, plan: LayerPlan, p, h, *, positions, mode, cache=None,
               cache_len: int = 0, t=None, policy=None, n_valid=None, inplace=False):
    """Returns (h, new_cache_or_None)."""
    newc = {}
    a_in = norm(cfg, p["norm"], h)
    if mode == "decode":
        out, c = decode_attention(tpl, p["attn"], a_in, cache["attn"], cfg=cfg, t=t,
                                  policy=policy, n_valid=n_valid, inplace=inplace)
        newc["attn"] = c
    else:
        a_in = constrain(a_in, "batch", "seq_act", "act_embed")
        out, c = attention(tpl, p["attn"], a_in, cfg=cfg, positions=positions,
                           cache_len=cache_len if mode == "prefill" else 0,
                           policy=policy)
        if mode == "prefill":
            newc["attn"] = c
        out = constrain(out, "batch", "seq_act", "act_embed")
    h = h + out
    f_in = norm(cfg, p["ffn_norm"], h)
    if mode != "decode":
        f_in = constrain(f_in, "batch", "seq_act", "act_embed")
    out = mlp(tpl, cfg, p["ffn"], f_in, policy=policy)
    if mode != "decode":
        out = constrain(out, "batch", "seq_act", "act_embed")
    h = constrain(h + out, "batch", "seq_act", "act_embed")
    return h, (newc or None)


def _run_stack(tpl, cfg, params, h, *, pattern, mode, positions, cache=None,
               cache_len: int = 0, t=None, policy=None, n_valid=None, inplace=False):
    """Run the stacked groups layer by layer (layer j of every pattern
    position in turn, as the reference's scan does), then the tail layers.
    Returns (h, cache' or None); with ``inplace`` a decode writes into the
    cache passed in (each layer's rings are views of its stacked leaves)
    and returns it."""
    blocks = params["blocks"]
    depth = _depth(blocks[0]) if blocks else 0
    block_caches = [[] for _ in pattern]
    for j in range(depth):
        for i, plan in enumerate(pattern):
            c = None if cache is None else _at(cache["blocks"][i], j)
            h, c = _run_layer(tpl, cfg, plan, _at(blocks[i], j), h, positions=positions,
                              mode=mode, cache=c, cache_len=cache_len, t=t,
                              policy=_group_policy(policy, f"g{i}"), n_valid=n_valid,
                              inplace=inplace)
            block_caches[i].append(c)
    tail_caches = []
    for j, lp in enumerate(params["tail"]):
        c = None if cache is None else cache["tail"][j]
        h, c = _run_layer(tpl, cfg, pattern[j], lp, h, positions=positions, mode=mode,
                          cache=c, cache_len=cache_len, t=t,
                          policy=_group_policy(policy, f"tail{j}"), n_valid=n_valid,
                          inplace=inplace)
        tail_caches.append(c)
    if mode not in ("prefill", "decode"):
        return h, None
    if inplace:
        return h, cache
    return h, {"blocks": tuple(_stack(cs) for cs in block_caches),
               "tail": tuple(tail_caches)}


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _embed_tokens(cfg, params, tokens):
    return constrain(params["embed"][tokens], "batch", "seq_act", "act_embed")


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
        # kernel reads it in place
        w = params["embed"].T if cfg.tie_embeddings else head
        logits = tpl.matmul(h, w)
    # a vocab-sharded head's logits stay sharded at the seam; the entry
    # points gather them whole before they are read
    return sh.replicated(constrain(logits, "batch", "seq_act", "vocab"))


def _no_ctx(ctx) -> None:
    if ctx is not None:
        raise NotImplementedError(f"context inputs (encoder frames, image embeddings) "
                                  f"are not ported yet ({_NOT_PORTED})")


def forward(tpl: Template, cfg, params, tokens, *, ctx=None,
            policy: Optional[NumericsPolicy] = None):
    """Teacher-forced full-sequence forward.  tokens: (B, S) -> (logits
    (B, S, V), aux).  A quantized ``policy`` runs the stack grid-resident on
    the matching :func:`quantize_params` tree; aux is 0 (no MoE).  The
    reference's ``mode`` (train / fwd) has no counterpart: the port does
    not train yet."""
    _no_ctx(ctx)
    s = tokens.shape[1]
    h = _embed_tokens(cfg, params, tokens)
    pattern, _, _ = _split(cfg)
    positions = torch.arange(s, device=h.device)
    h, _ = _run_stack(tpl, cfg, params, h, pattern=pattern, mode="fwd",
                      positions=positions, policy=policy)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _head(tpl, cfg, params, h, policy=policy), aux


def prefill(tpl: Template, cfg, params, tokens, *, ctx=None,
            cache_len: Optional[int] = None, last_pos=None,
            policy: Optional[NumericsPolicy] = None):
    """Process the prompt; return (logits (B, V) at ``last_pos`` — default
    the final position; a scalar or a (B,) vector — and the decode cache)."""
    _no_ctx(ctx)
    s = tokens.shape[1]
    cache_len = cache_len or s
    h = _embed_tokens(cfg, params, tokens)
    pattern, _, _ = _split(cfg)
    h, cache = _run_stack(tpl, cfg, params, h, pattern=pattern, mode="prefill",
                          positions=torch.arange(s, device=h.device), cache_len=cache_len,
                          policy=policy)
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
    into it and returns it).  ``t`` stays on the device: nothing here reads
    it back to the host.  Under a quantized ``policy`` the step is
    grid-resident end to end."""
    t = decode_positions(t, token.device)
    h = _embed_tokens(cfg, params, token)
    pattern, _, _ = _split(cfg)
    h, cache = _run_stack(tpl, cfg, params, h, pattern=pattern, mode="decode",
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
    pattern, _, _ = _split(cfg)
    h, cache = _run_stack(tpl, cfg, params, h, pattern=pattern, mode="decode",
                          positions=t, t=t, cache=cache, policy=policy, n_valid=nv,
                          inplace=inplace)
    last = torch.clamp(nv - 1, 0, s - 1)
    h_last = h[torch.arange(h.shape[0], device=dev), last][:, None]
    logits = _head(tpl, cfg, params, h_last, policy=policy)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# decode-cache construction and the scheduler's cache maintenance
# ---------------------------------------------------------------------------


def _init_layer_cache(cfg, plan: LayerPlan, batch, cache_len, dtype, per_slot=False,
                      device="cpu"):
    return {"attn": init_layer_cache(batch, cfg.n_kv_heads, cache_len, cfg.head_dim, dtype,
                                     per_slot=per_slot, device=device)}


def init_cache(cfg, batch: int, cache_len: int, dtype=None, *, per_slot: bool = False,
               policy=None, device="cpu"):
    """Zero decode cache with the prefill cache's structure.  ``per_slot``
    builds the slot-indexed layout (each self-attention pos vector (B, C))
    of the continuous-batching scheduler.  A quantized ``policy`` stores
    each group's k / v as its grid's raws (int16, or int8 on the int8
    rung); an explicit ``dtype`` overrides it."""
    pattern, g, r = _split(cfg)

    def group_dtype(name):
        if dtype is None and policy is not None and policy.quantized:
            return policy.fmt_for(name).storage_dtype
        return _dtype(dtype or cfg.dtype)

    def stacked(plan, name):
        one = _init_layer_cache(cfg, plan, batch, cache_len, group_dtype(name),
                                per_slot=per_slot, device=device)
        return _stack([one] * g)

    return {
        "blocks": tuple(stacked(p, f"g{i}") for i, p in enumerate(pattern)),
        "tail": tuple(_init_layer_cache(cfg, pattern[j], batch, cache_len,
                                        group_dtype(f"tail{j}"), per_slot=per_slot,
                                        device=device)
                      for j in range(r)),
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
    in the row cache and (B, C) batched, is told apart by its rank.
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

    return {"blocks": _map_leaves(ins(1), cache["blocks"], row_cache["blocks"]),
            "tail": _map_leaves(ins(0), cache["tail"], row_cache["tail"])}


def _as_index(x, device, dtype=torch.int64):
    return torch.as_tensor(x, device=device).to(dtype)


def insert_cache_rows(cache, rows_cache, *, src_rows, sel, valid_lens, inplace: bool = False):
    """Scatter rows of a batched (B_pre, L) prefill cache into cache slots.

    For every slot j with ``sel[j]``, source row ``src_rows[j]`` of
    ``rows_cache`` (same cache_len) is written into slot j and its pad
    positions >= ``valid_lens[j]`` invalidated (pos = -1); unselected slots
    keep their bytes.  ``src_rows`` / ``sel`` / ``valid_lens`` are
    (n_slots,) vectors (src_rows of unselected slots: any row in range).
    The prefill's shared pos, (C,) per group, is expanded per slot.  Returns
    the new cache; ``inplace`` writes it into the tensors of ``cache``."""
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

    new = {"blocks": _map_leaves(ins(1), cache["blocks"], rows_cache["blocks"]),
           "tail": _map_leaves(ins(0), cache["tail"], rows_cache["tail"])}
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
