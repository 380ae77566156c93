"""Per-layer precision drift sweep + end-to-end fixed-point drift and bytes.

    PYTHONPATH=src python -m repro_torch.benchmarks.precision_drift --device cpu
        [--out precision_drift.json] [--assert-agreement 0.99] [--budget 0.99]

The port's copy of the reference's ``benchmarks/precision_drift.py`` (and
of ``q16_drift``, its alias: :mod:`repro_torch.benchmarks.q16_drift`):

  * the q16 end-to-end rows: the grid-resident LeNet and reduced qwen2-0.5b
    against their float forwards (argmax agreement, logit error), the
    island counts (one quantize and one dequantize a LeNet forward), and the
    structural activation bytes of the q16 and float paths;
  * solo-flip drift rows: for every layer (LeNet) / scan group (reduced
    transformer), the network run with only that layer's activations on the
    int8 rung of the calibrated grid, its argmax agreement with the float
    reference.  The ``drift`` mapping is the dict
    ``calibrate_cnn_precision`` / ``calibrate_precision`` take as
    ``drift=``;
  * the chosen mixed plan, the cheapest grid per layer meeting the budget,
    and its structural activation bytes: an int8 layer moves exactly half
    the q16 bytes (1 against 2 bytes an element).

Drift is measured teacher-forced (per-position logits under identical
inputs).  Bytes are structural: activations crossing the compute unit
between layers plus KV-cache traffic, at 2 bytes (int16) / 1 byte (int8)
against 4 (f32); float islands and the final logits are not counted.

The reference's ``xla`` float template is the port's ``torch`` template;
``q16`` stays ``q16``; both on ``--device`` (the card unless ``cpu``).  The
draws come from the port's own generators through :func:`lenet_params`,
:func:`lenet_images`, :func:`transformer_params` and :func:`tokens`, which a
caller may replace to feed other draws in.
"""
from __future__ import annotations

import argparse
import json

import torch


def _agreement(lf, lq) -> dict:
    lf, lq = lf.float(), lq.float()
    return {
        "logit_mae": float((lf - lq).abs().mean()),
        "logit_max_err": float((lf - lq).abs().max()),
        "argmax_agreement": float(
            (torch.argmax(lf, -1) == torch.argmax(lq, -1)).float().mean()),
    }


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------


def lenet_params(seed: int, device):
    """LeNet's float weights (scale 0.4), drawn from ``seed``."""
    from repro_torch.models.cnn import LENET, init_cnn

    return init_cnn(torch.Generator().manual_seed(seed), LENET, scale=0.4, device=device)


def lenet_images(seed: int, step: int, batch: int, device) -> torch.Tensor:
    """One batch of LeNet-shaped synthetic images (``data/pipeline.py``)."""
    from repro_torch.data.pipeline import synthetic_images
    from repro_torch.models.cnn import LENET

    return synthetic_images(seed, step, batch, LENET.input_hw, LENET.input_ch,
                            LENET.n_classes, device=device)[0]


def transformer_params(seed: int, cfg, device):
    """A transformer's float weights, drawn from ``seed``."""
    from repro_torch.models import transformer as T

    return T.init_params(torch.Generator(device=device).manual_seed(seed), cfg)


def tokens(seed: int, shape: tuple, vocab: int, device) -> torch.Tensor:
    """Token ids in [0, vocab), drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen).to(device)


# ---------------------------------------------------------------------------
# structural bytes (per token / per sample activations crossing the unit)
# ---------------------------------------------------------------------------


def _transformer_decode_elements(cfg, cache_len: int) -> tuple:
    """(per-layer activation, per-layer KV, head) elements one decode token
    moves through the compute unit: the layer-count-free building block
    shared by the uniform and mixed byte accountings."""
    d = cfg.d_model
    qh = cfg.eff_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    ff = cfg.d_ff
    gates = 2 if cfg.act == "swiglu" else 1
    per_layer_act = (
        d              # quantized attention input (shared by q/k/v)
        + qh + 2 * kv  # q/k/v projection outputs
        + qh + d       # wo input + output
        + d            # quantized FFN input
        + gates * ff   # up (+gate) outputs
        + ff + d       # down input + output
    )
    per_layer_kv = 2 * cache_len * kv + 2 * kv  # read k+v rings, write new row
    head = d  # quantized post-final-norm hidden into the LM head
    return per_layer_act, per_layer_kv, head


def transformer_decode_bytes(cfg, cache_len: int, *, act_bytes: int,
                             kv_bytes: int) -> int:
    """Activation + KV bytes one decode token moves through the compute unit:
    the tensors entering / leaving GEMMs between layers and the ring cache's
    read / write; not the weights (the same on both paths), float-island
    internals (f32 on both paths) or the logits (model output)."""
    per_layer_act, per_layer_kv, head = _transformer_decode_elements(cfg, cache_len)
    return cfg.n_layers * (per_layer_act * act_bytes + per_layer_kv * kv_bytes) \
        + head * act_bytes


def transformer_decode_bytes_mixed(cfg, cache_len: int, policy) -> int:
    """Per-token decode bytes under a mixed per-group precision plan: each
    scan group's layers (and its slice of the KV cache) move bytes at that
    group's grid width, 1 byte on the int8 rung, 2 on int16."""
    from repro_torch.models import transformer as T

    per_layer_act, per_layer_kv, head = _transformer_decode_elements(cfg, cache_len)
    pattern, g, r = T._split(cfg)

    def group_bytes(name, n_layers):
        width = policy.fmt_for(name).total_bits // 8
        return n_layers * (per_layer_act + per_layer_kv) * width

    total = sum(group_bytes(f"g{i}", g) for i in range(len(pattern)))
    total += sum(group_bytes(f"tail{j}", 1) for j in range(r))
    return total + head * (policy.fmt_for("head").total_bits // 8)


def lenet_activation_elements(spec) -> dict:
    """Per-grid activation elements of the CNN, keyed by layer name.

    ``fmt_for(L)`` is layer L's *input* activation grid, so layer L-1's
    output (and its pooled map, on the same grid) count for layer L.  The
    classifier's output (the exact int32 read-out) is not counted.
    """
    from repro_torch.models.cnn import cnn_layer_names

    names = cnn_layer_names(spec)
    el = {n: 0 for n in names}
    hw = spec.input_hw
    el[names[0]] += hw * hw * spec.input_ch  # quantized input
    for i, (cout, k, stride, pad, pool) in enumerate(spec.convs):
        hw = (hw + 2 * pad - k) // stride + 1
        el[names[i + 1]] += hw * hw * cout  # conv output (ReLU fused)
        if pool:
            hw //= pool
            el[names[i + 1]] += hw * hw * cout  # pooled map, same grid
    nc = len(spec.convs)
    for i, wd in enumerate(spec.fcs):
        el[names[nc + i + 1]] += wd
    return el


def lenet_activation_bytes(spec, *, act_bytes: int) -> int:
    """Per-sample activation bytes crossing the unit at a uniform width."""
    return sum(lenet_activation_elements(spec).values()) * act_bytes


def lenet_activation_bytes_mixed(spec, policy) -> int:
    """Per-sample activation bytes under a mixed per-layer precision plan."""
    return sum(el * (policy.fmt_for(name).total_bits // 8)
               for name, el in lenet_activation_elements(spec).items())


# ---------------------------------------------------------------------------
# drift rows (the q16 end-to-end rows)
# ---------------------------------------------------------------------------


def lenet_row(seed: int = 0, batches: int = 4, device="cuda") -> dict:
    from repro_torch.core.template import default_template
    from repro_torch.models.cnn import (
        LENET, calibrate_cnn_policy, cnn_forward, quantize_cnn_params,
    )

    params = lenet_params(seed, device)
    tpl_f = default_template("torch", device=device)
    tpl_q = default_template("q16", device=device)
    policy = calibrate_cnn_policy(tpl_q, LENET, params, lenet_images(7, 0, 8, device))
    qp = quantize_cnn_params(tpl_q, LENET, params, policy)

    eng = tpl_q.engine
    q0, d0 = eng.counters["quantize_calls"], eng.counters["dequantize_calls"]
    lf, lq = [], []
    with torch.no_grad():
        for b in range(batches):
            img = lenet_images(99, 1000 + b, 16, device)
            lf.append(cnn_forward(tpl_f, LENET, params, img))
            lq.append(cnn_forward(tpl_q, LENET, qp, img, policy=policy))
    row = {
        "bench": "q16_drift_lenet",
        "activation_fmt": policy.fmt.name,
        "batches": batches,
        **_agreement(torch.cat(lf), torch.cat(lq)),
        "quantize_calls": eng.counters["quantize_calls"] - q0,
        "dequantize_calls": eng.counters["dequantize_calls"] - d0,
        "act_bytes_float": lenet_activation_bytes(LENET, act_bytes=4),
        "act_bytes_q16": lenet_activation_bytes(LENET, act_bytes=2),
    }
    row["bytes_ratio"] = round(row["act_bytes_q16"] / row["act_bytes_float"], 3)
    return row


def transformer_row(seed: int = 0, arch: str = "qwen2-0.5b", device="cuda") -> dict:
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.template import default_template
    from repro_torch.models import transformer as T

    cfg = reduced(get_config(arch))
    params = transformer_params(seed, cfg, device)
    tpl_f = default_template("torch", device=device)
    tpl_q = default_template("q16", device=device)
    policy = T.calibrate_policy(tpl_q, cfg, params, tokens(seed + 9, (2, 16), cfg.vocab,
                                                           device))
    qp = T.quantize_params(tpl_q, cfg, params, policy)

    # teacher-forced per-position drift on a fixed seed set
    toks = tokens(seed + 1, (4, 32), cfg.vocab, device)
    with torch.no_grad():
        lf, _ = T.forward(tpl_f, cfg, params, toks, mode="fwd")
        lq, _ = T.forward(tpl_q, cfg, qp, toks, mode="fwd", policy=policy)

    cache_len = 48
    return {
        "bench": "q16_drift_transformer",
        "arch": cfg.name,
        "activation_fmt": policy.fmt.name,
        "positions": toks.numel(),
        **_agreement(lf, lq),
        "per_token_bytes_float": transformer_decode_bytes(
            cfg, cache_len, act_bytes=4, kv_bytes=4),
        "per_token_bytes_q16": transformer_decode_bytes(
            cfg, cache_len, act_bytes=2, kv_bytes=2),
    }


# ---------------------------------------------------------------------------
# per-layer solo-flip precision sweep (the DSE's measurement side)
# ---------------------------------------------------------------------------


_QAT_CACHE: dict = {}


def train_lenet_qat(seed: int = 0, float_steps: int = 60, qat_steps: int = 30,
                    device="cuda"):
    """The QAT clamp recipe of ``examples/train_lenet_q214.py`` in miniature.

    Phase 1 trains float on the ``torch`` template; phase 2 fine-tunes with
    fake-quant Q2.14 (the straight-through estimator), whose saturating
    clamp trains the activations into the grid's [-2, 2) range, the recipe
    that makes a *deployed* fixed-point network agree with its float
    reference.  Memoized by (seed, steps, device): the kernel table's gate
    and this module's sweep measure the same network.
    """
    key = (seed, float_steps, qat_steps, str(device))
    if key in _QAT_CACHE:
        return _QAT_CACHE[key]
    from repro_torch.core.template import default_template
    from repro_torch.data.pipeline import synthetic_images
    from repro_torch.models.cnn import LENET, cnn_forward
    from repro_torch.optim import AdamW, adamw_init, adamw_update
    from repro_torch.optim.tree import tree_flatten, tree_unflatten

    tpl = default_template("torch", device=device)
    params = lenet_params(seed, device)
    opt = AdamW(lr=3e-3, weight_decay=0.0)
    opt_state = adamw_init(params)
    for step in range(float_steps + qat_steps):
        img, lab = synthetic_images(0, step, 32, LENET.input_hw, LENET.input_ch,
                                    LENET.n_classes, device=device)
        leaves, treedef = tree_flatten(params)
        live = [t.detach().requires_grad_(True) for t in leaves]
        logits = cnn_forward(tpl, LENET, tree_unflatten(treedef, live), img,
                             quantized=step >= float_steps)
        onehot = torch.nn.functional.one_hot(lab, LENET.n_classes).to(torch.float32)
        loss = -(onehot * torch.log_softmax(logits.to(torch.float32), -1)).sum(-1).mean()
        grads = tree_unflatten(treedef, torch.autograd.grad(loss, live))
        params, opt_state, _ = adamw_update(opt, grads, opt_state, params)
    _QAT_CACHE[key] = params
    return params


def lenet_precision_sweep(seed: int = 0, budget: float = 0.99, device="cuda",
                          ref=None) -> dict:
    """Solo-flip drift per LeNet layer + the chosen mixed int8/int16 plan.

    Measures the QAT-trained LeNet (:func:`train_lenet_qat`): the clamp
    recipe holds its activations inside the grid, so the int8 rung has
    headroom and layers drop.  The reference predictions are the argmax of
    the *fake-quant* float forward (the clamp is part of the trained model);
    ``ref`` replaces them.  The sweep runs inside ``calibrate_cnn_precision``,
    which pins every layer's choice in the plan registry (a second sweep
    replays the pins with no forward); this row reads the pins back and
    evaluates the composed mixed plan on the measurement batches.
    """
    from repro_torch.core.template import default_template
    from repro_torch.models.cnn import (
        LENET, calibrate_cnn_policy, calibrate_cnn_precision, cnn_forward,
        cnn_layer_names, quantize_cnn_params,
    )

    params = train_lenet_qat(seed, device=device)
    tpl_f = default_template("torch", device=device)
    tpl_q = default_template("q16", device=device)
    policy = calibrate_cnn_policy(tpl_q, LENET, params, lenet_images(7, 0, 16, device))
    # the DSE measurement set, on which the row's agreement is evaluated too
    # (the budget is a guarantee on this set)
    meas = torch.cat([lenet_images(99, 1000 + b, 16, device) for b in range(4)])
    with torch.no_grad():
        ref_logits = cnn_forward(tpl_f, LENET, params, meas, quantized=True)
    if ref is None:
        ref = torch.argmax(ref_logits, dim=-1)
    mixed = calibrate_cnn_precision(tpl_q, LENET, params, meas, budget=budget,
                                    policy=policy, ref=ref)

    reg, hw = tpl_q.engine.plan_cache, tpl_q.config.hw
    drift, plan = {}, {}
    for name in cnn_layer_names(LENET):
        pin = reg.precision_for(LENET.name, name, hw)
        drift[name] = pin.drift
        plan[name] = pin.fmt.name

    qp = quantize_cnn_params(tpl_q, LENET, params, mixed)
    mixed_logits = cnn_forward(tpl_q, LENET, qp, meas, policy=mixed)

    el = lenet_activation_elements(LENET)
    int8_layers = [n for n, f in mixed.layer_fmts if f.total_bits == 8]
    row = {
        "bench": "precision_dse_lenet",
        "net": LENET.name,
        "budget": budget,
        "base_fmt": policy.fmt.name,
        "drift": drift,          # feed back via calibrate_cnn_precision(drift=)
        "plan": plan,
        "int8_layers": sorted(int8_layers),
        **_agreement(ref_logits, mixed_logits),
        "act_bytes_q16": lenet_activation_bytes(LENET, act_bytes=2),
        "act_bytes_mixed": lenet_activation_bytes_mixed(LENET, mixed),
        "int8_layer_bytes_q16": {n: 2 * el[n] for n in int8_layers},
        "int8_layer_bytes_mixed": {n: el[n] for n in int8_layers},
    }
    row["bytes_saved"] = row["act_bytes_q16"] - row["act_bytes_mixed"]
    return row


def transformer_precision_sweep(seed: int = 0, budget: float = 0.99,
                                arch: str = "qwen2-0.5b", device="cuda",
                                ref=None) -> dict:
    """Solo-flip drift per transformer scan group + the chosen mixed plan;
    ``ref`` replaces the calibrator's own reference predictions."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.template import default_template
    from repro_torch.models import transformer as T

    cfg = reduced(get_config(arch))
    params = transformer_params(seed, cfg, device)
    tpl_f = default_template("torch", device=device)
    tpl_q = default_template("q16", device=device)
    policy = T.calibrate_policy(tpl_q, cfg, params, tokens(seed + 9, (2, 16), cfg.vocab,
                                                           device))
    # the DSE measures on the teacher-forced position set the row's agreement
    # is evaluated on (the budget is a guarantee on this set)
    meas = tokens(seed + 1, (4, 32), cfg.vocab, device)
    mixed = T.calibrate_precision(tpl_q, cfg, params, meas, budget=budget, policy=policy,
                                  ref=ref)

    reg, hw = tpl_q.engine.plan_cache, tpl_q.config.hw
    drift, plan = {}, {}
    for name in T.precision_group_names(cfg):
        pin = reg.precision_for(cfg.name, name, hw)
        drift[name] = pin.drift
        plan[name] = pin.fmt.name

    qp = T.quantize_params(tpl_q, cfg, params, mixed)
    with torch.no_grad():
        lf, _ = T.forward(tpl_f, cfg, params, meas, mode="fwd")
        lq, _ = T.forward(tpl_q, cfg, qp, meas, mode="fwd", policy=mixed)

    cache_len = 48
    int8_groups = [n for n, f in mixed.layer_fmts if f.total_bits == 8]
    return {
        "bench": "precision_dse_transformer",
        "net": cfg.name,
        "budget": budget,
        "base_fmt": policy.fmt.name,
        "drift": drift,       # feed back via T.calibrate_precision(drift=)
        "plan": plan,
        "int8_groups": sorted(int8_groups),
        **_agreement(lf, lq),
        "per_token_bytes_q16": transformer_decode_bytes(
            cfg, cache_len, act_bytes=2, kv_bytes=2),
        "per_token_bytes_mixed": transformer_decode_bytes_mixed(cfg, cache_len, mixed),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    ap.add_argument("--assert-agreement", type=float, default=None,
                    help="fail unless argmax agreement >= this on every row")
    ap.add_argument("--budget", type=float, default=0.99,
                    help="precision-DSE accuracy budget (min solo-flip "
                         "argmax agreement to drop a layer to int8)")
    ap.add_argument("--device", default="cuda",
                    help="where it runs: 'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = args.device

    print("== q16 end-to-end drift (grid-resident QTensor path) ==")
    rows = [lenet_row(device=dev), transformer_row(device=dev)]
    for row in rows:
        print(json.dumps(row))
    lenet, tfm = rows
    assert lenet["quantize_calls"] == lenet["batches"], (
        "LeNet must quantize exactly once per forward (the input)")
    assert lenet["dequantize_calls"] == lenet["batches"], (
        "LeNet must dequantize exactly once per forward (the classifier)")
    ratio = tfm["per_token_bytes_q16"] / tfm["per_token_bytes_float"]
    assert ratio <= 0.5, f"q16 per-token bytes ratio {ratio} > 0.5"
    assert lenet["bytes_ratio"] <= 0.5

    print("\n== per-layer precision DSE sweep (solo-flip drift) ==")
    sweeps = [lenet_precision_sweep(budget=args.budget, device=dev),
              transformer_precision_sweep(budget=args.budget, device=dev)]
    for row in sweeps:
        print(json.dumps(row))
    lsw = sweeps[0]
    assert lsw["int8_layers"], (
        "the QAT-trained LeNet must drop at least one layer to the int8 rung "
        "- the clamp recipe trains its activations into the grid")
    # the structural half-bytes law: every int8-chosen layer moves exactly
    # half the q16 bytes, and the network totals agree with the per-layer sum
    for n in lsw["int8_layers"]:
        assert lsw["int8_layer_bytes_mixed"][n] * 2 == lsw["int8_layer_bytes_q16"][n]
    assert lsw["act_bytes_q16"] - lsw["bytes_saved"] == lsw["act_bytes_mixed"]
    for row in sweeps:
        assert row["plan"], "the DSE must record a choice for every layer"
        assert all(v is None or 0.0 <= v <= 1.0 for v in row["drift"].values())
    rows += sweeps
    print("precision gates OK: one quantize / one dequantize a LeNet forward, q16 bytes "
          "<= 0.5x float, an int8 layer at exactly half the bytes")

    if args.assert_agreement is not None:
        for row in rows:
            if row["argmax_agreement"] < args.assert_agreement:
                raise SystemExit(
                    f"{row['bench']}: argmax agreement "
                    f"{row['argmax_agreement']:.4f} < {args.assert_agreement}")
        print(f"argmax agreement gate OK (>= {args.assert_agreement})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
