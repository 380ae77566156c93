"""The port's train step beyond one plain gradient: gradient accumulation,
rematerialization, the chunked attention route's gradients, the STE of
fake quantization and the LeNet's (float and QAT) gradients, and the
templates the step refuses.

Against the JAX package where it has the same function: the chunked
route's loss and gradients against the reference's ``_sdpa_chunked`` (both
packages' ``CHUNKED_THRESHOLD`` / ``_BQ`` / ``_BK`` monkeypatched, as
``tests/test_torch_transformer.py`` does), ``fake_quant_fmt``'s gradient and
the LeNet's loss and gradients on the reference's ``xla`` backend, from the
same numpy weights and images: loss within 1e-5 relative, each gradient
leaf within 1e-4 of its largest |g| (the QAT LeNet's within 1e-3: an
activation whose f32 value sits within an ulp of a rounding boundary of the
Q2.14 grid lands one grid step, 2^-14, apart in the two packages, and the
classifier's weight gradient reads those activations directly); the STE
bit for bit.  The port
against itself: ``accum=2`` within 5e-3 of ``accum=1`` after one step (the
reference's own bound, ``tests/test_optim_data.py``); remat on against off
bit for bit on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import Q1_7 as JQ1_7
from repro.core.quantization import Q2_14 as JQ2_14
from repro.core.quantization import fake_quant_fmt as j_fake_quant_fmt
from repro.core.template import default_template as j_template
from repro.models import attention as jattn
from repro.models import cnn as jcnn
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.core.quantization import Q1_7, Q2_14, fake_quant_fmt
from repro_torch.core.template import default_template
from repro_torch.launch import steps
from repro_torch.models import attention as tattn
from repro_torch.models import cnn
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, adamw_init
from repro_torch.optim.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from torch_family_cases import setup_of

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
QAT_GRAD_TOL = 1e-3
ACCUM_TOL = 5e-3


def _tpl():
    return default_template("torch", device="cpu")


def _batch(name):
    _, _, _, _, tokens, ctx = setup_of(name)
    b = {"tokens": torch.from_numpy(tokens).long()}
    if ctx is not None:
        b["ctx"] = torch.from_numpy(ctx)
    return b


def _check_grads(got, want, tol=GRAD_TOL):
    """Every leaf of the port's grads within ``tol`` of the reference
    leaf's largest |g| (trees matched by key)."""
    n = []

    def one(w, g):
        w, g = np.asarray(w), g.detach().numpy()
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= tol * max(float(np.abs(w).max()), 1e-12)
        n.append(1)

    jax.tree.map(one, want, got)
    assert len(n) == len(jax.tree.leaves(want))


def test_accumulation_equivalence():
    """accum=2 over a batch = accum=1 over the same batch (same grads), as
    the reference's test holds it."""
    cfg = reduced(get_config("qwen2-0.5b"))
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens}
    opt = AdamW(lr=1e-2, clip_norm=None)
    p1, _, m1 = steps.make_train_step(cfg, tpl=_tpl(), opt=opt, accum=1)(
        params, adamw_init(params), batch)
    p2, _, m2 = steps.make_train_step(cfg, tpl=_tpl(), opt=opt, accum=2)(
        params, adamw_init(params), batch)
    err = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert err < ACCUM_TOL, f"accum mismatch {err}"
    # the mean of the two microbatch losses is the whole batch's loss
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-5 * float(m1["loss"])
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) <= 1e-4 * float(m1["grad_norm"])


def test_accumulation_needs_whole_microbatches():
    cfg = reduced(get_config("qwen2-0.5b"))
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    step = steps.make_train_step(cfg, tpl=_tpl(), accum=2)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, adamw_init(params), {"tokens": torch.zeros((3, 8), dtype=torch.long)})


#: remat's regions: one group a layer (qwen2), three-layer groups with a
#: tail (recurrentgemma), the encoder's layers (whisper), an MoE aux loss
#: carried through the regions (granite), the attn_out split (qwen2.5-32b)
REMAT_ARCHS = ["qwen2-0.5b", "recurrentgemma-9b", "whisper-medium", "granite-moe-3b-a800m",
               "qwen2.5-32b"]


@pytest.mark.parametrize("name", REMAT_ARCHS)
def test_remat_changes_no_number(name, monkeypatch):
    _, cfg, _, params, _, _ = setup_of(name)
    batch = _batch(name)
    calls = []
    real = T._run_layer
    monkeypatch.setattr(T, "_run_layer", lambda *a, **kw: calls.append(kw.get("part", "all"))
                        or real(*a, **kw))
    out = {}
    for remat in (False, True):
        calls.clear()
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = (steps.loss_and_grads(_tpl(), c, params, batch), list(calls))
    (l0, m0, g0), calls0 = out[False]
    (l1, m1, g1), calls1 = out[True]
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))
    # the backward ran the recomputed regions: more layer calls than layers
    assert len(calls1) > len(calls0)
    if cfg.remat_policy == "attn_out":
        assert "mixer" in calls1 and "rest" in calls1


def test_forward_train_equals_fwd_without_autograd():
    _, cfg, _, params, tokens, _ = setup_of("qwen2-0.5b")
    c = dataclasses.replace(cfg, remat=True)
    x = torch.from_numpy(tokens).long()
    with torch.no_grad():
        a, _ = T.forward(_tpl(), c, params, x, mode="train")
    b, _ = T.forward(_tpl(), c, params, x, mode="fwd")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="mode"):
        T.forward(_tpl(), c, params, x, mode="decode")


@pytest.mark.parametrize("name", ["qwen2-0.5b", "recurrentgemma-9b"])
def test_chunked_route_grads_match_reference(name, monkeypatch):
    """A 16-token batch through the chunked route of both packages (the
    plain online softmax on the torch template; recurrentgemma's local
    layers with their window) against the reference's ``_sdpa_chunked``."""
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "CHUNKED_THRESHOLD", 8)
        monkeypatch.setattr(mod, "_BQ", 4)
        monkeypatch.setattr(mod, "_BK", 4)
    chunked = []
    real = tattn._online_softmax_chunked
    monkeypatch.setattr(tattn, "_online_softmax_chunked",
                        lambda *a, **kw: chunked.append(kw["window"]) or real(*a, **kw))
    cfg_j, cfg, params_j, params, tokens, _ = setup_of(name)
    tpl_j = j_template("xla")
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(tpl_j, cfg_j, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True))(params_j)
    loss, _, grads = steps.loss_and_grads(_tpl(), cfg, params, _batch(name))
    assert chunked and (name != "recurrentgemma-9b" or all(chunked))
    assert abs(float(loss) - float(want)) <= LOSS_TOL * abs(float(want))
    _check_grads(grads, want_g)


@pytest.mark.parametrize("fmt,jfmt", [(Q2_14, JQ2_14), (Q1_7, JQ1_7)], ids=["q214", "q17"])
def test_fake_quant_ste_grads_match_reference(fmt, jfmt):
    """Straight through inside the representable range, zero outside it."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(257) * 1.5).astype(np.float32)
    x[:4] = [fmt.min_val, fmt.max_val, fmt.max_val + 1e-3, fmt.min_val - 1e-3]
    w = rng.standard_normal(257).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fake_quant_fmt(xt, fmt)
    (y * torch.from_numpy(w)).sum().backward()
    jy, jg = jax.value_and_grad(lambda a: (j_fake_quant_fmt(a, jfmt) * jnp.asarray(w)).sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(j_fake_quant_fmt(
        jnp.asarray(x), jfmt)))
    assert xt.grad[2] == 0 and xt.grad[3] == 0 and xt.grad[0] == w[0] and xt.grad[1] == w[1]


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "qat"])
def test_lenet_grads_match_reference(quantized):
    """The LeNet's cross-entropy and its gradients through ``cnn_forward``
    on the torch template, float and fake-quantized (the QAT path): the
    plan cache and the engine detach nothing."""
    spec, jspec = cnn.LENET, jcnn.LENET
    jparams = jcnn.init_cnn(jax.random.PRNGKey(0), jspec, scale=0.4)
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(2)
    img = rng.standard_normal((8, 32, 32, 1)).astype(np.float32)
    lab = rng.integers(0, 10, 8)
    tpl_j = j_template("xla")

    def jloss(p):
        logits = jcnn.cnn_forward(tpl_j, jspec, p, jnp.asarray(img), quantized=quantized)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -(jax.nn.one_hot(lab, 10) * logp).sum(-1).mean()

    want, want_g = jax.jit(jax.value_and_grad(jloss))(jparams)
    params = tree_map(lambda t: t.requires_grad_(True), cnn_params_from_numpy(tree))
    logits = cnn.cnn_forward(_tpl(), spec, params, torch.from_numpy(img),
                             quantized=quantized)
    loss = torch.nn.functional.cross_entropy(logits.float(), torch.from_numpy(lab))
    leaves, treedef = tree_flatten(params)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want)) <= LOSS_TOL * abs(float(want))
    assert all(float(g.abs().max()) > 0 for g in grads)
    _check_grads(tree_unflatten(treedef, grads), want_g,
                 tol=QAT_GRAD_TOL if quantized else GRAD_TOL)


@pytest.mark.parametrize("backend", ["cuda", "q16"])
def test_kernel_templates_are_refused(backend):
    cfg = reduced(get_config("qwen2-0.5b"))
    with pytest.raises(ValueError, match="autograd"):
        steps.make_train_step(cfg, tpl=default_template(backend, device="cpu"))


def test_maxpool_routes_a_tied_gradient_to_the_first_maximum():
    """Ties in a pooling window (frequent on a fake-quant grid): the whole
    gradient goes to the window's first maximum in row-major order, as the
    reference's ``reduce_window`` routes it."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 3, (2, 6, 6, 3)).astype(np.float32)  # many ties
    w = rng.standard_normal((2, 3, 3, 3)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (cnn._maxpool(xt, 2) * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda a: (jcnn._maxpool(a, 2) * jnp.asarray(w)).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    with torch.no_grad():
        np.testing.assert_array_equal(cnn._maxpool(xt, 2).numpy(),
                                      np.asarray(jcnn._maxpool(jnp.asarray(x), 2)))
