"""The port's training loss, gradients and train step held against the JAX
package, for every config of ``tests/test_models_smoke.py``.

Reduced configs (MoE capacity large enough that no token drops), the
reference's ``init_params`` weights with live norm scales and cross gates
carried across by ``convert.py`` (``tests/torch_family_cases.py``), a
(2, 16) numpy token batch and, for whisper / llama-vision, a numpy context.
The port runs ``models.transformer.loss_fn`` on the ``torch`` template on
the CPU; the reference runs its ``loss_fn`` on its ``xla`` backend, under
``jax.value_and_grad``.  Tolerances:

* the loss (and its ce / aux parts) within 1e-5 relative;
* every gradient leaf within 1e-4 of that leaf's largest |g|;
* the step's metrics: ``make_train_step``'s loss, grad norm and lr equal to
  the reference's loss, its ``global_norm`` of its grads and its schedule
  at step 1, within 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as j_all_configs
from repro.core.template import default_template as j_template
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.optim.adamw import global_norm as j_global_norm
from repro_torch.core.template import default_template
from repro_torch.launch import steps
from repro_torch.optim import AdamW, adamw_init, cosine_warmup
from repro_torch.optim.tree import tree_map
from torch_family_cases import setup_of

ARCHS = sorted(j_all_configs())
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4

_REF, _PORT = {}, {}


def _batches(name):
    cfg_j, cfg, params_j, params, tokens, ctx = setup_of(name)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens).long()}
    if ctx is not None:
        jb["ctx"], tb["ctx"] = jnp.asarray(ctx), torch.from_numpy(ctx)
    return jb, tb


def reference(name):
    """(loss, {"ce", "aux"}, grads as numpy) of the reference, memoized."""
    if name not in _REF:
        cfg_j, _, params_j, _, _, _ = setup_of(name)
        jb, _ = _batches(name)
        tpl = j_template("xla")
        fn = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(tpl, cfg_j, p, b),
                                        has_aux=True))
        (loss, metrics), grads = fn(params_j, jb)
        _REF[name] = (float(loss), {k: float(v) for k, v in metrics.items()},
                      jax.tree.map(np.asarray, grads), float(j_global_norm(grads)))
    return _REF[name]


def _port_grads(name):
    """(loss, {"ce", "aux"}, grads) of the port, memoized."""
    if name not in _PORT:
        _, cfg, _, params, _, _ = setup_of(name)
        _, tb = _batches(name)
        _PORT[name] = steps.loss_and_grads(default_template("torch", device="cpu"), cfg,
                                            params, tb)
    return _PORT[name]


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_matches_reference(name):
    loss, metrics, _ = _port_grads(name)
    want_loss, want, _, _ = reference(name)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert _rel(float(loss), want_loss) <= LOSS_TOL
    assert _rel(float(metrics["ce"]), want["ce"]) <= LOSS_TOL
    assert abs(float(metrics["aux"]) - want["aux"]) <= LOSS_TOL * max(abs(want["aux"]), 1.0)


@pytest.mark.parametrize("name", ARCHS)
def test_grads_match_reference(name):
    _, _, grads = _port_grads(name)
    _, _, want, _ = reference(name)
    got = tree_map(lambda t: t.numpy(), grads)
    paths = []

    def check(path, g, w):
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert np.isfinite(g).all(), path
        assert err <= GRAD_TOL * max(scale, 1e-12), (path, err, scale)
        paths.append(path)

    jax.tree_util.tree_map_with_path(lambda p, w, g: check(jax.tree_util.keystr(p), g, w),
                                     want, got)
    assert len(paths) == len(jax.tree.leaves(want))


@pytest.mark.parametrize("name", ARCHS)
def test_step_metrics_match_reference(name):
    _, cfg, _, params, _, _ = setup_of(name)
    _, tb = _batches(name)
    want_loss, _, _, want_norm = reference(name)
    opt = AdamW(lr=cosine_warmup(1e-3, 3, 30))
    step = steps.make_train_step(cfg, tpl=default_template("torch", device="cpu"), opt=opt)
    new_params, new_opt, m = step(params, adamw_init(params), tb)
    assert sorted(m) == ["aux", "ce", "grad_norm", "loss", "lr"]
    assert _rel(float(m["loss"]), want_loss) <= LOSS_TOL
    assert _rel(float(m["grad_norm"]), want_norm) <= LOSS_TOL
    want_lr = float(JAdamW(lr=j_cosine_warmup(1e-3, 3, 30)).lr(jnp.int32(1)))
    assert _rel(float(m["lr"]), want_lr) <= 1e-7
    assert int(new_opt.step) == 1
    # the step keeps every leaf's dtype and shape
    same = tree_map(lambda a, b: a.dtype == b.dtype and a.shape == b.shape, new_params,
                    params)
    assert all(jax.tree.leaves(same))
