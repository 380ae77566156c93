"""The port's optimizer held against the JAX package's.

Inputs are numpy draws from a seed.  Tolerances:

* schedules within 1e-7 relative of the reference's, at every step;
* ``adamw_update`` from the same params, grads and state within 1e-6 (new
  params, m, v, grad norm, lr): at step 1 from ``adamw_init`` and at step 3
  from a drawn state, with clipping active and decay on matrices only.
  The grads are drawn away from 0: at step 1 AdamW moves a weight by about
  lr·sign(g), so an ulp of difference in a gradient near 0 could flip it;
* ``compress_int8`` / ``decompress_int8`` bit for bit, error feedback as
  the reference's test holds it (``tests/test_optim_data.py``) and equal to
  the reference's on the same grads;
* ``compressed_grad_reduce`` on 2 gloo ranks of the CPU against the numpy
  mathematics of the reference's ``compressed_psum`` (the largest scale of
  the ranks, requantize, sum the raws, dequantize, divide by the ranks).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_cases
from repro.optim import AdamW as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import compress as jcompress
from repro.optim import schedules as jsched
from repro_torch.convert import opt_state_from_numpy, opt_state_to_numpy
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.optim import AdamW, OptState, adamw_init, adamw_update
from repro_torch.optim import compress, schedules
from repro_torch.optim.tree import tree_leaves, tree_map

SCHED_TOL = 1e-7
ADAM_TOL = 1e-6

SCHEDULES = [
    ("constant", (3e-4,)),
    ("linear_warmup", (1e-3, 10)),
    ("linear_warmup", (2e-3, 0)),
    ("cosine_warmup", (1e-3, 10, 100)),
    ("cosine_warmup", (3e-4, 7, 50, 0.2)),
    ("cosine_warmup", (1e-3, 1, 14)),
]


@pytest.mark.parametrize("name,args", SCHEDULES, ids=lambda v: str(v))
def test_schedule_matches_reference(name, args):
    fn, jfn = getattr(schedules, name)(*args), getattr(jsched, name)(*args)
    for step in range(0, 130):
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        want = float(jfn(jnp.int32(step)))
        np.testing.assert_allclose(float(got), want, rtol=SCHED_TOL, atol=0)
        assert float(fn(step)) == float(got)  # a Python int step gives the same


def _tree(rng, dtype=np.float32):
    """A parameter tree of every rank the transformer has: a stacked 3-d
    leaf, matrices, vectors and a 0-d leaf, inside dicts and a tuple."""
    return {
        "embed": rng.standard_normal((12, 8)).astype(dtype),
        "blocks": ({"w": rng.standard_normal((2, 8, 6)).astype(dtype),
                    "b": rng.standard_normal((2, 6)).astype(dtype)},),
        "norm": {"scale": rng.standard_normal((8,)).astype(dtype)},
        "gate": np.asarray(rng.standard_normal(), dtype=dtype),
    }


def _away_from_zero(rng, like, scale):
    g = rng.standard_normal(like.shape)
    return (np.sign(g) * (np.abs(g) + 0.05) * scale).astype(np.float32)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, tol=ADAM_TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=tol, atol=tol)


CASES = {
    # (step of the state passed in, grad scale: 30 makes the norm clip at 1)
    "step1_clipped": (0, 30.0),
    "step1_unclipped": (0, 0.01),
    "step3_clipped": (2, 30.0),
    "step3_unclipped": (2, 0.01),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_update_matches_reference(case):
    step0, scale = CASES[case]
    rng = np.random.default_rng(7)
    params = _tree(rng)
    grads = jax.tree.map(lambda p: _away_from_zero(rng, p, scale), params)
    if step0:
        m = jax.tree.map(lambda p: (0.1 * rng.standard_normal(p.shape)).astype(np.float32),
                         params)
        v = jax.tree.map(lambda p: (0.01 * rng.random(p.shape) + 1e-4).astype(np.float32),
                         params)
        jstate = j_adamw_init(_j(params))._replace(step=jnp.int32(step0), m=_j(m), v=_j(v))
        state = opt_state_from_numpy((np.int32(step0), m, v))
    else:
        jstate, state = j_adamw_init(_j(params)), adamw_init(_t(params))
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)
    jopt = JAdamW(lr=jsched.cosine_warmup(1e-2, 2, 10), **kw)
    opt = AdamW(lr=schedules.cosine_warmup(1e-2, 2, 10), **kw)
    jp, js, jm = j_adamw_update(jopt, _j(grads), jstate, _j(params))
    p, s, m = adamw_update(opt, _t(grads), state, _t(params))
    assert int(s.step) == int(js.step) == step0 + 1 and s.step.dtype == torch.int32
    _close(float(m["grad_norm"]), float(jm["grad_norm"]))
    _close(float(m["lr"]), float(jm["lr"]))
    got_step, got_m, got_v = opt_state_to_numpy(s)
    for got, want in ((tree_map(lambda t: t.numpy(), p), jp), (got_m, js.m), (got_v, js.v)):
        jax.tree.map(_close, got, jax.tree.map(np.asarray, want))
    assert all(t.dtype == torch.float32 for t in tree_leaves(s.m) + tree_leaves(s.v))


def test_adamw_state_is_f32_for_bf16_params_and_decay_skips_vectors():
    params = {"mat": torch.ones((2, 2), dtype=torch.bfloat16),
              "vec": torch.ones((2,), dtype=torch.bfloat16)}
    state = adamw_init(params)
    assert state.m["mat"].dtype == torch.float32 and state.v["vec"].dtype == torch.float32
    grads = tree_map(torch.zeros_like, params)
    new, _, _ = adamw_update(AdamW(lr=0.1, weight_decay=0.5, clip_norm=None), grads,
                             state, params)
    assert new["mat"].dtype == torch.bfloat16
    assert float(new["mat"][0, 0]) < 1.0  # decayed
    assert torch.equal(new["vec"], params["vec"])  # not decayed


def test_adamw_matches_hand_computed_update():
    """One step against a hand-computed Adam update (the reference's test)."""
    opt = AdamW(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0, clip_norm=None)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    new_p, new_st, _ = adamw_update(opt, g, adamw_init(p), p)
    mhat = 0.1 * 0.5 / (1 - 0.9)
    vhat = 0.01 * 0.25 / (1 - 0.99)
    want = 1.0 - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(float(new_p["w"][0]), want, rtol=1e-6)
    assert isinstance(new_st, OptState) and int(new_st.step) == 1


def test_grad_clipping_reports_the_unclipped_norm():
    opt = AdamW(lr=1.0, clip_norm=1.0)
    p = {"w": torch.zeros((3,))}
    g = {"w": torch.full((3,), 100.0)}
    _, _, metrics = adamw_update(opt, g, adamw_init(p), p)
    assert float(metrics["grad_norm"]) == pytest.approx(100.0 * np.sqrt(3), rel=1e-4)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 17, 4242, 9999])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_compress_int8_bit_for_bit(seed, dtype):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((64, 3)) * 10.0 ** rng.integers(-4, 3)).astype(np.float32)
    if dtype == "bfloat16":
        gt = torch.from_numpy(g).to(torch.bfloat16)
        gj = jnp.asarray(gt.float().numpy()).astype(jnp.bfloat16)
    else:
        gt, gj = torch.from_numpy(g), jnp.asarray(g)
    q, scale = compress.compress_int8(gt)
    jq, jscale = jcompress.compress_int8(gj)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    back = compress.decompress_int8(q, scale)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jcompress.decompress_int8(jq, jscale)))
    assert float((back - gt.float()).abs().max()) <= float(scale) / 2 + 1e-7


def test_error_feedback_accumulates_residual_as_the_reference():
    grads = {"w": torch.tensor([0.3e-3, -0.2e-3, 1.0])}
    comp = compress.compress_int8
    decomp = lambda pk: compress.decompress_int8(*pk)
    ef = compress.init_error_feedback(grads)
    out, ef2 = compress.apply_error_feedback(grads, ef, comp, decomp)
    np.testing.assert_allclose(ef2["w"].numpy(), (grads["w"] - out["w"]).numpy(), atol=1e-7)
    jg = {"w": jnp.asarray(grads["w"].numpy())}
    jout, jef = jcompress.apply_error_feedback(
        jg, jax.tree.map(lambda g: jnp.zeros(g.shape, jnp.float32), jg),
        jcompress.compress_int8, lambda pk: jcompress.decompress_int8(*pk))
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(jout["w"]))
    np.testing.assert_array_equal(ef2["w"].numpy(), np.asarray(jef["w"]))
    # the time-average of EF-compressed gradients converges to the true one
    total = torch.zeros_like(grads["w"])
    ef = compress.init_error_feedback(grads)
    n = 400
    for _ in range(n):
        out, ef = compress.apply_error_feedback(grads, ef, comp, decomp)
        total = total + out["w"]
    step = float(grads["w"].abs().max()) / 127.0
    np.testing.assert_allclose((total / n).numpy(), grads["w"].numpy(), atol=step / 2 + 2e-5)


def _psum_numpy(per_rank):
    """The reference's compressed_psum, in numpy, over the ranks' tensors."""
    f = np.float32
    scales = [np.maximum(np.abs(g).max(), f(1e-12)) / f(127.0) for g in per_rank]
    smax = f(max(scales))
    q = [np.clip(np.round(g / smax), -127, 127).astype(np.int8) for g in per_rank]
    total = np.sum([x.astype(np.int32) for x in q], axis=0)
    return total.astype(np.float32) * smax


def test_compressed_grad_reduce_on_two_gloo_ranks():
    rng = np.random.default_rng(3)
    grads = [{"a": (rng.standard_normal((5, 4)) * s).astype(np.float32),
              "b": (rng.standard_normal((7,)) * s * 1e-3).astype(np.float32)}
             for s in (1.0, 3.0)]
    out = spawn_ranks(functools.partial(torch_train_cases.compressed_reduce_case,
                                        {"grads": grads}), 2, device="cpu", timeout=120)
    for key in ("a", "b"):
        want = _psum_numpy([g[key] for g in grads]) / np.float32(2)
        for rank in range(2):
            np.testing.assert_array_equal(out[rank]["plain"][key], want)
            # error feedback from a zero state changes nothing on the wire:
            # C(g + 0) is g's own compression, dequantized, then reduced
            restored = [compress.decompress_int8(*compress.compress_int8(
                torch.from_numpy(g[key]))).numpy() for g in grads]
            np.testing.assert_array_equal(out[rank]["ef"][key],
                                          _psum_numpy(restored) / np.float32(2))
            np.testing.assert_array_equal(out[rank]["residual"][key],
                                          grads[rank][key] - restored[rank])
