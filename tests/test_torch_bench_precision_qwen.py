"""``repro_torch.benchmarks.precision_drift``'s reduced-qwen2 rows held to
the reference's ``benchmarks/precision_drift.py`` on the same weights and
draws, on the CPU (``torch_bench_cases.reference_draws``; each reference
function runs once).

* ``transformer_row``: the fixed-point fields and bytes equal, the
  agreement within 1/N (N argmax rows) and the logit errors within 1e-5.
* ``transformer_precision_sweep``: given the reference's predictions
  (``ref=``, its default: the per-op q16 forward of the float weights), the
  drift mapping and the plan equal the reference's (Q3.13 for ``g0`` and
  ``head``); with the port's own predictions the drifts lie within 1/N.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import precision_drift as jpd
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.engine import reset_plan_caches as j_reset
from repro.core.template import default_template as j_template
from repro.models import transformer as JT
from repro_torch.benchmarks import precision_drift as pd
from repro_torch.core.engine import reset_plan_caches

import torch_bench_cases as cases


@pytest.fixture(scope="module")
def draws():
    mp, jparams = cases.reference_draws()
    yield jparams
    cases.forget_qat()
    mp.undo()


def test_transformer_row_equals_the_reference(draws):
    j_reset()
    reset_plan_caches()
    got, want = pd.transformer_row(device="cpu"), jpd.transformer_row()
    cases.close_rows(got, want, 128, ("bench", "arch", "activation_fmt", "positions",
                                      "per_token_bytes_float", "per_token_bytes_q16"))


@pytest.fixture(scope="module")
def qwen_sweeps(draws):
    """The reference's reduced-qwen2 sweep, its default reference predictions
    and the port's sweep given them and on its own; each cold."""
    j_reset()
    reset_plan_caches()
    want = jpd.transformer_precision_sweep()
    cfg_j = j_reduced(j_get_config("qwen2-0.5b"))
    jparams = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    meas = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, cfg_j.vocab)
    jref = np.array(jnp.argmax(JT.forward(j_template("q16"), cfg_j, jparams, meas,
                                          mode="fwd")[0], -1))
    got = pd.transformer_precision_sweep(device="cpu", ref=torch.from_numpy(jref))
    reset_plan_caches()
    own = pd.transformer_precision_sweep(device="cpu")
    j_reset()
    reset_plan_caches()
    return want, got, own


def test_transformer_sweep_equals_the_reference_given_its_predictions(qwen_sweeps):
    want, got, _ = qwen_sweeps
    for key in ("bench", "net", "budget", "base_fmt", "drift", "plan", "int8_groups",
                "per_token_bytes_q16", "per_token_bytes_mixed"):
        assert got[key] == want[key], key
    assert got["plan"] == {"g0": "Q3.13", "head": "Q3.13"}


def test_transformer_sweep_with_its_own_predictions_within_one_row(qwen_sweeps):
    want, _, own = qwen_sweeps
    assert set(own["drift"]) == set(want["drift"]) == {"g0", "head"}
    assert all(abs(own["drift"][k] - want["drift"][k]) <= 1 / 128 for k in want["drift"])
