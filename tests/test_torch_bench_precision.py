"""``repro_torch.benchmarks.precision_drift``'s LeNet rows held to the
reference's ``benchmarks/precision_drift.py`` on the same weights and draws,
on the CPU (the reduced-qwen2 rows: ``test_torch_bench_precision_qwen.py``).

The port's draw hooks are replaced by the reference's draws
(``torch_bench_cases.reference_draws``); the LeNet both sweeps measure is
the reference's init (scale 0.4), seeded into both QAT memos under the
default steps (writing to the dicts, not to a file).  Each reference
function runs once (module-scoped fixtures).

* ``lenet_row``: the fixed-point counts and bytes equal, the agreement
  within 1/N (N argmax rows) and the logit errors within 1e-5 (the float
  forwards may differ by an ulp).
* ``lenet_precision_sweep``: given the reference's predictions (``ref=``,
  the fake-quant float argmax), only the grid forwards decide, which are
  exact: the drift mapping and the plan equal the reference's.  With the
  port's own predictions the drifts lie within 1/N of the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import precision_drift as jpd
from repro.core.engine import reset_plan_caches as j_reset
from repro.core.template import default_template as j_template
from repro.data.pipeline import synthetic_images as j_synthetic_images
from repro.models import cnn as jcnn
from repro_torch.benchmarks import precision_drift as pd
from repro_torch.core.engine import reset_plan_caches

import torch_bench_cases as cases


@pytest.fixture(scope="module")
def draws():
    mp, jparams = cases.reference_draws()
    yield jparams
    cases.forget_qat()
    mp.undo()


def test_lenet_row_equals_the_reference(draws):
    j_reset()
    reset_plan_caches()
    got, want = pd.lenet_row(batches=2, device="cpu"), jpd.lenet_row(batches=2)
    cases.close_rows(got, want, 32, ("bench", "activation_fmt", "batches", "quantize_calls",
                                     "dequantize_calls", "act_bytes_float", "act_bytes_q16",
                                     "bytes_ratio"))
    assert got["quantize_calls"] == got["dequantize_calls"] == got["batches"] == 2


@pytest.fixture(scope="module")
def lenet_sweeps(draws):
    """The reference's LeNet sweep, its reference predictions, and the port's
    sweep given them and on its own; each cold."""
    j_reset()
    reset_plan_caches()
    want = jpd.lenet_precision_sweep()
    meas = jnp.concatenate([j_synthetic_images(99, 1000 + b, 16, 32, 1, 10)[0]
                            for b in range(4)])
    jref = np.array(jnp.argmax(jcnn.cnn_forward(j_template("xla"), jcnn.LENET, draws, meas,
                                                quantized=True), -1))
    got = pd.lenet_precision_sweep(device="cpu", ref=torch.from_numpy(jref))
    reset_plan_caches()
    own = pd.lenet_precision_sweep(device="cpu")
    j_reset()
    reset_plan_caches()
    return want, got, own


def test_lenet_sweep_equals_the_reference_given_its_predictions(lenet_sweeps):
    want, got, _ = lenet_sweeps
    for key in ("bench", "net", "budget", "base_fmt", "drift", "plan", "int8_layers",
                "act_bytes_q16", "act_bytes_mixed", "int8_layer_bytes_q16",
                "int8_layer_bytes_mixed", "bytes_saved", "argmax_agreement"):
        assert got[key] == want[key], key
    assert abs(got["logit_mae"] - want["logit_mae"]) <= cases.LOGIT_TOL


def test_lenet_sweep_with_its_own_predictions_within_one_row(lenet_sweeps):
    want, _, own = lenet_sweeps
    assert set(own["drift"]) == set(want["drift"])
    assert all(abs(own["drift"][k] - want["drift"][k]) <= 1 / 64 for k in want["drift"])
