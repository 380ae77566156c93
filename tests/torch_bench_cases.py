"""Shared setup of ``test_torch_bench_precision*.py``: the port's
``precision_drift`` draw hooks swapped for the reference's draws, the
weights carried across by ``repro_torch.convert``."""
import jax
import numpy as np
import pytest
import torch

from benchmarks import precision_drift as jpd
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data.pipeline import synthetic_images as j_synthetic_images
from repro.models import cnn as jcnn
from repro.models import transformer as JT
from repro_torch.benchmarks import precision_drift as pd
from repro_torch.convert import cnn_params_from_numpy, transformer_params_from_numpy

#: the logit errors of a port row against the reference's (f32 forwards)
LOGIT_TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def reference_draws():
    """A MonkeyPatch with the port's hooks drawing the reference's numbers,
    and both QAT memos (default steps) holding the reference's LeNet init
    (scale 0.4): the sweeps then measure one network in both packages.
    ``undo()`` it and :func:`forget_qat` when done."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pd, "lenet_params", lambda seed, device: cnn_params_from_numpy(
        _np(jcnn.init_cnn(jax.random.PRNGKey(seed), jcnn.LENET, scale=0.4))))
    mp.setattr(pd, "lenet_images", lambda seed, step, batch, device: torch.from_numpy(
        np.array(j_synthetic_images(seed, step, batch, 32, 1, 10)[0])))

    def transformer_params(seed, cfg, device):
        cfg_j = j_reduced(j_get_config("qwen2-0.5b"))
        assert cfg.name == cfg_j.name
        return transformer_params_from_numpy(_np(JT.init_params(jax.random.PRNGKey(seed),
                                                                cfg_j)))

    mp.setattr(pd, "transformer_params", transformer_params)
    mp.setattr(pd, "tokens", lambda seed, shape, vocab, device: torch.from_numpy(
        np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, vocab))).long())
    jparams = jcnn.init_cnn(jax.random.PRNGKey(0), jcnn.LENET, scale=0.4)
    jpd._QAT_CACHE[(0, 60, 30)] = jparams
    pd._QAT_CACHE[(0, 60, 30, "cpu")] = cnn_params_from_numpy(_np(jparams))
    return mp, jparams


def forget_qat():
    jpd._QAT_CACHE.pop((0, 60, 30), None)
    pd._QAT_CACHE.pop((0, 60, 30, "cpu"), None)


def close_rows(got: dict, want: dict, n_rows: int, exact: tuple):
    """Fixed-point fields equal; the agreement within 1/``n_rows``; the logit
    errors within :data:`LOGIT_TOL`."""
    for key in exact:
        assert got[key] == want[key], key
    assert abs(got["argmax_agreement"] - want["argmax_agreement"]) <= 1 / n_rows
    for key in ("logit_mae", "logit_max_err"):
        assert abs(got[key] - want[key]) <= LOGIT_TOL, (key, got[key], want[key])
