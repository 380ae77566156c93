"""Tensor-parallel training with ``remat`` on two ranks of the card.

Reduced qwen2-0.5b (f32) with ``remat`` on a (1, 2) ("data", "model") mesh:
two gloo ranks of one card, the sequence-parallel seams' collectives staged
through the host.  The meshed loss and grads against one device's: a CUDA
backward recomputes each region on the autograd engine's thread, where the
sequence gathers and reduce-scatters of the recomputed layer must find the
mesh (the CPU, whose backward runs on the caller's thread, cannot show it).
Needs an NVIDIA card and skips without one; run it there with ``python -m
pytest --noconftest -m gpu``.
"""
import dataclasses
import functools

import pytest
import torch

import torch_train_cases
from repro_torch.configs import get_config, reduced
from repro_torch.core.template import default_template
from repro_torch.data import synthetic_batch
from repro_torch.launch import steps
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import transformer as T
from repro_torch.optim.tree import tree_leaves

pytestmark = pytest.mark.gpu


def test_tp_remat_regions_reshard_on_the_backward_thread():
    """Loss within 1e-5 and each grad leaf within 1e-4 of its largest |g|
    of one device's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    payload = {"seed": 0, "batch": 8, "seq": 128, "model": 2}
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), remat=True)
    dev = torch.device("cuda", 0)
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tokens = synthetic_batch(0, 0, 8, 128, cfg.vocab).to(dev)
    loss, _, grads = steps.loss_and_grads(default_template("torch"), cfg, params,
                                          {"tokens": tokens})
    got = spawn_ranks(functools.partial(torch_train_cases.remat_case, payload), 2,
                      device="cuda")[0]
    assert abs(float(got["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    for g, w in zip(tree_leaves(got["grads"]), tree_leaves(grads)):
        w = w.cpu().numpy()
        assert g.shape == w.shape
        assert abs(g - w).max() <= 1e-4 * max(abs(w).max(), 1e-12)
