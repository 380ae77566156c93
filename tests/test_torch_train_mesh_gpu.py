"""Phase 12 of ``chip_smoke.py`` at reduced width on the card.

Reduced qwen2-0.5b (f32, the reduced config's dtype) through
``launch/train.main``: once on the card
alone, then ``--mesh single --ranks 2`` (two gloo ranks of the card, their
collectives staged through the host) as FSDP, as data parallelism
(``--no-fsdp``), and as FSDP failing at step 2 with checkpoints every 2
steps; 3 steps of 8 x 128 tokens in 2 microbatches.  Held: every loss
finite; step 0's loss within 1e-3 and its grad norm within 1e-2 (relative)
of the single-device run's step 0; the restarted run's losses and grad
norms equal to the fault-free FSDP run's bit for bit; the card's memory
reported for each rank.  And with ``remat`` on (the reduced config has it
off), the meshed loss and grads against one device's: a CUDA backward
recomputes each region on the autograd engine's thread, which must find
the mesh there to gather the layer again.  Every test needs an NVIDIA card
and skips without one; run them there with ``python -m pytest --noconftest
-m gpu``.
"""
import dataclasses
import functools
import math

import pytest
import torch

import torch_train_cases
from repro_torch.configs import get_config, reduced
from repro_torch.core.template import default_template
from repro_torch.data import synthetic_batch
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import transformer as T
from repro_torch.optim.tree import tree_leaves

pytestmark = pytest.mark.gpu

ARGV = ["--arch", "qwen2-0.5b", "--batch", "8", "--seq", "128", "--accum", "2",
        "--steps", "3", "--log-every", "100", "--device", "cuda"]
MESH = ["--mesh", "single", "--ranks", "2"]
LOSS_TOL, GNORM_TOL = 1e-3, 1e-2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(stats, losses) of the single-device run and of the three meshed
    runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    tmp = tmp_path_factory.mktemp("train_mesh_gpu")
    out = {"single": train.main(ARGV + ["--ckpt-dir", str(tmp / "single")])}
    for name, more in (("fsdp", []), ("dp", ["--no-fsdp"]),
                       ("restart", ["--ckpt-every", "2", "--fail-at", "2"])):
        out[name] = train.main(ARGV + MESH + more + ["--ckpt-dir", str(tmp / name)])
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("name", ["fsdp", "dp"])
def test_two_ranks_of_the_card_match_one_device(runs, name):
    stats, losses = runs[name]
    one_stats, one = runs["single"]
    assert all(math.isfinite(x) for x in losses + stats["grad_norms"])
    assert _rel(losses[0], one[0]) <= LOSS_TOL
    assert _rel(stats["grad_norms"][0], one_stats["grad_norms"][0]) <= GNORM_TOL
    assert len(stats["peak_mem_bytes_by_rank"]) == 2
    assert all(p > 0 for p in stats["peak_mem_bytes_by_rank"])


def test_restart_on_two_ranks_replays_bit_for_bit(runs):
    stats, losses = runs["restart"]
    free_stats, free = runs["fsdp"]
    assert stats["failures"] == 1 and stats["restarts"] == [2]
    assert losses == free and stats["grad_norms"] == free_stats["grad_norms"]
    assert len(stats["save_seconds"]) == 2 and len(stats["restore_seconds"]) == 1


def test_remat_regions_regather_on_the_backward_thread():
    """FSDP with ``remat`` on two ranks of the card: loss within 1e-5 and
    each grad leaf within 1e-4 of its largest |g| of one device's, f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    payload = {"seed": 0, "batch": 8, "seq": 128}
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), remat=True)
    dev = torch.device("cuda", 0)
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tokens = synthetic_batch(0, 0, 8, 128, cfg.vocab).to(dev)
    loss, _, grads = steps.loss_and_grads(default_template("torch"), cfg, params,
                                          {"tokens": tokens})
    got = spawn_ranks(functools.partial(torch_train_cases.remat_case, payload), 2,
                      device="cuda")[0]
    assert _rel(float(got["loss"]), float(loss)) <= 1e-5
    for g, w in zip(tree_leaves(got["grads"]), tree_leaves(grads)):
        w = w.cpu().numpy()
        assert g.shape == w.shape
        assert abs(g - w).max() <= 1e-4 * max(abs(w).max(), 1e-12)
