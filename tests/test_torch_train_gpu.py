"""Phase 11(a) of ``chip_smoke.py`` at reduced size on the card.

Reduced qwen2-0.5b in bf16 through ``launch/train.main`` on the card: a
fault-free run and a run that fails at step 6 and resumes from its step-4
checkpoint, 8 steps of 4 x 128 tokens in 2 microbatches.  Held: every loss
finite, the loss falls, the restarted run's losses equal the fault-free
run's bit for bit; step 0 in bf16 within 1 % (loss) and 5 % (grad norm) of
the same weights in f32; the train step refuses the kernel templates on the
card too.  Every test needs an NVIDIA card and skips without one; run them
there with ``python -m pytest --noconftest -m gpu``.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.template import default_template
from repro_torch.data import synthetic_batch
from repro_torch.launch import train
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import global_norm
from repro_torch.optim.tree import tree_map

pytestmark = pytest.mark.gpu

ARGV = ["--arch", "qwen2-0.5b", "--batch", "4", "--seq", "128", "--accum", "2",
        "--steps", "8", "--log-every", "100", "--device", "cuda"]


@pytest.fixture(scope="module")
def dev():
    """The card, decided when a test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bf16():
    return dataclasses.replace(reduced(get_config("qwen2-0.5b")), dtype="bfloat16")


def test_restarted_run_replays_the_fault_free_run(dev, tmp_path, monkeypatch):
    monkeypatch.setattr(train, "reduced", lambda cfg: dataclasses.replace(
        reduced(cfg), dtype="bfloat16"))
    stats_a, loss_a = train.main(ARGV + ["--ckpt-every", "100", "--ckpt-dir",
                                         str(tmp_path / "a")])
    stats_b, loss_b = train.main(ARGV + ["--ckpt-every", "4", "--fail-at", "6",
                                         "--ckpt-dir", str(tmp_path / "b")])
    assert all(math.isfinite(x) for x in loss_a + loss_b)
    assert sum(loss_a[-2:]) / 2 < loss_a[0]
    assert (stats_b["failures"], stats_b["restarts"]) == (1, [4])
    assert loss_b == loss_a[:6] + loss_a[4:]


def test_bf16_step_zero_near_f32(dev):
    cfg = _bf16()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    batch = {"tokens": synthetic_batch(0, 0, 4, 128, cfg.vocab, device=dev)}
    tpl = default_template("torch")
    loss, _, grads = loss_and_grads(tpl, cfg, params, batch)
    loss32, _, g32 = loss_and_grads(tpl, cfg, tree_map(lambda t: t.float(), params), batch)
    assert abs(float(loss) - float(loss32)) <= 0.01 * float(loss32)
    gn, gn32 = float(global_norm(grads)), float(global_norm(g32))
    assert abs(gn - gn32) <= 0.05 * gn32


@pytest.mark.parametrize("backend", ["cuda", "q16"])
def test_kernel_templates_are_refused_on_the_card(dev, backend):
    with pytest.raises(ValueError, match="autograd"):
        make_train_step(_bf16(), tpl=default_template(backend))
