"""The port's training driver, data pipeline and examples on the CPU.

* ``launch.train.main`` through an injected failure (the reference's
  ``test_end_to_end_train_restart`` on the port: reduced qwen2, 14 steps,
  failure at 9, checkpoints every 4), and the restarted run's losses equal
  a fault-free run's from the checkpoint on, bit for bit;
* five LeNet float steps (the LeNet example's optimizer) on the
  reference's images and weights follow the reference's losses within
  1e-4;
* the pipeline: batches pure functions of (seed, step), the context stub;
  an optimizer state's checkpoint round trip;
* the examples' CLIs with ``--device cpu`` at reduced size (only
  ``quickstart`` and ``fault_tolerant_train`` assert that the loss falls,
  as the reference's do).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import synthetic_images as j_synthetic_images
from repro.models import cnn as jcnn
from repro.optim import AdamW as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.core.template import default_template as j_template
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.core.template import default_template
from repro_torch.data import make_pipeline, synthetic_batch, synthetic_images
from repro_torch.examples import fault_tolerant_train, quickstart, train_lenet_q214
from repro_torch.launch import train
from repro_torch.models import cnn
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, OptState, adamw_init, adamw_update
from repro_torch.optim.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

LENET_LOSS_TOL = 1e-4


def _run(tmp, *extra):
    return train.main(["--arch", "qwen2-0.5b", "--steps", "14", "--batch", "4", "--seq", "64",
                       "--ckpt-every", "4", "--ckpt-dir", str(tmp), "--log-every", "100",
                       "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A run with a failure at step 9 and a fault-free run."""
    faulty = _run(tmp_path_factory.mktemp("faulty"), "--fail-at", "9")
    free = _run(tmp_path_factory.mktemp("free"))
    return faulty, free


def test_end_to_end_train_restart(runs, capsys):
    """The real training driver: the loss decreases and a failure does not
    corrupt the run."""
    (stats, history), _ = runs
    assert stats["failures"] == 1
    assert stats["steps"] == 14
    assert stats["restarts"] == [8]
    assert history[-1] < history[0]  # learned something through the restart
    assert len(stats["step_seconds"]) == len(history) == 9 + 6
    assert len(stats["save_seconds"]) == 14 // 4 + 1 and len(stats["restore_seconds"]) == 1


def test_restart_replays_the_fault_free_run(runs):
    """From the checkpoint on, the restarted run's losses are the fault-free
    run's bit for bit (data from (seed, step), state from the checkpoint)."""
    (stats, faulty), (free_stats, free) = runs
    assert free_stats["failures"] == 0 and len(free) == 14
    assert faulty[:9] == free[:9]
    assert faulty[9:] == free[8:]


def test_driver_prints_the_reference_lines(tmp_path, capsys):
    train.main(["--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                "--ckpt-dir", str(tmp_path), "--fail-at", "2", "--log-every", "1",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step    0 loss " in out and " gnorm " in out and " lr " in out
    assert "[train] resumed from checkpoint step 2" in out
    assert "[train] done: 3 steps, 1 failures, restarts at [2], loss " in out
    assert "[train] plan registry: " in out


def test_ckpt_every_zero_saves_nothing(tmp_path):
    """``--ckpt-every 0``: no checkpoint is written or read, and the losses
    are the checkpointed run's; a failure then restarts from step 0."""
    argv = ["--steps", "3", "--batch", "2", "--seq", "16", "--log-every", "100",
            "--device", "cpu"]
    saved, want = train.main(argv + ["--ckpt-every", "1", "--ckpt-dir", str(tmp_path / "a")])
    assert len(saved["save_seconds"]) == 3
    stats, got = train.main(argv + ["--ckpt-every", "0", "--ckpt-dir", str(tmp_path / "b")])
    assert got == want and stats["save_seconds"] == [] and stats["restore_seconds"] == []
    assert not (tmp_path / "b").exists()
    # the checkpoints of another run in the directory are not resumed from
    stats, again = train.main(argv + ["--ckpt-every", "0", "--ckpt-dir", str(tmp_path / "a"),
                                      "--fail-at", "2"])
    assert stats["restarts"] == [0] and again == want[:2] + want


@pytest.mark.parametrize("arch", ["whisper-medium", "granite-moe-3b-a800m",
                                  "mamba2-1.3b"])
def test_driver_trains_the_families(tmp_path, arch):
    stats, history = train.main(["--arch", arch, "--steps", "2", "--batch", "2", "--seq",
                                 "16", "--ckpt-dir", str(tmp_path), "--device", "cpu",
                                 "--accum", "2"])
    assert stats["steps"] == 2 and all(np.isfinite(history))


def test_driver_refuses_a_mesh(tmp_path):
    """The meshes the driver refuses before any rank starts: a multi-pod
    mesh of an odd rank count, and (through ``train_mesh``, which every rank
    calls) a "model" axis that does not divide the ranks."""
    from repro_torch.launch.mesh import train_mesh

    with pytest.raises(ValueError, match="even"):
        train.main(["--mesh", "multi", "--ranks", "3", "--ckpt-dir", str(tmp_path),
                    "--device", "cpu"])
    with pytest.raises(ValueError, match="multiple of model"):
        train.main(["--mesh", "single", "--ranks", "4", "--model", "3", "--ckpt-dir",
                    str(tmp_path), "--device", "cpu"])
    with pytest.raises(ValueError, match="even"):
        train_mesh(4, True, model=4)
    assert train_mesh(4, model=2).shape == {"data": 2, "model": 2}
    assert train_mesh(8, True, model=2).shape == {"pod": 2, "data": 2, "model": 2}


def test_lenet_float_steps_follow_the_reference():
    """Five float steps of the LeNet example (AdamW 3e-3, no decay) on the
    reference's images, from the reference's weights."""
    jparams = jcnn.init_cnn(jax.random.PRNGKey(0), jcnn.LENET, scale=0.4)
    params = cnn_params_from_numpy(jax.tree.map(np.asarray, jparams))
    jopt, opt = JAdamW(lr=3e-3, weight_decay=0.0), AdamW(lr=3e-3, weight_decay=0.0)
    jstate, state = j_adamw_init(jparams), adamw_init(params)
    tpl_j, tpl = j_template("xla"), default_template("torch", device="cpu")

    def jloss(p, img, lab):
        logits = jcnn.cnn_forward(tpl_j, jcnn.LENET, p, img)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -(jax.nn.one_hot(lab, 10) * logp).sum(-1).mean()

    @jax.jit
    def jstep(p, o, img, lab):
        l, g = jax.value_and_grad(jloss)(p, img, lab)
        p, o, _ = j_adamw_update(jopt, g, o, p)
        return p, o, l

    for step in range(5):
        img, lab = j_synthetic_images(0, step, 32, 32, 1, 10)
        jparams, jstate, want = jstep(jparams, jstate, img, lab)
        leaves, treedef = tree_flatten(params)
        live = [t.requires_grad_(True) for t in leaves]
        logits = cnn.cnn_forward(tpl, cnn.LENET, tree_unflatten(treedef, live),
                                 torch.from_numpy(np.array(img)))
        loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(np.array(lab))
                                                 .long())
        grads = tree_unflatten(treedef, torch.autograd.grad(loss, live))
        params, state, _ = adamw_update(opt, grads, state, tree_unflatten(
            treedef, [t.detach() for t in live]))
        assert abs(float(loss.detach()) - float(want)) <= LENET_LOSS_TOL, step


def test_batches_are_pure_functions_of_seed_and_step():
    a = synthetic_batch(0, 5, 4, 32, 1000)
    assert torch.equal(a, synthetic_batch(0, 5, 4, 32, 1000))
    assert not torch.equal(a, synthetic_batch(0, 6, 4, 32, 1000))
    assert not torch.equal(a, synthetic_batch(1, 5, 4, 32, 1000))
    assert int(a.min()) >= 0 and int(a.max()) < 1000
    img, lab = synthetic_images(0, 3, 4, 32, 3, 10)
    img2, lab2 = synthetic_images(0, 3, 4, 32, 3, 10)
    assert torch.equal(img, img2) and torch.equal(lab, lab2)
    assert img.shape == (4, 32, 32, 3) and img.dtype == torch.float32
    assert lab.shape == (4,) and int(lab.max()) < 10


def test_pipeline_includes_ctx_for_multimodal():
    for arch, n in (("whisper-medium", "n_frames"), ("llama-3.2-vision-90b",
                                                     "n_image_tokens")):
        cfg = reduced(get_config(arch))
        pipe = make_pipeline(cfg, SHAPES["train_4k"], global_batch=2, seq_len=16,
                             device="cpu")
        b = pipe.batch(0)
        assert b["ctx"].shape == (2, getattr(cfg, n), cfg.d_model)
        assert torch.equal(b["ctx"], pipe.batch(0)["ctx"])
        assert b["tokens"].shape == (2, 16)
    pipe = make_pipeline(reduced(get_config("qwen2-0.5b")), SHAPES["train_4k"],
                         device="cpu")
    assert set(pipe.batch(0)) == {"tokens"}
    assert pipe.batch(0)["tokens"].shape == (SHAPES["train_4k"].global_batch,
                                             SHAPES["train_4k"].seq_len)


def test_opt_state_checkpoint_round_trip(tmp_path):
    cfg = reduced(get_config("qwen2-0.5b"))
    params = T.init_params(torch.Generator().manual_seed(0), cfg, dtype=torch.bfloat16)
    state = adamw_init(params)
    state = state._replace(step=state.step + 3, m=tree_map(lambda t: t + 0.5, state.m))
    CheckpointManager(str(tmp_path)).save(3, {"params": params, "opt": state})
    fresh = T.init_params(torch.Generator().manual_seed(1), cfg, dtype=torch.bfloat16)
    step, got = CheckpointManager(str(tmp_path)).restore_latest(
        {"params": fresh, "opt": adamw_init(fresh)})
    assert step == 3 and isinstance(got["opt"], OptState)
    assert int(got["opt"].step) == 3 and got["opt"].step.dtype == torch.int32
    for a, b in zip(tree_leaves((params, state)), tree_leaves((got["params"], got["opt"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the examples' CLIs
# ---------------------------------------------------------------------------


def test_quickstart_cli():
    losses, out = quickstart.main(["--device", "cpu", "--steps", "12", "--batch", "4",
                                   "--seq", "32"])
    assert losses[-1] < losses[0]
    assert out.shape == (2, 12)


def test_fault_tolerant_train_cli():
    stats, history = fault_tolerant_train.main(["--device", "cpu", "--steps", "12"])
    assert stats["failures"] == 2 and stats["steps"] == 12
    assert history[-1] < history[0]


def test_train_lenet_q214_cli():
    res = train_lenet_q214.main(["--device", "cpu", "--float-steps", "6", "--qat-steps",
                                 "3", "--batch", "16"])
    assert len(res["float_losses"]) == 6 and len(res["qat_losses"]) == 3
    assert all(np.isfinite(res["float_losses"] + res["qat_losses"]))
    assert res["islands"] == (1, 1)  # the input's quantize, the read-out
    assert res["grid_logits"].shape == (16, 10)
    assert res["mixed"].layer_fmts  # the DSE chose a rung for every layer
