"""The port's atomic checkpoints and fault-tolerance runtime, on the CPU.

* The reference's ``tests/test_checkpoint_failover.py`` cases that need
  no training, on the port: the save / restore round trip, atomicity, shape
  mismatches, rotation, the restart loop, heartbeats, stragglers and the
  elastic remesh plan.
* Restoring onto shardings (the elastic re-shard) on the four ranks of a
  (2, 2) ("data", "model") mesh: each rank gets its column-parallel slice
  of every leaf, the same slice of the reference's tree that the
  reference's ``column_parallel_shardings`` names; ``convert`` carries the
  reference's numpy tree into the same shards.
* Against the reference: both packages write equal manifests for the same
  tree, and each restores the other's arrays bit for bit; ``FaultPlan``,
  ``HeartbeatMonitor``, ``detect_stragglers`` and ``plan_elastic_remesh``
  give the reference's outputs.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmanager
from repro.runtime import failover as jfailover
from repro_torch.checkpoint import CheckpointManager, latest_step, manifest_extra, restore, save
from repro_torch.checkpoint import manager as M
from repro_torch.runtime import (
    FailureInjector,
    FaultPlan,
    HeartbeatMonitor,
    SimulatedFailure,
    detect_stragglers,
    plan_elastic_remesh,
    run_with_restarts,
)


#: a hung collective fails the test instead of the run
RANKS_TIMEOUT_S = 300


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.standard_normal((4, 8)).astype(np.float32),
        "nested": {"b": np.arange(6, dtype=np.int32), "c": np.float32(3.5)},
        "list": (np.ones((2, 2), np.float32), np.zeros((3,), np.float32)),
        "raw": rng.integers(-32768, 32767, (3, 5)).astype(np.int16),
    }


def _tree(seed=0):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(conv(v) for v in x)
        return torch.from_numpy(np.array(x))

    return conv(_np_tree(seed))


def _leaves(tree):
    return [leaf for _, leaf in M._walk(tree)]


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 7, t, extra={"note": "x"})
    assert latest_step(str(tmp_path)) == 7
    assert manifest_extra(str(tmp_path), 7) == {"note": "x"}
    back = restore(str(tmp_path), 7, _tree(1))
    for a, b in zip(_leaves(t), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(back["list"], tuple)


def test_bf16_leaf_travels_as_raw_int16(tmp_path):
    w = torch.randn((3, 4)).to(torch.bfloat16)
    save(str(tmp_path), 1, {"w": w})
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        meta = json.load(f)["arrays"]["w"]
    assert meta["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_00000001" / meta["file"]).dtype == np.int16
    back = restore(str(tmp_path), 1, {"w": torch.zeros((3, 4), dtype=torch.bfloat16)})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], w)


def test_atomicity_no_partial_checkpoints(tmp_path, monkeypatch):
    t = _tree()

    def boom(*a, **k):
        raise RuntimeError("crash mid-write")

    with monkeypatch.context() as mp:
        mp.setattr(M.json, "dump", boom)
        with pytest.raises(RuntimeError):
            save(str(tmp_path), 3, t)
    assert latest_step(str(tmp_path)) is None
    save(str(tmp_path), 4, t)
    assert [d for d in os.listdir(tmp_path) if ".tmp" in d] == []
    assert latest_step(str(tmp_path)) == 4


def test_restore_shape_mismatch_rejected(tmp_path):
    save(str(tmp_path), 1, {"w": torch.ones((4,))})
    with pytest.raises(ValueError):
        restore(str(tmp_path), 1, {"w": torch.ones((5,))})
    with pytest.raises(KeyError):
        restore(str(tmp_path), 1, {"v": torch.ones((4,))})


def test_manager_rotation(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, {"x": torch.full((2,), s)}, extra={"tick": s})
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4] and m.latest() == 4
    assert m.latest_extra() == (4, {"tick": 4})
    step, back = m.restore_latest({"x": torch.zeros((2,), dtype=torch.int64)})
    assert step == 4 and torch.equal(back["x"], torch.full((2,), 4))


def test_restore_onto_shardings_not_ported(tmp_path):
    """Restoring onto shardings: a None sharding keeps the whole leaf (the
    reference's default placement); a placement on a mesh without ranks (a
    layout only) is refused."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import NamedSharding, PartitionSpec

    save(str(tmp_path), 2, {"w": torch.ones((4, 4))})
    out = restore(str(tmp_path), 2, {"w": torch.ones((4, 4))}, shardings={"w": None})
    assert torch.equal(out["w"], torch.ones((4, 4)))
    layout = NamedSharding(make_test_mesh(), PartitionSpec(None, "model"))
    with pytest.raises(ValueError, match="ranks"):
        restore(str(tmp_path), 2, {"w": torch.ones((4, 4))}, shardings={"w": layout})


@pytest.fixture(scope="module")
def sharded_restore(tmp_path_factory):
    """Four ranks restore one checkpoint of a reduced qwen2 tree onto their
    column-parallel shardings, and convert the reference's tree directly."""
    import functools

    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models import transformer as JT
    from repro_torch.convert import transformer_params_from_numpy
    from repro_torch.launch.mesh import spawn_ranks

    import torch_shard_cases

    cfg_j = j_reduced(j_get_config("qwen2-0.5b"))
    params_np = jax.tree_util.tree_map(np.asarray,
                                       JT.init_params(jax.random.PRNGKey(3), cfg_j))
    directory = str(tmp_path_factory.mktemp("ckpt"))
    save(directory, 5, transformer_params_from_numpy(params_np))
    payload = {"params": params_np, "directory": directory, "step": 5}
    ranks = spawn_ranks(functools.partial(torch_shard_cases.checkpoint_case, payload), 4,
                        device="cpu", timeout=RANKS_TIMEOUT_S)
    return cfg_j, params_np, ranks


def _ref_slice(arr, spec, coords, sizes):
    """The slice of ``arr`` a rank at ``coords`` holds under the reference's
    PartitionSpec ``spec``."""
    for d, axes in enumerate(tuple(spec)):
        if axes is None:
            continue
        idx, n = 0, 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            idx, n = idx * sizes[a] + coords[a], n * sizes[a]
        step = arr.shape[d] // n
        arr = np.take(arr, range(idx * step, (idx + 1) * step), axis=d)
    return arr


def test_restore_onto_shardings_gives_each_rank_its_slice(sharded_restore):
    from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding

    from repro.models import transformer as JT
    from repro.parallel import sharding as JS

    cfg_j, params_np, ranks = sharded_restore
    sizes = {"data": 2, "model": 2}
    specs = JS.column_parallel_shardings(AbstractMesh((2, 2), ("data", "model")),
                                         JS.DECODE_RULES, params_np,
                                         JT.param_axes(cfg_j))
    want_specs = {}

    def walk(spec_tree, arr_tree, prefix=()):
        if isinstance(spec_tree, JNamedSharding):
            if isinstance(arr_tree, (dict, tuple, list)):
                for key, leaf in M._walk(arr_tree):
                    want_specs[M._name(prefix + key)] = spec_tree.spec
            else:
                want_specs[M._name(prefix)] = spec_tree.spec
            return
        items = spec_tree.items() if isinstance(spec_tree, dict) else enumerate(spec_tree)
        for k, sub in items:
            walk(sub, arr_tree[k], prefix + (k,))

    walk(specs, params_np)
    flat = {M._name(key): leaf for key, leaf in M._walk(params_np)}
    sharded = 0
    for rec in ranks:
        for which in ("restored", "converted"):
            got = rec[which]
            assert set(got) == set(flat)
            for name, arr in flat.items():
                want = _ref_slice(arr, want_specs[name], rec["coords"], sizes)
                np.testing.assert_array_equal(got[name], want, err_msg=name)
                sharded += got[name].shape != arr.shape
    assert sharded > 0


# ---------------------------------------------------------------------------
# against the reference: one on-disk format
# ---------------------------------------------------------------------------


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_manifests_equal_between_packages(tmp_path):
    save(str(tmp_path / "port"), 5, _tree(), extra={"tick": 5, "sessions": []})
    jtree = jax.tree_util.tree_map(jnp.asarray, _np_tree())
    jmanager.save(str(tmp_path / "ref"), 5, jtree, extra={"tick": 5, "sessions": []})
    assert _manifest(tmp_path / "port", 5) == _manifest(tmp_path / "ref", 5)


def test_each_package_restores_the_others_arrays_bit_for_bit(tmp_path):
    np_tree = _np_tree(3)
    jmanager.save(str(tmp_path / "ref"), 1, jax.tree_util.tree_map(jnp.asarray, np_tree))
    back = restore(str(tmp_path / "ref"), 1, _tree(0))
    for want, got in zip(_leaves(_tree(3)), _leaves(back)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    save(str(tmp_path / "port"), 1, _tree(3))
    jback = jmanager.restore(str(tmp_path / "port"), 1,
                             jax.tree_util.tree_map(jnp.asarray, _np_tree(0)))
    for want, got in zip(jax.tree_util.tree_leaves(np_tree), jax.tree_util.tree_leaves(jback)):
        got = np.asarray(got)
        assert got.dtype == np.asarray(want).dtype
        assert got.tobytes() == np.asarray(want).tobytes()


# ---------------------------------------------------------------------------
# restart loop
# ---------------------------------------------------------------------------


def test_run_with_restarts_resumes_exactly():
    state = {"acc": 0.0}
    ckpt = {}
    seen = []
    inj = FailureInjector(fail_at_steps=[7, 13])

    def step_fn(step):
        inj.check(step)
        seen.append(step)
        state["acc"] += float(step)

    def save_fn(step):
        ckpt[step] = dict(state)

    def restore_fn():
        if not ckpt:
            state.update(acc=0.0)
            return 0
        s = max(ckpt)
        state.update(ckpt[s])
        return s

    stats = run_with_restarts(num_steps=20, step_fn=step_fn, save_fn=save_fn,
                              restore_fn=restore_fn, checkpoint_every=5, max_failures=3)
    assert stats["failures"] == 2 and stats["restarts"] == [5, 10]
    assert state["acc"] == sum(range(20))
    assert sorted(set(seen)) == list(range(20))
    assert sorted(s for s in set(seen) if seen.count(s) == 2) == [5, 6, 10, 11, 12]


def test_run_with_restarts_gives_up_after_max():
    def step_fn(step):
        if step == 1:
            raise SimulatedFailure("always")

    with pytest.raises(SimulatedFailure):
        run_with_restarts(num_steps=5, step_fn=step_fn, save_fn=lambda s: None,
                          restore_fn=lambda: 0, max_failures=2)


# ---------------------------------------------------------------------------
# heartbeats / stragglers / elasticity, each against the reference
# ---------------------------------------------------------------------------


def test_heartbeat_detects_dead_host():
    mons = [mod(["h0", "h1", "h2"], timeout_steps=2)
            for mod in (HeartbeatMonitor, jfailover.HeartbeatMonitor)]
    for mon in mons:
        for step in range(5):
            mon.report("h0", step, 1.0)
            mon.report("h1", step, 1.0 + 3.0 * (step > 1))
            if step < 2:
                mon.report("h2", step, 1.0)
    assert mons[0].dead_hosts(current_step=4) == ["h2"]
    for now in range(7):
        assert mons[0].dead_hosts(now) == mons[1].dead_hosts(now)
    assert mons[0].stragglers() == mons[1].stragglers()


def test_straggler_detection_median_policy():
    times = {"h0": [1.0] * 5, "h1": [1.0] * 5, "h2": [1.0] * 5,
             "slow": [1.0, 1.0, 3.1, 3.2, 3.3]}
    assert detect_stragglers(times, factor=2.0, patience=3) == ["slow"]
    times["blip"] = [1.0, 1.0, 1.0, 3.5, 1.0]
    assert "blip" not in detect_stragglers(times, factor=2.0, patience=3)
    rng = np.random.default_rng(4)
    for _ in range(20):
        draw = {f"h{i}": [float(x) for x in rng.uniform(0.5, 4.0, int(rng.integers(1, 6)))]
                for i in range(5)}
        for factor, patience in ((2.0, 3), (1.5, 1)):
            assert detect_stragglers(draw, factor, patience) == \
                jfailover.detect_stragglers(draw, factor, patience)


def test_elastic_remesh_plan():
    plan = plan_elastic_remesh({"data": 16, "model": 16}, lost_hosts=4, hosts_per_replica=4)
    assert plan.new_shape == (15, 16) and plan.dropped_axis == "data"
    with pytest.raises(SimulatedFailure):
        plan_elastic_remesh({"data": 1, "model": 16}, lost_hosts=8, hosts_per_replica=4)
    for shape in ({"data": 16, "model": 16}, {"pod": 2, "data": 8, "model": 4}):
        for lost, per in ((0, 4), (1, 4), (4, 4), (9, 2)):
            got = plan_elastic_remesh(shape, lost, per)
            want = jfailover.plan_elastic_remesh(shape, lost, per)
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.old_shape, got.new_shape, got.dropped_axis, got.note) == \
                    (want.old_shape, want.new_shape, want.dropped_axis, want.note)


def test_fault_plan_equals_the_reference():
    spec = dict(kills=((3, 0), (3, 1), (7, 0)), reject_windows=((0, 1, 4), (1, 6, 6)),
                delayed_saves=((0, 2, 3), (1, 4, 1)))
    ours, ref = FaultPlan(**spec), jfailover.FaultPlan(**spec)
    for tick in range(10):
        assert ours.kills_at(tick) == ref.kills_at(tick)
        for replica in range(3):
            assert ours.rejects_admission(replica, tick) == \
                ref.rejects_admission(replica, tick)
            assert ours.save_delay(replica, tick) == ref.save_delay(replica, tick)
