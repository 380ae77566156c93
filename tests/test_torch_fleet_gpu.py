"""The serving fleet on the card: a reduced qwen2-0.5b (random weights from
a seed) on the grid.

* Two live schedulers on one q16 template, stepped in turn, each decode in
  a cache and a CUDA graph of their own: each one's tokens equal its own
  run alone, and releasing one drops only its graphs.
* A :class:`ReplicaRouter` kill on the grid keeps the token ledger
  byte-identical to a one-replica, fault-free run.
* ``measure_and_pin`` times the hand-written GEMM kernels route against
  route and pins a legal plan that round-trips through the plan store and
  is the one the next call launches.

Every test needs an NVIDIA card and skips without one; run them there with
``python -m pytest --noconftest -m gpu tests/test_torch_fleet_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import dse
from repro_torch.core.engine import Engine, PlanRegistry
from repro_torch.core.template import TemplateConfig, default_template
from repro_torch.core.tiling import H100
from repro_torch.kernels import _build
from repro_torch.launch.router import ReplicaRouter
from repro_torch.launch.scheduler import (
    CAPTURE_COUNTS,
    Request,
    SchedulerConfig,
    ServeScheduler,
    VirtualClock,
    replay_trace,
)
from repro_torch.models import transformer as T
from repro_torch.runtime.failover import FaultPlan

pytestmark = pytest.mark.gpu

LADDER = (8, 16, 24)


@pytest.fixture(scope="module")
def dev():
    """The card, decided when a test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def grid(dev):
    cfg = reduced(get_config("qwen2-0.5b"))
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tpl = default_template("q16")
    cal = torch.randint(0, cfg.vocab, (2, 16), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(9))
    return cfg, params, tpl, T.calibrate_policy(tpl, cfg, params, cal)


def _sched(grid, slots=3):
    cfg, params, tpl, pol = grid
    return ServeScheduler(cfg, params, tpl=tpl, policy=pol, clock=VirtualClock(),
                          sched=SchedulerConfig(ladder=LADDER, slots=slots, max_new_limit=6))


def _trace(seed, lengths, base_rid):
    rng = np.random.default_rng(seed)
    return [Request(prompt=tuple(int(t) for t in rng.integers(0, 96, n)),
                    max_new=3 + i % 4, rid=base_rid + i) for i, n in enumerate(lengths)]


def _ptrs(tree) -> set:
    if isinstance(tree, dict):
        return set().union(*(_ptrs(v) for v in tree.values()))
    if isinstance(tree, (tuple, list)):
        return set().union(*(_ptrs(v) for v in tree))
    return {tree.data_ptr()}


def test_two_live_schedulers_keep_their_own_cache(grid):
    lens_a, lens_b = [5, 9, 3, 15, 8], [16, 2, 11, 7, 12]
    alone = []
    for seed, lens in ((1, lens_a), (2, lens_b)):
        s = _sched(grid)
        s.warmup()
        trace = _trace(seed, lens, 0)
        replay_trace(s, trace, tick=1.0)
        alone.append([s.results[r.rid].generated for r in trace])
        s.release()
    caps = sum(CAPTURE_COUNTS.values())
    a, b = _sched(grid), _sched(grid)
    a.warmup()
    b.warmup()
    assert sum(CAPTURE_COUNTS.values()) == caps + 2, "one capture per owner"
    ta, tb = _trace(1, lens_a, 100), _trace(2, lens_b, 200)
    for ra, rb in zip(ta, tb):
        assert a.submit(ra) and b.submit(rb)
    while a.queue or a.active or b.queue or b.active:
        a.step()
        b.step()
        if a.cache is not None and b.cache is not None:
            assert not _ptrs(a.cache) & _ptrs(b.cache), "two schedulers share a cache"
    assert sum(CAPTURE_COUNTS.values()) == caps + 2, "no capture after warm-up"
    assert [a.results[r.rid].generated for r in ta] == alone[0]
    assert [b.results[r.rid].generated for r in tb] == alone[1]
    step = a._decode_next
    n_b = sum(1 for key in step.graphs if key[1] == id(b))
    a.release()
    assert not any(key[1] == id(a) for key in step.graphs)
    assert sum(1 for key in step.graphs if key[1] == id(b)) == n_b >= 1


def test_router_kill_keeps_the_grid_ledger(grid, tmp_path):
    cfg, params, tpl, pol = grid

    def make(rid, clock):
        return ServeScheduler(cfg, params, tpl=tpl, policy=pol, clock=clock,
                              sched=SchedulerConfig(ladder=LADDER, slots=3, max_new_limit=6))

    lens = [5, 9, 3, 15, 8, 16, 2, 11]
    ref = ReplicaRouter(make, 1, clock=VirtualClock())
    trace = _trace(3, lens, 1000)
    ref.run(trace)
    want = ref.ledger.as_dict()
    router = ReplicaRouter(make, 2, clock=VirtualClock(),
                           fault_plan=FaultPlan(kills=((3, 0),)),
                           checkpoint_dir=str(tmp_path), checkpoint_every=1)
    router.run(_trace(3, lens, 1000))
    router.verify_against(want)
    router.assert_exactly_once()
    assert router.counters["killed"] == 1 and router.counters["restored_sessions"] > 0
    assert router.replicas[0].graveyard and router.replicas[0].incarnation == 1


@pytest.mark.parametrize("kernel,m", [("matmul_fp", 4), ("matmul_fp", 64),
                                      ("matmul_q16", 4), ("matmul_q16", 64)])
def test_measure_and_pin_on_the_card(dev, tmp_path, kernel, m):
    n, k = 512, 256
    reg = PlanRegistry()
    eng = Engine(TemplateConfig(backend="cuda" if kernel == "matmul_fp" else "q16"),
                 plan_cache=reg)
    dtype = torch.bfloat16
    best = eng.measure_and_pin(m, n, k, dtype=dtype, top_k=4, reps=3)
    widths = dict(dtype_bytes=2) if kernel == "matmul_fp" else dict(xbits=16, wbits=16)
    legal = dse.fp_block_legal if kernel == "matmul_fp" else dse.q16_block_legal
    assert legal(best, m, n, k, spec=H100, **widths)
    assert len(reg.last_measurement) >= 2
    assert all(t > 0 for _, t in reg.last_measurement)
    assert reg.source_for(m, n, k, kernel=kernel, **widths) == "measured"
    path = str(tmp_path / "store.json")
    reg.save(path)
    warm = PlanRegistry()
    warm.load(path)
    assert warm.source_for(m, n, k, kernel=kernel, **widths) == "measured"
    eng2 = Engine(eng.config, plan_cache=warm)
    _build.reset_launches()
    if kernel == "matmul_fp":
        x = torch.randn((m, k), device=dev, dtype=dtype)
        w = torch.randn((k, n), device=dev, dtype=dtype)
        eng2.matmul(x, w)
    else:
        from repro_torch.core.quantization import QTensor, Q2_14

        x = torch.randint(-3000, 3000, (m, k), device=dev, dtype=torch.int16)
        w = torch.randint(-3000, 3000, (k, n), device=dev, dtype=torch.int16)
        eng2.matmul(QTensor(x, Q2_14), QTensor(w, Q2_14))
    torch.cuda.synchronize()
    assert warm.misses == 0
    assert _build.launches[f"{kernel}.{best.route}"] == 1
