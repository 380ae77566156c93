"""The port's other model families served, held against the JAX package:
``serve.main --arch`` for every family, the reference's refusals (grid-
resident fixed point for every family but the dense stack, the scheduler
for all but dense and MoE) and reduced granite-moe through both packages'
``ServeScheduler``.  Setup and tolerances: ``tests/torch_family_cases.py``
and ``test_torch_families.py``'s docstring.
"""
import jax
import numpy as np
import pytest

from repro.configs import all_configs as j_all_configs
from repro.core.quantization import NumericsPolicy as JNumericsPolicy
from repro.core.template import default_template as j_template
from repro.launch import scheduler as jsched
from repro.models import transformer as JT
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.quantization import NumericsPolicy
from repro_torch.core.template import default_template
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from torch_family_cases import NEW, _cfgs, _make, _np_tree


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_serve_main_runs_every_family_on_cpu():
    for name in NEW:
        out = serve.main(["--device", "cpu", "--arch", name, "--prompts", "2",
                          "--prompt-len", "8", "--gen", "3"])
        assert out.shape == (2, 3), name
    out = serve.main(["--device", "cpu", "--arch", "granite-moe-3b-a800m", "--scheduler",
                      "--prompts", "3", "--prompt-len", "8", "--gen", "3"])
    assert [len(row) for row in out] == [3, 3, 3]
    with pytest.raises(SystemExit, match="scheduler requires full-attention"):
        serve.main(["--device", "cpu", "--arch", "mamba2-1.3b", "--scheduler"])


@pytest.mark.parametrize("name", [n for n in NEW if j_all_configs()[n].family != "dense"])
def test_q16_and_scheduler_refusals_match_reference(name):
    """Grid-resident fixed point refuses every family but the dense stack,
    and the scheduler every family but dense and MoE, with the reference's
    ValueError (the same message)."""
    cfg_j, cfg = _cfgs(name)
    params_j = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    params = transformer_params_from_numpy(_np_tree(params_j))
    with pytest.raises(ValueError) as want:
        JT.quantize_params(j_template("q16"), cfg_j, params_j, JNumericsPolicy("q16"))
    with pytest.raises(ValueError) as got:
        T.quantize_params(default_template("q16", device="cpu"), cfg, params,
                          NumericsPolicy("q16"))
    assert str(got.value) == str(want.value)
    if cfg.family == "moe":
        jsched.ServeScheduler(cfg_j, params_j, tpl=j_template("xla"))
        tsched.ServeScheduler(cfg, params, tpl=default_template("cuda", device="cpu"))
        return
    with pytest.raises(ValueError) as want:
        jsched.ServeScheduler(cfg_j, params_j, tpl=j_template("xla"))
    with pytest.raises(ValueError) as got:
        tsched.ServeScheduler(cfg, params, tpl=default_template("cuda", device="cpu"))
    assert str(got.value) == str(want.value)


def test_granite_scheduler_matches_reference():
    """Reduced granite-moe (the config's own capacity factor: tokens drop)
    through both packages' ServeScheduler on one trace: the same history,
    event for event, and the same greedy tokens."""
    cfg_j, cfg, params_j, params, _, _ = _make("granite-moe-3b-a800m")
    ladder = (8, 16, 24)
    rng = np.random.default_rng(7)
    lengths = [5, 9, 3, 17, 8, 24, 2, 12]
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab, size=n)) for n in lengths]
    arrivals = [float(i % 3) for i in range(len(lengths))]
    mine = [tsched.Request(prompt=p, max_new=4, arrival=a, rid=20_000 + i)
            for i, (p, a) in enumerate(zip(prompts, arrivals))]
    ref = [jsched.Request(prompt=p, max_new=4, arrival=a, rid=20_000 + i)
           for i, (p, a) in enumerate(zip(prompts, arrivals))]
    ps = tsched.ServeScheduler(cfg, params, tpl=default_template("cuda", device="cpu"),
                               clock=tsched.VirtualClock(),
                               sched=tsched.SchedulerConfig(ladder=ladder, slots=3,
                                                            max_new_limit=4))
    js = jsched.ServeScheduler(cfg_j, params_j, tpl=j_template("xla"),
                               clock=jsched.VirtualClock(),
                               sched=jsched.SchedulerConfig(ladder=ladder, slots=3,
                                                            max_new_limit=4))
    tsched.replay_trace(ps, mine, tick=1.0)
    jsched.replay_trace(js, ref, tick=1.0)
    assert ps.history == js.history
    for a, b in zip(mine, ref):
        assert (a.slot_history, a.bucket, a.finish_reason, a.completed_at) == (
            b.slot_history, b.bucket, b.finish_reason, b.completed_at)
        assert a.generated == b.generated, a.rid
    assert ps.counters == js.counters and ps.counters["completed"] == len(lengths)
