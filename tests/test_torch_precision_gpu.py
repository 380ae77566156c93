"""The precision DSE on the card, held to the same DSE on the CPU.

Reduced qwen2-0.5b (random weights from a seed, f32, tied embeddings) and
LeNet: ``calibrate_precision`` / ``calibrate_cnn_precision`` on a CUDA q16
template (the kernels) and on a CPU one (their plain versions), from the
same weights and calibration batch, measure the same solo-flip drifts and
pick the same plan (the transformer's drifts within one argmax row of the
32: its f32 islands, norms and softmax, may differ by an ulp between the
card and the CPU, as between the two packages).  The default reference forward runs the per-op q16
path, whose tied LM head multiplies by the embedding table's transposed
view.  Every test needs an NVIDIA card and skips without one; run them
there with ``python -m pytest --noconftest -m gpu``.
"""
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.engine import reset_plan_caches
from repro_torch.core.template import default_template
from repro_torch.kernels import _build
from repro_torch.models import cnn
from repro_torch.models import transformer as T

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    """The card, decided when a test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    return torch.device("cuda", 0)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def _drifts(tpl, net, names):
    reg = tpl.engine.plan_cache
    return {n: reg.precision_for(net, n, tpl.config.hw).drift for n in names}


@pytest.mark.parametrize("budget", [0.99, 0.5, 0.0])
def test_transformer_dse_on_the_card_equals_the_cpu(dev, budget):
    cfg = reduced(get_config("qwen2-0.5b"))
    assert cfg.tie_embeddings
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    cal = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(9))
    names = T.precision_group_names(cfg)
    out = {}
    for device, tree, tokens in (("cpu", params, cal), ("cuda", _to(params, dev),
                                                          cal.to(dev))):
        reset_plan_caches()
        tpl = default_template("q16", device=device)
        pol = T.calibrate_policy(tpl, cfg, tree, tokens)
        got = T.calibrate_precision(tpl, cfg, tree, tokens, budget=budget, policy=pol)
        out[device] = (got, _drifts(tpl, cfg.name, names))
    reset_plan_caches()
    (got, drift), (want, want_drift) = out["cuda"], out["cpu"]
    assert got.layer_fmts == want.layer_fmts and got.fmt == want.fmt
    assert all(abs(drift[n] - want_drift[n]) <= 1 / cal.numel() for n in names)


def test_cnn_dse_on_the_card_equals_the_cpu(dev):
    spec = cnn.LENET
    params = cnn.init_cnn(torch.Generator().manual_seed(0), spec, scale=0.4)
    x = torch.rand((4, 32, 32, 1), generator=torch.Generator().manual_seed(2)) * 2 - 1
    names = cnn.cnn_layer_names(spec)
    out = {}
    for device in ("cpu", "cuda"):
        reset_plan_caches()
        tpl = default_template("q16", device=device)
        tree, xs = _to(params, device), x.to(device)
        pol = cnn.calibrate_cnn_policy(tpl, spec, tree, xs)
        got = cnn.calibrate_cnn_precision(tpl, spec, tree, xs, budget=0.99, policy=pol)
        out[device] = (got, _drifts(tpl, spec.name, names))
    reset_plan_caches()
    assert out["cuda"] == out["cpu"]
