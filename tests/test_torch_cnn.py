"""The port's CNN main path held against the JAX package on the same weights.

Weights come from the reference's ``init_cnn`` and cross over as numpy
arrays through ``repro_torch.convert``; inputs are numpy draws from a fixed
seed.  The port runs with ``device="cpu"`` (its wrappers then run the
kernels' plain versions); JAX runs on the CPU, its Pallas kernels in
interpret mode.

* Float logits agree within 2e-3 (the reference's conv tolerance,
  ``tests/test_kernels.py``), against both the ``xla`` and the ``pallas``
  reference backends.
* Grid-resident Q2.14 and a forced-mixed int8/int16 policy give
  bit-identical logits, after formats and raws that are equal leaf by leaf.
* The counters hold the island law: one quantize and one dequantize per
  grid-resident forward, one kernel call per layer, and a warm forward
  plans nothing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import Q2_6 as J_Q2_6, Q2_14 as J_Q2_14, QTensor as JQTensor
from repro.core.quantization import NumericsPolicy as JPolicy
from repro.core.template import default_template as j_template
from repro.models import cnn as jcnn
from repro_torch.convert import cnn_params_from_numpy, qparams_from_numpy
from repro_torch.core.quantization import Q2_6, Q2_14, NumericsPolicy, QFormat, QTensor
from repro_torch.core.template import Template, TemplateConfig, default_template
from repro_torch.models import cnn as tcnn

# a narrow VGG-style net: 32x32x3, convs (8, 8, 16) with two pools
J_MINI = jcnn.CNNSpec("vggmini", 32, 3, 10,
                      convs=((8, 3, 1, 1, 0), (8, 3, 1, 1, 2), (16, 3, 1, 1, 2)),
                      fcs=(32,))
T_MINI = tcnn.CNNSpec(**dataclasses.asdict(J_MINI))
NETS = {"lenet": (jcnn.LENET, tcnn.LENET), "vggmini": (J_MINI, T_MINI)}
MIXED = {
    "lenet": (("conv0", "Q2_6"), ("fc0", "Q2_6"), ("fc2", "Q2_6")),
    "vggmini": (("conv0", "Q2_6"), ("conv2", "Q2_6"), ("fc1", "Q2_6")),
}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _qtree_np(qp):
    def leaf(q):
        return np.asarray(q.raw), (q.fmt.int_bits, q.fmt.frac_bits, q.fmt.total_bits)

    return {g: [{k: leaf(v) for k, v in layer.items()} for layer in qp[g]]
            for g in ("convs", "fcs")}


def _mixed(name, pkg):
    fmts = {"Q2_6": (J_Q2_6 if pkg == "jax" else Q2_6)}
    cls, base = (JPolicy, J_Q2_14) if pkg == "jax" else (NumericsPolicy, Q2_14)
    return cls("mixed", fmt=base, layer_fmts=tuple((n, fmts[f]) for n, f in MIXED[name]))


def _fitted_tree(jspec, tspec, key, img):
    """A random net whose every layer has a bias, as numpy arrays.

    The reference's ``init_cnn`` at He scale √2 gives the weights; biases
    are numpy draws; the port's ``fit_cnn_activations`` then scales each
    hidden layer so its float output on ``img`` peaks at 0.5, inside the
    activation grid that calibration picks from the input.  The logits are
    O(0.1-1), so the float tolerance below is small beside them.
    """
    tree = _np_tree(jcnn.init_cnn(jax.random.PRNGKey(key), jspec, scale=2 ** 0.5))
    rng = np.random.default_rng(key + 11)
    for g in ("convs", "fcs"):
        for layer in tree[g]:
            layer["b"] = (0.1 * rng.standard_normal(layer["b"].shape)).astype(np.float32)
    fitted = tcnn.fit_cnn_activations(default_template("torch", device="cpu"), tspec,
                                      cnn_params_from_numpy(tree), torch.from_numpy(img))
    return {g: [{k: v.numpy() for k, v in layer.items()} for layer in fitted[g]]
            for g in ("convs", "fcs")}


@pytest.fixture(scope="module", params=list(NETS))
def net(request):
    """(name, jax spec, port spec, jax params, port params, image numpy)."""
    name = request.param
    jspec, tspec = NETS[name]
    rng = np.random.default_rng(7)
    img = (rng.uniform(-1, 1, (2, jspec.input_hw, jspec.input_hw, jspec.input_ch))
           .astype(np.float32))
    tree = _fitted_tree(jspec, tspec, 0, img)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return name, jspec, tspec, params, cnn_params_from_numpy(tree), img


def test_float_logits_match_xla_and_pallas(net):
    name, jspec, tspec, jp, tp, img = net
    want_xla = np.asarray(jcnn.cnn_forward(j_template("xla"), jspec, jp, jnp.asarray(img)))
    want_pl = np.asarray(jcnn.cnn_forward(j_template("pallas"), jspec, jp, jnp.asarray(img)))
    for backend in ("cuda", "torch"):
        tpl = default_template(backend, device="cpu")
        got = tcnn.cnn_forward(tpl, tspec, tp, torch.from_numpy(img)).numpy()
        assert got.shape == (2, jspec.n_classes) and np.isfinite(got).all()
        assert np.abs(want_xla).max() > 0.1
        np.testing.assert_allclose(got, want_xla, atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(got, want_pl, atol=2e-3, rtol=2e-3)


def test_fake_quant_forward_matches_and_trains(net):
    name, jspec, tspec, jp, tp, img = net
    want = np.asarray(jcnn.cnn_forward(j_template("xla"), jspec, jp, jnp.asarray(img),
                                       quantized=True))
    got = tcnn.cnn_forward(default_template("cuda", device="cpu"), tspec, tp,
                           torch.from_numpy(img), quantized=True).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    # the torch backend keeps the STE path differentiable
    leaf = {g: [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
                for layer in tp[g]] for g in ("convs", "fcs")}
    out = tcnn.cnn_forward(default_template("torch", device="cpu"), tspec, leaf,
                           torch.from_numpy(img), quantized=True)
    out.square().sum().backward()
    assert all(l["w"].grad is not None for l in leaf["convs"] + leaf["fcs"])


def test_forced_im2col_route_matches(net):
    name, jspec, tspec, jp, tp, img = net
    want = np.asarray(jcnn.cnn_forward(j_template("xla"), jspec, jp, jnp.asarray(img)))
    tpl = default_template("cuda", device="cpu")
    plan = tcnn.plan_cnn(tpl, tspec, img.shape, force_route="im2col")
    tpl.engine.counters.clear()
    got = tcnn.cnn_forward(tpl, tspec, tp, torch.from_numpy(img), plan=plan).numpy()
    assert tpl.engine.counters["conv_im2col"] == len(tspec.convs)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)


def _grid_case(net, mixed: bool):
    """Run the reference and the port grid-resident on the same weights;
    returns (jax policy, port policy, jax qparams, port qparams, logits...)."""
    name, jspec, tspec, jp, tp, img = net
    jt = j_template("q16")
    tt = default_template("q16", device="cpu")
    if mixed:
        jpol, tpol = _mixed(name, "jax"), _mixed(name, "torch")
    else:
        jpol = jcnn.calibrate_cnn_policy(jt, jspec, jp, jnp.asarray(img))
        tpol = tcnn.calibrate_cnn_policy(tt, tspec, tp, torch.from_numpy(img))
    jqp = jcnn.quantize_cnn_params(jt, jspec, jp, jpol)
    tqp = tcnn.quantize_cnn_params(tt, tspec, tp, tpol)
    want = np.asarray(jcnn.cnn_forward(jt, jspec, jqp, jnp.asarray(img), policy=jpol))
    tt.engine.counters.clear()
    got = tcnn.cnn_forward(tt, tspec, tqp, torch.from_numpy(img), policy=tpol)
    return jpol, tpol, jqp, tqp, want, got, tt


@pytest.mark.parametrize("mixed", [False, True], ids=["q214", "mixed"])
def test_grid_resident_logits_bit_identical(net, mixed):
    name, jspec, tspec, jp, tp, img = net
    jpol, tpol, jqp, tqp, want, got, tt = _grid_case(net, mixed)
    fj, ft = jpol.fmt, tpol.fmt
    assert (ft.int_bits, ft.frac_bits, ft.total_bits) == (fj.int_bits, fj.frac_bits,
                                                          fj.total_bits)
    for g in ("convs", "fcs"):
        for lj, lt in zip(jqp[g], tqp[g]):
            for k in ("w", "b"):
                assert lt[k].fmt.name == lj[k].fmt.name
                assert lt[k].fmt.total_bits == lj[k].fmt.total_bits
                np.testing.assert_array_equal(lt[k].raw.numpy(), np.asarray(lj[k].raw))
    if mixed:
        assert tqp["convs"][0]["w"].raw.dtype == torch.int8
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the island law, and one kernel call per layer
    c = tt.engine.counters
    assert c["quantize_calls"] == 1 and c["dequantize_calls"] == 1
    assert c["conv_direct"] == len(tspec.convs)
    assert c["gemm_q16"] == len(tspec.fcs) + 1


def test_grid_resident_values_stay_inside_the_grid(net, monkeypatch):
    """The bit-identical checks run over values the grid holds: no raw of
    any layer's grid-resident output sits at its rung's bounds, every bias
    is non-zero, and the Q2.14-family logits follow the float ones."""
    name, jspec, tspec, jp, tp, img = net
    assert all(bool((l["b"] != 0).all()) for l in tp["convs"] + tp["fcs"])
    tt = default_template("q16", device="cpu")
    x = torch.from_numpy(img)
    pol = tcnn.calibrate_cnn_policy(tt, tspec, tp, x)
    qp = tcnn.quantize_cnn_params(tt, tspec, tp, pol)
    clipped, layers = [], []
    for meth in ("conv2d", "linear"):
        def probe(*a, _orig=getattr(tt.engine, meth), **kw):
            out = _orig(*a, **kw)
            if isinstance(out, QTensor):
                r, f = out.raw, out.fmt
                layers.append(f)
                clipped.append(int(((r == f.raw_max) | (r == f.raw_min)).sum()))
            return out

        monkeypatch.setattr(tt.engine, meth, probe)
    got = tcnn.cnn_forward(tt, tspec, qp, x, policy=pol)
    assert len(layers) == len(tspec.convs) + len(tspec.fcs) and sum(clipped) == 0
    want = tcnn.cnn_forward(default_template("torch", device="cpu"), tspec, tp, x)
    assert float((got - want).abs().max()) < 0.02 * float(want.abs().max())
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_quantized_params_cross_over_and_warm_forward_plans_nothing(net):
    name, jspec, tspec, jp, tp, img = net
    jt = j_template("q16")
    jpol = _mixed(name, "jax")
    jqp = jcnn.quantize_cnn_params(jt, jspec, jp, jpol)
    want = np.asarray(jcnn.cnn_forward(jt, jspec, jqp, jnp.asarray(img), policy=jpol))
    tt = default_template("q16", device="cpu")
    tpol = _mixed(name, "torch")
    tqp = qparams_from_numpy(_qtree_np(jqp))
    x = torch.from_numpy(img)
    tcnn.cnn_forward(tt, tspec, tqp, x, policy=tpol)  # cold: plans
    reg = tt.engine.plan_cache
    with reg.scope() as delta:
        got = tcnn.cnn_forward(tt, tspec, tqp, x, policy=tpol)
    assert delta["misses"] == 0
    np.testing.assert_array_equal(got.numpy(), want)
    # quantize once: a second preparation of the same tree is a cache hit
    q1 = tcnn.quantize_cnn_params(tt, tspec, tp, tpol)
    q2 = tcnn.quantize_cnn_params(tt, tspec, tp, tpol)
    assert q1 is q2 and tt.engine.counters["qparam_cache_hits"] >= 1
    assert tt.engine.drop_qparams(tp, tpol)


def test_legacy_per_op_q16_path_bit_identical():
    """The q16 backend on float operands: quantize / kernel / dequantize per
    op, every round trip counted."""
    img = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    tree = _fitted_tree(jcnn.LENET, tcnn.LENET, 1, img)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = cnn_params_from_numpy(tree)
    want = np.asarray(jcnn.cnn_forward(j_template("q16"), jcnn.LENET, jp, jnp.asarray(img)))
    tt = default_template("q16", device="cpu")
    got = tcnn.cnn_forward(tt, tcnn.LENET, tp, torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), want)
    c = tt.engine.counters
    assert c["quantize_calls"] == 3 * 5 and c["dequantize_calls"] == 5


@pytest.mark.parametrize("dtype", [np.int16, np.int8, np.float32])
@pytest.mark.parametrize("hw,w", [(8, 2), (7, 2), (13, 3)])
def test_maxpool_matches_reduce_window(dtype, hw, w):
    """Pooling crops to whole windows and takes ``amax`` over a reshape:
    exact for the int16 and int8 raws (odd sizes crop like VALID)."""
    rng = np.random.default_rng(hw * 10 + w)
    if dtype == np.float32:
        x = rng.standard_normal((2, hw, hw + 1, 5)).astype(dtype)
        want = np.asarray(jcnn._maxpool(jnp.asarray(x), w))
        got = tcnn._maxpool(torch.from_numpy(x), w).numpy()
    else:
        lim = np.iinfo(dtype).max
        x = rng.integers(-lim - 1, lim + 1, (2, hw, hw + 1, 5)).astype(dtype)
        want = np.asarray(jcnn._maxpool(JQTensor(jnp.asarray(x), J_Q2_14), w).raw)
        got_q = tcnn._maxpool(QTensor(torch.from_numpy(x), Q2_14), w)
        assert isinstance(got_q, QTensor) and got_q.fmt == Q2_14
        got = got_q.raw.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_wide_readout_descale_is_exact():
    """The classifier's int32 accumulator, descaled as ``out.float() *
    2.0 ** -acc_frac``, equals the reference's bits, also above 2^24."""
    acc = np.array([2**31 - 1, -2**31, 16777217, -16777219, 12345, 0], np.int32)
    for frac in (0, 13, 29):
        want = np.asarray(jnp.asarray(acc).astype(jnp.float32) * 2.0 ** -frac)
        got = (torch.from_numpy(acc).float() * 2.0 ** -frac).numpy()
        np.testing.assert_array_equal(got, want)


def test_template_config_device_and_no_interpret():
    fields = {f.name for f in dataclasses.fields(TemplateConfig)}
    assert "interpret" not in fields and "device" in fields
    assert TemplateConfig.__dataclass_fields__["backend"].default == "cuda"
    if torch.cuda.is_available():
        assert TemplateConfig().device == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            TemplateConfig()
        with pytest.raises(RuntimeError):
            default_template("q16")
    with pytest.raises(ValueError):
        TemplateConfig(backend="pallas", device="cpu")


def test_engine_refuses_operands_off_its_device():
    tpl = default_template("cuda", device="cpu")
    x = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="template runs on"):
        tpl.matmul(x, torch.empty((4, 3), device="meta"))


def test_quantized_policy_needs_q16_backend():
    tpl = Template(TemplateConfig(backend="cuda", device="cpu"))
    p = tcnn.init_cnn(torch.Generator().manual_seed(0), tcnn.LENET)
    with pytest.raises(ValueError, match="q16"):
        tcnn.quantize_cnn_params(tpl, tcnn.LENET, p, NumericsPolicy("q16"))


def test_init_cnn_shapes_and_seed():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = tcnn.init_cnn(g1, tcnn.VGG16)
    b = tcnn.init_cnn(g2, tcnn.VGG16)
    assert [tuple(l["w"].shape) for l in a["fcs"]] == [(25088, 4096), (4096, 4096),
                                                        (4096, 1000)]
    assert torch.equal(a["convs"][5]["w"], b["convs"][5]["w"])
    assert tcnn.cnn_layer_names(tcnn.LENET) == ("conv0", "conv1", "fc0", "fc1", "fc2")


def test_plan_describe_lists_every_layer():
    tcnn.reset_plans()
    tpl = default_template("q16", device="cpu")
    plan = tcnn.plan_cnn(tpl, tcnn.ALEXNET, (8, 224, 224, 3))
    lines = plan.describe()
    assert len(lines) == 8
    assert all("route=direct" in l and "cin_chunk=" in l for l in lines[:5])
    assert lines[5].startswith("fc0: m=8 n=4096 k=1024")
    assert QFormat(2, 14).name == "Q2.14"
