"""Spatial (H-slab) sharding of the CNN zoo: the port against the reference.

The reference's ``tests/test_spatial_shard.py`` on the port, with fixed
geometries instead of random draws (the reference's property draws, about
once in 230, a geometry ``plan_spatial_halo`` rejects):

* the halo exchange and the slab mask, bit for bit against the reference's
  slab-major simulation, on one device (``axis=None``) and across the ranks
  of a (2, 2) ("data", "model") mesh of four ``gloo`` processes, where each
  rank holds its own slab and sends only its halo rows;
* the engine's spatial conv (``plan_conv(spatial=)``) against the
  reference's unsharded conv: float within 1e-6, q16 bit for bit;
* whole networks, LeNet, a seam-crossing LeNet and a reduced AlexNet (the
  zoo's layer structure at narrow widths and a 111² input, whose conv1
  runs at the ragged H = 27): q16 logits bit
  for bit, float within 1e-5 of the reference's unsharded forward, both as
  the one-device slab-major simulation and over the mesh's "data" axis.

The ranks are spawned once for the module (``torch_shard_cases.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import NumericsPolicy as JPolicy
from repro.core.quantization import Q2_14 as J_Q2_14
from repro.core.quantization import QTensor as JQTensor
from repro.core.quantization import quantize as j_quantize
from repro.core.template import default_template as j_template
from repro.models import cnn as JC
from repro.parallel import sharding as JS
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.core.quantization import NumericsPolicy, Q2_14, QTensor, quantize
from repro_torch.core.template import default_template
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import cnn as C
from repro_torch.parallel import sharding as S

import torch_shard_cases

#: a hung collective fails the test instead of the run
RANKS_TIMEOUT_S = 300

SEAM = ("seamnet", 28, 2, 7, ((5, 3, 1, 0, 2), (8, 3, 1, 0, 2)), (24,))
ALEX_R = ("alexnet-r", 111, 3, 10,
          ((8, 11, 4, 2, 3), (16, 5, 1, 2, 3), (24, 3, 1, 1, 0), (16, 3, 1, 1, 0),
           (16, 3, 1, 1, 3)), (32, 32))
NETS = {"lenet": dataclasses.astuple(C.LENET), "seamnet": SEAM, "alexnet-r": ALEX_R}
EXCHANGE = [(28, 3, 1, 1, 2), (27, 3, 1, 1, 2), (27, 3, 2, 1, 2), (26, 2, 2, 0, 2),
            (224, 11, 4, 2, 2), (13, 5, 1, 2, 2), (30, 1, 1, 0, 2)]


def _to_slabs_np(x, shards):
    n, h, w, c = x.shape
    lx = -(-h // shards)
    xp = np.pad(x, ((0, 0), (0, shards * lx - h), (0, 0), (0, 0)))
    return xp.reshape(n, shards, lx, w, c).transpose(1, 0, 2, 3, 4)


def _gather_np(v, ho):
    a = np.asarray(v)
    s, n = a.shape[0], a.shape[1]
    return a.transpose(1, 0, 2, 3, 4).reshape(n, s * a.shape[2], *a.shape[3:])[:, :ho]


def _exchange_input(geom, seed):
    h = geom[0]
    return np.random.default_rng(seed).standard_normal((2, h, 3, 2)).astype(np.float32)


def _net(name):
    """The net's specs in both packages, He-scale weights and small biases
    (numpy, seeded; the reference's ``init_cnn`` layout) and an input batch."""
    spec_t = C.CNNSpec(*NETS[name])
    spec_j = JC.CNNSpec(*NETS[name])
    rng = np.random.default_rng(0)
    params = {"convs": [], "fcs": []}
    ch, hw = spec_j.input_ch, spec_j.input_hw

    def leaf(shape, fan):
        return {"w": (rng.standard_normal(shape) * 0.5 * fan ** -0.5).astype(np.float32),
                "b": (rng.standard_normal(shape[-1]) * 0.05).astype(np.float32)}

    for cout, k, stride, pad, pool in spec_j.convs:
        params["convs"].append(leaf((k, k, ch, cout), k * k * ch))
        hw = (hw + 2 * pad - k) // stride + 1
        hw, ch = (hw // pool if pool else hw), cout
    fan = hw * hw * ch
    for wd in (*spec_j.fcs, spec_j.n_classes):
        params["fcs"].append(leaf((fan, wd), fan))
        fan = wd
    x = (rng.standard_normal((2, spec_j.input_hw, spec_j.input_hw, spec_j.input_ch))
         * 0.5).astype(np.float32)
    return spec_t, spec_j, params, x


@pytest.fixture(scope="module")
def nets():
    return {name: _net(name) for name in NETS}


@pytest.fixture(scope="module")
def reference(nets):
    """The reference's unsharded logits of each net, float and q16."""
    out = {}
    for name, (_, spec_j, params, x) in nets.items():
        p = jax.tree_util.tree_map(jnp.asarray, params)
        tq, pol = j_template("q16"), JPolicy("q16")
        out[name] = {
            "float": np.asarray(JC.cnn_forward(j_template("xla"), spec_j, p,
                                               jnp.asarray(x))),
            "q16": np.asarray(JC.cnn_forward(tq, spec_j, JC.quantize_cnn_params(
                tq, spec_j, p, pol), jnp.asarray(x), policy=pol)),
        }
    return out


@pytest.fixture(scope="module")
def ranks(nets):
    payload = {
        "exchange": [(g, _exchange_input(g, i)) for i, g in enumerate(EXCHANGE)],
        "nets": {name: (NETS[name], params, x) for name, (_, _, params, x) in nets.items()},
    }
    return spawn_ranks(functools.partial(torch_shard_cases.spatial_case, payload), 4,
                       device="cpu", timeout=RANKS_TIMEOUT_S)


# ---------------------------------------------------------------------------
# the halo exchange and the slab mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geom", EXCHANGE + [(28, 3, 1, 1, 3), (56, 3, 1, 1, 4),
                                             (26, 2, 2, 0, 3), (27, 5, 1, 2, 3)])
def test_halo_exchange_and_mask_bitwise_one_device(geom):
    hs, jhs = S.plan_spatial_halo(*geom), JS.plan_spatial_halo(*geom)
    assert dataclasses.asdict(hs) == dataclasses.asdict(jhs)
    x = _exchange_input(geom, 3)
    slabs = _to_slabs_np(x, hs.shards)
    got = S.halo_exchange(torch.from_numpy(np.ascontiguousarray(slabs)), hs).numpy()
    want = np.asarray(JS.halo_exchange(jnp.asarray(slabs), jhs))
    np.testing.assert_array_equal(got, want)
    raw = (x * 2 ** 14).astype(np.int16)
    slabs = _to_slabs_np(raw, hs.shards)
    np.testing.assert_array_equal(
        S.halo_exchange(torch.from_numpy(np.ascontiguousarray(slabs)), hs).numpy(),
        np.asarray(JS.halo_exchange(jnp.asarray(slabs), jhs)))
    v = np.random.default_rng(5).standard_normal((hs.shards, 2, hs.lo, 3, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(S.mask_slab_rows(torch.from_numpy(v), hs).numpy(),
                                  np.asarray(JS.mask_slab_rows(jnp.asarray(v), jhs)))


def test_halo_exchange_across_ranks(ranks):
    """Each rank's window is the reference simulation's window of its slab:
    only the halo rows crossed between the ranks of the "data" axis."""
    seen = set()
    for rec in ranks:
        s = rec["coords"]["data"]
        seen.add((s, rec["coords"]["model"]))
        for (geom, (win, mask, slab)) in zip(EXCHANGE, rec["exchange"]):
            assert slab == s
            jhs = JS.plan_spatial_halo(*geom)
            x = _exchange_input(geom, EXCHANGE.index(geom))
            want = np.asarray(JS.halo_exchange(jnp.asarray(_to_slabs_np(x, 2)), jhs))[s]
            np.testing.assert_array_equal(win, want)
            ones = jnp.ones((2, 1, jhs.lo, 2, 1))
            np.testing.assert_array_equal(mask, np.asarray(JS.mask_slab_rows(ones, jhs))[s])
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


# ---------------------------------------------------------------------------
# the engine's spatial conv
# ---------------------------------------------------------------------------

CONVS = [(27, 9, 4, 8, 3, 1, 1, 2), (27, 9, 4, 8, 3, 2, 1, 2), (28, 7, 3, 5, 5, 1, 2, 2),
         (29, 11, 2, 6, 5, 2, 0, 3), (16, 6, 1, 4, 1, 1, 0, 3), (30, 8, 5, 3, 3, 1, 0, 3)]


@pytest.mark.parametrize("h,w,cin,cout,kh,stride,pad,shards", CONVS)
def test_spatial_conv_matches_unsharded(h, w, cin, cout, kh, stride, pad, shards):
    rng = np.random.default_rng(h * 100 + kh)
    x = np.clip(rng.standard_normal((2, h, w, cin)) * 0.25, -1, 1).astype(np.float32)
    wt = np.clip(rng.standard_normal((kh, kh, cin, cout)) * 0.25, -1, 1).astype(np.float32)
    b = np.clip(rng.standard_normal((cout,)) * 0.1, -1, 1).astype(np.float32)
    jeng = j_template("pallas").engine
    ref = np.asarray(jeng.conv2d(jnp.asarray(x), jnp.asarray(wt), bias=jnp.asarray(b),
                                 relu=True, plan=jeng.plan_conv(x.shape, wt.shape,
                                                                stride=stride,
                                                                padding=pad)))
    eng = default_template("cuda", device="cpu").engine
    sp = eng.plan_conv(x.shape, wt.shape, stride=stride, padding=pad, spatial=shards)
    assert sp.halo is not None and sp.pad == 0
    out = eng.conv2d(torch.from_numpy(np.ascontiguousarray(_to_slabs_np(x, shards))),
                     torch.from_numpy(wt), bias=torch.from_numpy(b), relu=True, plan=sp)
    np.testing.assert_allclose(_gather_np(out, sp.halo.ho), ref, rtol=0, atol=1e-6)
    assert eng.counters["conv_spatial"] == 1

    jq = j_template("q16").engine
    qx, qw, qb = (JQTensor(j_quantize(jnp.asarray(a), J_Q2_14), J_Q2_14) for a in (x, wt, b))
    want = np.asarray(jq.conv2d(qx, qw, bias=qb, relu=True, plan=jq.plan_conv(
        x.shape, wt.shape, stride=stride, padding=pad)).raw)
    tq = default_template("q16", device="cpu").engine
    tx, tw, tb = (QTensor(quantize(torch.from_numpy(a), Q2_14), Q2_14) for a in (x, wt, b))
    sq = tq.plan_conv(x.shape, wt.shape, stride=stride, padding=pad, spatial=shards)
    slab = QTensor(torch.from_numpy(np.ascontiguousarray(_to_slabs_np(tx.raw.numpy(),
                                                                      shards))), Q2_14)
    got = tq.conv2d(slab, tw, bias=tb, relu=True, plan=sq)
    assert isinstance(got, QTensor)
    np.testing.assert_array_equal(_gather_np(got.raw, sq.halo.ho), want)


# ---------------------------------------------------------------------------
# whole networks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,shards", [("lenet", 2), ("lenet", 3), ("seamnet", 2),
                                         ("alexnet-r", 2)])
def test_spatial_cnn_forward_one_device(nets, reference, name, shards):
    spec, _, params, x = nets[name]
    tp = cnn_params_from_numpy(params)
    tpl = default_template("cuda", device="cpu")
    plan = C.plan_cnn(tpl, spec, x.shape, spatial=shards)
    assert plan.spatial == shards and plan.feat_h > 0
    if name == "seamnet":
        # the pool seam is misaligned: per-shard window offsets differ
        assert len(set(plan.pool_halos[0].offsets)) > 1
    got = C.cnn_forward(tpl, spec, tp, torch.from_numpy(x), plan=plan).numpy()
    np.testing.assert_allclose(got, reference[name]["float"], rtol=0, atol=1e-5)

    tq, pol = default_template("q16", device="cpu"), NumericsPolicy("q16")
    qp = C.quantize_cnn_params(tq, spec, tp, pol)
    qplan = C.plan_cnn(tq, spec, x.shape, spatial=shards)
    got = C.cnn_forward(tq, spec, qp, torch.from_numpy(x), policy=pol, plan=qplan).numpy()
    np.testing.assert_array_equal(got, reference[name]["q16"])


@pytest.mark.parametrize("name", list(NETS))
def test_spatial_cnn_forward_across_ranks(nets, reference, ranks, name):
    """Two slabs over "data" (each slab on two "model" ranks): every rank's
    logits are the reference's unsharded ones, q16 bit for bit."""
    spec = nets[name][0]
    for rec in ranks:
        got = rec["forward"][name]
        np.testing.assert_array_equal(got["q16"], reference[name]["q16"])
        np.testing.assert_allclose(got["float"], reference[name]["float"], rtol=0,
                                   atol=1e-5)
        assert got["conv_spatial"] == len(spec.convs)
        assert got["warm_misses"] == 0  # a warm forward plans nothing
        assert all("halo=S2" in line for line in got["describe"][:len(spec.convs)])


def test_spatial_plans_memoized_separately():
    tpl = default_template("cuda", device="cpu")
    shape = (2, 32, 32, 1)
    p1 = C.plan_cnn(tpl, C.LENET, shape)
    p2 = C.plan_cnn(tpl, C.LENET, shape, spatial=2)
    p3 = C.plan_cnn(tpl, C.LENET, shape, spatial=2)
    assert p1.spatial == 1 and p2.spatial == 2
    assert p2 is p3 and p1 is not p2
    assert any("halo=S2" in line for line in p2.describe())
    jp = JC.plan_cnn(j_template("pallas"), JC.LENET, shape, spatial=2)
    assert [cp.halo for cp in p2.convs] == [
        S.SpatialHalo(**dataclasses.asdict(cp.halo)) for cp in jp.convs]
    assert p2.pool_halos == tuple(S.SpatialHalo(**dataclasses.asdict(h))
                                  for h in jp.pool_halos)
    assert p2.feat_h == jp.feat_h
