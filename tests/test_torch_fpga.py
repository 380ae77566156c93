"""The port's FPGA plane held to the JAX package's, exactly.

``repro_torch.core.fpga_model`` (the template's resource and cycle model),
``dse.explore_board`` (the search over compute-unit configurations) and the
port's copies of ``benchmarks/table1.py``, ``table2.py`` and
``dse_sweep.py`` are pure Python on the same expressions as the reference,
so every field, row and printed line must be equal with ``==``: no
tolerance.  Both packages run here on the CPU; neither touches a device.
"""
import contextlib
import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmarks import dse_sweep as j_dse_sweep
from benchmarks import table1 as j_table1
from benchmarks import table2 as j_table2
from repro.core import dse as jdse
from repro.core import fpga_model as jfm
from repro.core.tiling import ConvTiling as JConvTiling
from repro.core.tiling import FCTiling as JFCTiling
from repro_torch.benchmarks import dse_sweep, table1, table2
from repro_torch.core import dse, fpga_model as fm
from repro_torch.core.tiling import ConvTiling, FCTiling

#: the paper's compute units (Table 1): board -> (μ, τ)
PAPER_CU = {"Ultra96": (12, 24), "ZCU104": (20, 30), "ZCU102": (20, 55)}
NETS = ("alexnet", "vgg16", "lenet")


def _instances(board: str):
    """The three Table 1 compute units on ``board``, in both packages."""
    out = []
    for mu, tau in PAPER_CU.values():
        j = jfm.TemplateInstance(board=jfm.BOARDS[board],
                                 conv=JConvTiling(t_r=27, t_c=27, mu=mu, tau=tau),
                                 fc=JFCTiling(lam=1024, omega=64, mu=mu, tau=tau))
        t = fm.TemplateInstance(board=fm.BOARDS[board],
                                conv=ConvTiling(t_r=27, t_c=27, mu=mu, tau=tau),
                                fc=FCTiling(lam=1024, omega=64, mu=mu, tau=tau))
        out.append((j, t))
    return out


def _instance_fields(inst, layers) -> dict:
    return {"asdict": dataclasses.asdict(inst), "dsp": inst.dsp, "bram18": inst.bram18,
            "lut": inst.lut, "ff": inst.ff, "fits": inst.fits(),
            "peak_gops": inst.peak_gops,
            "layer_cycles": [inst.layer_cycles(l, b) for l in layers for b in (1, 4)],
            "network_latency_s": [inst.network_latency_s(layers, b) for b in (1, 4)]}


def test_boards_and_layer_tables_equal():
    assert {k: dataclasses.asdict(v) for k, v in fm.BOARDS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jfm.BOARDS.items()}
    assert [b.freq_hz for b in fm.BOARDS.values()] == [b.freq_hz for b in jfm.BOARDS.values()]
    assert list(fm.NETWORKS) == list(jfm.NETWORKS)
    for name in NETS:
        got, want = fm.NETWORKS[name](), jfm.NETWORKS[name]()
        assert [dataclasses.asdict(l) for l in got] == [dataclasses.asdict(l) for l in want]
        assert [(l.macs, l.ops) for l in got] == [(l.macs, l.ops) for l in want]
    assert (fm.conv_layer("c", 5, 6, 7, 8, 3, 2), fm.fc_layer("f", 9, 10)) == (
        fm.LayerSpec("c", "conv", 5, 6, 7, 8, 3, 2), fm.LayerSpec("f", "fc", p=9, q=10))


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("board", list(PAPER_CU))
def test_evaluate_network_and_instance_equal_reference(board, net):
    """Every field of ``evaluate_network``'s report and of the instance,
    at the three Table 1 compute units on each board, batch 1 and 4."""
    layers_j, layers_t = jfm.NETWORKS[net](), fm.NETWORKS[net]()
    for j_inst, t_inst in _instances(board):
        assert _instance_fields(t_inst, layers_t) == _instance_fields(j_inst, layers_j)
        for batch in (1, 4):
            got = fm.evaluate_network(net, layers_t, t_inst, batch=batch)
            want = jfm.evaluate_network(net, layers_j, j_inst, batch=batch)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.summary() == want.summary()


def test_tilings_equal_reference():
    for t_r, t_c, mu, tau in ((27, 27, 12, 24), (13, 28, 20, 55), (7, 5, 3, 2)):
        j, t = JConvTiling(t_r, t_c, mu, tau), ConvTiling(t_r, t_c, mu, tau)
        for r, c, p, q, k, s in ((55, 55, 3, 64, 11, 4), (13, 13, 192, 384, 3, 1),
                                 (5, 3, 1, 1, 1, 1)):
            assert t.eff_spatial(r, c) == j.eff_spatial(r, c)
            assert t.num_invocations(r, c, p, q) == j.num_invocations(r, c, p, q)
            assert t.compute_cycles_per_invocation(k, r, c) == \
                j.compute_cycles_per_invocation(k, r, c)
            assert t.input_tile_elems(k, s) == j.input_tile_elems(k, s)
            assert t.weight_tile_elems(k) == j.weight_tile_elems(k)
        assert t.compute_cycles_per_invocation(5) == j.compute_cycles_per_invocation(5)
        assert t.output_tile_elems() == j.output_tile_elems()
    for lam, omega, mu, tau in ((1024, 64, 12, 24), (4096, 256, 20, 55), (100, 7, 3, 2)):
        j, t = JFCTiling(lam, omega, mu, tau), FCTiling(lam, omega, mu, tau)
        for p, q in ((9216, 4096), (84, 10)):
            assert t.num_invocations(p, q) == j.num_invocations(p, q)
        assert (t.compute_cycles_per_invocation(), t.input_tile_elems(),
                t.weight_tile_elems(), t.output_tile_elems()) == (
            j.compute_cycles_per_invocation(), j.input_tile_elems(),
            j.weight_tile_elems(), j.output_tile_elems())


@pytest.mark.parametrize("net", ("alexnet", "lenet"))
@pytest.mark.parametrize("board", list(PAPER_CU))
def test_explore_board_top10_equal_reference(board, net):
    got = dse.explore_board(fm.BOARDS[board], fm.NETWORKS[net](), name=net)
    want = jdse.explore_board(jfm.BOARDS[board], jfm.NETWORKS[net](), name=net)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert (g.mu, g.tau, g.gops, g.latency_ms) == (w.mu, w.tau, w.gops, w.latency_ms)


@pytest.mark.parametrize("board", list(PAPER_CU))
def test_paper_compute_units_fit_their_boards(board):
    """``tests/test_cnn_fpga.py``'s check, on the port: each board's own
    Table 1 compute unit fits it."""
    inst = table1.instance_for(board)
    assert inst.dsp <= fm.BOARDS[board].dsp and inst.bram18 <= fm.BOARDS[board].bram18
    assert inst.fits()


def test_table1_conv_gops_rise_from_ultra96_to_zcu102():
    gops = [fm.evaluate_network("alexnet", fm.alexnet_layers(), table1.instance_for(b),
                                batch=4).conv_gops for b in ("Ultra96", "ZCU104", "ZCU102")]
    assert gops[0] < gops[1] < gops[2]


def _stdout(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn()
    return res, buf.getvalue()


@pytest.mark.parametrize("name", ("table1", "table2", "dse_sweep"))
def test_table_scripts_equal_reference(name):
    """``run()``'s rows and ``main()``'s printed text, both packages."""
    port = {"table1": table1, "table2": table2, "dse_sweep": dse_sweep}[name]
    ref = {"table1": j_table1, "table2": j_table2, "dse_sweep": j_dse_sweep}[name]
    runs = ("run_fpga", "run_tpu") if name == "dse_sweep" else ("run",)
    for run in runs:
        assert getattr(port, run)() == getattr(ref, run)()
    got, got_text = _stdout(port.main)
    want, want_text = _stdout(ref.main)
    assert got == want and got_text == want_text and got_text.startswith("== ")


@pytest.mark.parametrize("name", ("table1", "table2", "dse_sweep"))
def test_script_runs_as_a_module_without_jax(name):
    """``python -m repro_torch.benchmarks.<name>`` with ``jax`` and ``repro``
    blocked prints the reference's text."""
    root = Path(__file__).resolve().parents[1]
    code = ("import runpy, sys\nsys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            f"runpy.run_module('repro_torch.benchmarks.{name}', run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")), cwd=root,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    ref = {"table1": j_table1, "table2": j_table2, "dse_sweep": j_dse_sweep}[name]
    assert res.stdout == _stdout(ref.main)[1]
