"""Paper Table 1 reproduction: resource utilization + GOP/s on three boards.

The paper reports, for AlexNet on the template with per-board compute units
(Ultra96 12x24 @169 MHz, ZCU104 20x30 @198 MHz, ZCU102 20x55 @167 MHz):
FF/LUT/BRAM/DSP utilization and 51 / 107 / 230 GOP/s.

The port's copy of ``benchmarks/table1.py``: the analytic template model
(``repro_torch/core/fpga_model.py``) at the same compute-unit
configurations, modeled resources and conv-plane GOP/s beside the paper's
numbers.  ``run()`` returns the reference's rows and ``main()`` prints its
text.

    PYTHONPATH=src python -m repro_torch.benchmarks.table1
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.fpga_model import (
    BOARDS,
    TemplateInstance,
    alexnet_layers,
    evaluate_network,
)
from repro_torch.core.tiling import ConvTiling, FCTiling

PAPER = {
    # board: (mu, tau, FF, LUT, BRAM, DSP, GOP/s, MHz)
    "Ultra96": (12, 24, 23_500, 15_600, 332, 334, 51, 169),
    "ZCU104": (20, 30, 46_000, 24_000, 594, 586, 107, 198),
    "ZCU102": (20, 55, 139_000, 57_000, 1_700, 1_700, 230, 167),
}


def instance_for(board_name: str) -> TemplateInstance:
    mu, tau = PAPER[board_name][:2]
    conv = ConvTiling(t_r=27, t_c=27, mu=mu, tau=tau)
    fc = FCTiling(lam=1024, omega=64, mu=mu, tau=tau)
    return TemplateInstance(board=BOARDS[board_name], conv=conv, fc=fc)


def run(batch: int = 4) -> list[dict]:
    rows = []
    layers = alexnet_layers()
    for name, vals in PAPER.items():
        inst = instance_for(name)
        rep = evaluate_network("alexnet", layers, inst, batch=batch)
        rows.append({
            "board": name,
            "cu": f"{inst.conv.mu}x{inst.conv.tau}",
            "dsp_model": inst.dsp,
            "dsp_paper": vals[5],
            "bram_model": inst.bram18,
            "bram_paper": vals[4],
            "lut_model": inst.lut,
            "lut_paper": vals[3],
            "ff_model": inst.ff,
            "ff_paper": vals[2],
            "gops_model": round(rep.conv_gops, 1),
            "gops_paper": vals[6],
            "gops_all_layers": round(rep.gops, 1),
            "latency_ms": round(rep.latency_ms, 3),
            "peak_gops": round(inst.peak_gops, 1),
            "fits": inst.fits(),
        })
    return rows


def main(argv=()):
    """Print the table; ``argv``: this script's flags (it takes none but
    ``--help``)."""
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(list(argv))
    print("== Table 1: resource utilization + performance (AlexNet) ==")
    rows = run()
    hdr = (f"{'board':8s} {'CU':7s} {'DSP m/p':12s} {'BRAM m/p':12s} "
           f"{'GOP/s m/p':12s} {'peak':7s} {'lat ms':8s} fits")
    print(hdr)
    for r in rows:
        print(
            f"{r['board']:8s} {r['cu']:7s} "
            f"{r['dsp_model']:4d}/{r['dsp_paper']:<6d} "
            f"{r['bram_model']:4d}/{r['bram_paper']:<6d} "
            f"{r['gops_model']:5.1f}/{r['gops_paper']:<5.0f} "
            f"{r['peak_gops']:6.1f} {r['latency_ms']:8.3f} {r['fits']}"
        )
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
