"""Design-space exploration sweep — reproduces the paper's §III.E finding
that the template performs best when τ ≈ 2μ under resource constraints,
and derives the per-board compute-unit choice the paper reports.

Also runs the TPU-plane analogue: Pallas (bm, bn, bk) block selection under
the VMEM budget for representative GEMMs of the assigned LM architectures.

The port's copy of ``benchmarks/dse_sweep.py``: ``explore_board`` of
``repro_torch.core.dse``, and its ``explore_tpu_block`` under ``TPU_V5E``
(the reference's plans, kept as data; the port's kernels plan under
``H100``).

    PYTHONPATH=src python -m repro_torch.benchmarks.dse_sweep
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.dse import explore_board, explore_tpu_block
from repro_torch.core.fpga_model import BOARDS, alexnet_layers


def run_fpga() -> dict:
    out = {}
    layers = alexnet_layers()
    for name, board in BOARDS.items():
        results = explore_board(board, layers, top=5)
        rows = [
            {
                "mu": r.mu,
                "tau": r.tau,
                "ratio": round(r.tau / r.mu, 2),
                "gops": round(r.gops, 1),
                "latency_ms": round(r.latency_ms, 2),
                "dsp": r.instance.dsp,
                "bram": r.instance.bram18,
            }
            for r in results
        ]
        out[name] = rows
    return out


def run_tpu() -> dict:
    """Block choice for the biggest GEMMs in the assigned archs (bf16)."""
    cases = {
        "qwen2.5-32b mlp (65536x27648x5120)": (65536, 27648, 5120),
        "llama-90b qkv (65536x10240x8192)": (65536, 10240, 8192),
        "qwen2-0.5b mlp (65536x4864x896)": (65536, 4864, 896),
        "granite expert (512x512x1536)": (512, 512, 1536),
    }
    out = {}
    for label, (m, n, k) in cases.items():
        ranked = explore_tpu_block(m, n, k, top=3)
        out[label] = [
            {
                "block": (b.bm, b.bn, b.bk),
                "score": round(s, 4),
                "vmem_MiB": round(b.vmem_bytes() / 2**20, 1),
                "ai_flops_per_byte": round(b.arithmetic_intensity(), 1),
            }
            for b, s in ranked
        ]
    return out


def main(argv=()):
    """Print the table; ``argv``: this script's flags (it takes none but
    ``--help``)."""
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(list(argv))
    print("== DSE: FPGA plane (paper §III.E — expect tau ~ 2*mu) ==")
    fpga = run_fpga()
    for board, rows in fpga.items():
        best = rows[0]
        print(f"{board:8s} best CU {best['mu']}x{best['tau']} "
              f"(ratio {best['ratio']}) {best['gops']} GOP/s "
              f"DSP {best['dsp']} BRAM {best['bram']}")
        ratios = [r["ratio"] for r in rows]
        print(f"         top-5 tau/mu ratios: {ratios}")
    print("\n== DSE: TPU plane (Pallas block selection under VMEM) ==")
    tpu = run_tpu()
    for label, rows in tpu.items():
        b = rows[0]
        print(f"{label:45s} -> block {b['block']} vmem {b['vmem_MiB']} MiB "
              f"AI {b['ai_flops_per_byte']} score {b['score']}")
    return {"fpga": fpga, "tpu": tpu}


if __name__ == "__main__":
    main(sys.argv[1:])
