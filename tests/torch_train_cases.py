"""Rank bodies of the port's training tests, run by ``spawn_ranks``.

Each function runs inside one rank process (``fn(payload, rank, world,
device)``, bound with ``functools.partial``), imports only the port, and
returns numpy results to the test process.  Imported by name (``tests/``
is on ``sys.path`` under pytest).
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.optim.compress import compressed_grad_reduce, init_error_feedback


def compressed_reduce_case(payload, rank, world, device):
    """``compressed_grad_reduce`` over a ``world``-way "data" axis: this
    rank's gradient tree is ``payload["grads"][rank]``; once without and once
    with error feedback (a zero state)."""
    mesh = Mesh((world,), ("data",)).init_groups()
    grads = {k: torch.from_numpy(v).to(device) for k, v in payload["grads"][rank].items()}
    plain, ef = compressed_grad_reduce(grads, mesh, axis="data")
    assert ef is None
    with_ef, ef = compressed_grad_reduce(grads, mesh, axis="data",
                                         ef_state=init_error_feedback(grads))
    return {"plain": plain, "ef": with_ef, "residual": ef}
