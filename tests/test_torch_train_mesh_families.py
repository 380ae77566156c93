"""The port's FSDP training of mamba2 and whisper on four gloo CPU ranks,
held against the reference's single-device step, and the training
state's shardings against the reference's.

The cases of ``tests/test_torch_train_mesh.py`` (its setup, reference and
tolerances) for the two families whose layers differ most from the dense
stack: mamba2's SSD mixer and whisper's encoder, whose context rows split
over the ranks as the tokens do; 8 x 16 tokens on a (4, 1) FSDP mesh, one
``spawn_ranks`` call while the test process computes the reference's
steps.  ``state_shardings`` and ``batch_shardings`` equal the reference's
on the production meshes and on the training meshes.
"""
import concurrent.futures
import functools

import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import steps as jsteps
from repro.parallel import sharding as JS
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.parallel import sharding as S

import torch_train_cases
from test_torch_train_mesh import _payload, check_case, reference

CASES = [
    ("mamba2-fsdp", "mamba2-1.3b", {}, 8, 16, "4x1", "fsdp", 1),
    ("whisper-fsdp", "whisper-medium", {}, 8, 16, "4x1", "fsdp", 1),
]


def _spawn(cases):
    payload = {"cases": [_payload(arch, ov, b, s, mesh=m, kind=k, accum=a)
                         for _, arch, ov, b, s, m, k, a in cases]}
    out = spawn_ranks(functools.partial(torch_train_cases.train_mesh_case, payload), 4,
                      device="cpu", timeout=240)[0]
    return dict(zip([c[0] for c in cases], out["cases"]))


@pytest.fixture(scope="module")
def runs():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_spawn, CASES)
        for _, arch, ov, b, s, _, _, accum in CASES:
            reference(arch, ov, b, s, accum)
        return ranks.result()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_meshed_family_step_matches_reference(runs, case):
    check_case(runs[case[0]], case)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m", "whisper-medium"])
def test_state_and_batch_shardings_equal_the_reference(arch):
    """``state_shardings`` and ``batch_shardings`` on the production meshes
    and the training meshes equal the reference's on an ``AbstractMesh``;
    ``abstract_params``' shapes equal the reference's."""
    cfg_j, cfg = j_get_config(arch), get_config(arch)
    rules_j = JS.TRAIN_RULES.with_overrides(**dict(cfg_j.rule_overrides))
    rules = S.TRAIN_RULES.with_overrides(**dict(cfg.rule_overrides))

    def specs(tree, is_leaf):
        return jax.tree_util.tree_map(lambda s: tuple(s.spec), tree, is_leaf=is_leaf)

    port_leaf = lambda x: isinstance(x, S.NamedSharding)
    ref_leaf = lambda x: isinstance(x, JNamedSharding)
    for sizes, names in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
                         ((4, 1), ("data", "model")), ((2, 2, 1), ("pod", "data", "model"))):
        jm, tm = AbstractMesh(sizes, names), tmesh.Mesh(sizes, names)
        p_j, o_j = jsteps.state_shardings(cfg_j, jm, rules_j)
        p, o = steps.state_shardings(cfg, tm, rules)
        assert specs(p, port_leaf) == specs(p_j, ref_leaf)
        assert specs(o.m, port_leaf) == specs(o_j.m, ref_leaf)
        assert specs(o.v, port_leaf) == specs(o_j.v, ref_leaf)
        assert tuple(o.step.spec) == tuple(o_j.step.spec) == ()
        b_j = jsteps.batch_shardings(cfg_j, J_SHAPES["train_4k"], jm, rules_j)
        b = steps.batch_shardings(cfg, SHAPES["train_4k"], tm, rules)
        assert {k: tuple(v.spec) for k, v in b.items()} == \
            {k: tuple(v.spec) for k, v in b_j.items()}
    shapes = jax.tree.map(lambda t: tuple(t.shape), steps.abstract_params(cfg),
                          is_leaf=lambda x: hasattr(x, "shape"))
    want = jax.tree.map(lambda t: tuple(t.shape), jsteps.abstract_params(cfg_j),
                        is_leaf=lambda x: hasattr(x, "shape"))
    assert shapes == want
