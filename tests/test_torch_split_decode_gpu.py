"""A data-split decode step gives each of a rank's rows one device's bits,
on the card, at the families' full widths; and the data split (2, 1) of
reduced recurrentgemma and whisper equals one card.

* ``attention._sdpa_dense`` at the decode shapes of whisper's cross
  attention (1500 frames), recurrentgemma's local attention (head dim 256,
  its 2048-slot window), llama-vision's self attention and qwen2's
  4128-slot ring, with and without a mask: 8 rows equal each rank's rows
  of the (f, 1) splits f = 1, 2, 4, 8 (8 to 1 rows a rank), and B rows,
  for B = 1..8, each row alone as a rank of a (B, 1) split;
* the SSD decode's output contraction (``layers.split_einsum``) at
  mamba2-1.3b's width, likewise;
* two ranks on one card over ``gloo`` (``launch/mesh.py:spawn_ranks``), a
  (2, 1) ("data", "model") mesh: reduced recurrentgemma-9b and
  whisper-medium in bf16 through ``compiled_steps(mesh=)``, 8 rows (4 a
  rank), the prefill and eight decode steps' logits and tokens equal to
  the single-device steps' on the card (the rank body is
  ``torch_family_shard_cases.split_case``).

Every test needs an NVIDIA card and skips without one; run them there with
``python -m pytest --noconftest -m gpu tests/test_torch_split_decode_gpu.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.launch.mesh import Mesh, spawn_ranks
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as S

import torch_family_shard_cases as cases

pytestmark = pytest.mark.gpu

#: a hung collective fails the test instead of the run
RANKS_TIMEOUT_S = 600
ROWS = 8


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _attn(name, what):
    """(q heads, kv heads, head dim, key length) of a family's decode call."""
    cfg = get_config(name)
    t = {"cross": cfg.n_frames or cfg.n_image_tokens, "self": 4128}[what]
    if cfg.window:
        t = min(cfg.window, t)
    return cfg.eff_heads, cfg.n_kv_heads, cfg.head_dim, t


def _on_rank(f, fn, *args):
    with S.use_mesh(Mesh((f, 1), ("data", "model")), S.DECODE_RULES), S.batch_split(f):
        return fn(*args)


def _split_rows(fn, args):
    """``fn`` on the rows of each rank of the (f, 1) splits of 8 rows, and
    on each row of B = 1..8 rows as a rank of a (B, 1) split, against the
    unsplit call."""
    full = fn(*args)
    for f in (1, 2, 4, 8):
        r = ROWS // f
        for j in range(f):
            got = _on_rank(f, fn, *(a[j * r:(j + 1) * r].clone() for a in args))
            assert torch.equal(got, full[j * r:(j + 1) * r]), ("split", f, j)
    for b in range(1, ROWS + 1):
        want = fn(*(a[:b] for a in args))
        for i in range(b):
            got = _on_rank(b, fn, *(a[i:i + 1].clone() for a in args))
            assert torch.equal(got, want[i:i + 1]), ("rows", b, i)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("case", [("whisper-medium", "cross"), ("recurrentgemma-9b", "self"),
                                  ("llama-3.2-vision-90b", "self"), ("qwen2-0.5b", "self")],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_sdpa_dense_split_rows_on_card(case, masked):
    dev = _card()
    h, hkv, d, t = _attn(*case)
    g = torch.Generator(device=dev).manual_seed(0)
    # k / v as decode_attention hands them: the (B, Hkv, T, D) ring, transposed
    q, kc, vc = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                 for s in ((ROWS, 1, h, d), (ROWS, hkv, t, d), (ROWS, hkv, t, d)))
    if masked:
        valid = torch.rand((ROWS, 1, 1, t), generator=g, device=dev) < 0.8
        _split_rows(lambda q_, k_, v_, m_: A._sdpa_dense(q_, k_.transpose(1, 2),
                                                         v_.transpose(1, 2), m_),
                    (q, kc, vc, valid))
    else:
        _split_rows(lambda q_, k_, v_: A._sdpa_dense(q_, k_.transpose(1, 2),
                                                     v_.transpose(1, 2), None), (q, kc, vc))


def test_ssd_output_split_rows_on_card():
    dev = _card()
    cfg = get_config("mamba2-1.3b")
    g = torch.Generator(device=dev).manual_seed(0)
    state = torch.randn((ROWS, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state), generator=g,
                        device=dev)
    cm = torch.randn((ROWS, cfg.ssm_nheads, cfg.ssm_state), generator=g, device=dev)
    _split_rows(functools.partial(L.split_einsum, "bhpn,bhn->bhp"), (state, cm))


@pytest.fixture(scope="module")
def split_ranks():
    """The two ranks' records, made when a test runs (never at import or
    collection)."""
    _card()
    _build.build_all()  # once, before the ranks load the libraries
    payload = {"names": ("recurrentgemma-9b", "whisper-medium"), "rows": ROWS, "gen": 8}
    return spawn_ranks(functools.partial(cases.split_case, payload), 2, device="cuda",
                       backend="gloo", timeout=RANKS_TIMEOUT_S)


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "whisper-medium"])
def test_data_split_decode_bitwise_on_card(split_ranks, name):
    for rec in split_ranks:
        got = rec[name]
        assert np.isfinite(got["single"]["logits"]).all()
        np.testing.assert_array_equal(got["meshed"]["logits"], got["single"]["logits"])
        np.testing.assert_array_equal(got["meshed"]["tokens"], got["single"]["tokens"])
        assert all(v == [ROWS // 2] for v in got["meshed"]["cache_rows"].values())
