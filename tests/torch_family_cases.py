"""Shared setup of the port's family tests (``tests/test_torch_families*.py``):
the reduced configs of both packages, reference weights with live norm
scales and cross gates carried across as numpy arrays, token and context
draws.  Imported by name (``tests/`` is on ``sys.path`` under pytest)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import all_configs as j_all_configs
from repro.configs import reduced as j_reduced
from repro.models import transformer as JT
from repro_torch.configs import all_configs, reduced
from repro_torch.convert import transformer_params_from_numpy

FLOAT_TOL = 1e-4
PREFILL_TOL = 3e-4
DECODE_TOL = 5e-4
NEW = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b", "recurrentgemma-9b",
       "whisper-medium", "llama-3.2-vision-90b", "qwen2.5-32b", "internlm2-1.8b",
       "mistral-nemo-12b"]
B, S = 2, 16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _live(tree, cfg, rng):
    """Norm scales N(0, 0.1²) (rmsnorm; layernorm scales 1 + N(0, 0.1²)) and
    cross gates 0.5 + N(0, 0.1²), drawn from ``rng`` in place."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "cross_gate":
                tree[k] = (0.5 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k.endswith("norm") and isinstance(v, dict) and "scale" in v:
                base = 1.0 if cfg.norm == "layernorm" else 0.0
                v["scale"] = (base + 0.1 * rng.standard_normal(v["scale"].shape)).astype(
                    np.float32)
            else:
                _live(v, cfg, rng)
    elif isinstance(tree, tuple):
        for v in tree:
            _live(v, cfg, rng)


def _cfgs(name, **kw):
    cfg_j = dataclasses.replace(j_reduced(j_all_configs()[name]), **kw)
    cfg = dataclasses.replace(reduced(all_configs()[name]), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    return cfg_j, cfg


def _ctx(cfg, rng, b=B):
    if cfg.family not in ("encdec", "vlm"):
        return None
    n = cfg.n_frames if cfg.family == "encdec" else cfg.n_image_tokens
    return (0.1 * rng.standard_normal((b, n, cfg.d_model))).astype(np.float32)


def _make(name, **kw):
    cfg_j, cfg = _cfgs(name, **kw)
    rng = np.random.default_rng(1)
    tree = _np_tree(JT.init_params(jax.random.PRNGKey(0), cfg_j))
    _live(tree, cfg, rng)
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    params = transformer_params_from_numpy(tree)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return cfg_j, cfg, params_j, params, tokens, _ctx(cfg, rng)


_SETUPS = {}


def setup_of(name):
    """(cfg_j, cfg, params_j, params, tokens, ctx) of a reduced config, with
    MoE capacity large enough that no token drops (so decode can equal the
    forward), memoized."""
    if name not in _SETUPS:
        cf = {"capacity_factor": 100.0} if "moe" in name else {}
        _SETUPS[name] = _make(name, **cf)
    return _SETUPS[name]


def _tok(a):
    return torch.from_numpy(np.array(a)).long()


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)
