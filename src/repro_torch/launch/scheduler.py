"""Continuous-batching serve scheduler over the execution-plan engine, in the port.

The port's copy of ``repro.launch.scheduler``.  The scheduler quantizes
traffic into the few GEMM shapes the plan registry holds plans for:

* **Bucket ladder** — every prefill is right-padded up to the smallest
  ladder rung >= its prompt length (``core/engine.py:bucket_for``); under
  causal attention the padding cannot reach the logits at real positions.
* **Coalesced (B, L) bucket prefill** — a tick's pending prefills for one
  rung go out as ONE batched launch (per-row last positions, the batch
  padded up to a batch rung, ``engine.batch_rungs``), then scattered row by
  row into the slot-indexed KV cache (``transformer.insert_cache_rows``).
* **Chunked prefill / decode interleaving** — with ``prefill_chunk > 0``,
  prompts longer than one chunk stream into their slot chunk by chunk
  (``transformer.prefill_chunk_step``, one fixed (slots, chunk) launch a
  tick) beside the batched decode step.
* **Slot-indexed continuous batching** — one decode step a tick over a
  cache with a position vector per slot (``init_cache(per_slot=True)``);
  t[b] < 0 turns a lane off.  The decode shape is (slots, ...) whatever the
  traffic.
* **Sampled decode lanes** — greedy argmax by default; with a
  :class:`SamplingParams` of temperature > 0 each token is drawn from the
  lane ``fold_in(fold_in(PRNGKey(seed), slot), position)``, JAX's threefry
  key and Gumbel-max draw bit for bit (:func:`sample_tokens`), so a stream
  depends only on (seed, slot, position).
* **Injectable clock** — :class:`SystemClock` in production, a
  :class:`VirtualClock` in tests: the same ``submit`` / ``step`` / ``drain``
  code runs scripted arrival traces deterministically.

:func:`compiled_steps` memoizes the serving closures of one (template,
config, cache_len, policy) setup, the port's analogue of the reference's
jitted, cache-donating closures.  On a CUDA template each decode step is
ONE captured CUDA graph, replayed once a tick: the first call for an input
signature and cache owner runs one eager warm-up step (which plans, builds
the kernels and sets their shared-memory attributes), then captures the
step with ``torch.cuda.graph``; the graph owns the cache passed in (the
caller gives it up, as the reference's donated argument) and writes the new
k / v rows, and a recurrent layer's new state and conv history, into it in
place (so every replay advances them); a cross layer's context k / v are
read, never written.  Each owner (a scheduler passes itself as
``owner``) has graphs of its own, so two live schedulers on one setup never
decode in one cache; an owner's graphs go when it is released or dropped.
A capture or replay that fails raises; there is no eager fallback on the
card.  On a CPU template the closures run eagerly, with the same signatures
and the same in-place cache contract.  Prefill and the chunk step are not
captured: they are device-bound.

**Tensor-parallel decode** (``mesh=``, default rules ``DECODE_RULES``):
every rank of the mesh runs the same scheduler loop on the same trace.
Parameters are column-parallel (each rank holds the columns its GEMMs
produce, every contraction whole), activations are gathered at the
model's seams, the slot-indexed KV cache is sharded over slots on the data
axes, and the tokens (and logits) of a step are gathered over the data
axes before the host decides anything, so a rank's stream is byte for byte
the single-device stream.  Prefill runs every row on every data rank; each
rank keeps its own slots' rows.  The meshed decode step takes the whole
batch's inputs and does all of that inside its body: this rank's rows,
``use_mesh`` / ``batch_split``, the step, the gathers of tokens and logits.
Over NCCL (a card a rank) that body is captured as the single-device step
is, one CUDA graph per (signature, owner) on each rank, collectives
inside, and replayed every tick (the reference's jitted meshed step): the
eager warm-up runs every collective once first (NCCL sets a communicator
up outside a capture), every rank captures the same collectives in the
same order (it runs the same loop), and a failed capture or replay raises
on its rank.  A replay adds the collectives its capture recorded to
``sharding.SEAM_COUNTS``.  A CUDA graph cannot hold a ``gloo`` collective
(the ranks of one card, staged through the host), so under gloo and on
the CPU the meshed step runs eagerly, holds nothing and is counted in
:data:`MESHED_EAGER_COUNTS`; ``capture=False`` keeps an NCCL step eager
too.

The meshed steps run every family.  An MoE layer's routing groups are the
logical batch's: where a rank's slots are a part of a group (a decode
step, a few slots over the data axes) its tokens are gathered over those
axes, every data rank routes the whole groups as one device does and
keeps its rows of the combine, so capacity drops are the single device's;
the rules may cut ``expert_mlp`` (gate / up by columns, the hidden
gathered before down).  A recurrent layer's state and conv history and a
cross layer's context k / v shard over slots with the k / v rings
(:func:`shard_cache`); the SSD and RG-LRU blocks run whole on every
"model" rank (``ssm_inner``, ``rec`` replicate under ``DECODE_RULES``).
Under ``embed`` over "model" the embedding table and the residual-width
columns of wo / down are cut and gathered at the seam that reads them.
The scheduler serves the meshed dense and MoE families; the others are
meshed through ``compiled_steps(mesh=)``, as in the reference.

**Admission** is the reference's: padding a prompt is sound only for
full-attention mixers, so the scheduler serves the dense and MoE families
and refuses the SSM, the windowed hybrid, encoder-decoder and VLM
(``ValueError``); ``generate`` serves every family.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
import weakref
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import (
    batch_rungs,
    bucket_for,
    register_plan_store,
    validate_policy,
)
from repro_torch.core.quantization import NumericsPolicy
from repro_torch.core.template import Template, default_template
from repro_torch.kernels import _build
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import DECODE_RULES

__all__ = [
    "CAPTURE_COUNTS",
    "MESHED_EAGER_COUNTS",
    "Request",
    "SamplingParams",
    "SchedulerConfig",
    "ServeScheduler",
    "StepFns",
    "SystemClock",
    "VirtualClock",
    "compiled_steps",
    "fold_in",
    "prng_key",
    "random_bits",
    "replay_trace",
    "request_from_snapshot",
    "sample_tokens",
    "sampler_fn",
    "serve_shardings",
    "session_snapshot",
    "shard_cache",
    "synthetic_trace",
    "threefry2x32",
]


# ---------------------------------------------------------------------------
# injectable clocks
# ---------------------------------------------------------------------------


class VirtualClock:
    """Deterministic simulation clock: time moves only when told to."""

    def __init__(self, start: float = 0.0) -> None:
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, dt: float) -> None:
        self._t += max(0.0, float(dt))


class SystemClock:
    """Production clock (monotonic)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


# ---------------------------------------------------------------------------
# sampling: JAX's threefry-2x32 and Gumbel-max draw, on the device
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the smallest normal f32, the floor of JAX's uniform draw for the Gumbel
_TINY = float(torch.finfo(torch.float32).tiny)


def threefry2x32(k0, k1, x0, x1):
    """JAX's threefry-2x32 hash (20 rounds).  Every argument holds uint32
    words in int64 tensors (or ints), broadcast together; returns the two
    output words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed, device="cpu"):
    """``jax.random.PRNGKey(uint32(seed))`` as its two words, (0, seed)."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device) & _M32
    return torch.zeros_like(seed), seed


def fold_in(key, data):
    """``jax.random.fold_in``: the key's words hash the counter (0, data);
    ``data`` (uint32 words in an int64 tensor) may carry a batch shape."""
    data = data & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def random_bits(key, n: int):
    """``jax.random.bits(key, (n,))`` in uint32 words, as JAX draws them with
    ``jax_threefry_partitionable`` (its default): counter i = (0, i), bits =
    the two output words xor'd.  ``key``'s words may carry a batch shape
    (B,); returns (B, n)."""
    k0, k1 = (k.reshape(-1, 1) for k in key)
    i = torch.arange(n, dtype=torch.int64, device=k0.device)[None, :]
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return b0 ^ b1


def _gumbel(key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low"): a uniform in
    [tiny, 1) from the bits' 23 mantissa bits, then -log(-log(u))."""
    bits = random_bits(key, n)
    one = (bits >> 9) | 0x3F800000  # an f32 in [1, 2)
    u = one.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(u + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def sample_tokens(logits, seed, lanes, positions, temperature, top_k: int = 0):
    """One draw per row of ``logits`` (B, V), the reference's sampler:
    logits / temperature in f32, cut to the ``top_k`` largest when 0 < top_k
    < V, then row b draws ``jax.random.categorical(fold_in(fold_in(
    PRNGKey(seed), lanes[b]), positions[b]), row)`` (Gumbel-max).  ``seed``,
    ``lanes``, ``positions``: ints or int64 tensors on the logits' device;
    ``temperature``: a float or a 0-d f32 tensor there (a tensor divides
    exactly as JAX does inside a CUDA graph).  Returns (B,) int64."""
    dev = logits.device
    b, v = logits.shape
    if not isinstance(temperature, torch.Tensor):
        temperature = torch.tensor(temperature, dtype=torch.float32, device=dev)
    scaled = logits.to(torch.float32) / temperature
    if 0 < top_k < v:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)

    def vec(x):
        x = torch.as_tensor(x, dtype=torch.int64, device=dev)
        return x.reshape(-1).expand(b)

    key = fold_in(fold_in(prng_key(seed, dev), vec(lanes)), vec(positions))
    return torch.argmax(_gumbel(key, v) + scaled, dim=-1)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Decode-time sampling policy.  temperature <= 0 is exact greedy argmax
    (the byte-parity mode); temperature > 0 samples from the softmax, with
    ``top_k > 0`` restricting to the k highest logits first.  ``seed`` roots
    every RNG lane: token draws are keyed (seed, lane, position) only."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def sampler_fn(temperature: float, top_k: int):
    """The sampler for one (temperature, top_k) setting:
    sample(logits (B, V), seed, lanes (B,), positions (B,)) -> tokens (B,).
    Row b draws from its own (lane, position) stream, so a draw never
    depends on which rows share the batch.  The scheduler uses lane = slot
    id; ``generate`` uses lane = batch row."""
    if temperature <= 0.0:
        raise ValueError("greedy sampling is argmax, not a sampler_fn")

    def sample(logits, seed, lanes, positions):
        return sample_tokens(logits, seed, lanes, positions, temperature, top_k)

    return sample


def _pick(logits, sampling, seed, lanes, positions, temperature):
    if sampling is None or sampling.greedy:
        return torch.argmax(logits, dim=-1)
    return sample_tokens(logits, seed, lanes, positions, temperature, sampling.top_k)


# ---------------------------------------------------------------------------
# compiled step functions: memoized closures, a CUDA graph per decode step
# ---------------------------------------------------------------------------

#: (kind, cfg.name, cache_len) -> captures: each CUDA graph a decode step
#: captured, one per (input signature, cache owner) (on a CPU template: each
#: such pair the step first met, what a CUDA template would capture).  A
#: repeated ``generate()`` or scheduler tick with unchanged shapes must not
#: grow these counts.
CAPTURE_COUNTS: collections.Counter = collections.Counter()

#: (kind, cfg.name, cache_len) -> meshed steps run eagerly (a gloo
#: collective cannot be captured; ``capture=False``)
MESHED_EAGER_COUNTS: collections.Counter = collections.Counter()

_STEP_FNS: dict = {}
#: LRU bound: ``generate()``'s default cache_len is s + gen, so prompt-length
#: diversity would otherwise pin a graph and its cache per length forever
_STEP_FNS_MAX = 64
# emptied with the plan caches: the closures hold templates whose plans went
register_plan_store(_STEP_FNS)
register_plan_store(CAPTURE_COUNTS)
register_plan_store(MESHED_EAGER_COUNTS)


class StepFns(NamedTuple):
    """The serving closures of one (template, config, cache_len, policy)
    setup.  Indexable like the reference's (prefill, decode, chunk)."""

    prefill: object      # (params, tokens (B,L), ctx, last_pos) -> (logits, cache)
    decode: object       # (params, token (B,1), t, cache) -> (logits, cache')
    chunk: object        # (params, tokens (B,S), t, n_valid, cache) -> (logits, cache')
    decode_next: object  # (params, token, t, cache, sampling, lanes, positions, owner)
                         #   -> (next tokens (B,), logits (B,V), cache')


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _fill(dst: torch.Tensor, value) -> None:
    """Load a step input into its static buffer (no stream sync)."""
    if isinstance(value, torch.Tensor):
        dst.copy_(value.reshape(dst.shape) if value.numel() == dst.numel() else
                  value.expand(dst.shape), non_blocking=True)
    elif isinstance(value, np.ndarray):
        _fill(dst, torch.from_numpy(value))
    else:
        dst.fill_(int(value))


def _on(x, device):
    """numpy arrays and tensors onto ``device``; ints pass through."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device) if isinstance(x, torch.Tensor) else x


class _Graph(NamedTuple):
    graph: object
    params: object  # the tree the graph reads (kept alive: its id is the key)
    token: torch.Tensor
    t: torch.Tensor
    seed: torch.Tensor
    lanes: torch.Tensor
    positions: torch.Tensor
    temperature: torch.Tensor
    cache: object
    tokens: torch.Tensor
    logits: torch.Tensor
    launches: dict
    counters: collections.Counter
    seams: collections.Counter  # the collectives it runs (``sharding.SEAM_COUNTS``)


def _batch_rows(b: int, mesh, batch):
    """This rank's rows of a ``b``-row step over the data axes ``batch``:
    (take, the batch split factor, whether the rows are a part of the
    batch); ``take`` cuts a tensor whose first dim is the batch to the rows
    and passes anything else through."""
    lo, hi = sh.local_rows(b, mesh, batch)

    def take(x):
        if isinstance(x, torch.Tensor) and x.ndim and x.shape[0] == b:
            return x[lo:hi]
        return x

    return take, b // (hi - lo), (lo, hi) != (0, b)


def _warmup_cache(tree, key=None):
    """A capture warm-up's cache: the k / v rings and pos of ``tree``
    themselves, a copy of every other leaf (recurrent states, conv
    histories), marks kept."""
    if isinstance(tree, dict):
        return {k: _warmup_cache(v, k) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_warmup_cache(v, key) for v in tree)
    return tree if key in ("k", "v", "pos") else sh.carry_marks(tree, tree.clone())


class _DecodeStep:
    """``decode_next`` of one setup: on a CUDA template, one CUDA graph per
    input signature (params tree, token / t shapes, cache shapes, sampling
    setting) and cache owner, replayed per call; on a CPU template, the
    eager step (with the same bookkeeping of what would be captured).

    With ``mesh`` (and ``rules``) it is this rank's tensor-parallel step:
    it takes the whole batch's inputs, runs this rank's rows of them (the
    data-axis shard of the slot-indexed cache it holds) under ``use_mesh``
    and ``batch_split``, and gathers the tokens and logits over the data
    axes, all inside the step, so a graph holds the collectives too.  It is
    captured where the mesh runs NCCL on a CUDA template (``capture``
    False keeps it eager, the baseline a captured step is timed against);
    under gloo, whose collectives stage through the host, and on the CPU it
    runs eagerly, holds nothing and is counted in
    :data:`MESHED_EAGER_COUNTS`.

    ``owner`` None is the anonymous caller (``generate``): its graphs adopt
    whatever cache they are handed, copying it in.  Any other owner gets
    graphs of its own, dropped (graph, its memory pool and the cache it
    holds) by :meth:`release` or when the owner is garbage-collected."""

    def __init__(self, tpl: Template, cfg, cache_len: int, policy: NumericsPolicy,
                 mesh=None, rules=None, capture: bool = True):
        self.tpl, self.cfg, self.cache_len, self.policy = tpl, cfg, cache_len, policy
        self.mesh, self.rules = mesh, rules
        self.graphed = tpl.engine.device.type == "cuda" and (
            mesh is None or (capture and mesh.backend == "nccl"))
        self.graphs: dict = {}  # (signature, id(owner) or None) -> _Graph (CPU: None)
        self._owners: dict = {}  # id(owner) -> weakref.finalize

    def release(self, owner) -> int:
        """Drop every graph ``owner`` owns (None: the anonymous caller's);
        returns how many."""
        oid = None if owner is None else id(owner)
        fin = self._owners.pop(oid, None)
        if fin is not None:
            fin.detach()
        return self._drop(oid)

    def _drop(self, oid) -> int:
        self._owners.pop(oid, None)
        keys = [key for key in self.graphs if key[1] == oid]
        for key in keys:
            del self.graphs[key]
        return len(keys)

    def eager(self, params, token, t, cache, sampling=None, seed=0, lanes=0, positions=0,
              temperature=1.0):
        """One step as it comes: the body a capture records."""
        if self.mesh is None:
            logits, cache = T.decode_step(self.tpl, self.cfg, params, token, t, cache,
                                          policy=self.policy, inplace=True)
            return _pick(logits, sampling, seed, lanes, positions, temperature), logits, cache
        batch = self.rules.get("batch")
        take, f, split = _batch_rows(token.shape[0], self.mesh, batch)
        with sh.use_mesh(self.mesh, self.rules), sh.batch_split(f):
            logits, cache = T.decode_step(self.tpl, self.cfg, params, take(token), take(t),
                                          cache, policy=self.policy, inplace=True)
            toks = _pick(logits, sampling, seed, take(lanes), take(positions), temperature)
            if split:
                toks, logits = (sh.gather(x, 0, batch) for x in (toks, logits))
        return toks, logits, cache

    def _run(self, params, token, t, cache, sampling, seed, lanes, positions):
        dev = self.tpl.engine.device
        token, t, lanes, positions = (_on(x, dev) for x in (token, t, lanes, positions))
        temp = None if sampling is None else sampling.temperature
        return self.eager(params, token, t, cache, sampling, seed, lanes, positions, temp)

    def _signature(self, params, token, t, cache, sampling):
        t_shape = tuple(t.shape) if isinstance(t, (torch.Tensor, np.ndarray)) else ()
        pick = None if sampling is None or sampling.greedy else (
            float(sampling.temperature), int(sampling.top_k))
        return (id(params), tuple(token.shape), t_shape, pick,
                tuple((tuple(x.shape), x.dtype) for x in _leaves(cache)))

    def __call__(self, params, token, t, cache, sampling=None, lanes=None, positions=None,
                 owner=None):
        b = token.shape[0]
        lanes = np.arange(b) if lanes is None else lanes
        positions = 0 if positions is None else positions
        seed = 0 if sampling is None else sampling.seed
        if self.mesh is not None and not self.graphed:
            MESHED_EAGER_COUNTS["decode", self.cfg.name, self.cache_len] += 1
            return self._run(params, token, t, cache, sampling, seed, lanes, positions)
        oid = None if owner is None else id(owner)
        key = (self._signature(params, token, t, cache, sampling), oid)
        new = key not in self.graphs
        if new:
            CAPTURE_COUNTS["decode", self.cfg.name, self.cache_len] += 1
            if oid is not None and oid not in self._owners:
                self._owners[oid] = weakref.finalize(owner, self._drop, oid)
        if not self.graphed:
            self.graphs[key] = None
            return self._run(params, token, t, cache, sampling, seed, lanes, positions)
        if new:
            self.graphs[key] = self._capture(params, token, t, cache, sampling)
        g = self.graphs[key]
        for dst, value in ((g.token, token), (g.t, t), (g.seed, seed), (g.lanes, lanes),
                           (g.positions, positions)):
            _fill(dst, value)
        if cache is not g.cache:
            T.copy_cache_(g.cache, cache)
        g.graph.replay()
        # the capture ticked the counters once, launching nothing; each
        # replay launches (and gathers) what it recorded
        for name, n in g.launches.items():
            _build.launches[name] += n
        self.tpl.engine.counters.update(g.counters)
        sh.SEAM_COUNTS.update(g.seams)
        return g.tokens, g.logits, g.cache

    def _capture(self, params, token, t, cache, sampling) -> _Graph:
        dev = self.tpl.engine.device
        b = token.shape[0]

        def buf(shape, value=0, dtype=torch.int64):
            return torch.full(shape, value, dtype=dtype, device=dev)

        t_shape = tuple(t.shape) if isinstance(t, (torch.Tensor, np.ndarray)) else ()
        st = dict(token=buf(tuple(token.shape)), t=buf(t_shape), seed=buf(()),
                  lanes=buf((b,)), positions=buf((b,)),
                  temperature=buf((), 1.0 if sampling is None else sampling.temperature,
                                  torch.float32))
        _fill(st["token"], token)
        _fill(st["t"], t)

        def step(c):
            return self.eager(params, st["token"], st["t"], c, sampling, st["seed"],
                              st["lanes"], st["positions"], st["temperature"])

        # warm-up: plans, loads the kernels' libraries, sets their shared
        # memory attributes, and (meshed) runs every collective of the step
        # once, so each NCCL communicator is set up before the capture.  It
        # steps a copy of every recurrent leaf of ``cache``: a state stepped
        # here and again by the replay would advance twice.  The k / v rings
        # and their pos are stepped in place: the replay writes the same
        # entries at the same slots again (a long ring is never held twice)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(_warmup_cache(cache))
        torch.cuda.current_stream(dev).wait_stream(side)
        eng = self.tpl.engine
        launches0, counters0 = dict(_build.launches), collections.Counter(eng.counters)
        seams0 = collections.Counter(sh.SEAM_COUNTS)
        graph = torch.cuda.CUDAGraph()
        # every rank captures the same collectives in the same order (every
        # rank runs the same loop); a meshed capture is thread-local, so the
        # process group's watchdog thread may query its events meanwhile
        with torch.cuda.graph(graph, capture_error_mode="global" if self.mesh is None
                              else "thread_local"):
            tokens, logits, _ = step(cache)
        launches = {k: n - launches0[k] for k, n in _build.launches.items() if n != launches0[k]}
        counters = collections.Counter(
            {k: n - counters0[k] for k, n in eng.counters.items() if n != counters0[k]})
        seams = collections.Counter(
            {k: n - seams0[k] for k, n in sh.SEAM_COUNTS.items() if n != seams0[k]})
        _build.launches.update(launches0)
        for k, n in counters.items():
            eng.counters[k] -= n
        for k, n in seams.items():
            sh.SEAM_COUNTS[k] -= n
        return _Graph(graph, params, st["token"], st["t"], st["seed"], st["lanes"],
                      st["positions"], st["temperature"], cache, tokens, logits, launches,
                      counters, seams)


#: activation names whose sharding the port's decode does not run: the
#: residual stream's (training's sequence-parallel ``seq_act``, a column
#: shard of ``act_embed``)
_SHARDED_ACTIVATIONS = ("seq_act", "act_embed")
#: what ``SERVE_RULES`` shards over "model" in serving: the heads and the
#: decode ring's sequence (flash-decoding style)
_SERVE_SHARDED = ("act_heads", "kv_heads", "heads", "seq_kv")
#: the families whose decode runs ``SERVE_RULES``' heads and sequence-sharded
#: ring (the recurrent, enc-dec and VLM families are column-parallel only)
SERVE_RULES_FAMILIES = ("dense", "moe")


def _check_rules(mesh, rules, cfg=None, tpl: Optional[Template] = None,
                 policy: Optional[NumericsPolicy] = None) -> None:
    """The rules a meshed decode step runs: column-parallel rules (every
    activation but the batch whole: ``DECODE_RULES`` and its variants), or,
    for the dense and MoE families on the ``torch`` and ``cuda`` templates
    in float, ``SERVE_RULES`` (heads over "model" and the KV ring's
    sequence over "model", per-config overrides included).  Rules that
    shard the residual stream (``TRAIN_RULES``' sequence-parallel
    ``seq_act``) are training's (``launch.steps.make_train_step(mesh=)``);
    the other families, the fixed-point template and quantized policies
    run column-parallel rules only."""
    bad = [n for n in _SHARDED_ACTIVATIONS if sh.axis_size(mesh, rules.get(n)) > 1]
    if bad:
        raise ValueError(f"the port's meshed decode does not shard the residual stream: "
                         f"these rules shard {bad} (TRAIN_RULES' sequence-parallel "
                         f"activations are for training: launch.steps.make_train_step(mesh=))")
    heads = [n for n in _SERVE_SHARDED if sh.axis_size(mesh, rules.get(n)) > 1]
    if not heads:
        return
    why = None
    if cfg is not None and cfg.family not in SERVE_RULES_FAMILIES:
        why = (f"{cfg.name} ({cfg.family}): the recurrent, enc-dec and VLM families serve "
               f"column-parallel rules (DECODE_RULES) until ROADMAP 9b")
    elif tpl is not None and tpl.config.backend not in ("torch", "cuda"):
        why = (f"the {tpl.config.backend!r} template runs column-parallel rules only "
               f"(its row-parallel route is ROADMAP 9c)")
    elif policy is not None and policy.quantized:
        why = "a quantized policy runs column-parallel rules only (ROADMAP 9c)"
    if why:
        raise ValueError(f"these rules shard {heads} over the mesh (SERVE_RULES' heads and "
                         f"sequence-sharded KV ring): {why}")


class _MeshedSteps:
    """The meshed closures of one setup: each enters ``use_mesh``; the chunk
    step runs this rank's rows of the batch (the data-axis shard of the
    slot-indexed cache it holds) under ``batch_split`` and gathers its
    logits over the data axes, eagerly; ``decode_next`` is the meshed
    :class:`_DecodeStep` (a CUDA graph a signature and owner under NCCL,
    eager under gloo)."""

    def __init__(self, tpl: Template, cfg, cache_len: int, policy, mesh, rules, capture):
        self.tpl, self.cfg, self.cache_len, self.policy = tpl, cfg, cache_len, policy
        self.mesh, self.rules = mesh, rules
        self.decode_next = _DecodeStep(tpl, cfg, cache_len, policy, mesh, rules, capture)

    def prefill(self, params, tokens, ctx, last_pos):
        with sh.use_mesh(self.mesh, self.rules):
            return T.prefill(self.tpl, self.cfg, params, tokens, ctx=ctx,
                             cache_len=self.cache_len, last_pos=last_pos,
                             policy=self.policy)

    def chunk(self, params, tokens, t, n_valid, cache):
        dev = self.tpl.engine.device
        batch = self.rules.get("batch")
        take, f, split = _batch_rows(tokens.shape[0], self.mesh, batch)
        with sh.use_mesh(self.mesh, self.rules), sh.batch_split(f):
            logits, cache = T.prefill_chunk_step(
                self.tpl, self.cfg, params, *(take(_on(x, dev)) for x in (tokens, t, n_valid)),
                cache, policy=self.policy, inplace=True)
            if split:
                logits = sh.gather(logits, 0, batch)
        return logits, cache

    def decode(self, params, token, t, cache):
        _, logits, cache = self.decode_next(params, token, t, cache)
        return logits.clone(), cache  # a graph's buffer is rewritten by its next call


def serve_shardings(cfg, mesh, rules=None, *, full: bool = False):
    """The column-parallel :class:`~repro_torch.parallel.sharding.NamedSharding`
    tree of ``init_params(cfg)``'s parameters under ``rules`` (default
    ``DECODE_RULES``), from their shapes alone: ``init_params(gen, cfg,
    shardings=...)`` then draws only this rank's shards (a model no single
    card holds), the shards the meshed scheduler and steps read.  ``full``:
    the rules' whole layout instead (``tree_shardings``, the dry-run's
    ``in_shardings``): under ``SERVE_RULES`` wo and the MLP's down
    projection (and granite's expert down) hold their rows' shard, so their
    GEMMs are row-parallel."""
    from repro_torch.launch.steps import abstract_params

    place = sh.tree_shardings if full else sh.column_parallel_shardings
    return place(mesh, rules or DECODE_RULES, abstract_params(cfg), T.param_axes(cfg))


def shard_cache(cfg, cache, mesh, rules=None):
    """This rank's share of a decode cache (:func:`transformer.init_cache`'s
    tree, per slot or not, or a prefill's): every leaf that holds batch
    rows (the k / v rings, a recurrent layer's state ``h``, an SSD's
    ``state``, their conv histories, a cross layer's context k / v) cut to
    this rank's rows over the data axes of ``rules`` (default
    ``DECODE_RULES``), a per-slot pos with its rows; under rules that shard
    the ring's sequence (``seq_kv``, ``SERVE_RULES``) each k / v ring and
    its pos cut to this rank's slots too.  Positions every row shares stay
    whole over the rows.  A dim that already holds its shard (a meshed
    prefill fills only its rank's slots) is left as it is.  A meshed
    :func:`compiled_steps` decode reads this shard; its prefill runs every
    row and returns every row's cache."""
    axes = _slot_pos_axes(cache, T.cache_axes(cfg, cache))
    return sh.shard_tree(cache, sh.tree_shardings(mesh, rules or DECODE_RULES, cache, axes))


def init_local_cache(cfg, batch: int, cache_len: int, mesh, rules=None, *,
                     per_slot: bool = False, policy=None, dtype=None, device="cpu"):
    """This rank's share of ``transformer.init_cache(...)`` (see
    :func:`shard_cache`), allocated at its local shapes only: a sequence-
    sharded ring of a long context never exists whole on a rank.  Zeros,
    and -1 in every self-attention pos; the leaves carry their marks."""
    meta = shard_cache(cfg, T.init_cache(cfg, batch, cache_len, dtype, per_slot=per_slot,
                                         policy=policy, device="meta"), mesh, rules)

    def real(tree, key=None):
        if isinstance(tree, dict):
            return {k: real(v, k) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(real(v, key) for v in tree)
        if key == "cross":
            raise ValueError("init_local_cache: a cross layer's context cache comes from "
                             "its prefill")
        fill = -1 if key == "pos" else 0
        return sh.carry_marks(tree, torch.full(tuple(tree.shape), fill, dtype=tree.dtype,
                                               device=device))

    return real(meta)


def compiled_steps(tpl: Template, cfg, cache_len: int,
                   policy: Optional[NumericsPolicy] = None, *, mesh=None,
                   rules=None, capture: bool = True) -> StepFns:
    """The memoized :class:`StepFns` of one serving setup.

    prefill(params, tokens, ctx, last_pos)   -> (logits (B, V), cache)
    decode(params, token, t, cache)          -> (logits (B, V), cache')
    chunk(params, tokens, t, n_valid, cache) -> (logits (B, V), cache')
    decode_next(params, token, t, cache, sampling=None, lanes=None,
                positions=None, owner=None)  -> (tokens (B,), logits, cache')

    Keyed by (template object, config, cache_len, numerics policy): repeated
    ``generate()`` calls and every scheduler tick reuse one set of closures.
    ``decode`` / ``decode_next`` and ``chunk`` take the cache over (the
    caller gives it up) and write into it in place; on a CUDA template the
    decode step is a captured CUDA graph (see the module docstring) that
    owns its cache, so the tokens and logits ``decode_next`` returns are its
    static outputs, valid until its next call (``decode`` returns a copy
    of the logits).  ``decode_next`` picks the next
    tokens inside the step: argmax, or with ``sampling`` (temperature > 0)
    the lane draw of :func:`sample_tokens` at ``lanes`` / ``positions``
    (ints or (B,) vectors).  ``owner`` (a scheduler) gets graphs and a cache
    of its own; ``decode_next.release(owner)`` drops them.  A quantized
    policy expects the matching
    :func:`repro_torch.models.transformer.quantize_params` tree as params.

    With ``mesh`` (a mesh with ranks; ``rules`` default ``DECODE_RULES``)
    the closures are this rank's tensor-parallel steps
    (:class:`_MeshedSteps`: under ``use_mesh``, the chunk and decode steps
    on this rank's slot rows, tokens and logits gathered over the data
    axes), memoized apart from the unmeshed ones; the params are this
    rank's shard tree and the cache its slot shard.  The meshed decode step
    is a captured graph, collectives inside, where the mesh runs NCCL on a
    CUDA template, and eager elsewhere; ``capture=False`` keeps it eager
    there too.
    """
    policy = validate_policy(tpl.config, policy)
    if mesh is not None:
        rules = rules or DECODE_RULES
        if not mesh.has_groups:
            raise ValueError(f"meshed steps run on ranks (spawn_ranks); {mesh} is a "
                             f"layout only")
        _check_rules(mesh, rules, cfg, tpl, policy)
    elif not capture:
        raise ValueError("capture=False keeps a meshed decode step eager; pass mesh=")
    else:
        rules = None
    key = (id(tpl), cfg, int(cache_len), policy, None if mesh is None else id(mesh),
           rules, capture)
    entry = _STEP_FNS.pop(key, None)
    if entry is None and mesh is not None:
        m = _MeshedSteps(tpl, cfg, int(cache_len), policy, mesh, rules, capture)
        entry = ((tpl, mesh), StepFns(m.prefill, m.decode, m.chunk, m.decode_next))
    if entry is None:
        def _prefill(params, tokens, ctx, last_pos):
            return T.prefill(tpl, cfg, params, tokens, ctx=ctx, cache_len=cache_len,
                             last_pos=last_pos, policy=policy)

        decode_next = _DecodeStep(tpl, cfg, int(cache_len), policy)

        def _decode(params, token, t, cache):
            _, logits, cache = decode_next(params, token, t, cache)
            return logits.clone(), cache  # the step's buffer is rewritten by its next call

        def _chunk(params, tokens, t, n_valid, cache):
            return T.prefill_chunk_step(tpl, cfg, params, tokens, t, n_valid, cache,
                                        policy=policy, inplace=True)

        entry = (tpl, StepFns(_prefill, _decode, _chunk, decode_next))
    while len(_STEP_FNS) >= _STEP_FNS_MAX:
        _STEP_FNS.pop(next(iter(_STEP_FNS)))
    _STEP_FNS[key] = entry  # (re-)insert at the LRU tail; holds tpl, so its id stays
    return entry[1]


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

_RID = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request moving through queued -> active -> completed."""

    prompt: tuple  # prompt token ids
    max_new: int
    eos_id: Optional[int] = None
    arrival: float = 0.0
    rid: int = dataclasses.field(default_factory=lambda: next(_RID))

    # runtime state (owned by the scheduler)
    state: str = "new"  # new | queued | active | completed | rejected
    bucket: int = 0
    slot: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    t_next: int = 0
    prefilled: int = 0  # prompt positions already written to the cache
    prefill_target: int = 0  # positions a (re-)prefill must cover
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    first_token_at: float = -1.0
    completed_at: float = 0.0
    preemptions: int = 0
    slot_history: list = dataclasses.field(default_factory=list)
    finish_reason: str = ""

    @property
    def seq_len(self) -> int:
        """Tokens a (re-)prefill must process: prompt + already generated."""
        return len(self.prompt) + len(self.generated)

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.generated)


def session_snapshot(req: Request) -> dict:
    """The JSON-serializable resume state of one in-flight request: prompt,
    tokens generated so far, budget, identity and arrival.  The slot, bucket
    and prefill progress are dropped; a restoring scheduler re-derives
    them on admission."""
    return {
        "rid": req.rid,
        "prompt": list(req.prompt),
        "generated": list(req.generated),
        "max_new": req.max_new,
        "eos_id": req.eos_id,
        "arrival": req.arrival,
        "preemptions": req.preemptions,
    }


def request_from_snapshot(doc: dict) -> Request:
    """Rebuild a resumable :class:`Request` from :func:`session_snapshot`,
    keeping its ``rid``; its state resets to "new" for a fresh ``submit``."""
    req = Request(
        prompt=tuple(doc["prompt"]),
        max_new=int(doc["max_new"]),
        eos_id=doc["eos_id"],
        arrival=float(doc.get("arrival", 0.0)),
        rid=int(doc["rid"]),
    )
    req.generated = [int(t) for t in doc.get("generated", ())]
    req.preemptions = int(doc.get("preemptions", 0))
    return req


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission / batching policy (the ladder is the shape contract)."""

    ladder: tuple = (16, 32, 64)
    slots: int = 4
    max_new_limit: int = 32
    #: ring-cache length; 0 derives max(ladder) + max_new_limit (no wrap)
    cache_len: int = 0
    max_queue: int = 256
    #: preempt the most recently admitted active request once the queue head
    #: has waited this long with no free slot (None = never preempt)
    preempt_after: Optional[float] = None
    #: > 0 streams prompts longer than this into their slot in fixed-width
    #: chunks (one (slots, prefill_chunk) launch a tick, beside decode)
    #: instead of one whole-bucket prefill; 0 disables chunking
    prefill_chunk: int = 0
    #: "batched" coalesces a rung's pending prefills into one (B, L) launch;
    #: "sequential" is the one-(1, L)-launch-per-admission baseline
    prefill_mode: str = "batched"

    def resolved_cache_len(self) -> int:
        return self.cache_len or (max(self.ladder) + self.max_new_limit)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


class ServeScheduler:
    """Continuous-batching scheduler: FIFO queue, one coalesced (B, L)
    prefill launch per bucket rung a tick, chunked long-prompt streaming,
    one coalesced decode step a tick over a slot-indexed KV cache.

    Padding a prompt is sound only for attention mixers (pad keys are masked
    out; recurrent / SSM states would absorb the pad tokens), so admission is
    restricted to families whose every layer mixes by full attention.

    ``logit_sink``, when set, is called as ``sink(request, logits_row)`` for
    every token picked (a check's hook: it keeps the scheduler's own logits
    beside its stream).

    ``mesh`` (a mesh with ranks, see ``launch/mesh.py:spawn_ranks``) runs
    this rank's share of tensor-parallel decode under ``rules`` (default
    ``DECODE_RULES``): its column shard of the parameters, its slots of the
    KV cache (the slots divide over the data axes), every host decision on
    tokens gathered from all ranks (module docstring).  Warm-up then also
    plans every GEMM shape it met at its local extent
    (``counters["warmup_shard_misses"]``).  Its decode step is a CUDA graph,
    replayed each tick, where the mesh runs NCCL on a CUDA template
    (``counters["meshed_replayed_decode_steps"]``; ``capture=False`` keeps
    it eager) and eager under gloo (``counters["meshed_eager_decode_steps"]``).
    """

    def __init__(self, cfg, params, *, sched: Optional[SchedulerConfig] = None,
                 tpl: Optional[Template] = None, clock=None,
                 policy: Optional[NumericsPolicy] = None,
                 sampling: Optional[SamplingParams] = None,
                 mesh=None, rules=None, capture: bool = True) -> None:
        pattern = T.plan_pattern(cfg)
        # "local" with a real window is unsound too: its ring is only
        # window-sized, so a padded prefill longer than the window evicts
        # real keys for pad keys that trimming then voids
        bad = [p.mixer for p in pattern
               if not (p.mixer == "attn" or (p.mixer == "local" and not cfg.window))]
        if bad or any(p.cross for p in pattern) or cfg.family in ("encdec", "vlm"):
            raise ValueError(
                f"scheduler requires full-attention mixers without context inputs; "
                f"{cfg.name} ({cfg.family}) has {bad or 'cross-attention'}")
        self.cfg = cfg
        self.params = params
        self.tpl = tpl or default_template()
        self.sched = sched or SchedulerConfig()
        self.clock = clock or SystemClock()
        self.sampling = sampling or SamplingParams()
        self.policy = validate_policy(self.tpl.config, policy)
        self.exec_params = (T.quantize_params(self.tpl, cfg, params, self.policy)
                            if self.policy.quantized else params)
        self.device = self.tpl.engine.device
        self.cache_len = self.sched.resolved_cache_len()
        if max(self.sched.ladder) > self.cache_len:
            raise ValueError("cache_len smaller than the largest bucket")
        if self.sched.prefill_mode not in ("batched", "sequential"):
            raise ValueError(f"unknown prefill_mode {self.sched.prefill_mode!r}")
        if self.sched.prefill_chunk < 0 or self.sched.prefill_chunk > self.cache_len:
            raise ValueError(f"prefill_chunk {self.sched.prefill_chunk} must be in "
                             f"[0, cache_len={self.cache_len}]")
        # -- tensor-parallel decode: column-parallel params, slot-sharded cache
        self.mesh = mesh
        self.rules = (rules or DECODE_RULES) if mesh is not None else None
        self._rows = (0, self.sched.slots)
        if mesh is not None:
            if not mesh.has_groups:
                raise ValueError(f"a meshed scheduler runs on ranks (spawn_ranks); "
                                 f"{mesh} is a layout only")
            batch = self.rules.get("batch")
            data_shards = sh.axis_size(mesh, batch)
            if data_shards > 1 and self.sched.slots % data_shards:
                raise ValueError(
                    f"slots={self.sched.slots} must divide over the {data_shards}-way "
                    f"data axes to shard the per-slot KV cache")
            axes = T.param_axes(cfg)
            if "lm_head" in self.exec_params and "lm_head" not in axes:
                # quantize_params materializes an int16 head for tied
                # embeddings; give it the untied head's logical axes
                axes = dict(axes, lm_head={"w": ("embed", "vocab")})
            self.exec_params = sh.shard_tree(
                self.exec_params,
                sh.column_parallel_shardings(mesh, self.rules, self.exec_params, axes))
            self._rows = sh.local_rows(self.sched.slots, mesh, batch)
        self.engine = self.tpl.engine
        self.registry = self.engine.plan_cache
        self._prefill, _, self._chunk, self._decode_next = compiled_steps(
            self.tpl, cfg, self.cache_len, self.policy, mesh=self.mesh, rules=self.rules,
            capture=capture)
        #: the counter a meshed decode step ticks
        self._meshed_steps = None if mesh is None else (
            "meshed_replayed_decode_steps" if self._decode_next.graphed
            else "meshed_eager_decode_steps")
        #: batch sizes a coalesced prefill launch is padded up to
        self._batch_rungs = ((1,) if self.sched.prefill_mode == "sequential"
                             else batch_rungs(self.sched.slots))
        self.logit_sink = None
        self.queue: collections.deque = collections.deque()
        self.active: dict = {}  # slot -> Request
        self._free: list = sorted(range(self.sched.slots))
        self.cache = None  # batched slot-indexed cache, built on first admit
        self.counters: collections.Counter = collections.Counter()
        self.bucket_stats: dict = {
            int(b): {"admitted": 0, "prefills": 0, "launches": 0,
                     "occupancy": 0, "hits": 0, "misses": 0}
            for b in sorted(self.sched.ladder)
        }
        self.history: list = []
        self.results: dict = {}  # rid -> Request (completed)

    def _make_cache(self):
        """A fresh slot-indexed KV cache on the template's device; under a
        mesh this rank's slots of it (``cache_axes``, with the per-slot pos
        rows sharded with their slots: a rank holds only its slots' rows)."""
        policy = self.policy if self.policy.quantized else None
        if self.mesh is None:
            return T.init_cache(self.cfg, self.sched.slots, self.cache_len, per_slot=True,
                                policy=policy, device=self.device)
        return init_local_cache(self.cfg, self.sched.slots, self.cache_len, self.mesh,
                                self.rules, per_slot=True, policy=policy, device=self.device)

    def _local(self, a: np.ndarray) -> np.ndarray:
        """This rank's slot rows of a per-slot host vector."""
        lo, hi = self._rows
        return a[lo:hi]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, torch.int64)

    # -- warmup --------------------------------------------------------------

    def warmup(self) -> dict:
        """Run every (batch rung x bucket) prefill, the chunk step and the
        coalesced decode step once: every plan (and, on a CUDA template, this
        scheduler's own decode graph) is made here, scoped per bucket, so a trace
        replayed afterwards makes no DSE search and no capture.  Returns the
        per-bucket hit / miss deltas."""
        slots = self.sched.slots
        for b in sorted(self.sched.ladder):
            for nb in self._batch_rungs:
                toks = torch.zeros((nb, b), dtype=torch.int64, device=self.device)
                last = torch.full((nb,), b - 1, dtype=torch.int64, device=self.device)
                with self.registry.scope(into=self.bucket_stats[b]):
                    self._prefill(self.exec_params, toks, None, last)
        cache = self._make_cache()
        if self.sched.prefill_chunk:
            ck = self.sched.prefill_chunk
            tok = torch.zeros((slots, ck), dtype=torch.int64, device=self.device)
            with self.registry.scope() as chunk_delta:
                _, cache = self._chunk(self.exec_params, tok,
                                       self._tensor(np.full((slots,), -1, np.int64)),
                                       self._tensor(np.zeros((slots,), np.int64)), cache)
            self.counters["warmup_chunk_misses"] += chunk_delta["misses"]
        tok = np.zeros((slots, 1), np.int64)
        with self.registry.scope() as decode_delta:
            self._decode_next(self.exec_params, tok, np.zeros((slots,), np.int64), cache,
                              self.sampling, np.arange(slots), np.zeros((slots,), np.int64),
                              owner=self)
        self.counters["warmup_decode_misses"] += decode_delta["misses"]
        if self.mesh is not None:
            # the local plan of every logical GEMM shape warm-up met, so a
            # store a meshed run saved warms a restart completely (the
            # steps above plan their own local calls already)
            with self.registry.scope() as shard_delta:
                for shape in self.registry.gemm_shapes(self.engine.config.hw):
                    self.engine.plan_gemm(*shape, mesh=self.mesh)
            self.counters["warmup_shard_misses"] += shard_delta["misses"]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {b: dict(s) for b, s in self.bucket_stats.items()}

    # -- admission control ---------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Queue a request; False (state=rejected) when admission control
        refuses it: unknown-bucket length, over-limit generation budget, a
        sequence that would wrap the ring cache, or a full queue.  A resumed
        session (non-empty ``generated``) is budgeted by ``remaining``."""
        self.counters["submitted"] += 1
        bucket = bucket_for(req.seq_len, self.sched.ladder)
        fits = (
            bucket is not None
            and 0 < req.remaining
            and req.max_new <= self.sched.max_new_limit
            and req.seq_len + req.remaining <= self.cache_len
        )
        if not fits or len(self.queue) >= self.sched.max_queue:
            req.state = "rejected"
            self.counters["rejected"] += 1
            return False
        if req.generated:
            self.counters["resumed_sessions"] += 1
        req.bucket = bucket
        req.state = "queued"
        req.submitted_at = self.clock.now()
        self.queue.append(req)
        return True

    # -- internals -----------------------------------------------------------

    def _complete(self, req: Request, reason: str) -> None:
        req.state = "completed"
        req.finish_reason = reason
        req.completed_at = self.clock.now()
        if req.slot is not None:
            self.active.pop(req.slot, None)
            self._free.append(req.slot)
            self._free.sort()
            req.slot = None
        self.counters["completed"] += 1
        self.results[req.rid] = req

    def _preempt_if_starving(self, now: float) -> Optional[Request]:
        pa = self.sched.preempt_after
        if pa is None or not self.queue or self._free or not self.active:
            return None
        head = self.queue[0]
        if now - head.submitted_at < pa:
            return None
        # victim: the most recently admitted active request that can re-bucket
        for slot in sorted(self.active, key=lambda s: (self.active[s].admitted_at, s),
                           reverse=True):
            req = self.active[slot]
            nb = bucket_for(req.seq_len, self.sched.ladder)
            if nb is not None and req.seq_len + req.remaining <= self.cache_len:
                self.active.pop(slot)
                self._free.append(slot)
                self._free.sort()
                req.slot = None
                req.state = "queued"
                req.preemptions += 1
                req.prefilled = 0
                req.prefill_target = 0
                req.submitted_at = now  # waits its turn afresh
                self.counters["preempted"] += 1
                return req
        return None

    def _pick_tokens(self, logits, lanes, positions) -> np.ndarray:
        """Next token per row of a (B, V) prefill logits batch: argmax when
        greedy, else one draw per RNG lane (lane = slot id, position = the
        absolute position the drawn token will occupy)."""
        if self.sampling.greedy:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        return sample_tokens(logits, self.sampling.seed, self._tensor(lanes),
                             self._tensor(positions), self.sampling.temperature,
                             self.sampling.top_k).cpu().numpy()

    def _emit_first(self, req: Request, tok: int, event: dict) -> None:
        """Record a request's first generated token (prefill completion)."""
        req.generated.append(int(tok))
        req.first_token_at = self.clock.now()
        self.counters["tokens"] += 1
        if req.eos_id is not None and int(tok) == req.eos_id:
            self._complete(req, "eos")
            event["completed"].append((req.rid, "eos"))
        elif req.remaining <= 0:
            self._complete(req, "length")
            event["completed"].append((req.rid, "length"))
        else:
            req.t_next = req.prefill_target

    def _launch_prefill(self, bucket: int, group: list, event: dict) -> None:
        """ONE coalesced (B, bucket) prefill launch for a rung's admissions:
        batch padded up to the smallest batch rung >= |group| (pad rows are
        zero prompts whose outputs are discarded), logits read at each row's
        real last token, surviving rows scattered into their cache slots."""
        bstats = self.bucket_stats[bucket]
        nreal = len(group)
        npad = next(nb for nb in self._batch_rungs if nb >= nreal)
        tokens = np.zeros((npad, bucket), np.int64)  # right-padded up to the rung
        last = np.zeros((npad,), np.int64)
        for i, r in enumerate(group):
            seq = list(r.prompt) + list(r.generated)
            tokens[i, : len(seq)] = seq
            last[i] = len(seq) - 1
        with self.registry.scope(into=bstats):
            logits, rows_cache = self._prefill(self.exec_params, self._tensor(tokens),
                                               None, self._tensor(last))
        bstats["admitted"] += nreal
        bstats["prefills"] += nreal
        bstats["launches"] += 1
        self.counters["prefills"] += nreal
        self.counters["prefill_launches"] += 1
        self.counters["prefill_rows"] += nreal
        event["prefill_launches"] += 1
        event["prefill_rows"] += nreal
        event["launches"] += 1

        lanes = np.zeros((npad,), np.int64)
        posv = np.zeros((npad,), np.int64)
        for i, r in enumerate(group):
            lanes[i] = r.slot
            posv[i] = r.prefill_target
        toks = self._pick_tokens(logits, lanes, posv)
        sel = np.zeros((self.sched.slots,), bool)
        src = np.zeros((self.sched.slots,), np.int64)
        vlen = np.ones((self.sched.slots,), np.int64)
        for i, r in enumerate(group):
            r.prefilled = r.prefill_target
            if self.logit_sink is not None:
                self.logit_sink(r, logits[i])
            self._emit_first(r, int(toks[i]), event)
            if r.state == "active":  # not at once eos / length-completed
                sel[r.slot] = True
                src[r.slot] = i
                vlen[r.slot] = r.prefill_target
        if self._local(sel).any():  # this rank's slots (every slot off a mesh)
            self.cache = T.insert_cache_rows(
                self.cache, rows_cache, src_rows=self._local(src), sel=self._local(sel),
                valid_lens=self._local(vlen), inplace=True)

    # -- the event loop body -------------------------------------------------

    def step(self):
        """One scheduler tick: (maybe) preempt, admit FIFO, one coalesced
        prefill launch per occupied bucket rung, one chunk launch for
        mid-prefill slots, one coalesced decode step over the decoding
        slots.  Returns the tick's event dict when any work ran, else False.
        The event's ``launches`` counts compute launches only (prefill +
        chunk + decode), the unit of :func:`replay_trace`'s cost model."""
        now = self.clock.now()
        event = {"now": now, "admitted": [], "completed": [], "preempted": [],
                 "decoded": 0, "prefill_launches": 0, "prefill_rows": 0,
                 "chunk_rows": 0, "launches": 0}

        victim = self._preempt_if_starving(now)

        admitted = []
        while self._free and self.queue:
            req = self.queue.popleft()
            slot = self._free.pop(0)
            req.slot = slot
            req.slot_history.append(slot)
            req.state = "active"
            req.admitted_at = now
            req.bucket = bucket_for(req.seq_len, self.sched.ladder)
            req.prefill_target = req.seq_len
            req.prefilled = 0
            self.active[slot] = req
            self.counters["admitted"] += 1
            admitted.append(req)
            event["admitted"].append(req.rid)
        if victim is not None:
            self.queue.appendleft(victim)
            event["preempted"].append(victim.rid)

        if admitted and self.cache is None:
            self.cache = self._make_cache()

        ck = self.sched.prefill_chunk
        whole = [r for r in admitted if not ck or r.prefill_target <= ck]
        chunked = [r for r in admitted if ck and r.prefill_target > ck]

        # ONE coalesced launch per rung with pending whole-prompt prefills
        # (sequential mode: one launch per admission, the A/B baseline)
        by_bucket: dict = {}
        for r in whole:
            by_bucket.setdefault(r.bucket, []).append(r)
        for bucket in sorted(by_bucket):
            grp = by_bucket[bucket]
            if self.sched.prefill_mode == "sequential":
                for r in grp:
                    self._launch_prefill(bucket, [r], event)
            else:
                self._launch_prefill(bucket, grp, event)

        # chunk-admitted slots inherit stale ring entries from their previous
        # occupant: invalidate them before the first chunk lands
        if chunked:
            sel = np.zeros((self.sched.slots,), bool)
            for r in chunked:
                sel[r.slot] = True
            self.cache = T.clear_cache_rows(self.cache, self._local(sel), inplace=True)

        # ONE fixed-shape chunk launch streams every mid-prefill slot forward
        pending = [r for r in self.active.values() if r.prefilled < r.prefill_target]
        if pending:
            slots = self.sched.slots
            tok = np.zeros((slots, ck), np.int64)
            t0 = np.full((slots,), -1, np.int64)
            nv = np.zeros((slots,), np.int64)
            for r in pending:
                seq = list(r.prompt) + list(r.generated)
                n = min(ck, r.prefill_target - r.prefilled)
                tok[r.slot, :n] = seq[r.prefilled: r.prefilled + n]
                t0[r.slot] = r.prefilled
                nv[r.slot] = n
            logits, self.cache = self._chunk(self.exec_params, self._tensor(tok),
                                             self._tensor(t0), self._tensor(nv), self.cache)
            self.counters["chunk_steps"] += 1
            event["chunk_rows"] = len(pending)
            event["launches"] += 1
            finishers = []
            for r in pending:
                r.prefilled += int(nv[r.slot])
                if r.prefilled >= r.prefill_target:
                    finishers.append(r)
            if finishers:
                lanes = np.arange(slots, dtype=np.int64)
                posv = np.zeros((slots,), np.int64)
                for r in finishers:
                    posv[r.slot] = r.prefill_target
                toks = self._pick_tokens(logits, lanes, posv)
                for r in finishers:
                    if self.logit_sink is not None:
                        self.logit_sink(r, logits[r.slot])
                    self._emit_first(r, int(toks[r.slot]), event)

        # ONE coalesced decode step over every decoding slot; mid-chunk and
        # free lanes are gated off with t = -1 (their cache rows do not move)
        decoding = {s: r for s, r in self.active.items() if r.prefilled >= r.prefill_target}
        if decoding:
            slots = self.sched.slots
            tok = np.zeros((slots, 1), np.int64)
            tvec = np.full((slots,), -1, np.int64)
            for slot, req in decoding.items():
                tok[slot, 0] = req.generated[-1]
                tvec[slot] = req.t_next
            toks, logits, self.cache = self._decode_next(
                self.exec_params, tok, tvec, self.cache, self.sampling,
                np.arange(slots, dtype=np.int64), np.maximum(tvec + 1, 0), owner=self)
            next_tok = toks.cpu().numpy()  # the tick's one read of the device
            self.counters["decode_steps"] += 1
            if self._meshed_steps is not None:
                self.counters[self._meshed_steps] += 1
            self.counters["slot_steps"] += len(decoding)
            event["decoded"] = len(decoding)
            event["launches"] += 1
            for slot in sorted(decoding):
                req = decoding[slot]
                self.bucket_stats[req.bucket]["occupancy"] += 1
                if self.logit_sink is not None:
                    self.logit_sink(req, logits[slot])
                req.generated.append(int(next_tok[slot]))
                req.t_next += 1
                self.counters["tokens"] += 1
            for slot in sorted(decoding):
                req = decoding[slot]
                if req.eos_id is not None and req.generated[-1] == req.eos_id:
                    self._complete(req, "eos")
                    event["completed"].append((req.rid, "eos"))
                elif req.remaining <= 0:
                    self._complete(req, "length")
                    event["completed"].append((req.rid, "length"))

        worked = bool(event["admitted"] or event["decoded"]
                      or event["preempted"] or event["launches"])
        if not worked:
            return False
        self.history.append(event)
        return event

    def release(self) -> None:
        """Give up this scheduler's device state: its KV cache and the CUDA
        graphs (with their memory pools) its decode steps own.  A router
        calls it on the incarnation it kills; dropping the scheduler does the
        same once it is garbage-collected."""
        self._decode_next.release(self)
        self.cache = None

    def export_sessions(self) -> list:
        """JSON-serializable snapshots of every in-flight session: active
        sessions first in admission order, then the queued backlog in queue
        order (the order a restoring router resubmits them in)."""
        order = sorted(self.active, key=lambda s: (self.active[s].admitted_at, s))
        reqs = [self.active[s] for s in order] + list(self.queue)
        return [session_snapshot(r) for r in reqs]

    def drain(self, *, tick: float = 0.0, max_steps: int = 100_000) -> None:
        """Run the event loop until queue and slots are empty."""
        for _ in range(max_steps):
            if not (self.queue or self.active):
                return
            self.step()
            self.clock.sleep(tick)
        raise RuntimeError(f"scheduler did not drain in {max_steps} steps")

    # -- reporting -----------------------------------------------------------

    def _ttft(self) -> dict:
        """Time-to-first-token percentiles over completed requests."""
        waits = sorted(r.first_token_at - r.submitted_at
                       for r in self.results.values() if r.first_token_at >= 0)
        out = {"n": len(waits)}
        if waits:
            arr = np.asarray(waits)
            out["p50"] = float(np.percentile(arr, 50))
            out["p99"] = float(np.percentile(arr, 99))
            out["mean"] = float(arr.mean())
        return out

    def stats(self) -> dict:
        c = self.counters
        return {
            "counters": dict(c),
            "mean_occupancy": round(c["slot_steps"] / max(c["decode_steps"], 1), 3),
            "prefill_coalescing": round(c["prefill_rows"] / max(c["prefill_launches"], 1), 3),
            "ttft": self._ttft(),
            "buckets": {b: dict(s) for b, s in self.bucket_stats.items()},
            "registry": self.registry.stats(),
        }

    def stats_line(self) -> str:
        c = self.counters
        occ = c["slot_steps"] / max(c["decode_steps"], 1)
        coal = c["prefill_rows"] / max(c["prefill_launches"], 1)
        ttft = self._ttft()
        per_bucket = " ".join(f"{b}:{s['admitted']}a/{s['occupancy']}o/{s['misses']}m"
                              for b, s in sorted(self.bucket_stats.items()))
        return (
            f"scheduler: submitted={c['submitted']} admitted={c['admitted']} "
            f"completed={c['completed']} rejected={c['rejected']} "
            f"preempted={c['preempted']} prefills={c['prefills']} "
            f"prefill_launches={c['prefill_launches']} coalescing={coal:.2f} "
            f"chunk_steps={c['chunk_steps']} "
            f"decode_steps={c['decode_steps']} tokens={c['tokens']} "
            f"mean_occupancy={occ:.2f} "
            f"ttft_p50={ttft.get('p50', 0.0):.3f} "
            f"ttft_p99={ttft.get('p99', 0.0):.3f} | "
            f"buckets[adm/occ/miss] {per_bucket}"
        )


# ---------------------------------------------------------------------------
# trace replay (the simulation harness: the loop production uses)
# ---------------------------------------------------------------------------


def _slot_pos_axes(cache, axes, ring: bool = False):
    """``cache_axes`` with each self-attention ring's pos sharded like its k
    / v: a per-slot pos ((B, C), stacked (L, B, C): two dims fewer than its
    k ring) over ("batch", "seq_kv"), a pos every row shares ((C,), (L, C))
    over "seq_kv"; a cross layer's context positions stay whole."""
    if isinstance(cache, dict):
        out = {}
        for k, v in cache.items():
            if k == "pos" and ring and isinstance(v, torch.Tensor) and "k" in cache:
                lead = v.ndim - (2 if v.ndim == cache["k"].ndim - 2 else 1)
                out[k] = (None,) * lead + (("batch", "seq_kv") if v.ndim - lead == 2
                                           else ("seq_kv",))
            else:
                out[k] = _slot_pos_axes(v, axes[k], ring or k == "attn")
        return out
    if isinstance(cache, tuple):
        return tuple(_slot_pos_axes(c, a, ring) for c, a in zip(cache, axes))
    return axes


def replay_trace(sched: ServeScheduler, requests: Sequence[Request], *,
                 tick: float = 1.0, max_steps: int = 100_000,
                 launch_cost: float = 0.0) -> dict:
    """Drive the scheduler from a scripted arrival trace.

    ``arrival`` times are offsets from the clock's reading at entry;
    submissions come due as the clock passes start + arrival, and an idle
    scheduler jumps (virtual clock) or sleeps (system clock) to the next
    arrival.  One ``step()`` per ``tick`` of clock time; ``launch_cost > 0``
    charges that much clock per compute launch the step issued.  Returns
    ``sched.stats()`` once everything drains."""
    pending = collections.deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
    t0 = sched.clock.now()
    for _ in range(max_steps):
        elapsed = sched.clock.now() - t0
        while pending and pending[0].arrival <= elapsed:
            sched.submit(pending.popleft())
        if not (sched.queue or sched.active):
            if not pending:
                return sched.stats()
            sched.clock.sleep(pending[0].arrival - elapsed)
            continue
        ev = sched.step()
        n_launch = ev["launches"] if isinstance(ev, dict) else 0
        sched.clock.sleep(tick + launch_cost * n_launch)
    raise RuntimeError(f"trace did not drain in {max_steps} steps")


def synthetic_trace(n: int, *, seed: int = 0, vocab: int = 128,
                    ladder: Sequence[int] = (16, 32, 64), max_new: int = 8,
                    arrival_every: float = 0.0, eos_id: Optional[int] = None,
                    min_len: int = 1, min_new: int = 1) -> list:
    """A deterministic mixed prompt-length trace (numpy's generator from
    ``seed``; with the default ``min_len`` / ``min_new`` of 1, the
    reference's draws).  Lengths sweep the ladder (from just above the
    previous rung, or ``min_len``, to the rung itself) so every bucket sees
    traffic; budgets run from ``min_new`` to ``max_new``; ``arrival_every >
    0`` spaces arrivals out, 0 makes the trace bursty (all at t = 0)."""
    rng = np.random.default_rng(seed)
    lo = [1] + [int(b) + 1 for b in sorted(ladder)[:-1]]
    hi = sorted(int(b) for b in ladder)
    reqs = []
    for i in range(n):
        j = int(rng.integers(0, len(hi)))
        length = int(rng.integers(max(lo[j], min_len), hi[j] + 1))
        prompt = tuple(int(x) for x in rng.integers(0, vocab, size=length))
        reqs.append(Request(prompt=prompt, max_new=int(rng.integers(min_new, max_new + 1)),
                            eos_id=eos_id, arrival=i * arrival_every))
    return reqs
