"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see ONE device
(the dry-run sets its own 512-device flag in its own process).

Also provides a minimal ``hypothesis`` shim when the real package is absent
(this container has no network), so the property tests still collect and run
with deterministic boundary + pseudo-random examples.  Install the real
thing via requirements-dev.txt to get full shrinking/fuzzing behavior.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

jax.config.update("jax_enable_x64", False)


# ---------------------------------------------------------------------------
# hypothesis shim (only when hypothesis is not installed)
# ---------------------------------------------------------------------------

try:  # pragma: no cover - depends on environment
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import functools as _functools
    import random as _random
    import sys as _sys
    import types as _types

    class _Strategy:
        """Draws deterministic boundary values first, then seeded randoms."""

        def __init__(self, draw):
            self._draw = draw

    def _integers(min_value=0, max_value=2**31 - 1):
        bounds = (min_value, max_value, min_value + (max_value - min_value) // 2)

        def draw(rng, i):
            if i < len(bounds):
                return bounds[i]
            return rng.randint(min_value, max_value)

        return _Strategy(draw)

    def _floats(min_value=0.0, max_value=1.0, allow_nan=False, **_kw):
        bounds = (float(min_value), float(max_value), 0.5 * (min_value + max_value))

        def draw(rng, i):
            if i < len(bounds):
                return bounds[i]
            return rng.uniform(min_value, max_value)

        return _Strategy(draw)

    def _sampled_from(elements):
        choices = list(elements)

        def draw(rng, i):
            if i < len(choices):
                return choices[i]
            return rng.choice(choices)

        return _Strategy(draw)

    def _lists(elements, min_size=0, max_size=10):
        def draw(rng, i):
            if i == 0:
                size = min_size
            elif i == 1:
                size = max_size
            else:
                size = rng.randint(min_size, max_size)
            # offset the element draw index so list contents vary per example
            return [elements._draw(rng, i + j + 1) for j in range(size)]

        return _Strategy(draw)

    def _given(*strategies, **kw):
        assert not kw, "hypothesis shim supports positional strategies only"

        def deco(fn):
            @_functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(
                    wrapper, "_shim_max_examples",
                    getattr(fn, "_shim_max_examples", 10),
                )
                rng = _random.Random(0)
                for i in range(n):
                    ex = tuple(s._draw(rng, i) for s in strategies)
                    fn(*args, *ex, **kwargs)

            # pytest must not introspect the strategy params as fixtures
            del wrapper.__wrapped__
            wrapper._shim_given = True
            return wrapper

        return deco

    def _settings(max_examples=10, deadline=None, **_kw):
        def deco(fn):
            fn._shim_max_examples = max_examples
            return fn

        return deco

    _h = _types.ModuleType("hypothesis")
    _st = _types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.lists = _lists
    _st.sampled_from = _sampled_from
    _h.given = _given
    _h.settings = _settings
    _h.strategies = _st
    _sys.modules["hypothesis"] = _h
    _sys.modules["hypothesis.strategies"] = _st


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


def assert_close(a, b, atol=1e-4, rtol=1e-4, msg=""):
    np.testing.assert_allclose(
        np.asarray(a, np.float32), np.asarray(b, np.float32),
        atol=atol, rtol=rtol, err_msg=msg,
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: runs the port's CUDA kernels on an NVIDIA card (skips without one); "
        "select with `pytest -m gpu`",
    )
