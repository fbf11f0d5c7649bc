"""Random sampling, counterpart of ``mxnet_tpu/random.py``.

A process-wide stream: :func:`seed` sets its seed and resets its draw
counter, and every draw takes a fresh ``torch.Generator`` on the target
device, seeded from ``(seed, draw index)``, so draws are reproducible
from a seed and :func:`set_state` with a state :func:`get_state` gave
replays the same draws (the JAX package folds the draw index into its
key the same way). The numbers differ from the JAX package's threefry
draws; tests hold them by replay and by distribution.

Besides the sampling functions, the executors' Dropout generators
(an executor bound without ``seed``) and the initializers made without
``seed=`` draw from this stream.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from .base import mx_real_t, torch_dtype
from .context import Context, current_context
from .ndarray import NDArray

__all__ = ["seed", "get_state", "set_state", "next_seed", "generator",
           "uniform", "normal", "gaussian", "randint"]

_lock = threading.Lock()
_seed = 0
_counter = 0
_MASK = (1 << 64) - 1


def seed(seed_state: int) -> None:
    """Seed the stream and reset its draw counter (``mx.random.seed``)."""
    global _seed, _counter
    with _lock:
        _seed = int(seed_state)
        _counter = 0


def get_state() -> Tuple[int, int]:
    """The stream's state ``(seed, draws)``."""
    with _lock:
        return (_seed, _counter)


def set_state(state: Tuple[int, int]) -> None:
    """Restore a :func:`get_state` state: the draws after it repeat."""
    global _seed, _counter
    s, n = state
    with _lock:
        _seed = int(s)
        _counter = int(n)


def _mix(x: int) -> int:
    """splitmix64's finaliser: nearby inputs give unrelated outputs."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK
    return x ^ (x >> 31)


def next_seed() -> int:
    """The seed of the stream's next draw (and count it): a function of
    ``(seed, draw index)`` below 2**63."""
    global _counter
    with _lock:
        n = _counter
        _counter += 1
        s = _seed
    return _mix((_mix(s & _MASK) + n * 0x9E3779B97F4A7C15) & _MASK) >> 1


def generator(device) -> torch.Generator:
    """A fresh generator on ``device`` seeded by :func:`next_seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(next_seed())
    return gen


def _target(shape, ctx: Optional[Context], out: Optional[NDArray], dtype):
    if out is not None:
        return out
    ctx = ctx if ctx is not None else current_context()
    if shape is None:
        shape = (1,)
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.empty(tuple(shape), dtype=torch_dtype(dtype),
                               device=ctx.torch_device()), ctx)


def uniform(low: float = 0.0, high: float = 1.0, shape=None,
            ctx: Optional[Context] = None, out: Optional[NDArray] = None,
            dtype=mx_real_t) -> NDArray:
    """Draws from U[low, high); into ``out`` in place where given."""
    res = _target(shape, ctx, out, dtype)
    with torch.no_grad():
        res.handle.uniform_(low, high, generator=generator(res.handle.device))
    return res


def normal(loc: float = 0.0, scale: float = 1.0, shape=None,
           ctx: Optional[Context] = None, out: Optional[NDArray] = None,
           dtype=mx_real_t) -> NDArray:
    """Draws from N(loc, scale^2); into ``out`` in place where given."""
    res = _target(shape, ctx, out, dtype)
    with torch.no_grad():
        res.handle.normal_(loc, scale, generator=generator(res.handle.device))
    return res


gaussian = normal


def randint(low: int, high: int, shape=None, ctx: Optional[Context] = None,
            dtype="int32") -> NDArray:
    """Integers drawn uniformly from [low, high)."""
    res = _target(shape, ctx, None, dtype)
    with torch.no_grad():
        res.handle.random_(low, high, generator=generator(res.handle.device))
    return res
