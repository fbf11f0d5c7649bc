"""Weight initializers, counterpart of ``mxnet_tpu/initializer.py``.

Dispatch is by parameter name, as in the JAX package: ``*bias`` and
``*beta`` and ``*moving_mean`` start at 0, ``*gamma`` and
``*moving_var`` at 1, ``*weight`` draws from the initializer's
distribution. Each initializer draws from its own ``torch.Generator``
on the CPU, seeded at construction (``seed=``), and copies the values to
the array's device: the same seed gives the same weights on the CPU and
on the card. (The JAX package draws from threefry keys; the numbers
differ from it, which is why parity tests carry weights across with
``interop``.)
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Initializer", "Uniform", "Normal", "Xavier"]


class Initializer:
    """Base: dispatch by parameter name suffix."""

    def __init__(self, seed: int = 0):
        self._gen = torch.Generator(device="cpu")
        self._gen.manual_seed(int(seed))

    def __call__(self, name: str, arr: NDArray):
        if name.endswith("bias") or name.endswith("beta"):
            arr[:] = 0.0
        elif name.endswith("gamma"):
            arr[:] = 1.0
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("moving_mean") or name.endswith("moving_avg"):
            arr[:] = 0.0
        elif name.endswith("moving_var"):
            arr[:] = 1.0
        else:
            raise MXNetError("unknown parameter name pattern '%s'" % name)

    def _uniform(self, arr: NDArray, low: float, high: float):
        t = torch.empty(arr.shape, dtype=torch.float32)
        t.uniform_(low, high, generator=self._gen)
        arr[:] = t

    def _normal(self, arr: NDArray, sigma: float):
        t = torch.empty(arr.shape, dtype=torch.float32)
        t.normal_(0.0, sigma, generator=self._gen)
        arr[:] = t

    def _init_weight(self, name, arr):
        raise NotImplementedError


class Uniform(Initializer):
    def __init__(self, scale: float = 0.07, seed: int = 0):
        super().__init__(seed)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._uniform(arr, -self.scale, self.scale)


class Normal(Initializer):
    def __init__(self, sigma: float = 0.01, seed: int = 0):
        super().__init__(seed)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        self._normal(arr, self.sigma)


class Xavier(Initializer):
    def __init__(self, rnd_type: str = "uniform", factor_type: str = "avg",
                 magnitude: float = 3.0, seed: int = 0):
        super().__init__(seed)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = magnitude

    def _init_weight(self, _, arr):
        shape = arr.shape
        fan_out = shape[0]
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        factors = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                   "out": fan_out}
        if self.factor_type not in factors:
            raise MXNetError("invalid factor_type %s" % self.factor_type)
        scale = float(np.sqrt(self.magnitude / factors[self.factor_type]))
        if self.rnd_type == "uniform":
            self._uniform(arr, -scale, scale)
        elif self.rnd_type == "gaussian":
            self._normal(arr, scale)
        else:
            raise MXNetError("invalid rnd_type %s" % self.rnd_type)
