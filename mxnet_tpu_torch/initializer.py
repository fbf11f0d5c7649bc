"""Weight initializers, counterpart of ``mxnet_tpu/initializer.py``.

Dispatch is by parameter name, as in the JAX package
(``initializer.py:22-45``): ``upsampling*`` takes the bilinear kernel,
``*bias``, ``*beta``, ``*moving_mean``/``*moving_avg`` and the RNN
states (``*state``, ``*state_cell``, ``*init_h``, ``*init_c``) start at
0, ``*gamma`` and ``*moving_var`` at 1, ``*weight`` and the fused-RNN
blob ``*parameters`` draw from the initializer's distribution, and any
other name goes to ``_init_default``, which raises (``Zero`` zeroes it).
Each case is a hook (``_init_zero``, ``_init_one``, ``_init_bias``,
``_init_gamma``, ``_init_beta``, ``_init_bilinear``, ``_init_weight``,
``_init_default``) a subclass may override.

An initializer made without ``seed=`` draws from
:mod:`mxnet_tpu_torch.random`'s stream on the array's device, as the JAX
package's draw from its global key. With ``seed=`` it draws from its own
``torch.Generator`` on the CPU, seeded at construction, and copies the
values to the array's device: the same seed gives the same weights on
the CPU and on the card. (The JAX package draws from threefry keys; the
numbers differ from it, which is why parity tests carry weights across
with ``interop`` or compare distributions.) ``Orthogonal`` draws its
matrix from numpy's global generator, as the JAX package's does.
"""
from __future__ import annotations

import re
from typing import List, Optional

import numpy as np
import torch

from . import random as _random
from .base import MXNetError, Registry
from .ndarray import NDArray

__all__ = ["Initializer", "Uniform", "Normal", "Xavier", "MSRAPrelu",
           "Orthogonal", "Zero", "One", "Constant", "Load", "Mixed"]

_REG: Registry = Registry.get_registry("initializer")


class Initializer:
    """Base: dispatch by parameter name, to the hooks below."""

    def __init__(self, seed: Optional[int] = None):
        self._gen = None
        if seed is not None:
            self._gen = torch.Generator(device="cpu")
            self._gen.manual_seed(int(seed))

    def __call__(self, name: str, arr: NDArray):
        if name.startswith("upsampling"):
            self._init_bilinear(name, arr)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("parameters"):
            # the fused RNN's flat parameter blob
            self._init_weight(name, arr)
        elif name.endswith("moving_mean") or name.endswith("moving_avg"):
            self._init_zero(name, arr)
        elif name.endswith("state") or name.endswith("state_cell") \
                or name.endswith("init_h") or name.endswith("init_c"):
            # RNN initial states
            self._init_zero(name, arr)
        elif name.endswith("moving_var"):
            self._init_one(name, arr)
        else:
            self._init_default(name, arr)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_bilinear(self, _, arr):
        """The bilinear upsampling kernel over the last two axes."""
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(int(np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        arr[:] = weight.astype(np.float32).reshape(shape)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        raise MXNetError("unknown parameter name pattern '%s'; use a Mixed "
                         "initializer" % name)

    def _uniform(self, arr: NDArray, low: float, high: float):
        if self._gen is None:
            _random.uniform(low, high, out=arr)
            return
        t = torch.empty(arr.shape, dtype=torch.float32)
        t.uniform_(low, high, generator=self._gen)
        arr[:] = t

    def _normal(self, arr: NDArray, sigma: float):
        if self._gen is None:
            _random.normal(0.0, sigma, out=arr)
            return
        t = torch.empty(arr.shape, dtype=torch.float32)
        t.normal_(0.0, sigma, generator=self._gen)
        arr[:] = t


@_REG.register("uniform")
class Uniform(Initializer):
    def __init__(self, scale: float = 0.07, seed: Optional[int] = None):
        super().__init__(seed)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._uniform(arr, -self.scale, self.scale)


@_REG.register("normal")
class Normal(Initializer):
    def __init__(self, sigma: float = 0.01, seed: Optional[int] = None):
        super().__init__(seed)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        self._normal(arr, self.sigma)


@_REG.register("xavier")
class Xavier(Initializer):
    def __init__(self, rnd_type: str = "uniform", factor_type: str = "avg",
                 magnitude: float = 3.0, seed: Optional[int] = None):
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


@_REG.register("msraprelu")
class MSRAPrelu(Xavier):
    """Xavier, gaussian, with the magnitude ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type: str = "avg", slope: float = 0.25,
                 seed: Optional[int] = None):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude, seed=seed)


@_REG.register("orthogonal")
class Orthogonal(Initializer):
    """``scale`` times an orthonormal factor of a (out, in) matrix drawn
    from numpy's global generator."""

    def __init__(self, scale: float = 1.414, rand_type: str = "uniform"):
        super().__init__()
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = np.random.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = np.random.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == (nout, nin) else v
        arr[:] = (self.scale * q).reshape(arr.shape).astype(np.float32)


@_REG.register("zero")
class Zero(Initializer):
    """Zeros for weights and for every name the base does not know."""

    def __init__(self):
        super().__init__()

    def _init_weight(self, _, arr):
        arr[:] = 0.0

    def _init_default(self, _, arr):
        arr[:] = 0.0


@_REG.register("one")
class One(Initializer):
    def __init__(self):
        super().__init__()

    def _init_weight(self, _, arr):
        arr[:] = 1.0


class Constant(Initializer):
    def __init__(self, value: float):
        super().__init__()
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


class Load:
    """Values from a dict of NDArrays (or an NDArray file, its ``arg:``
    and ``aux:`` prefixes dropped) by name; names it lacks go to
    ``default_init``."""

    def __init__(self, param, default_init: Optional[Initializer] = None,
                 verbose: bool = False):
        from . import ndarray as nd

        if isinstance(param, str):
            param = nd.load(param)
        self.param = {}
        for name, arr in param.items():
            self.param[name.replace("arg:", "").replace("aux:", "")] = arr
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name: str, arr: NDArray):
        if name in self.param:
            if self.param[name].shape != arr.shape:
                raise MXNetError("Load: shape mismatch for '%s'" % name)
            arr[:] = self.param[name]
        else:
            if self.default_init is None:
                raise MXNetError("Load: no init for '%s'" % name)
            self.default_init(name, arr)


class Mixed:
    """The initializer of the first pattern (a regex) that matches the
    name."""

    def __init__(self, patterns: List[str], initializers: List[Initializer]):
        if len(patterns) != len(initializers):
            raise MXNetError("Mixed: patterns and initializers must pair up")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name: str, arr: NDArray):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise MXNetError("Mixed: no pattern matched '%s'; add '.*'" % name)

