"""The port's fused linear layer (K1's wrapper, ops/kernels.py) against
the JAX package's fused_linear, its Pallas kernel run in interpret mode
on the CPU, with tests/test_pallas_rtc.py's shapes and tolerances. On
the CPU the port's wrapper takes its plain version; the CUDA kernel is
held against a float64 product on the card by chip_smoke.py and
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import kernels as tk

ACTS = ["none", "relu", "tanh", "sigmoid"]
_NP_ACTS = {"none": lambda y: y, "relu": lambda y: np.maximum(y, 0.0),
            "tanh": np.tanh, "sigmoid": lambda y: 1.0 / (1.0 + np.exp(-y))}


def _xwb(m, k, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            rng.randn(n, k).astype(np.float32),
            rng.randn(n).astype(np.float32))


@pytest.mark.parametrize("act", ACTS)
def test_fused_linear_matches_pallas_interpret(act):
    x, w, b = _xwb(128, 256, 128, 0)
    want = pk.fused_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           act=act)
    assert want is not None
    got = tk.fused_linear(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("act", ACTS)
def test_fused_linear_gradients_match_jax(act):
    """The backward's products and activation derivatives (taken from
    the output) against jax.grad through the Pallas kernel's VJP."""
    x, w, b = (a * 0.25 for a in _xwb(128, 128, 128, 1))
    want = jax.grad(lambda x, w, b: jnp.sum(pk.fused_linear(x, w, b, act=act)
                                            ** 2),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    (tk.fused_linear(*leaves, act=act) ** 2).sum().backward()
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=1e-3, atol=1e-3)


def test_fused_linear_takes_misaligned_shapes():
    """(5, 7) -> 3: the JAX wrapper returns None; the port computes it,
    with and without bias, for every activation."""
    x, w, b = _xwb(5, 7, 3, 2)
    assert pk.fused_linear(jnp.asarray(x), jnp.asarray(w)) is None
    ref = x.astype(np.float64) @ w.T.astype(np.float64)
    for act in ACTS:
        got = tk.fused_linear(torch.from_numpy(x), torch.from_numpy(w),
                              None, act)
        np.testing.assert_allclose(got.numpy(), _NP_ACTS[act](ref),
                                   rtol=1e-5, atol=1e-6)
        got = tk.fused_linear(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), act)
        np.testing.assert_allclose(got.numpy(), _NP_ACTS[act](ref + b),
                                   rtol=1e-5, atol=1e-6)


def test_fused_linear_without_bias_gives_no_bias_gradient():
    x, w, _ = _xwb(4, 6, 3, 3)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tk.fused_linear(xt, wt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.broadcast_to(w.sum(0), x.shape), rtol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(),
                               np.broadcast_to(x.sum(0), w.shape), rtol=1e-6)


def test_fused_linear_refuses_what_the_kernel_cannot_do():
    x = torch.ones(4, 6)
    w = torch.ones(3, 6)
    with pytest.raises(tmx.MXNetError, match="act must be one of"):
        tk.fused_linear(x, w, act="gelu")
    with pytest.raises(tmx.MXNetError, match="float32 inputs only"):
        tk.fused_linear(x.double(), w.double())
    with pytest.raises(tmx.MXNetError, match="bias must be"):
        tk.fused_linear(x, w, torch.ones(4))
    with pytest.raises(tmx.MXNetError, match=r"x \(M, K\) and weight"):
        tk.fused_linear(x, torch.ones(3, 5))
    with pytest.raises(tmx.MXNetError, match="K = 0"):
        tk.fused_linear(torch.ones(4, 0), torch.ones(3, 0))
