"""The port's flash attention (K2's wrapper, ops/kernels.py) and
reference attention against the JAX package: the Pallas kernel run in
interpret mode on the CPU, as tests/test_pallas_rtc.py runs it, with
that file's inputs and tolerances. On the CPU the port's wrapper takes
its plain version (the tensors lie on the CPU); the CUDA kernel itself
is held against the same plain version on the card by chip_smoke.py and
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.parallel.ring_attention import \
    reference_attention as jreference
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.ops import kernels as tk


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_pallas_interpret(causal):
    q, k, v = _qkv((2, 256, 2, 64), 0)
    want = pk.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
    assert want is not None
    got = tk.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal)
    assert tuple(got.shape) == (2, 256, 2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_flash_attention_gradients_match_pallas_vjp():
    q, k, v = _qkv((1, 128, 2, 32), 1)
    want = jax.grad(lambda q, k, v: (pk.flash_attention(q, k, v, causal=True)
                                     ** 2).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tk.flash_attention(*leaves, causal=True) ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_takes_any_sequence_length(causal):
    """T=100: the JAX wrapper returns None (not a multiple of 128); the
    port runs it and matches the JAX reference attention."""
    q, k, v = _qkv((1, 100, 2, 32), 2)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    assert pk.flash_attention(jq, jk, jv, causal=causal) is None
    got = tk.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jreference(jq, jk, jv,
                                                     causal=causal)),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("mask_value", [-np.inf, -1e30])
@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(mask_value, causal):
    q, k, v = _qkv((2, 48, 3, 16), 3)
    want = jreference(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                      scale=0.3, mask_value=mask_value)
    got = parallel.reference_attention(*(torch.from_numpy(a)
                                         for a in (q, k, v)),
                                       causal=causal, scale=0.3,
                                       mask_value=mask_value)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_flash_attention_refuses_what_the_kernel_cannot_do():
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(tmx.MXNetError, match="float32 inputs only"):
        tk.flash_attention(x.double(), x.double(), x.double())
    wide = torch.zeros(1, 8, 1, 257)
    with pytest.raises(tmx.MXNetError, match="1..256"):
        tk.flash_attention(wide, wide, wide)
    with pytest.raises(tmx.MXNetError, match="of one shape"):
        tk.flash_attention(x, x[:, :4], x)
