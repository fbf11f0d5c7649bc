"""The numerics of the port's tensor-core kernels (csrc/tf32x3.cuh), on the
CPU: the plain torch model of their arithmetic in tests/torch_tf32x3_model.py
held to the float32 contracts that K3/K1 (within 1e-6 * sum|a||b| of a
float64 product) and K2 (rtol 2e-4 / atol 2e-5 of its plain version) must
keep on the card, with a single TF32 pass shown to miss both. The CUDA
kernels themselves are held to the same contracts on the card by
chip_smoke.py and tests/test_torch_cuda.py."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk
from torch_tf32x3_model import (attention_model, gemm_model,
                                linear_k_chunk, linear_model, split, tf32,
                                within_k2_contract, within_k3_contract)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, -(one + 2 ** -11),
                      one + 2 ** -11 - 2 ** -23, one + 3 * 2 ** -11, 0.0,
                      -0.0, 3.0], dtype=torch.float32)
    want = torch.tensor([one + 2 ** -10, -(one + 2 ** -10), one,
                         one + 2 ** -9, 0.0, -0.0, 3.0], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    hi, lo = split(torch.tensor([math.pi], dtype=torch.float32))
    assert float(hi + lo) == pytest.approx(math.pi, rel=2 ** -20)
    assert int(hi.view(torch.int32)) & 0x1FFF == 0
    assert int(lo.view(torch.int32)) & 0x1FFF == 0


# RAGGED_GEMMS of chip_smoke.py, and the stem's weight gradient (M = 7*7*3,
# N = 64) with K cut to 65536 from 32*112*112
@pytest.mark.parametrize("m,n,k", [(257, 33, 1001), (129, 65, 7), (1, 1, 1),
                                   (1000, 130, 4099), (147, 64, 65536)])
def test_three_tf32_products_keep_the_k3_contract(m, n, k):
    """3xTF32 is within 1e-6 * sum|a||b| of float64; one TF32 pass is not
    (so the comparison bites)."""
    rng = np.random.RandomState(m + n + k)
    a = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    b = torch.from_numpy(rng.randn(k, n).astype(np.float32))
    assert within_k3_contract(gemm_model(a, b), a, b)
    assert not within_k3_contract(gemm_model(a, b, passes=1), a, b)


@pytest.mark.parametrize("d", [128, 32])
@pytest.mark.parametrize("causal", [False, True])
def test_three_tf32_attention_keeps_the_k2_contract(d, causal):
    """3xTF32 scores and P V are within rtol 2e-4 / atol 2e-5 of
    flash_attention_plain; one TF32 pass is not (so the comparison
    bites)."""
    rng = np.random.RandomState(d)
    q, k, v = (torch.from_numpy(rng.randn(1, 256, 2, d).astype(np.float32))
               for _ in range(3))
    bkv = 32 if d >= 128 else 64
    assert within_k2_contract(attention_model(q, k, v, causal, bkv),
                              q, k, v, causal)
    assert not within_k2_contract(
        attention_model(q, k, v, causal, bkv, passes=1), q, k, v, causal)


@pytest.mark.parametrize("d", [128, 32])
@pytest.mark.parametrize("causal", [False, True])
def test_three_tf32_attention_matches_pallas_interpret(d, causal):
    """The same model against the JAX package's flash_attention, its Pallas
    kernel run in interpret mode on the CPU."""
    rng = np.random.RandomState(d + 1)
    q, k, v = (rng.randn(1, 256, 2, d).astype(np.float32) for _ in range(3))
    want = pk.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              causal=causal)
    assert want is not None
    got = attention_model(*(torch.from_numpy(x) for x in (q, k, v)), causal,
                          32 if d >= 128 else 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


# (M, K, N) of chip_smoke.py's fused linear (LINEAR_CASES, the MNIST MLP's
# layers at batch 128, layers of 32-128 wide tiles) and K1's K range a
# split on a 132-SM card
@pytest.mark.parametrize("m,k,n,chunk", [
    (128, 256, 128, 64), (32, 2048, 1000, 256), (8192, 4096, 4096, 4096),
    (257, 1001, 33, 128), (128, 784, 128, 128), (128, 128, 64, 64),
    (128, 64, 10, 64), (3, 5, 2, 32), (1, 1, 1, 32),
    (512, 1024, 1024, 1024), (1024, 1024, 1024, 1024),
    (768, 2048, 2048, 2048), (4096, 1024, 512, 1024),
    (256, 1024, 256, 256)])
def test_linear_split_rule(m, k, n, chunk):
    assert linear_k_chunk(m, n, k) == chunk


@pytest.mark.parametrize("m,k,n,act", [(128, 256, 128, "tanh"),
                                       (32, 2048, 1000, "none"),
                                       (128, 784, 128, "sigmoid"),
                                       (257, 1001, 33, "none")])
def test_three_tf32_linear_keeps_the_k1_contract(m, k, n, act):
    """K1's arithmetic, split as linear_k_chunk splits it, within 1e-6 of
    sum|x||w| + |b| of a float64 act(x @ w.T + b) (plus one libm ulp,
    2e-7, for tanh and sigmoid)."""
    rng = np.random.RandomState(m + k + n)
    x, w = (torch.from_numpy(rng.randn(*s).astype(np.float32))
            for s in ((m, k), (n, k)))
    b = torch.from_numpy(rng.randn(n).astype(np.float32))
    pre = x.double() @ w.double().t() + b.double()
    want = {"none": pre, "tanh": torch.tanh(pre),
            "sigmoid": torch.sigmoid(pre)}[act]
    bound = 1e-6 * (x.double().abs() @ w.double().abs().t()
                    + b.double().abs()) + (0.0 if act == "none" else 2e-7)
    got = linear_model(x, w, b, act)
    assert bool(((got.double() - want).abs() <= bound).all())


@pytest.mark.parametrize("act", ["none", "relu", "tanh", "sigmoid"])
def test_three_tf32_linear_matches_pallas_interpret(act):
    """The K1 model against the JAX package's fused_linear, its Pallas
    kernel run in interpret mode on the CPU, at the JAX test's shape."""
    rng = np.random.RandomState(5)
    x, w, b = (rng.randn(*s).astype(np.float32)
               for s in ((128, 256), (128, 256), (128,)))
    want = pk.fused_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           act=act)
    assert want is not None
    got = linear_model(*(torch.from_numpy(a) for a in (x, w, b)), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
