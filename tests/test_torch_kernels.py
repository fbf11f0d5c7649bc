"""The port's fused norm+act (K4) against the JAX package's Pallas
kernel, run in interpret mode on the CPU as the JAX package's own tests
run it, and the port's channels-last BatchNorm with that kernel engaged
on both sides. On the CPU the port's wrapper takes its plain version
(the tensor lies on the CPU); the CUDA kernel itself is held against
the same plain version on the card by chip_smoke.py and
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import autotune
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import OpContext as JOpContext
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import kernels as tk
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops.registry import OpContext as TOpContext

from test_torch_common import bf16_ulp


def _to_torch(a_jax, dtype):
    return torch.from_numpy(np.array(a_jax, np.float32)).to(dtype)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_fused_norm_act_matches_pallas_interpret(dt, act):
    """test_pallas_conv.py:121-139's inputs and tolerances."""
    jdt = jnp.dtype(dt)
    tdt = torch.float32 if dt == "float32" else torch.bfloat16
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(256, 128), jdt)
    sc = jnp.asarray(rng.randn(128) * 0.5 + 1.0, jnp.float32)
    sh = jnp.asarray(rng.randn(128) * 0.1, jnp.float32)
    ref = pk.fused_norm_act(x, sc, sh, act=act)
    assert ref is not None
    out = tk.fused_norm_act(_to_torch(x, tdt), _to_torch(sc, torch.float32),
                            _to_torch(sh, torch.float32), act)
    assert out.dtype == tdt and tuple(out.shape) == (256, 128)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("shape", [(1000, 100), (7, 3), (4, 5, 6, 64)])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_fused_norm_act_ragged_shapes(shape, act):
    """No 128-row / 128-channel tiling condition: any (R, C) works and
    equals act(x*scale+shift) computed in float64."""
    rng = np.random.RandomState(5)
    x = rng.randn(*shape).astype(np.float32)
    c = shape[-1]
    sc = (rng.rand(c) + 0.5).astype(np.float32)
    sh = rng.randn(c).astype(np.float32)
    out = tk.fused_norm_act(torch.from_numpy(x), torch.from_numpy(sc),
                            torch.from_numpy(sh), act).numpy()
    ref = x.astype(np.float64) * sc + sh
    if act == "relu":
        ref = np.maximum(ref, 0.0)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_fused_norm_act_refuses_what_it_cannot_do():
    x = torch.ones(4, 8)
    s = torch.ones(8)
    with pytest.raises(tmx.MXNetError, match="act must be one of"):
        tk.fused_norm_act(x, s, s, "tanh")
    with pytest.raises(tmx.MXNetError, match="scale/shift must be"):
        tk.fused_norm_act(x, s[:4], s, "none")
    # a leaf with requires_grad now trains: the backward (K5's plain
    # version on the CPU) gives g*scale and the per-channel sums
    xg = torch.randn(4, 8).requires_grad_()
    sg = torch.rand(8).requires_grad_()
    hg = torch.randn(8).requires_grad_()
    tk.fused_norm_act(xg, sg, hg, "none").sum().backward()
    assert torch.equal(xg.grad, sg.detach().expand(4, 8))
    assert torch.allclose(sg.grad, xg.detach().sum(0))
    assert torch.equal(hg.grad, torch.full((8,), 4.0))
    # under no_grad a leaf with requires_grad is just data
    with torch.no_grad():
        assert not tk.fused_norm_act(xg, s, s, "none").requires_grad


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    tk.reset_launch_counts()
    x = torch.randn(16, 8)
    s = torch.rand(8)
    out = tk.fused_norm_act(x, s, s, "relu")
    assert torch.equal(out, tk.fused_norm_act_plain(x, s, s, "relu"))
    tk.fused_norm_act_bwd(x, s, s, torch.ones_like(x), "relu")
    tk.matmul_f32acc(x, x, transpose_a=True)
    tk.fused_linear(x, x, act="tanh")
    q = x.reshape(1, 16, 1, 8)
    tk.flash_attention(q, q, q, causal=True)
    assert tk.launch_counts() == {"norm_act_fwd": 0, "norm_act_bwd": 0,
                                  "conv_gemm": 0, "linear": 0,
                                  "flash_attn": 0, "rtc": 0}


def _bn_pair(dtype_j, dtype_t, shape, monkeypatch):
    """JAX and port BatchNorm (inference, channels-last) on the same
    inputs, with the JAX kernel engaged via the autotune hook and both
    kernel entry points spied."""
    calls = {"jax": 0, "torch": 0}
    monkeypatch.setattr(autotune, "norm_block_rows", lambda *a, **k: 128)
    real_pk, real_tk = pk.fused_norm_act, tnn.fused_norm_act

    def spy_pk(*a, **k):
        out = real_pk(*a, **k)
        calls["jax"] += out is not None
        return out

    def spy_tk(*a, **k):
        calls["torch"] += 1
        return real_tk(*a, **k)

    monkeypatch.setattr(pk, "fused_norm_act", spy_pk)
    monkeypatch.setattr(tnn, "fused_norm_act", spy_tk)
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    mm = rng.randn(c).astype(np.float32)
    mv = rng.uniform(0.5, 2.0, c).astype(np.float32)
    params = dict(axis=-1, fix_gamma=False, eps=2e-5)
    jop = jnn.BatchNorm(**params)
    (yj,), _ = jop.apply(JOpContext(False), [jnp.asarray(x, dtype_j),
                                             jnp.asarray(gamma),
                                             jnp.asarray(beta)],
                         [jnp.asarray(mm), jnp.asarray(mv)])
    top = tnn.BatchNorm(**params)
    (yt,), _ = top.apply(TOpContext(False),
                         [torch.from_numpy(x).to(dtype_t),
                          torch.from_numpy(gamma), torch.from_numpy(beta)],
                         [torch.from_numpy(mm), torch.from_numpy(mv)])
    assert calls == {"jax": 1, "torch": 1}
    return np.asarray(yj, np.float32), yt.float().numpy()


def test_batchnorm_channels_last_with_kernel_engaged(monkeypatch):
    yj, yt = _bn_pair(jnp.float32, torch.float32, (2, 8, 8, 128),
                      monkeypatch)
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-6)


def test_batchnorm_bf16_reproduces_double_rounding(monkeypatch):
    """scale/shift round to bf16 first and widen back to f32 in the
    kernel, on both sides: outputs agree within one bf16 ulp."""
    yj, yt = _bn_pair(jnp.bfloat16, torch.bfloat16, (2, 8, 8, 128),
                      monkeypatch)
    assert np.all(np.abs(yt - yj) <= bf16_ulp(yj))


def test_batchnorm_symbol_goes_through_kernel_wrapper(monkeypatch):
    """A channels-last BatchNorm node of a bound port graph calls
    fused_norm_act once per forward; NCHW never does."""
    calls = []
    real = tnn.fused_norm_act
    monkeypatch.setattr(tnn, "fused_norm_act",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    for axis, shape, want in ((-1, (2, 3, 3, 4), 1), (1, (2, 4, 3, 3), 0)):
        calls.clear()
        s = tmx.sym.BatchNorm(tmx.sym.Variable("data"), axis=axis,
                              name="bn")
        ex = s.simple_bind(tmx.cpu(), data=shape)
        ex.aux_dict["bn_moving_var"][:] = 1.0
        ex.forward(data=np.ones(shape, np.float32))
        assert len(calls) == want
