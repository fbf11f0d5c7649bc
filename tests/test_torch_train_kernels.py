"""The training slice's kernels on the CPU against the JAX package.

* K5 (the norm+act backward): the port's differentiable
  ``fused_norm_act`` against ``jax.grad`` of ``pk.fused_norm_act``, whose
  Pallas kernels run in interpret mode, with test_pallas_conv.py:119-155's
  inputs and tolerances.
* K3 (the conv-backward GEMM): ``matmul_f32acc_plain`` against
  ``pk._matmul`` in interpret mode; ``conv_dgrad``/``conv_wgrad`` against
  ``pk.conv_dgrad``/``pk.conv_wgrad`` at test_pallas_conv.py:36-39's
  aligned geometries; and the port's ``conv2d`` gradients against
  ``jax.vjp`` of ``lax.conv_general_dilated`` at geometries the JAX
  package's gate refuses (odd stride remainders, pad > k-1, groups,
  dilation).

On the CPU each wrapper takes its kernel's plain version (the tensors
lie on the CPU); the CUDA kernels are held against the same plain
versions on the card by chip_smoke.py and tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as pk
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import kernels as tk

from test_torch_common import bf16_round


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_norm_act_backward_matches_pallas_interpret(dt, act):
    """test_pallas_conv.py:119-155: gradients of sum(fused_norm_act * g)
    in x, scale and shift; rtol 3e-2, atol 1e-3 (float32) / 3e-1
    (bfloat16), that test's tolerances."""
    jdt = jnp.dtype(dt)
    tdt = torch.float32 if dt == "float32" else torch.bfloat16
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(256, 128), jdt)
    sc = jnp.asarray(rng.randn(128) * 0.5 + 1.0, jnp.float32)
    sh = jnp.asarray(rng.randn(128) * 0.1, jnp.float32)
    g = jnp.asarray(rng.randn(256, 128), jdt)

    def loss(x, sc, sh):
        out = pk.fused_norm_act(x, sc, sh, act=act)
        assert out is not None
        return (out * g).sum()

    want = jax.grad(loss, (0, 1, 2))(x, sc, sh)
    xt = _t(x, tdt).requires_grad_()
    st = _t(sc).requires_grad_()
    ht = _t(sh).requires_grad_()
    (tk.fused_norm_act(xt, st, ht, act) * _t(g, tdt)).sum().backward()
    assert xt.grad.dtype == tdt and st.grad.dtype == torch.float32
    atol = 3e-1 if dt == "bfloat16" else 1e-3
    for got, ref in zip((xt.grad, st.grad, ht.grad), want):
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                                   rtol=3e-2, atol=atol)


def test_norm_act_backward_plain_matches_float64():
    """Ragged (rows, C), no tiling condition: dx is g*scale masked by the
    recomputed pre-activation, the sums agree with a float64 sum."""
    rng = np.random.RandomState(4)
    x = rng.randn(1000, 100).astype(np.float32)
    g = rng.randn(1000, 100).astype(np.float32)
    sc = (rng.rand(100) + 0.5).astype(np.float32)
    sh = rng.randn(100).astype(np.float32)
    dx, dsc, dsh = tk.fused_norm_act_bwd(_t(x), _t(sc), _t(sh), _t(g), "relu")
    pre = x.astype(np.float64) * sc + sh
    gm = np.where(pre > 0, g.astype(np.float64), 0.0)
    np.testing.assert_allclose(_np(dx), gm * sc, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(dsc), (gm * x).sum(0), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(_np(dsh), gm.sum(0), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_matmul_plain_matches_pallas_interpret(transpose_a, dt):
    """``a @ b`` and ``a.T @ b`` with float32 accumulation; bfloat16
    products are exact in float32, so both types keep the float32
    forward tolerance of test_pallas_conv.py (rtol 1e-5, atol 1e-4)."""
    rng = np.random.RandomState(3)
    jdt = jnp.dtype(dt)
    tdt = torch.float32 if dt == "float32" else torch.bfloat16
    a = rng.randn(*((384, 256) if transpose_a else (256, 384)))
    b = rng.randn(384, 128)
    ref = pk._matmul(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                     (128, 128, 128), transpose_a=transpose_a)
    got = tk.matmul_f32acc(_t(a, tdt), _t(b, tdt), transpose_a)
    assert got.dtype == torch.float32 and tuple(got.shape) == (256, 128)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


def test_matmul_refuses_what_it_cannot_do():
    a = torch.ones(4, 3)
    with pytest.raises(tmx.MXNetError, match="inner dimensions"):
        tk.matmul_f32acc(a, torch.ones(4, 2))
    with pytest.raises(tmx.MXNetError, match="both be float32"):
        tk.matmul_f32acc(a, torch.ones(3, 2, dtype=torch.bfloat16))
    out = tk.matmul_f32acc(a, torch.ones(4, 2), transpose_a=True)
    assert torch.equal(out, torch.full((3, 2), 4.0))


# test_pallas_conv.py:36-39, NCHW there: here NHWC x, OIHW w
GEOMS = [
    ((2, 8, 8, 128), (128, 128, 3, 3), (1, 1), (1, 1)),
    ((2, 16, 16, 128), (128, 128, 2, 2), (2, 2), (0, 0)),
]


@pytest.mark.parametrize("xshape,wshape,stride,pad", GEOMS)
def test_conv_dgrad_wgrad_match_pallas_interpret(xshape, wshape, stride,
                                                 pad):
    """rtol 1e-4 / atol 1e-3, the float32 vjp tolerance of
    test_pallas_conv.py."""
    rng = np.random.RandomState(0)
    x = rng.randn(*xshape).astype(np.float32)
    w = (rng.randn(*wshape) * 0.1).astype(np.float32)
    n, h, wd, _ = xshape
    ho = (h + 2 * pad[0] - wshape[2]) // stride[0] + 1
    wo = (wd + 2 * pad[1] - wshape[3]) // stride[1] + 1
    g = rng.randn(n, ho, wo, wshape[0]).astype(np.float32)
    dx_ref = pk.conv_dgrad(jnp.asarray(w), jnp.asarray(g), xshape, stride,
                           pad)
    gw_ref = pk.conv_wgrad(jnp.asarray(x), jnp.asarray(g), wshape, stride,
                           pad)
    assert dx_ref is not None and gw_ref is not None
    dx = tk.conv_dgrad(_t(w), _t(g), xshape, stride, pad)
    gw = tk.conv_wgrad(_t(x), _t(g), wshape, stride, pad)
    np.testing.assert_allclose(_np(dx), np.asarray(dx_ref), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(_np(gw), np.asarray(gw_ref), rtol=1e-4,
                               atol=1e-3)


# (x NHWC, w OIHW, stride, pad, dilate, groups): each refused by
# conv_backward_applicable, taken by the port
REFUSED = {
    "stem_7x7_s2": ((2, 32, 32, 3), (8, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1),
    "3x3_s2": ((2, 16, 16, 8), (16, 8, 3, 3), (2, 2), (1, 1), (1, 1), 1),
    "1x1_s2": ((2, 16, 16, 8), (16, 8, 1, 1), (2, 2), (0, 0), (1, 1), 1),
    "pad_gt_k-1": ((2, 8, 8, 4), (6, 4, 3, 3), (1, 1), (3, 3), (1, 1), 1),
    "groups2": ((2, 8, 8, 8), (8, 4, 3, 3), (1, 1), (1, 1), (1, 1), 2),
    "dilate2": ((2, 10, 10, 4), (6, 4, 3, 3), (1, 1), (1, 1), (2, 2), 1),
    "mixed": ((2, 11, 9, 4), (6, 2, 3, 2), (2, 3), (2, 3), (2, 1), 2),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_conv2d_gradients_match_jax_vjp(name, layout):
    """dx and dw of the port's conv2d (backward on K3's plain version)
    against jax.vjp of lax.conv_general_dilated, float32, rtol 1e-4 /
    atol 1e-3."""
    xshape, wshape, stride, pad, dilate, groups = REFUSED[name]
    assert not pk.conv_backward_applicable(xshape, wshape, stride, pad,
                                           dilate, groups)
    rng = np.random.RandomState(1)
    x = rng.randn(*xshape).astype(np.float32)
    w = (rng.randn(*wshape) * 0.2).astype(np.float32)
    if layout == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    dn = (layout, "OIHW", layout)

    def f(x, w):
        return jax.lax.conv_general_dilated(
            x, w, window_strides=stride, padding=[(p, p) for p in pad],
            rhs_dilation=dilate, dimension_numbers=dn,
            feature_group_count=groups,
            precision=jax.lax.Precision.HIGHEST)

    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    g = rng.randn(*out.shape).astype(np.float32)
    dx_ref, dw_ref = vjp(jnp.asarray(g))

    xt = _t(x).requires_grad_()
    wt = _t(w).requires_grad_()
    xin = xt.movedim(-1, 1) if layout == "NHWC" else xt
    yt = tk.conv2d(xin, wt, stride, pad, dilate, groups)
    if layout == "NHWC":
        yt = yt.movedim(1, -1)
    np.testing.assert_allclose(_np(yt), np.asarray(out), rtol=1e-4,
                               atol=1e-4)
    (yt * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(xt.grad), np.asarray(dx_ref), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(_np(wt.grad), np.asarray(dw_ref), rtol=1e-4,
                               atol=1e-3)


def test_conv2d_backward_skips_dgrad_without_input_grad(monkeypatch):
    """The stem's data input needs no gradient: one GEMM (wgrad), no
    dgrad. A 1x1 stride-1 window is a view of x, not a copy."""
    calls = []
    real = tk.matmul_f32acc
    monkeypatch.setattr(tk, "matmul_f32acc",
                        lambda a, b, transpose_a=False:
                        calls.append(transpose_a) or real(a, b, transpose_a))
    x = torch.randn(2, 3, 8, 8)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    tk.conv2d(x, w, (2, 2), (1, 1)).sum().backward()
    assert calls == [True] and w.grad is not None
    calls.clear()
    xg = x.requires_grad_()
    tk.conv2d(xg, w, (1, 1), (1, 1)).sum().backward()
    assert sorted(calls) == [False, True]
    xh = torch.randn(2, 5, 5, 7)
    pat = tk._patches(xh, 1, 1, (1, 1), (1, 1), (5, 5))
    assert pat.data_ptr() == xh.data_ptr() and tuple(pat.shape) == (50, 7)


def test_conv_gemm_bf16_operands_match_float32_of_rounded_inputs():
    """bfloat16 operands: the products are exact in float32, so the
    result equals the float32 product of the rounded inputs."""
    rng = np.random.RandomState(6)
    a = bf16_round(rng.randn(70, 33))
    b = bf16_round(rng.randn(70, 19))
    got = tk.matmul_f32acc(_t(a, torch.bfloat16), _t(b, torch.bfloat16),
                           transpose_a=True)
    np.testing.assert_allclose(_np(got), a.T.astype(np.float64) @ b,
                               rtol=1e-5, atol=1e-5)
