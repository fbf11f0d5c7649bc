"""The ImageNet models' K3 geometries and AlexNet's fused step on the
card. Marked ``cuda``: without a card (or nvcc) every test here skips
with the reason. Like ``test_torch_cuda.py`` this file imports neither
jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py tests/test_torch_cuda_models.py
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    try:
        from mxnet_tpu_torch import _build

        _build.find_nvcc()
    except tmx.MXNetError as e:
        pytest.skip(str(e))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# (M, N, K, transpose_a) at batch 32: AlexNet's stem (11x11/4 over 3
# channels, 55x55 out) weight gradient; Inception-v3's 1x7 and 7x1 at
# 17x17 (128 channels) weight and input gradients; its unpadded 3x3/2
# from 35x35 to 17x17 (288 -> 384 channels) and its stem (3x3/2, 299 ->
# 149) weight gradients and that input gradient
MODEL_GEMMS = [(363, 96, 96800, True),
               (896, 128, 9248, True), (9248, 128, 896, False),
               (2592, 384, 9248, True), (39200, 288, 3456, False),
               (27, 32, 710432, True)]


@pytest.mark.parametrize("m,n,k,trans", MODEL_GEMMS)
def test_conv_gemm_at_the_models_products(card, m, n, k, trans):
    """Each element within 1e-6 * sum|a||b| of the float64 product; a
    rerun bit-identical."""
    gen = torch.Generator(device=card).manual_seed(3)
    a = torch.randn(*((k, m) if trans else (m, k)), generator=gen,
                    device=card)
    b = torch.randn(k, n, generator=gen, device=card)
    got = kernels.matmul_f32acc(a, b, trans)
    again = kernels.matmul_f32acc(a, b, trans)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ad = a.double().t() if trans else a.double()
    err = (got.double() - ad @ b.double()).abs()
    assert bool((err <= 1e-6 * (ad.abs() @ b.double().abs())).all())


# NCHW x shape, OIHW w shape, stride, pad: AlexNet's stem (the stride
# leaves a remainder of 1 at 224), Inception-v3's 1x7 and 7x1 with their
# per-axis pads, its unpadded 3x3/2 at the odd sizes 35 and 147
MODEL_CONVS = [((2, 3, 224, 224), (8, 3, 11, 11), (4, 4), (0, 0)),
               ((2, 16, 17, 17), (16, 16, 1, 7), (1, 1), (0, 3)),
               ((2, 16, 17, 17), (16, 16, 7, 1), (1, 1), (3, 0)),
               ((2, 16, 35, 35), (24, 16, 3, 3), (2, 2), (0, 0)),
               ((2, 8, 147, 147), (8, 8, 3, 3), (2, 2), (0, 0))]


@pytest.mark.parametrize("xshape,wshape,stride,pad", MODEL_CONVS)
def test_conv2d_backward_at_the_models_geometries(card, xshape, wshape,
                                                  stride, pad):
    """The NCHW conv2d VJP on the card (K3) against the port on the CPU
    (the plain GEMM): dx comes back H x W and dx, dw agree within
    1e-4."""
    rng = np.random.RandomState(5)
    x = rng.randn(*xshape).astype(np.float32)
    w = (rng.randn(*wshape) * 0.2).astype(np.float32)
    grads = []
    for dev in (card, torch.device("cpu")):
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        wt = torch.from_numpy(w).to(dev).requires_grad_()
        y = kernels.conv2d(xt, wt, stride, pad)
        g = torch.from_numpy(np.random.RandomState(6).randn(*y.shape)
                             .astype(np.float32)).to(dev)
        before = kernels.conv_gemm_launches
        (y * g).sum().backward()
        if dev.type == "cuda":
            assert kernels.conv_gemm_launches == before + 2
        assert xt.grad.shape == xt.shape
        grads.append((xt.grad.cpu().numpy(), wt.grad.cpu().numpy()))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def _alexnet_fit(x, y, fused_step):
    net = tmx.models.get_alexnet(num_classes=10)
    mod = tmx.mod.Module(net, context=tmx.gpu(0))
    metric = tmx.metric.create("acc")
    kernels.reset_launch_counts()
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
            initializer=tmx.init.Xavier(factor_type="in", magnitude=2.0,
                                        seed=7),
            optimizer_params=(("learning_rate", 0.01), ("momentum", 0.9)),
            eval_metric=metric, fused_step=fused_step)
    args, aux = mod.get_params()
    return (mod, kernels.launch_counts(), metric.get()[1],
            {k: v.asnumpy().copy() for k, v in args.items()})


def test_fused_alexnet_captures_once_and_equals_the_classic_loop(card):
    """AlexNet (LRN and two Dropouts) at 67x67 through fit(fused_step=
    True): one capture, K3 9 launches a step (the eager step and the
    capture), params and metric bit-equal to the classic loop's, whose
    Dropout draws from the same generator."""
    rng = np.random.RandomState(0)
    x = rng.randn(16, 3, 67, 67).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.float32)
    fused, f_launch, f_acc, f_args = _alexnet_fit(x, y, True)
    step = fused._fused_step
    assert (step.eager_steps, step.captures, step.dispatches) == (1, 1, 3)
    assert f_launch["conv_gemm"] == 18
    assert f_launch["norm_act_fwd"] == f_launch["norm_act_bwd"] == 0
    _, c_launch, c_acc, c_args = _alexnet_fit(x, y, False)
    assert c_launch["conv_gemm"] == 36
    assert c_acc == f_acc
    for k in c_args:
        np.testing.assert_array_equal(f_args[k], c_args[k], err_msg=k)
