"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Marked ``cuda``: without a card (or nvcc) every test here
skips with the reason. This file imports neither jax nor the JAX
package, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
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


@pytest.mark.parametrize("shape,offset", [((401408, 64), 0),
                                          ((1568, 2048), 0),
                                          ((1000, 100), 0), ((7, 3), 0),
                                          ((64, 5000), 0), ((4096, 64), 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_norm_act_fwd_matches_plain(card, shape, offset, dtype, act):
    """float32: bit-equal (the kernel rounds the product and the sum
    apart, as the plain version does); bfloat16: within one ulp."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=card).manual_seed(0)
    rows, c = shape
    base = (torch.randn(rows * c + offset, generator=gen, device=card) * 2
            + 0.5).to(dt)
    x = base[offset:].view(rows, c)
    scale = torch.rand(c, generator=gen, device=card) + 0.5
    shift = torch.randn(c, generator=gen, device=card)
    before = kernels.norm_act_fwd_launches
    got = kernels.fused_norm_act(x, scale, shift, act)
    torch.cuda.synchronize()
    assert kernels.norm_act_fwd_launches == before + 1
    want = kernels.fused_norm_act_plain(x, scale, shift, act)
    diff = (got.double() - want.double()).abs()
    if dtype == "float32":
        assert float(diff.max()) == 0.0
    else:
        mag = torch.clamp(want.double().abs(), min=2.0 ** -126)
        assert bool((diff <= torch.exp2(torch.floor(torch.log2(mag)) - 7))
                    .all())


def test_norm_act_fwd_refuses_non_contiguous(card):
    x = torch.randn(8, 16, device=card).t()
    s = torch.ones(8, device=card)
    with pytest.raises(tmx.MXNetError, match="contiguous"):
        kernels.fused_norm_act(x, s, s, "none")


def test_small_resnet_on_card_matches_cpu(card):
    """The whole small NHWC ResNet through the port on the card and on
    the CPU, same seeded weights: probabilities within 1e-5."""
    net = tmx.models.get_resnet([1, 1, 1, 1], [16, 32, 64, 128, 256],
                                num_classes=10, small_input=True,
                                layout="NHWC")
    x = np.random.RandomState(0).randn(4, 32, 32, 3).astype(np.float32)
    probs = []
    for ctx in (tmx.gpu(0), tmx.cpu()):
        mod = tmx.mod.Module(net, context=ctx)
        mod.bind([("data", x.shape)], for_training=False)
        mod.init_params(tmx.init.Xavier(seed=3))
        probs.append(mod.predict(x).asnumpy())
    np.testing.assert_allclose(probs[0], probs[1], atol=1e-5, rtol=0)


def test_served_argmax_ties_take_the_first_maximum_on_card(card):
    """jnp.argmax returns the first maximum; so must the card's top_k=1
    post-processing (FC with zero weights, bias [0, 2, 2, 1])."""
    ctx = tmx.gpu(0)
    s = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=4,
                               name="fc")
    mod = tmx.mod.Module(s, label_names=(), context=ctx)
    mod.bind([("data", (8, 3))], for_training=False)
    mod.set_params({"fc_weight": tmx.nd.zeros((4, 3), ctx=ctx),
                    "fc_bias": tmx.nd.array([0, 2, 2, 1], ctx=ctx)}, {})
    with tmx.serving.InferenceServer(mod, top_k=1, max_batch=8) as srv:
        (idx,) = srv.infer([np.ones((5, 3), np.float32)])
    assert list(idx) == [1] * 5


def _ulp_bf16(t):
    mag = torch.clamp(t.double().abs(), min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("shape,offset", [((401408, 64), 0),
                                          ((1568, 2048), 0),
                                          ((1000, 100), 0), ((7, 3), 0),
                                          ((64, 5000), 0), ((4096, 64), 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_norm_act_bwd_matches_plain(card, shape, offset, dtype, act):
    """dx: float32 bit-equal to the plain version, bfloat16 within one
    ulp; dscale/dshift within 1e-5 of sum|term| of a float64 sum; a
    rerun bit-identical (two stages, no atomics)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=card).manual_seed(1)
    rows, c = shape
    x = (torch.randn(rows * c + offset, generator=gen, device=card) * 2
         + 0.5).to(dt)[offset:].view(rows, c)
    g = torch.randn(rows, c, generator=gen, device=card).to(dt)
    scale = torch.rand(c, generator=gen, device=card) + 0.5
    shift = torch.randn(c, generator=gen, device=card)
    before = kernels.norm_act_bwd_launches
    dx, dsc, dsh = kernels.fused_norm_act_bwd(x, scale, shift, g, act)
    again = kernels.fused_norm_act_bwd(x, scale, shift, g, act)
    torch.cuda.synchronize()
    assert kernels.norm_act_bwd_launches == before + 2
    for a, b in zip((dx, dsc, dsh), again):
        assert torch.equal(a, b)
    pdx, _, _ = kernels.fused_norm_act_bwd_plain(x, scale, shift, g, act)
    diff = (dx.double() - pdx.double()).abs()
    if dtype == "float32":
        assert float(diff.max()) == 0.0
    else:
        assert bool((diff <= _ulp_bf16(pdx)).all())
    xd, gd = x.double(), g.double()
    if act == "relu":
        pre = x.float() * scale + shift
        gd = torch.where(pre > 0, gd, torch.zeros_like(gd))
    for got, term in ((dsc, gd * xd), (dsh, gd)):
        err = (got.double() - term.sum(0)).abs()
        assert bool((err <= 1e-5 * term.abs().sum(0)).all())


@pytest.mark.parametrize("m,n,k,trans", [(147, 64, 401408, True),
                                         (100352, 64, 576, False),
                                         (4608, 512, 1568, True),
                                         (1568, 2048, 512, False),
                                         (257, 33, 1001, True),
                                         (129, 65, 7, False), (1, 1, 1, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_gemm_matches_float64(card, m, n, k, trans, dtype):
    """Each element within 1e-6 * sum|a||b| of the float64 product of the
    same operands; a rerun bit-identical (split K sums in order)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=card).manual_seed(2)
    a = torch.randn(*((k, m) if trans else (m, k)), generator=gen,
                    device=card).to(dt)
    b = torch.randn(k, n, generator=gen, device=card).to(dt)
    before = kernels.conv_gemm_launches
    got = kernels.matmul_f32acc(a, b, trans)
    again = kernels.matmul_f32acc(a, b, trans)
    torch.cuda.synchronize()
    assert kernels.conv_gemm_launches == before + 2
    assert torch.equal(got, again)
    ad = a.double().t() if trans else a.double()
    ref = ad @ b.double()
    bound = 1e-6 * (ad.abs() @ b.double().abs())
    assert bool(((got.double() - ref).abs() <= bound).all())


@pytest.mark.parametrize("geom", [((2, 32, 32, 3), (8, 3, 7, 7), (2, 2),
                                   (3, 3), (1, 1), 1),
                                  ((2, 16, 16, 8), (16, 8, 3, 3), (2, 2),
                                   (1, 1), (1, 1), 1),
                                  ((2, 11, 9, 4), (6, 2, 3, 2), (2, 3),
                                   (2, 3), (2, 1), 2)])
def test_conv2d_backward_on_card_matches_cpu(card, geom):
    """The conv2d VJP on the card (K3) against the port on the CPU (the
    plain GEMM), same inputs: dx and dw within 1e-4 of each other."""
    xshape, wshape, stride, pad, dilate, groups = geom
    rng = np.random.RandomState(3)
    x = rng.randn(*xshape).astype(np.float32)
    w = (rng.randn(*wshape) * 0.2).astype(np.float32)
    grads = []
    for dev in (card, torch.device("cpu")):
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        wt = torch.from_numpy(w).to(dev).requires_grad_()
        y = kernels.conv2d(xt.movedim(-1, 1), wt, stride, pad, dilate, groups)
        g = torch.from_numpy(np.random.RandomState(4).randn(*y.shape)
                             .astype(np.float32)).to(dev)
        before = kernels.conv_gemm_launches
        (y * g).sum().backward()
        if dev.type == "cuda":
            assert kernels.conv_gemm_launches == before + 2 * groups
        grads.append((xt.grad.cpu().numpy(), wt.grad.cpu().numpy()))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_small_resnet_training_step_on_card_matches_cpu(card):
    """One fit step of the small NHWC ResNet on the card and on the CPU
    from the same params and data: loss within rtol 1e-4, params after
    the step within rtol 1e-3 / atol 1e-5; every 2-D conv backward and
    every channels-last BatchNorm backward launched its kernel."""
    net = tmx.models.get_resnet([1, 1, 1, 1], [16, 32, 64, 128, 256],
                                num_classes=10, small_input=False,
                                layout="NHWC")
    rng = np.random.RandomState(5)
    x = rng.randn(4, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.float32)
    res = []
    for ctx in (tmx.gpu(0), tmx.cpu()):
        mod = tmx.mod.Module(net, context=ctx)
        mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
        mod.init_params(tmx.init.Xavier(magnitude=2.0, seed=7))
        mod.init_optimizer(optimizer_params=(("learning_rate", 0.01),
                                             ("momentum", 0.9)))
        kernels.reset_launch_counts()
        batch = tmx.io.DataBatch([x], [y])
        mod.forward_backward(batch)
        mod.update()
        counts = kernels.launch_counts()
        probs = mod.get_outputs()[0].asnumpy()
        loss = -np.log(probs[np.arange(4), y.astype(int)]).mean()
        args, _ = mod.get_params()
        res.append((loss, {k: v.asnumpy().copy() for k, v in args.items()},
                    counts))
    # 17 convolutions, each followed by a BatchNorm; the stem needs no dgrad
    assert res[0][2] == {"norm_act_fwd": 17, "norm_act_bwd": 17,
                         "conv_gemm": 33, "linear": 0, "flash_attn": 0,
                         "rtc": 0}
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-4)
    for k in res[1][1]:
        np.testing.assert_allclose(res[0][1][k], res[1][1][k], rtol=1e-3,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("shape", [(1, 4096, 8, 32), (2, 1024, 4, 64),
                                   (1, 512, 2, 128), (1, 256, 2, 256),
                                   (2, 100, 2, 48), (1, 1000, 4, 96),
                                   (3, 1, 2, 5), (1, 65, 3, 33)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_matches_plain(card, shape, causal):
    """K2 against its plain version (reference attention, mask -1e30)
    within rtol 2e-4 / atol 2e-5; a rerun bit-identical (no atomics)."""
    gen = torch.Generator(device=card).manual_seed(6)
    q, k, v = (torch.randn(*shape, generator=gen, device=card)
               for _ in range(3))
    before = kernels.flash_attn_launches
    got = kernels.flash_attention(q, k, v, causal=causal)
    again = kernels.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.flash_attn_launches == before + 2
    assert torch.equal(got, again)
    want = kernels.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (32, 2048, 1000),
                                   (257, 1001, 33), (3, 5, 2)])
@pytest.mark.parametrize("act", ["none", "relu", "tanh", "sigmoid"])
def test_linear_matches_float64(card, m, k, n, act):
    """K1 against act(x @ w.T + b) in float64: within 1e-6 of
    sum|x||w| + |b| (plus one libm ulp, 2e-7, for tanh and sigmoid); a
    rerun bit-identical (split K sums in order, the epilogue once)."""
    gen = torch.Generator(device=card).manual_seed(7)
    x = torch.randn(m, k, generator=gen, device=card)
    w = torch.randn(n, k, generator=gen, device=card)
    b = torch.randn(n, generator=gen, device=card)
    before = kernels.linear_launches
    got = kernels.fused_linear(x, w, b, act)
    again = kernels.fused_linear(x, w, b, act)
    torch.cuda.synchronize()
    assert kernels.linear_launches == before + 2
    assert torch.equal(got, again)
    pre = x.double() @ w.double().t() + b.double()
    want = {"none": pre, "relu": torch.relu(pre), "tanh": torch.tanh(pre),
            "sigmoid": torch.sigmoid(pre)}[act]
    bound = 1e-6 * (x.double().abs() @ w.double().abs().t() + b.double().abs())
    if act in ("tanh", "sigmoid"):
        bound = bound + 2e-7
    assert bool(((got.double() - want).abs() <= bound).all())


def _nd(t):
    return tmx.nd.NDArray(t, tmx.gpu(0))


def test_rtc_axpy_bit_equal(card):
    """tests/test_pallas_rtc.py:82-92 with a CUDA body."""
    from mxnet_tpu_torch.rtc import Rtc

    x = _nd(torch.arange(64, dtype=torch.float32, device=card).reshape(8, 8))
    y = _nd(torch.ones(8, 8, device=card))
    out = _nd(torch.zeros(8, 8, device=card))
    kern = Rtc("axpy", [("x", x), ("y", y)], [("out", out)],
               "int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
               "if (i < 64) out[i] = 2.0f * x[i] + y[i];")
    before = kernels.rtc_launches
    kern.push([x, y], [out], grid_dims=(1,), block_dims=(64,))
    torch.cuda.synchronize()
    assert kernels.rtc_launches == before + 1
    assert torch.equal(out.handle, 2 * x.handle + y.handle)


def test_rtc_multiline_kernel(card):
    """tests/test_pallas_rtc.py:95-107: the gelu-like body."""
    from mxnet_tpu_torch.rtc import Rtc

    v = torch.from_numpy(np.random.RandomState(8).randn(16, 16)
                         .astype(np.float32)).to(card)
    x, out = _nd(v), _nd(torch.zeros(16, 16, device=card))
    kern = Rtc("gelu_ish", [("x", x)], [("out", out)],
               "int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
               "if (i < 256) {\n"
               "  float v = x[i];\n"
               "  out[i] = v / (1.0f + expf(-1.702f * v));\n"
               "}")
    kern.push([x], [out], grid_dims=(2,), block_dims=(128,))
    torch.cuda.synchronize()
    torch.testing.assert_close(out.handle, v / (1 + torch.exp(-1.702 * v)),
                               rtol=1e-4, atol=0)


def test_rtc_bad_source_raises_with_nvrtc_log(card):
    from mxnet_tpu_torch.rtc import Rtc

    x = _nd(torch.ones(4, 4, device=card))
    with pytest.raises(tmx.MXNetError, match="NVRTC failed to compile"):
        Rtc("bad", [("x", x)], [("out", x)], "this is not CUDA !!!")


def test_ulysses_at_one_rank_launches_flash_once(card):
    """make_ring_attention over a one-rank cuda mesh: ulysses runs K2
    once a call, the ring never; both match the reference."""
    import torch.distributed as dist
    from mxnet_tpu_torch import parallel

    gen = torch.Generator(device=card).manual_seed(9)
    q, k, v = (torch.randn(1, 512, 4, 32, generator=gen, device=card)
               for _ in range(3))
    want = parallel.reference_attention(q, k, v, causal=True)
    mesh = parallel.make_mesh({"sp": 1})
    try:
        for impl, launches in (("ulysses", 1), ("ring", 0)):
            attn = parallel.make_ring_attention(mesh, "sp", causal=True,
                                                impl=impl)
            before = kernels.flash_attn_launches
            out = attn(q, k, v)
            torch.cuda.synchronize()
            assert kernels.flash_attn_launches == before + launches
            torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-5)
    finally:
        dist.destroy_process_group()
