"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Marked ``cuda``: without a card (or nvcc) every test here
skips with the reason. This file imports neither jax nor the JAX
package, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
import torch_tf32x3_model
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


@pytest.mark.parametrize("d", [32, 64, 128, 256, 48])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_reads_a_head_slice_by_strides(card, d, causal):
    """K2 on a non-contiguous (B, T, H, D) head slice, as ulysses_attention
    can hand it over, at each head-width instantiation: within rtol 2e-4
    / atol 2e-5 of the plain version on contiguous copies, a rerun
    bit-identical, one launch a call, no copy of the inputs."""
    gen = torch.Generator(device=card).manual_seed(10)
    full = [torch.randn(2, 300, 5, d, generator=gen, device=card)
            for _ in range(3)]
    q, k, v = (x[:, :, 1:4] for x in full)
    assert not q.is_contiguous()
    before = kernels.flash_attn_launches
    got = kernels.flash_attention(q, k, v, causal=causal)
    again = kernels.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.flash_attn_launches == before + 2
    assert torch.equal(got, again)
    want = kernels.flash_attention_plain(*(x.contiguous() for x in (q, k, v)),
                                         causal=causal)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_flash_attn_refuses_a_strided_head_dimension(card):
    x = torch.randn(1, 64, 2, 32, device=card).transpose(2, 3)
    with pytest.raises(tmx.MXNetError, match="stride 1"):
        kernels.flash_attention(x, x, x)


@pytest.mark.parametrize("trans", [False, True])
def test_conv_gemm_misaligned_operands(card, trans):
    """Operands one float off the 16-byte alignment take the 4-byte copies:
    within 1e-6 * sum|a||b| of float64, a rerun bit-identical."""
    m, n, k = 257, 96, 4099
    gen = torch.Generator(device=card).manual_seed(11)
    a = torch.randn(m * k + 1, generator=gen, device=card)[1:]
    a = a.view(k, m) if trans else a.view(m, k)
    b = torch.randn(k * n + 1, generator=gen, device=card)[1:].view(k, n)
    got = kernels.matmul_f32acc(a, b, trans)
    again = kernels.matmul_f32acc(a, b, trans)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ad = a.double().t() if trans else a.double()
    bound = 1e-6 * (ad.abs() @ b.double().abs())
    assert bool(((got.double() - ad @ b.double()).abs() <= bound).all())


def _conv_gemm_model(m, n, k, sms):
    return torch_tf32x3_model.k_chunk(m, n, k,
                                      torch_tf32x3_model.CONV_MIN_SPLIT, sms)


@pytest.mark.parametrize("name,fn,model", [
    ("conv_gemm", "conv_gemm_k_chunk", _conv_gemm_model),
    ("linear", "linear_k_chunk", torch_tf32x3_model.linear_k_chunk)],
    ids=["conv_gemm", "linear"])
def test_k_chunk_matches_the_cpu_model(card, name, fn, model):
    """The built split-K rule gives the K ranges that the CPU model of the
    kernels' arithmetic (tests/torch_tf32x3_model.py) splits by."""
    from mxnet_tpu_torch import _build

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    rule = getattr(_build.load(name), fn)
    for m, n, k in [(147, 64, 401408), (147, 64, 65536), (100352, 64, 576),
                    (4608, 512, 1568), (2304, 256, 6272), (257, 33, 1001),
                    (1000, 130, 4099), (129, 65, 7), (1, 1, 1), (32, 1000, 2048),
                    (128, 128, 256), (8192, 4096, 4096), (0, 5, 5),
                    (128, 128, 784), (128, 64, 128), (128, 10, 64),
                    (1024, 2048, 2048), (1536, 1408, 512)]:
        assert rule(m, n, k) == model(m, n, k, sms), (m, n, k)


@pytest.mark.parametrize("name", ["conv_gemm", "linear", "flash_attn"])
def test_kernels_run_tf32_tensor_core_mma(card, name):
    """K3, K1 and K2 are built on the tensor cores: their libraries hold
    HMMA instructions with TF32 operands (cuobjdump -sass)."""
    from mxnet_tpu_torch import _build

    assert _build.tf32_mma_count(name) > 0


def cuda_kernels(fn):
    """Names of the kernels the card ran for fn() (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (3, 5, 2), (128, 256, 128),
                                   (128, 784, 128), (32, 2048, 1000),
                                   (257, 1001, 33)])
@pytest.mark.parametrize("act", ["none", "relu", "tanh", "sigmoid"])
def test_linear_matches_float64(card, m, k, n, act):
    """K1 against act(x @ w.T + b) in float64: within 1e-6 of
    sum|x||w| + |b| (plus one libm ulp, 2e-7, for tanh and sigmoid); one
    CUDA launch a call; a rerun bit-identical (split K sums in order, the
    epilogue once)."""
    gen = torch.Generator(device=card).manual_seed(7)
    x = torch.randn(m, k, generator=gen, device=card)
    w = torch.randn(n, k, generator=gen, device=card)
    b = torch.randn(n, generator=gen, device=card)
    before = kernels.linear_launches
    got = kernels.fused_linear(x, w, b, act)
    ran = cuda_kernels(lambda: kernels.fused_linear(x, w, b, act))
    again = kernels.fused_linear(x, w, b, act)
    torch.cuda.synchronize()
    assert len(ran) == 1 and "linear_kernel" in ran[0], ran
    assert kernels.linear_launches == before + 3
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


def test_rtc_in_place_push(card):
    """x declared as input and output: the push computes what a fresh
    output would hold, as the JAX reference's fresh outputs do."""
    from mxnet_tpu_torch.rtc import Rtc

    v = torch.randn(4096, generator=torch.Generator(device=card)
                    .manual_seed(3), device=card)
    x = _nd(v.clone())
    kern = Rtc("scale2", [("x", x)], [("out", x)],
               "int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
               "if (i < 4096) out[i] = 2.0f * x[i];")
    before = kernels.rtc_launches
    kern.push([x], [x], grid_dims=(16,), block_dims=(256,))
    torch.cuda.synchronize()
    assert kernels.rtc_launches == before + 1
    assert torch.equal(x.handle, 2 * v)


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


# ---------------------------------------------------------------------------
# the fused train step as a CUDA graph
# ---------------------------------------------------------------------------
def _small_resnet_fit(x, y, fused_step, mod=None,
                      opt=(("learning_rate", 0.01), ("momentum", 0.9))):
    """One epoch of the small NHWC ResNet under torch.profiler: the module,
    the wrappers' launch counts, the launches the card ran (by the
    profiler's kernel events), the params and the moving statistics."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if mod is None:
        net = tmx.models.get_resnet([1, 1, 1, 1], [16, 32, 64, 128, 256],
                                    num_classes=10, small_input=False,
                                    layout="NHWC")
        mod = tmx.mod.Module(net, context=tmx.gpu(0))
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
                initializer=tmx.init.Xavier(magnitude=2.0, seed=7),
                optimizer_params=opt, fused_step=fused_step)
        torch.cuda.synchronize()
    ran = kernels.launches_in(e.name for e in prof.events()
                              if e.device_type == DeviceType.CUDA)
    args, aux = mod.get_params()
    return (mod, kernels.launch_counts(), ran,
            {k: v.asnumpy().copy() for k, v in args.items()},
            {k: v.asnumpy().copy() for k, v in aux.items()})


_SMALL_RESNET_STEP = {"norm_act_fwd": 17, "norm_act_bwd": 17,
                      "conv_gemm": 33, "linear": 0, "flash_attn": 0}


def _steps(n, rtc=None):
    out = {k: n * v for k, v in _SMALL_RESNET_STEP.items()}
    if rtc is not None:
        out["rtc"] = rtc
    return out


def test_fused_step_replays_with_launch_counts_multiplied(card):
    """Four fit steps of the small NHWC ResNet through the fused step:
    one eager step, one capture, three replays. The card ran four steps'
    launches (17 K4, 17 K5, 33 K3 a step, by the profiler's kernel
    events), as in the classic loop; the wrappers counted two steps' (the
    eager step and the launches the capture recorded); the params and
    moving statistics equal the classic loop's bit for bit."""
    rng = np.random.RandomState(5)
    x = rng.randn(16, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.float32)
    mod, counts, ran, args, aux = _small_resnet_fit(x, y, True)
    _, classic_counts, classic_ran, args_c, aux_c = _small_resnet_fit(
        x, y, False)
    fused = mod._fused_step
    assert (fused.eager_steps, fused.captures, fused.dispatches) == (1, 1, 3)
    assert ran == classic_ran == _steps(4)
    assert classic_counts == _steps(4, rtc=0)
    assert counts == _steps(2, rtc=0)
    for k in args_c:
        np.testing.assert_array_equal(args[k], args_c[k], err_msg=k)
    for k in aux_c:
        np.testing.assert_array_equal(aux[k], aux_c[k], err_msg=k)


def test_second_fit_captures_its_own_graph(card):
    """Two fused fits on one module: each builds its step, runs one eager
    step, captures once and replays the rest, and the card runs every
    batch's launches; the params equal two classic fits' bit for bit."""
    rng = np.random.RandomState(8)
    x = rng.randn(12, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 10, 12).astype(np.float32)
    results = []
    for fused_step in (True, False):
        mod, _, ran, _, _ = _small_resnet_fit(x, y, fused_step)
        first = mod._fused_step
        _, _, ran2, args, _ = _small_resnet_fit(x, y, fused_step, mod=mod)
        assert ran == ran2 == _steps(3)
        results.append((first, mod._fused_step, args))
    first, second, args = results[0]
    assert second is not first
    for step in (first, second):
        assert (step.eager_steps, step.captures, step.dispatches) == \
            (1, 1, 2)
    for k, v in results[1][2].items():
        np.testing.assert_array_equal(args[k], v, err_msg=k)


def test_fused_step_lr_change_between_replays_needs_no_recapture(card):
    """After the capture, a learning rate of 0 leaves every weight as it
    was and a new learning rate moves them again, with no new capture."""
    rng = np.random.RandomState(6)
    x = rng.randn(8, 10).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.float32)
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
    mod = tmx.mod.Module(net, context=tmx.gpu(0))
    mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
    mod.init_params(tmx.init.Xavier(seed=1))
    mod.init_optimizer(optimizer_params=(("learning_rate", 0.5),))
    metric = tmx.metric.create("acc")
    fused = mod._fused_train_step(metric)
    batch = tmx.io.DataBatch([x], [y])
    fused.step(batch, metric)
    fused.step(batch, metric)
    assert (fused.captures, fused.dispatches) == (1, 1)
    before = mod.get_params()[0]["fc_weight"].asnumpy().copy()
    mod._optimizer.lr = 0.0
    fused.step(batch, metric)
    frozen = mod.get_params()[0]["fc_weight"].asnumpy().copy()
    np.testing.assert_array_equal(frozen, before)
    mod._optimizer.lr = 0.25
    fused.step(batch, metric)
    assert not np.array_equal(mod.get_params()[0]["fc_weight"].asnumpy(),
                              frozen)
    assert (fused.captures, fused.dispatches) == (1, 3)
    assert metric.get()[0] == "accuracy"


def test_fused_step_dropout_draws_a_fresh_mask_each_replay(card):
    """A graph with Dropout registers the executor's generator with the
    CUDA graph, so each replay draws a new mask; where this PyTorch
    cannot register it, the capture raises naming the reason."""
    x = np.ones((4, 64), np.float32)
    y = np.zeros(4, np.float32)
    net = tmx.sym.Variable("data")
    net = tmx.sym.Dropout(net, p=0.5)
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        net, num_hidden=2, name="fc"), name="softmax")
    mod = tmx.mod.Module(net, context=tmx.gpu(0))
    mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
    mod.init_params(tmx.init.Xavier(seed=2))
    mod.init_optimizer(optimizer_params=(("learning_rate", 0.0),))
    metric = tmx.metric.create("acc")
    fused = mod._fused_train_step(metric)
    batch = tmx.io.DataBatch([x], [y])
    fused.step(batch, metric)
    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        with pytest.raises(tmx.MXNetError, match="generator"):
            fused.step(batch, metric)
        return
    outs = []
    for _ in range(3):
        fused.step(batch, metric)
        outs.append(mod.get_outputs()[0].asnumpy().copy())
    assert fused.dispatches == 3
    assert not np.array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[1], outs[2])


# ---------------------------------------------------------------------------
# checkpoints through the captured graph
# ---------------------------------------------------------------------------
def _ckpt_mlp(dropout):
    net = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(net, num_hidden=64, name="fc1")
    net = tmx.sym.Activation(net, act_type="relu")
    if dropout:
        net = tmx.sym.Dropout(net, p=dropout)
    net = tmx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return tmx.sym.SoftmaxOutput(net, name="softmax")


def _ckpt_fit(x, y, dropout=0.0, callback=None):
    """One epoch of batches of 8 through fit(fused_step=True) on the card
    from seeded weights; the per-batch (nbatch, outputs, accumulated
    metric) and the module."""
    stream = []

    def record(param):
        stream.append((param.nbatch,
                       param.locals["self"].get_outputs()[0].asnumpy()
                       .copy(), param.eval_metric.get()[1]))
        if callback is not None:
            callback(param)

    net = _ckpt_mlp(dropout)
    shapes, _, _ = net.infer_shape(data=(8, x.shape[1]),
                                   softmax_label=(8,))
    rng = np.random.RandomState(3)
    params = {n: tmx.nd.array((rng.randn(*s) * 0.1).astype(np.float32),
                              ctx=tmx.cpu())
              for n, s in zip(net.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    mod = tmx.mod.Module(net, context=tmx.gpu(0))
    tmx.random.seed(0)   # the Dropout stream, alike in every run
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
            eval_metric="ce", arg_params=params, initializer=None,
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                              "wd": 1e-4},
            batch_end_callback=record, fused_step=True)
    return stream, mod


def _ckpt_data(nbatches):
    rng = np.random.RandomState(0)
    x = rng.randn(8 * nbatches, 16).astype(np.float32)
    y = rng.randint(0, 3, 8 * nbatches).astype(np.float32)
    return x, y


def _same_stream(got, want):
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1], err_msg=str(g[0]))
        assert g[2] == w[2], g[0]


@pytest.mark.parametrize("dropout", [0.0, 0.3], ids=["mlp", "dropout"])
def test_resume_through_a_captured_graph_is_bit_identical(
        card, tmp_path, monkeypatch, dropout):
    """A fresh module resumes from the step-3 snapshot of a fused run on
    the card (its generator state included): batches 3-5 give the
    uninterrupted run's outputs (so Dropout's masks) and metric bit for
    bit, and the final params equal its params; one capture."""
    from mxnet_tpu_torch import checkpoint as ckpt

    x, y = _ckpt_data(6)
    ref, ref_mod = _ckpt_fit(x, y, dropout)
    d = str(tmp_path / "snaps")
    monkeypatch.setenv("MXNET_TPU_CKPT_DIR", d)
    monkeypatch.setenv("MXNET_TPU_CKPT_EVERY_N_STEPS", "3")
    monkeypatch.setenv("MXNET_TPU_CKPT_RESUME", "0")
    saved, _ = _ckpt_fit(x, y, dropout)
    _same_stream(saved, ref)
    store = ckpt.SnapshotStore(d)
    man = store._read_manifest()
    man["snapshots"] = [e for e in man["snapshots"] if e["step"] == 3]
    ckpt.atomic_write_bytes(store._manifest_path(),
                            json.dumps(man).encode())
    monkeypatch.setenv("MXNET_TPU_CKPT_RESUME", "1")
    monkeypatch.setenv("MXNET_TPU_CKPT_EVERY_N_STEPS", "0")
    got, mod = _ckpt_fit(x, y, dropout)
    _same_stream(got, ref[3:])
    step = mod._fused_step
    assert (step.eager_steps, step.captures, step.dispatches) == (1, 1, 2)
    for k, v in ref_mod.get_params()[0].items():
        np.testing.assert_array_equal(mod.get_params()[0][k].asnumpy(),
                                      v.asnumpy(), err_msg=k)


@pytest.mark.parametrize("dropout", [0.0, 0.3], ids=["mlp", "dropout"])
def test_rollback_into_a_live_graph(card, tmp_path, monkeypatch, dropout):
    """Batches b0, b1, b2, b3, b3 with a rollback to the step-3 snapshot
    after the first b3: the replay that follows reads the restored
    weights, momenta, metric accumulator and generator offset, so it
    gives the first b3's outputs and metric bit for bit, the params end
    as after four uninterrupted steps, and the graph is not captured
    again. Where set_state on a generator registered with the graph did
    not move the replay's offset, the Dropout case fails here."""
    x, y = _ckpt_data(4)
    ref, ref_mod = _ckpt_fit(x, y, dropout)
    x5 = np.concatenate([x, x[24:32]])
    y5 = np.concatenate([y, y[24:32]])
    monkeypatch.setenv("MXNET_TPU_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_TPU_CKPT_EVERY_N_STEPS", "3")
    monkeypatch.setenv("MXNET_TPU_CKPT_RESUME", "0")

    def rollback(param):
        if param.nbatch == 3:
            assert param.locals["ckpt"].rollback()["step"] == 3

    got, mod = _ckpt_fit(x5, y5, dropout, callback=rollback)
    _same_stream(got[:4], ref)
    np.testing.assert_array_equal(got[4][1], ref[3][1])
    assert got[4][2] == ref[3][2]
    step = mod._fused_step
    assert (step.eager_steps, step.captures, step.dispatches) == (1, 1, 4)
    for k, v in ref_mod.get_params()[0].items():
        np.testing.assert_array_equal(mod.get_params()[0][k].asnumpy(),
                                      v.asnumpy(), err_msg=k)


# -- fit's health and input plane on the card ---------------------------------

@pytest.mark.parametrize("staging,depth", [("1", "0"), ("0", "2")])
def test_capture_with_the_feed_running(card, monkeypatch, staging, depth):
    """The small NHWC ResNet through fit(fused_step=True) with device
    staging or a feed scheduler whose worker stages batches on its copy
    stream while the step captures (capture_error_mode thread_local): one
    capture, the card ran every batch's launches, and the params and
    moving statistics equal a fit without staging bit for bit."""
    rng = np.random.RandomState(11)
    x = rng.randn(24, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 10, 24).astype(np.float32)
    monkeypatch.delenv("MXNET_TPU_DEVICE_STAGING", raising=False)
    monkeypatch.delenv("MXNET_TPU_FEED_DEPTH", raising=False)
    _, _, _, args, aux = _small_resnet_fit(x, y, True)
    monkeypatch.setenv("MXNET_TPU_DEVICE_STAGING", staging)
    monkeypatch.setenv("MXNET_TPU_FEED_DEPTH", depth)
    mod, counts, ran, args_s, aux_s = _small_resnet_fit(x, y, True)
    step = mod._fused_step
    assert (step.eager_steps, step.captures, step.dispatches) == (1, 1, 5)
    assert ran == _steps(6) and counts == _steps(2, rtc=0)
    for want, got in ((args, args_s), (aux, aux_s)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_numwatch_rollback_into_a_live_graph(card, tmp_path, monkeypatch):
    """MXNET_TPU_NUMWATCH with the rollback guard on the card: a weight
    poisoned in place is named by the next fetch (kind "param"), the
    guard restores the healthy snapshot into the tensors the graph
    captured (every data_ptr, the pack's and the pre-step copies'
    unchanged), no second capture, and the following replays are
    finite."""
    monkeypatch.setenv("MXNET_TPU_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_TPU_NUMWATCH", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_EVERY_N", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_GUARD", "rollback")
    x, y = _ckpt_data(6)
    seen = {}

    def poison(param):
        plane = param.locals["numwatch"]
        ex = param.locals["self"]._exec_group.executor
        if param.nbatch == 1:
            seen["ptrs"] = [a.handle.data_ptr() for a in ex.arg_arrays]
            seen["pack"] = plane._pack.data_ptr()
            seen["old"] = [t.data_ptr() for t in
                           param.locals["fused"]._w_old]
            ex.arg_dict["fc2_weight"].handle.fill_(float("nan"))
            rollback = plane._rollback

            def spy(extras):
                seen["prov"] = plane.provenance()
                return rollback(extras)
            plane._rollback = spy
        if param.nbatch == 2:
            seen["rollbacks"] = plane._rollbacks

    stream, mod = _ckpt_fit(x, y, callback=poison)
    step = mod._fused_step
    ex = mod._exec_group.executor
    assert seen["rollbacks"] == 1
    assert seen["prov"] == ("fc2_weight", "param", 3)
    pack = step._numwatch._pack.cpu().numpy()
    assert pack[-1, 0] == 3 and not pack[:-1, 7:].any()   # 3 steps since
    assert (step.eager_steps, step.captures) == (1, 1)
    assert [a.handle.data_ptr() for a in ex.arg_arrays] == seen["ptrs"]
    assert step._numwatch._pack.data_ptr() == seen["pack"]
    assert [t.data_ptr() for t in step._w_old] == seen["old"]
    for nbatch, probs, _ in stream[3:]:
        assert np.isfinite(probs).all(), nbatch
    assert all(np.isfinite(v.asnumpy()).all()
               for v in mod.get_params()[0].values())


def test_numwatch_skip_guard_and_pack_on_the_card(card, monkeypatch):
    """The skip guard on the card: a NaN batch leaves the weights, the
    momenta and the metric sums bit-identical, the pack's grad sums of
    squares equal a float64 recomputation from the bound gradients
    (rtol 1e-5), and the armed fit's params equal an unarmed fit's bit
    for bit before the NaN batch."""
    monkeypatch.setenv("MXNET_TPU_NUMWATCH", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_EVERY_N", "1")
    monkeypatch.setenv("MXNET_TPU_NUMWATCH_GUARD", "skip")
    x, y = _ckpt_data(4)
    x[24:] = np.nan
    state = {}

    def keep(param):
        mod = param.locals["self"]
        ex = mod._exec_group.executor
        plane = param.locals["numwatch"]
        if param.nbatch == 2:
            pack = plane._pack.cpu().numpy()
            for i, name in enumerate(plane.names):
                g = ex.grad_dict[name].asnumpy().astype(np.float64)
                np.testing.assert_allclose(pack[i, 0], (g * g).sum(),
                                           rtol=1e-5, err_msg=name)
            state["w"] = {k: ex.arg_dict[k].handle.clone()
                          for k in mod._param_names}
            state["m"] = {i: s.handle.clone()
                          for i, s in mod._updater.states.items()}
            state["acc"] = param.eval_metric._acc.clone()
        if param.nbatch == 3:
            assert plane._pack[-1, 3].item() == 1   # one skip
            for k, v in state["w"].items():
                assert torch.equal(ex.arg_dict[k].handle, v), k
            for i, s in mod._updater.states.items():
                assert torch.equal(s.handle, state["m"][i]), i
            assert torch.equal(param.eval_metric._acc, state["acc"])
            state["checked"] = True

    _, mod = _ckpt_fit(x, y, callback=keep)
    assert state.get("checked")
    assert mod._fused_step.captures == 1


# ---------------------------------------------------------------------------
# every fusable optimizer through the captured graph
# ---------------------------------------------------------------------------
def _optimizer_fit(x, y, fused_step, kind, opt):
    """One epoch of the small NHWC ResNet with ``kind``: the module, the
    wrappers' launch counts, params, moving statistics and the
    optimizer's state tensors."""
    net = tmx.models.get_resnet([1, 1, 1, 1], [16, 32, 64, 128, 256],
                                num_classes=10, small_input=False,
                                layout="NHWC")
    mod = tmx.mod.Module(net, context=tmx.gpu(0))
    kernels.reset_launch_counts()
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
            initializer=tmx.init.Xavier(magnitude=2.0, seed=7),
            optimizer=kind, optimizer_params=opt, fused_step=fused_step)
    args, aux = mod.get_params()
    states = {i: [t.cpu().numpy().copy() for t in
                  tmx.optimizer._state_tensors(s)]
              for i, s in mod._updater.states.items()}
    return (mod, kernels.launch_counts(),
            {k: v.asnumpy().copy() for k, v in args.items()},
            {k: v.asnumpy().copy() for k, v in aux.items()}, states)


@pytest.mark.parametrize("kind,opt", [
    ("ccsgd", {"learning_rate": 0.01, "momentum": 0.9}),
    ("nag", {"learning_rate": 0.01, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-3, "clip_gradient": 5.0}),
    ("adagrad", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.002}),
    ("adadelta", {})])
def test_every_fusable_optimizer_through_the_graph(card, kind, opt):
    """Four steps of the small NHWC ResNet with each fusable optimizer:
    one eager step, one capture, three replays; the wrappers counted the
    eager step's and the capture's launches; params, moving statistics
    and every optimizer state tensor equal the classic loop's bit for
    bit (a scalar frozen into the graph would show from the third step
    on, as Adam's bias correction and RMSProp's schedule move)."""
    if kind == "rmsprop":
        opt = dict(opt, lr_scheduler=tmx.lr_scheduler.FactorScheduler(
            step=2, factor=0.5))
    rng = np.random.RandomState(5)
    x = rng.randn(16, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.float32)
    mod, counts, args, aux, states = _optimizer_fit(x, y, True, kind, opt)
    if kind == "rmsprop":
        opt = dict(opt, lr_scheduler=tmx.lr_scheduler.FactorScheduler(
            step=2, factor=0.5))
    _, counts_c, args_c, aux_c, states_c = _optimizer_fit(x, y, False, kind,
                                                          opt)
    fused = mod._fused_step
    assert (fused.eager_steps, fused.captures, fused.dispatches) == (1, 1, 3)
    assert counts == _steps(2, rtc=0) and counts_c == _steps(4, rtc=0)
    for got, want in ((args, args_c), (aux, aux_c)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert states.keys() == states_c.keys()
    for i in states_c:
        assert len(states[i]) == len(states_c[i]) \
            == mod._optimizer._n_states()
        for a, b in zip(states[i], states_c[i]):
            np.testing.assert_array_equal(a, b, err_msg=str(i))


def test_regression_head_folds_its_metric_in_the_graph(card):
    """An MLP with LinearRegressionOutput through fit(fused_step=True)
    with [mse, mae, rmse]: the metric folds inside the graph (one
    capture), each value within rtol 1e-6 of a float64 recomputation
    from the batches' outputs."""
    rng = np.random.RandomState(0)
    x = rng.rand(5 * 32, 64).astype(np.float32)
    y = (x @ (rng.randn(64, 1) / 8)).astype(np.float32)
    net = tmx.sym.Activation(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=128, name="fc1"),
        act_type="relu")
    net = tmx.sym.LinearRegressionOutput(tmx.sym.FullyConnected(
        net, num_hidden=1, name="fc2"), name="lro")
    outs = []
    metric = tmx.metric.create(["mse", "mae", "rmse"])
    mod = tmx.mod.Module(net, context=tmx.gpu(0), label_names=["lro_label"])
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=32, label_name="lro_label"),
            num_epoch=1, eval_metric=metric,
            initializer=tmx.init.Xavier(seed=1),
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9},
            batch_end_callback=lambda p: outs.append(
                p.locals["self"].get_outputs()[0].asnumpy().copy()),
            fused_step=True)
    step = mod._fused_step
    assert step._fold is metric
    assert (step.eager_steps, step.captures, step.dispatches) == (1, 1, 4)
    errs = [y[i * 32:(i + 1) * 32].astype(np.float64) - o
            for i, o in enumerate(outs)]
    want = [np.mean([(e ** 2).mean() for e in errs]),
            np.mean([np.abs(e).mean() for e in errs]),
            np.mean([np.sqrt((e ** 2).mean()) for e in errs])]
    np.testing.assert_allclose(metric.get()[1], want, rtol=1e-6)
