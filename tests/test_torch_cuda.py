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
