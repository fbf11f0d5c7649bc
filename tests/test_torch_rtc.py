"""The port's runtime-compiled kernels (mxnet_tpu_torch.rtc, K6) on the
CPU: the CUDA source a body is wrapped into, the dtype map, and the
errors that need no card. Compiling and launching a body needs a card
and NVRTC: tests/test_torch_cuda.py and chip_smoke.py do that."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _nvrtc, rtc

AXPY = "int i = threadIdx.x;\nout[i] = 2.0f * x[i] + y[i];"


def test_wrapped_source_is_the_mxrtc_signature():
    f32 = torch.float32
    src = rtc.wrap_source("axpy", [("x", f32), ("y", f32)], [("out", f32)],
                          "\n" + AXPY + "\n")
    assert src == ('extern "C" __global__ void axpy(const float* x, '
                   'const float* y, float* out) {\n'
                   'int i = threadIdx.x;\nout[i] = 2.0f * x[i] + y[i];\n}\n')


@pytest.mark.parametrize("dtype,ctype", [("float32", "float"),
                                         ("float64", "double"),
                                         ("int32", "int"),
                                         ("uint8", "unsigned char")])
def test_dtype_map(dtype, ctype):
    dt = getattr(torch, dtype)
    src = rtc.wrap_source("k", [("a", dt)], [("b", dt)], "")
    assert src.startswith('extern "C" __global__ void k(const %s* a, %s* b)'
                          % (ctype, ctype))


@pytest.mark.parametrize("dtype", ["float16", "int64", "bfloat16"])
def test_unsupported_dtype_is_named(dtype):
    with pytest.raises(tmx.MXNetError, match="'a' has dtype torch.%s" % dtype):
        rtc.wrap_source("k", [("a", getattr(torch, dtype))], [], "")


def test_without_a_card_rtc_raises_naming_nvrtc():
    x = tmx.nd.zeros((4,), ctx=tmx.cpu())
    with pytest.raises(tmx.DeviceUnavailableError, match="NVRTC"):
        rtc.Rtc("axpy", [("x", x)], [("out", x)], AXPY)


@pytest.fixture
def fake_compiled(monkeypatch):
    """An Rtc whose compilation is faked, for the checks push makes
    before it touches a card."""
    monkeypatch.setattr(_nvrtc, "require_card", lambda what: None)
    monkeypatch.setattr(_nvrtc, "device_arch", lambda device: "sm_90a")
    monkeypatch.setattr(_nvrtc, "compile_cubin", lambda *a: b"cubin")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    x = tmx.nd.array(np.arange(8, dtype=np.float32), ctx=tmx.cpu())
    out = tmx.nd.zeros((8,), ctx=tmx.cpu())
    return rtc.Rtc("axpy", [("x", x), ("y", x)], [("out", out)], AXPY), x, out


def test_push_checks_arity_and_launch_dims(fake_compiled):
    kern, x, out = fake_compiled
    assert "const float* y" in kern.source
    with pytest.raises(tmx.MXNetError, match="arity mismatch"):
        kern.push([x], [out], (1,), (8,))
    with pytest.raises(tmx.MXNetError, match="grid_dims and block_dims"):
        kern.push([x, x], [out])
    with pytest.raises(tmx.MXNetError, match="grid_dims must be"):
        kern.push([x, x], [out], (0,), (8,))
    with pytest.raises(tmx.MXNetError, match="one CUDA device"):
        kern.push([x, x], [out], (1,), (8,))
    with pytest.raises(tmx.MXNetError, match="at least one output"):
        rtc.Rtc("sink", [("x", x)], [], "")
