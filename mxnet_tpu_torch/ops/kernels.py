"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``. Each kernel has:

* a wrapper that launches the CUDA kernel for a CUDA tensor (or raises:
  there is no fallback on the card), and takes the plain version only
  for a tensor that lies on the CPU;
* the plain version, the same function in plain torch, used by the CPU
  tests and held against the kernel on the card by ``chip_smoke.py``;
* a launch count, a plain integer that the wrapper raises by one where it
  launches the kernel and nowhere else.

Ported so far (``csrc/``):

* K4, the fused norm+act forward, and K5, its backward
  (``norm_act.cu``): :func:`fused_norm_act` is differentiable, its
  backward launches K5;
* K3, the float32-accumulating GEMM of the convolution backward
  (``conv_gemm.cu``): :func:`matmul_f32acc`, under :func:`conv_dgrad`,
  :func:`conv_wgrad` and the differentiable :func:`conv2d`;
* K1, the fused linear layer (``linear.cu``): :func:`fused_linear`;
* K2, flash attention (``flash_attn.cu``): :func:`flash_attention`,
  which ``parallel.ulysses_attention`` runs;
* K6's launches, the runtime-compiled kernels of ``rtc.Rtc``, are
  counted here too (``rtc``).

Every TPU kernel of the JAX package now has its counterpart here.
"""
from __future__ import annotations

import math
import threading

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["fused_norm_act", "fused_norm_act_plain", "fused_norm_act_bwd",
           "fused_norm_act_bwd_plain", "matmul_f32acc", "matmul_f32acc_plain",
           "conv_dgrad", "conv_wgrad", "conv2d", "fused_linear",
           "fused_linear_plain", "flash_attention", "flash_attention_plain",
           "reference_attention", "FLASH_MAX_D", "reset_launch_counts", "launch_counts"]

#: kernel launches since the last reset, one per wrapper call that
#: launched its kernel
norm_act_fwd_launches = 0
norm_act_bwd_launches = 0
conv_gemm_launches = 0
linear_launches = 0
flash_attn_launches = 0
rtc_launches = 0
_count_lock = threading.Lock()

_ACTS = {"none": 0, "relu": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LINEAR_ACTS = {"none": 0, "relu": 1, "tanh": 2, "sigmoid": 3}
#: the widest head dimension K2 takes (pallas_kernels.py:253)
FLASH_MAX_D = 256
_FLASH_MASK = -1e30


def launch_counts() -> dict:
    """Every kernel's launch count, by kernel name."""
    return {"norm_act_fwd": norm_act_fwd_launches,
            "norm_act_bwd": norm_act_bwd_launches,
            "conv_gemm": conv_gemm_launches,
            "linear": linear_launches,
            "flash_attn": flash_attn_launches,
            "rtc": rtc_launches}


def reset_launch_counts() -> None:
    global norm_act_fwd_launches, norm_act_bwd_launches, conv_gemm_launches
    global linear_launches, flash_attn_launches, rtc_launches
    with _count_lock:
        norm_act_fwd_launches = 0
        norm_act_bwd_launches = 0
        conv_gemm_launches = 0
        linear_launches = 0
        flash_attn_launches = 0
        rtc_launches = 0


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(fn: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device, contiguous, of a supported dtype."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise MXNetError("%s: unsupported device %s" % (fn, dev))
    for t in tensors:
        if t.device != dev:
            raise MXNetError("%s: tensors on %s and %s" % (fn, dev, t.device))
        if not t.is_contiguous():
            raise MXNetError("%s: tensors must be contiguous, got strides %s"
                             % (fn, t.stride()))


# ---------------------------------------------------------------------------
# K4 / K5: fused norm + act, forward and backward
# ---------------------------------------------------------------------------
def fused_norm_act_plain(x: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor, act: str = "none"):
    """``act(x * scale + shift)`` over the last (channel) axis, math in
    float32, cast back to ``x.dtype``: the JAX kernel's arithmetic
    (``pallas_kernels.py:587-592``) in plain torch."""
    y = x.float() * scale.float() + shift.float()
    if act == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)


def fused_norm_act_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                             shift: torch.Tensor, g: torch.Tensor,
                             act: str = "none"):
    """``(dx, dscale, dshift)`` of :func:`fused_norm_act_plain` for the
    cotangent ``g``: the JAX kernel's arithmetic
    (``pallas_kernels.py:629-636``). The ReLU mask is recomputed from the
    pre-activation; dx is cast to ``x.dtype``, the sums are float32 over
    every axis but the last."""
    c = x.shape[-1]
    xf = x.float().reshape(-1, c)
    gf = g.float().reshape(-1, c)
    sc = scale.float()
    if act == "relu":
        pre = xf * sc + shift.float()
        gf = torch.where(pre > 0.0, gf, torch.zeros_like(gf))
    dx = (gf * sc).to(x.dtype).reshape(x.shape)
    return dx, (gf * xf).sum(0), gf.sum(0)


def _check_norm_act(fn, x, scale, shift, act):
    if act not in _ACTS:
        raise MXNetError("%s: act must be one of %s, got %r"
                         % (fn, sorted(_ACTS), act))
    if x.dtype not in _DTYPES:
        raise MXNetError("%s: dtype %s not supported (float32, bfloat16)"
                         % (fn, x.dtype))
    c = x.shape[-1] if x.dim() else 0
    if tuple(scale.shape) != (c,) or tuple(shift.shape) != (c,):
        raise MXNetError("%s: scale/shift must be (%d,), got %s and %s"
                         % (fn, c, tuple(scale.shape), tuple(shift.shape)))
    return c


def _norm_act_fwd(x, sc, sh, act):
    """K4 on a CUDA tensor (sc, sh float32), the plain version on the CPU."""
    c = _check_norm_act("fused_norm_act", x, sc, sh, act)
    if x.device.type == "cpu":
        return fused_norm_act_plain(x, sc, sh, act)
    _check_cuda("fused_norm_act", x, sc, sh)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    from .. import _build

    lib = _build.load("norm_act")
    with torch.cuda.device(x.device):
        rc = lib.norm_act_fwd(x.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                              y.data_ptr(), x.numel() // c, c,
                              _DTYPES[x.dtype], _ACTS[act], _stream(x))
    if rc != 0:
        raise MXNetError("norm_act_fwd launch failed: CUDA error %d" % rc)
    _count("norm_act_fwd_launches")
    return y


def fused_norm_act_bwd(x: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor, g: torch.Tensor,
                       act: str = "none"):
    """``(dx, dscale, dshift)`` of ``act(x * scale + shift)`` for the
    cotangent ``g`` (``x``'s shape and dtype). ``scale``/``shift`` are
    float32 ``(C,)``; dx has ``x.dtype``, dscale and dshift are float32.

    On a CUDA tensor: launches ``norm_act_bwd`` (two stages, no atomics:
    reruns are bit-identical) or raises. On a CPU tensor:
    :func:`fused_norm_act_bwd_plain`."""
    c = _check_norm_act("fused_norm_act_bwd", x, scale, shift, act)
    if tuple(g.shape) != tuple(x.shape) or g.dtype != x.dtype:
        raise MXNetError("fused_norm_act_bwd: g is %s %s, x is %s %s"
                         % (tuple(g.shape), g.dtype, tuple(x.shape), x.dtype))
    if x.device.type == "cpu":
        return fused_norm_act_bwd_plain(x, scale, shift, g, act)
    _check_cuda("fused_norm_act_bwd", x, scale, shift, g)
    if scale.dtype != torch.float32 or shift.dtype != torch.float32:
        raise MXNetError("fused_norm_act_bwd: scale/shift must be float32")
    dx = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    if rows == 0:
        return (dx, torch.zeros(c, dtype=torch.float32, device=x.device),
                torch.zeros(c, dtype=torch.float32, device=x.device))
    dscale = torch.empty(c, dtype=torch.float32, device=x.device)
    dshift = torch.empty(c, dtype=torch.float32, device=x.device)
    from .. import _build

    lib = _build.load("norm_act")
    with torch.cuda.device(x.device):
        blocks = lib.norm_act_bwd_row_blocks(rows, c)
        partial = torch.empty((blocks, 2, c), dtype=torch.float32,
                              device=x.device)
        rc = lib.norm_act_bwd(x.data_ptr(), scale.data_ptr(),
                              shift.data_ptr(), g.data_ptr(), dx.data_ptr(),
                              dscale.data_ptr(), dshift.data_ptr(),
                              partial.data_ptr(), rows, c, blocks,
                              _DTYPES[x.dtype], _ACTS[act], _stream(x))
    if rc != 0:
        raise MXNetError("norm_act_bwd launch failed: CUDA error %d" % rc)
    _count("norm_act_bwd_launches")
    return dx, dscale, dshift


class _NormAct(torch.autograd.Function):
    """Forward K4, backward K5 (``pallas_kernels.py:687-702``)."""

    @staticmethod
    def forward(ctx, x, sc, sh, act):
        ctx.act = act
        ctx.save_for_backward(x, sc, sh)
        return _norm_act_fwd(x, sc, sh, act)

    @staticmethod
    def backward(ctx, gy):
        x, sc, sh = ctx.saved_tensors
        dx, dsc, dsh = fused_norm_act_bwd(x, sc, sh, gy.contiguous(), ctx.act)
        return dx, dsc, dsh, None


def fused_norm_act(x: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, act: str = "none") -> torch.Tensor:
    """``act(x * scale + shift)`` with per-channel ``scale``/``shift``
    over the last axis of a channels-last ``x`` (float32 or bfloat16;
    any rank; any row and channel count). ``scale`` and ``shift`` are
    widened to float32 before the math, as the JAX wrapper does
    (``pallas_kernels.py:684-685``); autograd sees that cast, so their
    cotangents come back in their own dtype.

    Differentiable in all three inputs. On a CUDA tensor the forward
    launches ``norm_act_fwd`` and the backward ``norm_act_bwd``, or they
    raise; on a CPU tensor both take their plain versions."""
    _check_norm_act("fused_norm_act", x, scale, shift, act)
    return _NormAct.apply(x, scale.to(torch.float32),
                          shift.to(torch.float32), act)


# ---------------------------------------------------------------------------
# K3: the GEMM of the convolution backward
# ---------------------------------------------------------------------------
def matmul_f32acc_plain(a: torch.Tensor, b: torch.Tensor,
                        transpose_a: bool = False) -> torch.Tensor:
    """``a @ b`` or ``a.T @ b`` in float32 (``pallas_kernels.py:319-365``
    in plain torch): the operands are widened to float32, which is exact
    for bfloat16, so the products are exact and the sum is float32."""
    a = a.float()
    return (a.t() if transpose_a else a) @ b.float()


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor,
                  transpose_a: bool = False) -> torch.Tensor:
    """``a @ b``, or ``a.T @ b`` with ``transpose_a`` (the transpose is
    folded into the kernel's tile loads, never materialised), for 2-D
    float32 or bfloat16 operands of one dtype; float32 result.

    On CUDA tensors: launches ``conv_gemm`` (contiguous operands; any M,
    N and K) or raises. On CPU tensors: :func:`matmul_f32acc_plain`."""
    if a.dim() != 2 or b.dim() != 2:
        raise MXNetError("matmul_f32acc: operands must be 2-D, got %s and %s"
                         % (tuple(a.shape), tuple(b.shape)))
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise MXNetError("matmul_f32acc: operands must both be float32 or "
                         "both bfloat16, got %s and %s" % (a.dtype, b.dtype))
    k, m = a.shape if transpose_a else (a.shape[1], a.shape[0])
    if b.shape[0] != k:
        raise MXNetError("matmul_f32acc: inner dimensions differ: %s%s @ %s"
                         % (tuple(a.shape), ".T" if transpose_a else "",
                            tuple(b.shape)))
    n = b.shape[1]
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_f32acc_plain(a, b, transpose_a)
    _check_cuda("matmul_f32acc", a, b)
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=a.device)
    from .. import _build

    lib = _build.load("conv_gemm")
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        chunk = lib.conv_gemm_k_chunk(m, n, k)
        splits = -(-k // chunk)
        ws = (torch.empty((splits, m, n), dtype=torch.float32,
                          device=a.device) if splits > 1 else None)
        rc = lib.conv_gemm(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                           None if ws is None else ws.data_ptr(), m, n, k,
                           int(bool(transpose_a)), _DTYPES[a.dtype], chunk,
                           splits, _stream(a))
    if rc != 0:
        raise MXNetError("conv_gemm launch failed: CUDA error %d" % rc)
    _count("conv_gemm_launches")
    return c


def _patches(x, kh, kw, stride, dilate, out_hw):
    """im2col over an already padded NHWC tensor: (N, Hp, Wp, C) ->
    (N*HO*WO, KH*KW*C), minor order (kh, kw, c), taps ``dilate`` apart
    (``pallas_kernels.py:368-387``). One strided view and one copy; a 1x1
    stride-1 window over a contiguous tensor is a view, no copy."""
    n, _, _, c = x.shape
    ho, wo = out_hw
    sn, sh, sw, sc = x.stride()
    win = x.as_strided((n, ho, wo, kh, kw, c),
                       (sn, sh * stride[0], sw * stride[1], sh * dilate[0],
                        sw * dilate[1], sc))
    return win.reshape(n * ho * wo, kh * kw * c).contiguous()


def _dilate_pad(g, stride, lead, trail):
    """g (N, HO, WO, O) with ``stride - 1`` zeros between its rows and
    columns, padded by ``lead`` before and ``trail`` after each spatial
    axis; a negative pad crops instead."""
    n, ho, wo, o = g.shape
    if tuple(stride) == (1, 1) and all(p == 0 for p in lead + trail):
        return g
    hd, wd = (ho - 1) * stride[0] + 1, (wo - 1) * stride[1] + 1
    top, left = max(lead[0], 0), max(lead[1], 0)
    out = g.new_zeros((n, top + hd + max(trail[0], 0),
                       left + wd + max(trail[1], 0), o))
    out[:, top:top + hd:stride[0], left:left + wd:stride[1], :] = g
    return out[:, max(-lead[0], 0):out.shape[1] - max(-trail[0], 0),
               max(-lead[1], 0):out.shape[2] - max(-trail[1], 0), :]


def conv_dgrad(w, g, x_shape, stride=(1, 1), pad=(0, 0), dilate=(1, 1),
               groups=1):
    """Input gradient of a 2-D convolution as one K3 GEMM a group
    (``pallas_kernels.py:424-458``): dx = patches(g~) @ w~, where g~ is
    ``g`` stride-dilated and edge-padded and w~ is ``w`` spatially flipped
    with O and C swapped. ``w`` OIHW, ``g`` the NHWC output cotangent,
    ``x_shape`` the NHWC input shape; returns dx NHWC in ``g.dtype``.

    Any geometry: the trailing edge takes the remainder ``(H + 2p - k) %
    s`` that stride leaves unread, so dx comes out H x W; where ``p >
    k - 1`` the pad is a crop; dilation dilates the taps; groups loop."""
    n, h, wd, c = x_shape
    o, cg, kh, kw = w.shape
    og = o // groups
    ekh, ekw = dilate[0] * (kh - 1) + 1, dilate[1] * (kw - 1) + 1
    lead = (ekh - 1 - pad[0], ekw - 1 - pad[1])
    trail = (lead[0] + (h + 2 * pad[0] - ekh) % stride[0],
             lead[1] + (wd + 2 * pad[1] - ekw) % stride[1])
    gt = _dilate_pad(g, stride, lead, trail)
    wt = w.flip(2, 3).permute(2, 3, 0, 1)          # (kh, kw, O, Cg)
    parts = []
    for gi in range(groups):
        gs = gt[..., gi * og:(gi + 1) * og] if groups > 1 else gt
        pat = _patches(gs, kh, kw, (1, 1), dilate, (h, wd))
        wm = wt[:, :, gi * og:(gi + 1) * og, :].reshape(kh * kw * og, cg)
        dx = matmul_f32acc(pat, wm.to(pat.dtype).contiguous())
        parts.append(dx.reshape(n, h, wd, cg))
    dx = torch.cat(parts, dim=-1) if groups > 1 else parts[0]
    return dx.to(g.dtype)


def conv_wgrad(x, g, w_shape, stride=(1, 1), pad=(0, 0), dilate=(1, 1),
               groups=1):
    """Weight gradient of a 2-D convolution as one K3 GEMM a group,
    ``patches(x)^T @ g`` with the transpose folded into the kernel's tile
    loads (``pallas_kernels.py:461-480``). ``x``/``g`` NHWC; returns gw
    OIHW in ``g.dtype``. Any geometry, as :func:`conv_dgrad`."""
    o, cg, kh, kw = w_shape
    og = o // groups
    ho, wo = g.shape[1], g.shape[2]
    if any(pad):
        x = F.pad(x, (0, 0, pad[1], pad[1], pad[0], pad[0]))
    parts = []
    for gi in range(groups):
        xs = x[..., gi * cg:(gi + 1) * cg] if groups > 1 else x
        gs = g[..., gi * og:(gi + 1) * og] if groups > 1 else g
        pat = _patches(xs, kh, kw, stride, dilate, (ho, wo))
        gm = gs.reshape(-1, og).to(pat.dtype).contiguous()
        gw = matmul_f32acc(pat, gm, transpose_a=True)   # (kh*kw*Cg, Og)
        parts.append(gw.reshape(kh, kw, cg, og).permute(3, 2, 0, 1))
    gw = torch.cat(parts, dim=0) if groups > 1 else parts[0].contiguous()
    return gw.to(g.dtype)


class _Conv2d(torch.autograd.Function):
    """Forward ``F.conv2d`` (cuDNN on the card), backward K3
    (``pallas_kernels.py:514-536``). Tensors are NCHW-shaped in any
    memory format; the backward works channels-last."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, dilate, groups):
        ctx.geom = (stride, pad, dilate, groups)
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, None, stride, pad, dilate, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pad, dilate, groups = ctx.geom
        gh = g.movedim(1, -1).contiguous()
        dx = gw = None
        if ctx.needs_input_grad[0]:
            shape = (x.shape[0], x.shape[2], x.shape[3], x.shape[1])
            dx = conv_dgrad(w, gh, shape, stride, pad, dilate,
                            groups).to(x.dtype).movedim(-1, 1)
        if ctx.needs_input_grad[1]:
            xh = x.movedim(1, -1).contiguous()
            gw = conv_wgrad(xh, gh, w.shape, stride, pad, dilate,
                            groups).to(w.dtype)
        return dx, gw, None, None, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride=(1, 1), pad=(0, 0),
           dilate=(1, 1), groups: int = 1) -> torch.Tensor:
    """2-D convolution of an NCHW-shaped ``x`` (any memory format: an
    NHWC tensor enters as ``x.movedim(-1, 1)``) with an OIHW ``w``, no
    bias. The forward is ``F.conv2d``; the backward runs :func:`conv_dgrad`
    (skipped when ``x`` needs no gradient) and :func:`conv_wgrad` on the
    K3 kernel, for every geometry: no applicability gate."""
    return _Conv2d.apply(x, w, tuple(stride), tuple(pad), tuple(dilate),
                         int(groups))


# ---------------------------------------------------------------------------
# K1: the fused linear layer
# ---------------------------------------------------------------------------
def _act_plain(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(y)
    if act == "tanh":
        return torch.tanh(y)
    if act == "sigmoid":
        return torch.sigmoid(y)
    return y


def fused_linear_plain(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor = None, act: str = "none"):
    """``act(x @ weight.T + bias)`` in float32: the JAX kernel's
    arithmetic (``pallas_kernels.py:67-85``) in plain torch."""
    y = x @ weight.t()
    if bias is not None:
        y = y + bias
    return _act_plain(y, act)


def _linear_fwd(x, w, b, act):
    """K1 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return fused_linear_plain(x, w, b, act)
    _check_cuda("fused_linear", *[t for t in (x, w, b) if t is not None])
    m, k = x.shape
    n = w.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    from .. import _build

    lib = _build.load("linear")
    with torch.cuda.device(x.device):
        chunk = lib.linear_k_chunk(m, n, k)
        splits = -(-k // chunk)
        ws = (torch.empty((splits, m, n), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        rc = lib.linear_fwd(x.data_ptr(), w.data_ptr(),
                            None if b is None else b.data_ptr(),
                            out.data_ptr(),
                            None if ws is None else ws.data_ptr(), m, n, k,
                            _LINEAR_ACTS[act], chunk, splits, _stream(x))
    if rc != 0:
        raise MXNetError("linear_fwd launch failed: CUDA error %d" % rc)
    _count("linear_launches")
    return out


class _Linear(torch.autograd.Function):
    """Forward K1; backward the JAX package's plain products with the
    activation's derivative taken from the output
    (``pallas_kernels.py:128-139``)."""

    @staticmethod
    def forward(ctx, x, w, b, act):
        out = _linear_fwd(x, w, b, act)
        ctx.act = act
        ctx.has_bias = b is not None
        ctx.save_for_backward(x, w, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        if ctx.act == "relu":
            g = torch.where(out > 0, g, torch.zeros_like(g))
        elif ctx.act == "tanh":
            g = g * (1.0 - out * out)
        elif ctx.act == "sigmoid":
            g = g * out * (1.0 - out)
        gx = g @ w if ctx.needs_input_grad[0] else None
        gw = g.t() @ x if ctx.needs_input_grad[1] else None
        gb = g.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return gx, gw, gb, None


def fused_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor = None, act: str = "none") -> torch.Tensor:
    """``act(x @ weight.T + bias)`` for x (M, K), ``weight`` (N, K) (the
    framework's layout) and ``bias`` (N,) or None, all float32 (as the
    JAX wrapper requires, ``pallas_kernels.py:115-117``); act is none,
    relu, tanh or sigmoid. Any M, N and K >= 1: there is no 128-multiple
    condition and no None return.

    Differentiable in all three inputs. On CUDA tensors the forward
    launches ``linear`` (contiguous operands) or raises; on CPU tensors
    it takes :func:`fused_linear_plain`."""
    if act not in _LINEAR_ACTS:
        raise MXNetError("fused_linear: act must be one of %s, got %r"
                         % (sorted(_LINEAR_ACTS), act))
    if x.dim() != 2 or weight.dim() != 2 or x.shape[1] != weight.shape[1]:
        raise MXNetError("fused_linear: x (M, K) and weight (N, K) expected, "
                         "got %s and %s" % (tuple(x.shape), tuple(weight.shape)))
    n, k = weight.shape
    if bias is not None and tuple(bias.shape) != (n,):
        raise MXNetError("fused_linear: bias must be (%d,), got %s"
                         % (n, tuple(bias.shape)))
    for t in (x, weight, bias):
        if t is not None and t.dtype != torch.float32:
            raise MXNetError("fused_linear: float32 inputs only, got %s"
                             % t.dtype)
    if k == 0:
        raise MXNetError("fused_linear: x has no columns (K = 0)")
    return _Linear.apply(x, weight, bias, act)


# ---------------------------------------------------------------------------
# K2: flash attention
# ---------------------------------------------------------------------------
def reference_attention(q, k, v, causal: bool = False, scale=None,
                        mask_value=-math.inf):
    """Plain full attention over (B, T, H, D): the correctness oracle of
    ``parallel.ring_attention``, and the recompute path of the flash
    kernel's backward (which passes its own scale and finite
    ``mask_value``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        t_q, t_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((t_q, t_k), dtype=torch.bool,
                          device=logits.device).tril()
        logits = logits.masked_fill(~mask, mask_value)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, scale: float = None):
    """The plain attention that K2 computes: :func:`reference_attention`
    at the kernel's scale (1/sqrt(D) by default) and finite mask value
    -1e30, as the JAX VJP pins it (``pallas_kernels.py:269-275``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return reference_attention(q, k, v, causal=causal, scale=scale,
                               mask_value=_FLASH_MASK)


def _flash_fwd(q, k, v, causal, scale):
    """K2 on CUDA tensors, the plain version on CPU tensors."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal, scale)
    b, t, h, d = q.shape
    if b * h > 65535:
        raise MXNetError("flash_attention: B*H = %d above the kernel grid's "
                         "limit of 65535" % (b * h))

    def pack(x):   # (B, T, H, D) -> (B*H, T, D)
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    qp, kp, vp = pack(q), pack(k), pack(v)
    _check_cuda("flash_attention", qp, kp, vp)
    o = torch.empty_like(qp)
    if qp.numel():
        from .. import _build

        lib = _build.load("flash_attn")
        with torch.cuda.device(q.device):
            rc = lib.flash_attn_fwd(qp.data_ptr(), kp.data_ptr(),
                                    vp.data_ptr(), o.data_ptr(), b * h, t, d,
                                    scale, int(causal), _stream(q))
        if rc != 0:
            raise MXNetError("flash_attn launch failed: CUDA error %d" % rc)
        _count("flash_attn_launches")
    return o.reshape(b, h, t, d).transpose(1, 2)


class _Flash(torch.autograd.Function):
    """Forward K2; backward recomputes through the plain reference under
    autograd, as ``f_bwd`` does (``pallas_kernels.py:280-283``): the
    JAX package has no backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v)
        return _flash_fwd(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
            out = flash_attention_plain(qd, kd, vd, ctx.causal, ctx.scale)
        return torch.autograd.grad(out, (qd, kd, vd), g) + (None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: float = None) -> torch.Tensor:
    """Attention over (B, T, H, D) float32 inputs of one shape (the layout
    of :mod:`mxnet_tpu_torch.parallel.ring_attention`), scale 1/sqrt(D)
    by default. Any T; D up to :data:`FLASH_MAX_D`; other dtypes and
    wider heads raise, naming the limit (the JAX wrapper returns None
    for them, and for a T that is not a multiple of 128).

    Differentiable: the backward recomputes through the plain reference.
    On CUDA tensors the forward launches ``flash_attn`` (one launch over
    all B*H rows) or raises; on CPU tensors it takes
    :func:`flash_attention_plain`."""
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape):
        raise MXNetError("flash_attention: q, k, v must be (B, T, H, D) of one "
                         "shape, got %s, %s, %s" % (tuple(q.shape),
                                                    tuple(k.shape),
                                                    tuple(v.shape)))
    for t in (q, k, v):
        if t.dtype != torch.float32:
            raise MXNetError("flash_attention: float32 inputs only, got %s"
                             % t.dtype)
    d = q.shape[-1]
    if not 0 < d <= FLASH_MAX_D:
        raise MXNetError("flash_attention: head dimension %d outside the "
                         "kernel's 1..%d" % (d, FLASH_MAX_D))
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    return _Flash.apply(q, k, v, bool(causal), scale)
