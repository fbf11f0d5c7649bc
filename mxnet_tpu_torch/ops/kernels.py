"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``. Each kernel has:

* a wrapper that launches the CUDA kernel for a CUDA tensor (or raises:
  there is no fallback on the card), and takes the plain version only
  for a tensor that lies on the CPU;
* the plain version, the same function in plain torch, used by the CPU
  tests and held against the kernel on the card by ``chip_smoke.py``;
* a launch count, a plain integer that the wrapper raises by one where it
  launches the kernel and nowhere else. A CUDA graph's capture runs the
  wrappers, which count the launches it records; its replays run no
  wrapper and move no count (:func:`launches_in` counts them from a
  profiler's kernel events).

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

Two kernels here replace no TPU kernel: ``roi_pool`` (``roi_pool.cu``),
ROIPooling's forward and backward, which the JAX package leaves to XLA
as a masked max over the whole map per bin (:func:`roi_pool`), and
``crop_norm`` (``crop_norm.cu``), the device feed's crop, mirror and
normalisation of uint8 frames, which the JAX package jits
(:func:`crop_norm`).

Every TPU kernel of the JAX package now has its counterpart here. K1, K2
and K3 run on the tensor cores at float32 accuracy (three TF32 products a
fragment, ``csrc/tf32x3.cuh``), so their results keep the float32
contracts of their plain versions. K3 with bfloat16 or float16 operands
runs its own 16-bit mainloop, written for Hopper (``csrc/gemm_wgmma16.cuh``:
TMA loads, wgmma, exact products, float32 sums), and K4/K5 take both
16-bit types with float32 math.

Launch parameters: K3's split-K chunk, K4's grid cap and K5's row blocks
come from each kernel's own rule, or, with ``MXNET_TPU_AUTOTUNE`` on,
from the autotuner's cache (``autotune.conv_k_chunk``,
``norm_fwd_blocks``, ``norm_bwd_row_blocks``: looked up once a
signature). K3's and K5's sums take their order from them; K4 is
elementwise and gives the same bits under any cap.
"""
from __future__ import annotations

import ctypes
import math
import re
import threading

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["fused_norm_act", "fused_norm_act_plain", "fused_norm_act_bwd",
           "fused_norm_act_bwd_plain", "matmul_f32acc", "matmul_f32acc_plain",
           "conv_dgrad", "conv_wgrad", "conv2d", "fused_linear",
           "fused_linear_plain", "flash_attention", "flash_attention_plain",
           "reference_attention", "FLASH_MAX_D", "roi_pool", "roi_pool_plain",
           "roi_pool_plain_grad", "roi_pool_fwd", "roi_pool_bwd",
           "crop_norm", "crop_normalize_plain", "reset_launch_counts",
           "launch_counts", "LAUNCH_KERNELS", "launches_in", "pitched16"]

#: kernel launches since the last reset, one per wrapper call that
#: launched its kernel
norm_act_fwd_launches = 0
norm_act_bwd_launches = 0
conv_gemm_launches = 0
linear_launches = 0
flash_attn_launches = 0
rtc_launches = 0
roi_pool_launches = 0
crop_norm_launches = 0
#: padded copies ``matmul_f32acc`` made of 16-bit operands whose rows the
#: 16-bit mainloop cannot read in place (:func:`pitched16`)
conv_gemm_pad_copies = 0
#: the FLOPs (2 M N K a product) of K3's launches since the last reset,
#: which run outside aten, so ``FlopCounterMode`` cannot see them
#: (``xprof.count_flops``)
conv_gemm_flops = 0
#: (wrapper, dtype name) -> launches since the last reset: which of a
#: kernel's typed paths ran (``launch_records``)
_by_dtype: dict = {}
_count_lock = threading.Lock()

_ACTS = {"none": 0, "relu": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
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
            "rtc": rtc_launches,
            "roi_pool": roi_pool_launches,
            "crop_norm": crop_norm_launches}


def launch_records() -> dict:
    """The launches since the last reset by kernel and operand dtype,
    ``{"conv_gemm": {"bfloat16": 105}, ...}``: which typed path of each
    kernel ran. Every launch counted by :func:`launch_counts` is here
    under its dtype."""
    with _count_lock:
        out: dict = {}
        for (name, dtype), n in _by_dtype.items():
            out.setdefault(name, {})[dtype] = n
        return out


def reset_launch_counts() -> None:
    global norm_act_fwd_launches, norm_act_bwd_launches, conv_gemm_launches
    global linear_launches, flash_attn_launches, rtc_launches
    global roi_pool_launches, crop_norm_launches
    global conv_gemm_pad_copies, conv_gemm_flops
    with _count_lock:
        _by_dtype.clear()
        conv_gemm_pad_copies = 0
        conv_gemm_flops = 0
        norm_act_fwd_launches = 0
        norm_act_bwd_launches = 0
        conv_gemm_launches = 0
        linear_launches = 0
        flash_attn_launches = 0
        rtc_launches = 0
        roi_pool_launches = 0
        crop_norm_launches = 0


def _count(name: str, dtype: torch.dtype = torch.float32) -> None:
    """One launch of ``name`` (the ``<kernel>_launches`` counter) with
    operands of ``dtype``."""
    key = (name[:-len("_launches")], str(dtype).replace("torch.", ""))
    with _count_lock:
        globals()[name] += 1
        _by_dtype[key] = _by_dtype.get(key, 0) + 1


#: the CUDA kernel that each wrapper's launch starts with (K3 and K5 may
#: add a reduce kernel after it): a CUDA graph's replay runs the launches
#: its capture recorded without any wrapper, so a replay's launches are
#: counted from a profiler's kernel events by these names
#: (:func:`launches_in`)
LAUNCH_KERNELS = {"norm_act_fwd": ("norm_act_vec_kernel",
                                   "norm_act_scalar_kernel"),
                  "norm_act_bwd": ("norm_act_bwd_partial_kernel",),
                  "conv_gemm": ("conv_gemm_kernel", "conv_gemm16_kernel"),
                  "linear": ("linear_kernel",),
                  "flash_attn": ("flash_attn_kernel",),
                  "roi_pool": ("roi_pool_fwd_kernel", "roi_pool_bwd_kernel"),
                  "crop_norm": ("crop_norm_kernel",)}
_LAUNCH_RE = {wrapper: re.compile(r"\b(%s)[<(]" % "|".join(names))
              for wrapper, names in LAUNCH_KERNELS.items()}


def launches_in(kernel_names) -> dict:
    """The launches of each compiled kernel's wrapper among the names of
    the CUDA kernels that ran (a profiler's device events, one name a
    kernel run), by :data:`LAUNCH_KERNELS`."""
    out = dict.fromkeys(LAUNCH_KERNELS, 0)
    for name in kernel_names:
        for wrapper, pattern in _LAUNCH_RE.items():
            if pattern.search(name):
                out[wrapper] += 1
    return out


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(fn: str, *tensors: torch.Tensor,
                contiguous: bool = True) -> None:
    """Every tensor on one CUDA device and, unless told otherwise,
    contiguous."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise MXNetError("%s: unsupported device %s" % (fn, dev))
    for t in tensors:
        if t.device != dev:
            raise MXNetError("%s: tensors on %s and %s" % (fn, dev, t.device))
        if contiguous and not t.is_contiguous():
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
        raise MXNetError("%s: dtype %s not supported (float32, bfloat16, "
                         "float16)"
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
    from .. import _build, autotune

    lib = _build.load("norm_act")
    rows = x.numel() // c
    # the grid cap: the autotuner's where it is on and holds one, else 0
    # (the kernel's own)
    cap = autotune.norm_fwd_blocks(rows, c, x.dtype, x.device) or 0
    with torch.cuda.device(x.device):
        rc = lib.norm_act_fwd(x.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                              y.data_ptr(), rows, c, _DTYPES[x.dtype],
                              _ACTS[act], cap, _stream(x))
    if rc != 0:
        raise MXNetError("norm_act_fwd launch failed: CUDA error %d" % rc)
    _count("norm_act_fwd_launches", x.dtype)
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
    from .. import _build, autotune

    lib = _build.load("norm_act")
    with torch.cuda.device(x.device):
        # the row blocks (the partials' count and so the sums' order): the
        # autotuner's where it is on and holds one, else the kernel's rule
        blocks = (autotune.norm_bwd_row_blocks(rows, c, x.dtype, x.device)
                  or lib.norm_act_bwd_row_blocks(rows, c))
        partial = torch.empty((blocks, 2, c), dtype=torch.float32,
                              device=x.device)
        rc = lib.norm_act_bwd(x.data_ptr(), scale.data_ptr(),
                              shift.data_ptr(), g.data_ptr(), dx.data_ptr(),
                              dscale.data_ptr(), dshift.data_ptr(),
                              partial.data_ptr(), rows, c, blocks,
                              _DTYPES[x.dtype], _ACTS[act], _stream(x))
    if rc != 0:
        raise MXNetError("norm_act_bwd launch failed: CUDA error %d" % rc)
    _count("norm_act_bwd_launches", x.dtype)
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
    over the last axis of a channels-last ``x`` (float32, bfloat16 or
    float16;
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
    for bfloat16 and float16, so the products are exact and the sum is
    float32."""
    a = a.float()
    return (a.t() if transpose_a else a) @ b.float()


def pitched16(t: torch.Tensor) -> torch.Tensor:
    """A 2-D 16-bit ``t``'s values in fresh memory at a pitch of a
    multiple of 8 elements, as a ``(rows, cols)`` view: what the 16-bit
    mainloop reads in place (the pad is never read)."""
    rows, cols = t.shape
    pitch = max(-(-cols // 8) * 8, 8)
    out = t.new_empty((rows, pitch))[:, :cols]
    out.copy_(t)
    return out


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor,
                  transpose_a: bool = False) -> torch.Tensor:
    """``a @ b``, or ``a.T @ b`` with ``transpose_a`` (the transpose is
    folded into the kernel's tile loads, never materialised), for 2-D
    float32, bfloat16 or float16 operands of one dtype; float32 result.

    On CUDA tensors: launches ``conv_gemm`` (any M, N and K; float32
    operands, contiguous, take the 3xTF32 mainloop; 16-bit ones the
    Hopper mainloop, which reads row-major operands at any pitch of a
    multiple of 8 elements, as :func:`_patches` writes them) or raises. A
    16-bit operand it cannot read in place (a contiguous one whose rows
    are not a multiple of 8 elements, a misaligned start) is copied first
    by :func:`pitched16`, counted in ``conv_gemm_pad_copies``. On CPU
    tensors: :func:`matmul_f32acc_plain`."""
    if a.dim() != 2 or b.dim() != 2:
        raise MXNetError("matmul_f32acc: operands must be 2-D, got %s and %s"
                         % (tuple(a.shape), tuple(b.shape)))
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise MXNetError("matmul_f32acc: operands must both be float32, "
                         "both bfloat16 or both float16, got %s and %s"
                         % (a.dtype, b.dtype))
    k, m = a.shape if transpose_a else (a.shape[1], a.shape[0])
    if b.shape[0] != k:
        raise MXNetError("matmul_f32acc: inner dimensions differ: %s%s @ %s"
                         % (tuple(a.shape), ".T" if transpose_a else "",
                            tuple(b.shape)))
    n = b.shape[1]
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_f32acc_plain(a, b, transpose_a)
    wide = a.dtype == torch.float32
    _check_cuda("matmul_f32acc", a, b, contiguous=wide)
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=a.device)
    if not wide:
        a, b = _in_place16(a), _in_place16(b)
    from .. import _build, autotune

    lib = _build.load("conv_gemm")
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        # the split-K chunk (and so the sum's order): the autotuner's where
        # it is on and holds one, else the kernel's rule
        chunk = (autotune.conv_k_chunk(m, n, k, a.dtype, transpose_a,
                                       a.device)
                 or (lib.conv_gemm_k_chunk if wide
                     else lib.conv_gemm16_k_chunk)(m, n, k))
        splits = -(-k // chunk)
        ws = (torch.empty((splits, m, n), dtype=torch.float32,
                          device=a.device) if splits > 1 else None)
        rc = lib.conv_gemm(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                           None if ws is None else ws.data_ptr(), m, n, k,
                           *((k if not transpose_a else m, n) if wide else
                             (a.stride(0), b.stride(0))),
                           int(bool(transpose_a)),
                           _DTYPES[a.dtype], chunk, splits, _stream(a))
    if rc != 0:
        raise MXNetError("conv_gemm launch failed: CUDA error %d" % rc)
    _count("conv_gemm_launches", a.dtype)
    global conv_gemm_flops
    with _count_lock:
        conv_gemm_flops += 2 * m * n * k
    return c


def _in_place16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the 16-bit mainloop reads it in place (TMA's
    conditions: unit column stride, a pitch of a multiple of 8 elements
    and at least the row, a 16-byte aligned start), else its
    :func:`pitched16` copy, counted."""
    global conv_gemm_pad_copies
    if (t.stride(1) == 1 and t.stride(0) % 8 == 0
            and t.stride(0) >= max(t.shape[1], 1)
            and t.data_ptr() % 16 == 0):
        return t
    with _count_lock:
        conv_gemm_pad_copies += 1
    return pitched16(t)


def _patches(x, kh, kw, stride, dilate, out_hw):
    """im2col over an already padded NHWC tensor: (N, Hp, Wp, C) ->
    (N*HO*WO, KH*KW*C), minor order (kh, kw, c), taps ``dilate`` apart
    (``pallas_kernels.py:368-387``). One strided view and one copy; a 1x1
    stride-1 window over a contiguous tensor is a view, no copy. In 16
    bits a row that is not a multiple of 8 elements (the stem's 7*7*3 =
    147, a 3x3 window over 3 channels) is written at a pitch of the next
    multiple of 8, a view whose pad is never read: the 16-bit mainloop
    reads it in place."""
    n, _, _, c = x.shape
    ho, wo = out_hw
    cols = kh * kw * c
    sn, sh, sw, sc = x.stride()
    win = x.as_strided((n, ho, wo, kh, kw, c),
                       (sn, sh * stride[0], sw * stride[1], sh * dilate[0],
                        sw * dilate[1], sc))
    if x.element_size() != 2 or cols % 8 == 0:
        return win.reshape(n * ho * wo, cols).contiguous()
    out = x.new_empty((n * ho * wo, -(-cols // 8) * 8))[:, :cols]
    out.view(n, ho, wo, kh, kw, c).copy_(win)
    return out


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
        rc = lib.linear_fwd(x.data_ptr(), w.data_ptr(),
                            None if b is None else b.data_ptr(),
                            out.data_ptr(), m, n, k, _LINEAR_ACTS[act], chunk,
                            -(-k // chunk), _stream(x))
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
    launches ``linear`` once at every shape (contiguous operands; a
    split K is summed inside that launch, across a thread block cluster)
    or raises; on CPU tensors it takes :func:`fused_linear_plain`."""
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
    """K2 on CUDA tensors, the plain version on CPU tensors. The kernel
    reads (B, T, H, D) by strides (any layout with a unit stride on D: a
    head slice or a transposed view goes in without a copy) and writes a
    contiguous (B, T, H, D) output."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal, scale)
    b, t, h, d = q.shape
    if b > 65535 or h > 65535:
        raise MXNetError("flash_attention: B = %d, H = %d; the kernel grid "
                         "takes at most 65535 of each" % (b, h))
    dev = q.device
    if dev.type != "cuda":
        raise MXNetError("flash_attention: unsupported device %s" % dev)
    for x in (k, v):
        if x.device != dev:
            raise MXNetError("flash_attention: tensors on %s and %s"
                             % (dev, x.device))
    for x in (q, k, v):
        if d > 1 and x.stride(3) != 1:
            raise MXNetError("flash_attention: the head dimension must have "
                             "stride 1, got strides %s" % (x.stride(),))
    o = torch.empty((b, t, h, d), dtype=torch.float32, device=dev)
    if o.numel():
        from .. import _build

        lib = _build.load("flash_attn")
        strides = (ctypes.c_longlong * 12)(*[
            x.stride(i) for x in (q, k, v, o) for i in (0, 1, 2)])
        with torch.cuda.device(dev):
            rc = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    o.data_ptr(), b, t, h, d, strides, scale,
                                    int(causal), _stream(q))
        if rc != 0:
            raise MXNetError("flash_attn launch failed: CUDA error %d" % rc)
        _count("flash_attn_launches")
    return o


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
    all B*H rows, reading any layout whose head dimension has stride 1,
    B and H up to 65535 each) or raises; on CPU tensors it takes
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


# ---------------------------------------------------------------------------
# roi_pool: ROIPooling's max over bins, a port-only kernel (the JAX package
# computes it in XLA, mxnet_tpu/ops/vision.py:28)
# ---------------------------------------------------------------------------
#: elements of the (rois, C, ph, pw, H, W) masked tensor one chunk of the
#: plain version builds (1 GiB in float32)
ROI_PLAIN_CHUNK_ELEMS = 1 << 28


def _roi_geometry(rois, n, h, w, pooled_size, spatial_scale, dtype):
    """Per roi: the image index (truncated toward zero, negative from the
    end, clamped, as a JAX gather indexes), int64 (R,), and the bins' row
    and column ranges ``[start, end)``, int32 (R, ph) x 2 and (R, pw) x 2.

    The edges follow the reference's arithmetic in the data's ``dtype``
    (``vision.py:55-76``), every operation rounded to it as JAX rounds
    it: ``round(roi * scale)``, ``y2 - y1 + 1``, the division by ``ph``,
    ``iy * bin_h``, the sum, ``floor``/``ceil``/``clip``; a row belongs
    to a bin where the dtype's ``arange`` of rows lies in its range, so
    an edge is the count of rows below it. The plain version's table;
    ``csrc/roi_pool.cu``'s ``roi_geom_kernel`` computes the same one on
    the card, operation for operation."""
    ph, pw = pooled_size
    dev = rois.device

    def const(v):
        # a fill on the device: a CUDA graph's capture allows no copy from
        # pageable host memory
        return torch.full((), v, dtype=dtype, device=dev)

    r = rois.to(dtype)
    b = r[:, 0].to(torch.int32)
    b = torch.where(b < 0, b + n, b).clamp(0, n - 1).long()
    # multiply and divide by tensors of the dtype: a Python number would
    # be applied in float32 (or, on the card, as a reciprocal), not as the
    # reference's dtype constant
    x1, y1, x2, y2 = (torch.round(r[:, k] * const(spatial_scale))
                      for k in (1, 2, 3, 4))
    one = const(1.0)
    bin_h = torch.maximum(y2 - y1 + one, one) / const(ph)
    bin_w = torch.maximum(x2 - x1 + one, one) / const(pw)
    iy = torch.arange(ph, dtype=dtype, device=dev)
    ix = torch.arange(pw, dtype=dtype, device=dev)
    lim_h, lim_w, zero = const(h), const(w), const(0.0)
    edges = (torch.floor(y1[:, None] + iy * bin_h[:, None]),
             torch.ceil(y1[:, None] + (iy + one) * bin_h[:, None]),
             torch.floor(x1[:, None] + ix * bin_w[:, None]),
             torch.ceil(x1[:, None] + (ix + one) * bin_w[:, None]))
    rows = torch.arange(h, dtype=dtype, device=dev)
    cols = torch.arange(w, dtype=dtype, device=dev)
    out = []
    for e, lim, grid in zip(edges, (lim_h, lim_h, lim_w, lim_w),
                            (rows, rows, cols, cols)):
        e = torch.minimum(torch.maximum(e, zero), lim)
        out.append((grid < e[..., None]).sum(-1, dtype=torch.int32))
    return (b,) + tuple(out)


def _roi_chunk(data, geom, lo, hi):
    """The reference's masked max for rois ``lo:hi``: every bin masks the
    whole map, ``torch.amax`` over (H, W) jointly (its VJP splits a tie
    equally over the tied positions, as JAX's max does), an empty or
    non-finite bin gives 0 and takes no gradient. A NaN is its bin's max
    under JAX's max, so a bin that holds one gives 0: the max runs over
    the map with its NaNs at -inf (amax's VJP would spread 0/0 over a
    NaN bin) and such bins are zeroed after."""
    b, ys, ye, xs, xe = (t[lo:hi] for t in geom)
    h, w = data.shape[2], data.shape[3]
    rows = torch.arange(h, dtype=torch.int32, device=data.device)
    cols = torch.arange(w, dtype=torch.int32, device=data.device)
    row_mask = (rows >= ys[..., None]) & (rows < ye[..., None])  # (r, ph, H)
    col_mask = (cols >= xs[..., None]) & (cols < xe[..., None])  # (r, pw, W)
    mask = row_mask[:, :, None, :, None] & col_mask[:, None, :, None, :]
    # index_select: its backward (index_add_) sums in a fixed order on the
    # CPU, where indexing's accumulating backward does not
    img = torch.index_select(data, 0, b)                         # (r, C, H, W)
    neg = torch.tensor(-math.inf, dtype=data.dtype, device=data.device)
    nan = torch.isnan(img)
    masked = torch.where(mask[:, None], torch.where(nan, neg, img)[
        :, :, None, None], neg)
    pooled = torch.amax(masked, dim=(-2, -1))                    # (r, C, ph, pw)
    # NaNs a bin holds: exact counts, as two small products over the masks
    nans = torch.einsum("rchw,rih,rjw->rcij", nan.float(), row_mask.float(),
                        col_mask.float())
    return torch.where(torch.isfinite(pooled) & (nans == 0), pooled,
                       torch.zeros((), dtype=data.dtype, device=data.device))


def _roi_chunk_rows(data, pooled_size):
    c, h, w = data.shape[1:]
    return max(1, ROI_PLAIN_CHUNK_ELEMS // max(1, c * pooled_size[0]
                                               * pooled_size[1] * h * w))


def roi_pool_plain(data: torch.Tensor, rois: torch.Tensor, pooled_size,
                   spatial_scale: float) -> torch.Tensor:
    """ROIPooling as the reference computes it (``vision.py:52-89``): the
    masked max over the whole map for each bin, in chunks of rois so that
    a chunk's mask stays under :data:`ROI_PLAIN_CHUNK_ELEMS` elements.
    Differentiable through autograd (which keeps every chunk's masked
    tensor: the CPU tests' sizes); :func:`roi_pool_plain_grad` is the
    bounded-memory gradient."""
    n, _, h, w = data.shape
    geom = _roi_geometry(rois, n, h, w, pooled_size, spatial_scale,
                         data.dtype)
    step = _roi_chunk_rows(data, pooled_size)
    parts = [_roi_chunk(data, geom, lo, lo + step)
             for lo in range(0, rois.shape[0], step)]
    if not parts:
        return data.new_zeros((0, data.shape[1]) + tuple(pooled_size))
    return torch.cat(parts)


def roi_pool_plain_grad(data: torch.Tensor, rois: torch.Tensor, g,
                        pooled_size, spatial_scale: float) -> torch.Tensor:
    """The gradient of :func:`roi_pool_plain` into ``data`` for the
    cotangent ``g``, one chunk of rois at a time (each chunk's graph is
    freed before the next), summed over the chunks in order."""
    n, _, h, w = data.shape
    geom = _roi_geometry(rois, n, h, w, pooled_size, spatial_scale,
                         data.dtype)
    step = _roi_chunk_rows(data, pooled_size)
    dx = torch.zeros_like(data)
    for lo in range(0, rois.shape[0], step):
        with torch.enable_grad():
            d = data.detach().requires_grad_()
            out = _roi_chunk(d, geom, lo, lo + step)
            dx += torch.autograd.grad(out, d, g[lo:lo + step])[0]
    return dx


def _roi_cuda(fn, data, rois, pooled_size, *more):
    """Checks for a launch; the rois in ``data``'s dtype, the int32
    scratch of the kernel's geometry table, and the size arguments."""
    _check_cuda(fn, data, rois, *more)
    for t in (data,) + more:
        if t.dtype not in _DTYPES:
            raise MXNetError("%s: dtype %s not supported (float32, bfloat16, "
                             "float16)" % (fn, t.dtype))
        if t.dtype != data.dtype:
            raise MXNetError("%s: tensors of %s and %s" % (fn, data.dtype,
                                                           t.dtype))
    n, c, h, w = data.shape
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    r = rois.shape[0]
    table = torch.empty(r * (1 + 2 * (ph + pw)), dtype=torch.int32,
                        device=data.device)
    return (rois.to(data.dtype).contiguous(), table,
            (n, c, h, w, r, ph, pw))


def roi_pool_fwd(data, rois, pooled_size, spatial_scale):
    """Launch ``roi_pool``'s forward on CUDA tensors (float32, bfloat16 or
    float16 ``data``): ``(out, count)``, the bins' maxima (R, C, ph, pw)
    in ``data``'s dtype and the count of positions tied for each (int32,
    0 for a bin that gives 0). The bins are computed on the card in
    ``data``'s dtype, as :func:`_roi_geometry` computes them."""
    rois, table, sizes = _roi_cuda("roi_pool", data, rois, pooled_size)
    out = torch.empty((rois.shape[0], data.shape[1]) + tuple(pooled_size),
                      dtype=data.dtype, device=data.device)
    count = torch.empty(out.shape, dtype=torch.int32, device=data.device)
    from .. import _build

    lib = _build.load("roi_pool")
    with torch.cuda.device(data.device):
        rc = lib.roi_pool_fwd(data.data_ptr(), rois.data_ptr(),
                              table.data_ptr(), out.data_ptr(),
                              count.data_ptr(), *sizes,
                              ctypes.c_float(spatial_scale),
                              _DTYPES[data.dtype], _stream(data))
    if rc != 0:
        raise MXNetError("roi_pool_fwd launch failed: CUDA error %d" % rc)
    _count("roi_pool_launches", data.dtype)
    return out, count


def roi_pool_bwd(data, rois, out, count, g, pooled_size, spatial_scale):
    """Launch ``roi_pool``'s backward on CUDA tensors: the gradient into
    ``data``, ``g / count`` (in ``data``'s dtype) to each position tied
    for its bin's max, summed in float32 in one fixed order (no atomics)
    and rounded to the dtype once."""
    rois, table, sizes = _roi_cuda("roi_pool", data, rois, pooled_size,
                                   out, g)
    _check_cuda("roi_pool", count)
    dx = torch.empty_like(data)
    from .. import _build

    lib = _build.load("roi_pool")
    with torch.cuda.device(data.device):
        rc = lib.roi_pool_bwd(data.data_ptr(), rois.data_ptr(),
                              table.data_ptr(), out.data_ptr(),
                              count.data_ptr(), g.data_ptr(), dx.data_ptr(),
                              *sizes, ctypes.c_float(spatial_scale),
                              _DTYPES[data.dtype], _stream(data))
    if rc != 0:
        raise MXNetError("roi_pool_bwd launch failed: CUDA error %d" % rc)
    _count("roi_pool_launches", data.dtype)
    return dx


class _ROIPool(torch.autograd.Function):
    """Forward and backward through ``roi_pool``'s two kernels; the rois
    take no gradient (the reference rounds them)."""

    @staticmethod
    def forward(ctx, data, rois, pooled_size, spatial_scale):
        out, count = roi_pool_fwd(data, rois, pooled_size, spatial_scale)
        ctx.geom = (pooled_size, spatial_scale)
        ctx.save_for_backward(data, rois, out, count)
        ctx.mark_non_differentiable(count)
        return out

    @staticmethod
    def backward(ctx, g):
        data, rois, out, count = ctx.saved_tensors
        dx = roi_pool_bwd(data, rois, out, count, g.contiguous(), *ctx.geom)
        return dx, None, None, None


def roi_pool(data: torch.Tensor, rois: torch.Tensor, pooled_size,
             spatial_scale: float) -> torch.Tensor:
    """ROIPooling of NCHW ``data`` over (R, 5) ``rois`` ``[batch_index,
    x1, y1, x2, y2]`` to (R, C, ph, pw), differentiable in ``data``.

    On CUDA tensors (float32, bfloat16 or float16, contiguous) the forward
    and the backward each launch one ``roi_pool`` kernel, or raise; on CPU
    tensors: :func:`roi_pool_plain` through autograd. The bins are
    computed in ``data``'s dtype on either path (:func:`_roi_geometry`)."""
    pooled_size = (int(pooled_size[0]), int(pooled_size[1]))
    if data.dim() != 4 or rois.dim() != 2 or rois.shape[1] != 5:
        raise MXNetError("roi_pool: data must be NCHW and rois (R, 5), got "
                         "%s and %s" % (tuple(data.shape), tuple(rois.shape)))
    if data.device.type == "cpu" and rois.device.type == "cpu":
        return roi_pool_plain(data, rois, pooled_size, spatial_scale)
    return _ROIPool.apply(data, rois, pooled_size, float(spatial_scale))


# ---------------------------------------------------------------------------
# crop_norm: the device feed's crop, mirror and normalisation, a port-only
# kernel (the JAX package jits it: mxnet_tpu/io_cache.py:455, :675,
# mxnet_tpu/fused_step.py:543)
# ---------------------------------------------------------------------------
_LAYOUTS = ("NCHW", "NHWC")


def _crop_shape(x, crop_hw, layout):
    if layout not in _LAYOUTS:
        raise MXNetError("crop_norm: layout must be NCHW or NHWC, got %r"
                         % (layout,))
    if x.dim() != 4 or x.dtype != torch.uint8:
        raise MXNetError("crop_norm: frames must be uint8 (B, H, W, C), got "
                         "%s %s" % (x.dtype, tuple(x.shape)))
    b, sh, sw, c = x.shape
    h, w = int(crop_hw[0]), int(crop_hw[1])
    if not (0 < h <= sh and 0 < w <= sw):
        raise MXNetError("crop_norm: crop %dx%d outside the %dx%d frames"
                         % (h, w, sh, sw))
    return (b, c, h, w) if layout == "NCHW" else (b, h, w, c)


def crop_normalize_plain(x, tops, lefts, mirror, mean, scale, crop_hw,
                         layout="NCHW"):
    """The plain version of :func:`crop_norm`, by index grids: each
    frame's crop at ``(top, left)`` (clamped into the frame, as
    ``dynamic_slice`` clamps), its columns reversed where ``mirror``,
    then ``(x - mean) * scale`` in float32 and the layout."""
    b, sh, sw, _ = x.shape
    h, w = int(crop_hw[0]), int(crop_hw[1])
    dev = x.device
    t = tops.to(dev, torch.long).clamp(0, sh - h)
    l = lefts.to(dev, torch.long).clamp(0, sw - w)
    cols = torch.arange(w, device=dev)
    ys = t[:, None] + torch.arange(h, device=dev)                # (B, h)
    xs = torch.where(mirror.to(dev, torch.bool)[:, None],
                     l[:, None] + (w - 1 - cols), l[:, None] + cols)
    crop = x[torch.arange(b, device=dev)[:, None, None], ys[:, :, None],
             xs[:, None, :]]                                     # (B, h, w, C)
    y = (crop.to(torch.float32) - mean.to(dev, torch.float32)) \
        * scale.to(dev, torch.float32).reshape(())
    return y.permute(0, 3, 1, 2).contiguous() if layout == "NCHW" else y


def crop_norm(x: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
              mirror: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
              crop_hw, layout: str = "NCHW",
              out: torch.Tensor = None) -> torch.Tensor:
    """uint8 frames ``x`` (B, SH, SW, C) -> float32 ``(x[b, t+y, l+x', c]
    - mean[c]) * scale`` of shape (B, C, h, w) (``layout`` NCHW) or (B, h,
    w, C) (NHWC), where ``x'`` runs backwards where ``mirror[b]``: the
    arithmetic of the JAX package's jitted augment, bit for bit.

    ``tops``/``lefts`` are int32 (B,), ``mirror`` bool or uint8 (B,),
    ``mean`` float32 (C,), ``scale`` float32 with one element; each is
    read from device memory, so a CUDA graph that holds the launch serves
    new values. ``out``, when given, is written in place (contiguous
    float32 of the result's shape) and returned.

    On CUDA tensors: launches ``crop_norm`` (one launch) or raises. On CPU
    tensors: :func:`crop_normalize_plain`."""
    shape = _crop_shape(x, crop_hw, layout)
    if tuple(tops.shape) != (shape[0],) or tuple(lefts.shape) != (shape[0],) \
            or tuple(mirror.shape) != (shape[0],):
        raise MXNetError("crop_norm: tops, lefts and mirror must be (%d,)"
                         % shape[0])
    if tuple(mean.shape) != (x.shape[3],) or scale.numel() != 1:
        raise MXNetError("crop_norm: mean must be (%d,) and scale one value, "
                         "got %s and %s" % (x.shape[3], tuple(mean.shape),
                                            tuple(scale.shape)))
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.float32):
        raise MXNetError("crop_norm: out must be float32 %s, got %s %s"
                         % (shape, out.dtype, tuple(out.shape)))
    args = (x, tops, lefts, mirror, mean, scale)
    if all(t.device.type == "cpu" for t in args):
        y = crop_normalize_plain(*args, crop_hw, layout)
        return y if out is None else out.copy_(y)
    _check_cuda("crop_norm", *args, *(() if out is None else (out,)))
    if tops.dtype != torch.int32 or lefts.dtype != torch.int32 \
            or mirror.dtype not in (torch.bool, torch.uint8) \
            or mean.dtype != torch.float32 or scale.dtype != torch.float32:
        raise MXNetError("crop_norm: tops/lefts int32, mirror bool or uint8, "
                         "mean/scale float32; got %s %s %s %s %s"
                         % (tops.dtype, lefts.dtype, mirror.dtype, mean.dtype,
                            scale.dtype))
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=x.device)
    from .. import _build

    lib = _build.load("crop_norm")
    b, sh, sw, c = x.shape
    with torch.cuda.device(x.device):
        rc = lib.crop_norm(x.data_ptr(), tops.data_ptr(), lefts.data_ptr(),
                           mirror.data_ptr(), mean.data_ptr(),
                           scale.data_ptr(), out.data_ptr(), b, sh, sw, c,
                           int(crop_hw[0]), int(crop_hw[1]),
                           int(layout == "NCHW"), _stream(x))
    if rc != 0:
        raise MXNetError("crop_norm launch failed: CUDA error %d" % rc)
    _count("crop_norm_launches", torch.uint8)
    return out
