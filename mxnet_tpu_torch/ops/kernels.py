"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``. Each kernel has:

* a wrapper that launches the CUDA kernel for a CUDA tensor (or raises:
  there is no fallback on the card), and takes the plain version only
  for a tensor that lies on the CPU;
* the plain version, the same function in plain torch, used by the CPU
  tests and held against the kernel on the card by ``chip_smoke.py``;
* a launch count, a plain integer that the wrapper raises by one where it
  launches the kernel and nowhere else.

Ported so far: K4, the fused norm+act forward (``csrc/norm_act.cu``).
The other TPU kernels are listed in ROADMAP.md, Queue B.
"""
from __future__ import annotations

import threading

import torch

from ..base import MXNetError, TrainingNotPortedError

__all__ = ["fused_norm_act", "fused_norm_act_plain", "norm_act_fwd_launches",
           "reset_launch_counts", "launch_counts"]

#: kernel launches of norm_act_fwd since the last reset
norm_act_fwd_launches = 0
_count_lock = threading.Lock()

_ACTS = {"none": 0, "relu": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launch_counts() -> dict:
    """Every kernel's launch count, by kernel name."""
    return {"norm_act_fwd": norm_act_fwd_launches}


def reset_launch_counts() -> None:
    global norm_act_fwd_launches
    with _count_lock:
        norm_act_fwd_launches = 0


def fused_norm_act_plain(x: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor, act: str = "none"):
    """``act(x * scale + shift)`` over the last (channel) axis, math in
    float32, cast back to ``x.dtype``: the JAX kernel's arithmetic
    (``pallas_kernels.py:587-592``) in plain torch."""
    y = x.float() * scale.float() + shift.float()
    if act == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)


def fused_norm_act(x: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, act: str = "none") -> torch.Tensor:
    """``act(x * scale + shift)`` with per-channel ``scale``/``shift``
    over the last axis of a channels-last ``x`` (float32 or bfloat16;
    any rank; any row and channel count). ``scale`` and ``shift`` are
    widened to float32 before the math, as the JAX wrapper does
    (``pallas_kernels.py:684-685``).

    On a CUDA tensor: launches ``norm_act_fwd`` or raises. On a CPU
    tensor: :func:`fused_norm_act_plain`. Forward only: a call that
    autograd would have to differentiate raises
    :class:`TrainingNotPortedError`."""
    global norm_act_fwd_launches
    if act not in _ACTS:
        raise MXNetError("fused_norm_act: act must be one of %s, got %r"
                         % (sorted(_ACTS), act))
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or shift.requires_grad):
        raise TrainingNotPortedError(
            "fused_norm_act has no backward yet: the norm+act backward "
            "kernel (K5) comes with the training slice, ROADMAP.md "
            "Queue B item 2")
    if x.device.type == "cpu":
        return fused_norm_act_plain(x, scale, shift, act)
    if x.device.type != "cuda":
        raise MXNetError("fused_norm_act: unsupported device %s" % x.device)
    c = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPES:
        raise MXNetError("fused_norm_act: dtype %s not supported (float32, "
                         "bfloat16)" % x.dtype)
    if not x.is_contiguous():
        raise MXNetError("fused_norm_act: x must be contiguous "
                         "channels-last, got strides %s" % (x.stride(),))
    if tuple(scale.shape) != (c,) or tuple(shift.shape) != (c,):
        raise MXNetError("fused_norm_act: scale/shift must be (%d,), got "
                         "%s and %s" % (c, tuple(scale.shape),
                                        tuple(shift.shape)))
    if scale.device != x.device or shift.device != x.device:
        raise MXNetError("fused_norm_act: scale/shift on %s/%s, x on %s"
                         % (scale.device, shift.device, x.device))
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    sc = scale.to(torch.float32).contiguous()
    sh = shift.to(torch.float32).contiguous()
    from .. import _build

    lib = _build.load("norm_act")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.norm_act_fwd(x.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                              y.data_ptr(), x.numel() // c, c,
                              _DTYPES[x.dtype], _ACTS[act], stream)
    if rc != 0:
        raise MXNetError("norm_act_fwd launch failed: CUDA error %d" % rc)
    with _count_lock:
        norm_act_fwd_launches += 1
    return y
