"""Fused inference step, counterpart of ``FusedInfer`` in
``mxnet_tpu/fused_step.py`` (single device; the mesh and tensor-parallel
parts wait for the distribution slice).

A :class:`FusedInfer` packs the bound executor's non-data arguments and
auxiliary states onto the device once, then serves each batch with one
call: place the batch on the device, run the forward and the argmax or
top-k under ``torch.inference_mode()``, and hand back device tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError

__all__ = ["make_fused_infer", "FusedInfer"]


def make_fused_infer(executor, data_names, top_k=0):
    """A :class:`FusedInfer` over a bound executor. ``data_names`` are
    the per-batch argument slots; every other argument is packed.
    ``top_k=0`` returns the raw outputs only, ``1`` adds the argmax over
    the last axis of the first output, ``>1`` its top-k values and
    indices."""
    return FusedInfer(executor, data_names, top_k=top_k)


class FusedInfer:
    """One call per batch. ``dispatches`` counts calls; ``compiles`` is
    the number of distinct batch shapes seen (PyTorch compiles nothing;
    the count mirrors the JAX package's, whose executable cache it
    bounds, and under the serving ladder it stays at most the number of
    buckets)."""

    def __init__(self, executor, data_names, top_k=0):
        self._ex = executor
        arg_pos = {n: i for i, n in enumerate(executor.arg_names)}
        missing = [n for n in data_names if n not in arg_pos]
        if missing:
            raise MXNetError("fused_infer data args %s not in the "
                             "executor's arguments" % (missing,))
        self._data_names = list(data_names)
        self._d_idx = [arg_pos[n] for n in data_names]
        self._p_idx = [i for i in range(len(executor.arg_names))
                       if i not in set(self._d_idx)]
        self._top_k = int(top_k)
        self._device = executor._device
        self._seen_sigs = set()
        self.dispatches = 0
        self.refresh_params()

    @property
    def compiles(self) -> int:
        return len(self._seen_sigs)

    def refresh_params(self):
        """(Re)pack the non-data arguments and auxiliary states: a copy
        on the device, so later writes to the executor's arrays reach
        serving only through this call (as with the JAX package)."""
        ex = self._ex
        self._param_vals = [ex.arg_arrays[i].handle.detach().clone()
                            for i in self._p_idx]
        self._aux_vals = [a.handle.detach().clone() for a in ex.aux_arrays]

    def place_batch(self, arrays):
        """Host arrays (or tensors) of one batch -> tensors on the
        device."""
        placed = []
        for a in arrays:
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(a))
            placed.append(a.to(self._device))
        return placed

    def __call__(self, arrays):
        """One batch -> ``(outputs, post)``: ``post`` is ``()`` for
        top_k=0, ``(argmax,)`` for top_k=1, ``(values, indices)``
        otherwise. Results stay on the device."""
        d_vals = self.place_batch(arrays)
        self._seen_sigs.add(tuple((tuple(v.shape), str(v.dtype))
                                  for v in d_vals))
        self.dispatches += 1
        full = [None] * len(self._ex.arg_names)
        for pos, i in enumerate(self._p_idx):
            full[i] = self._param_vals[pos]
        for pos, i in enumerate(self._d_idx):
            full[i] = d_vals[pos]
        outs = self._ex.run(full, self._aux_vals, is_train=False)
        post = ()
        head = outs[0] if outs else None
        if self._top_k and head is not None and head.dim() >= 2 \
                and head.is_floating_point():
            with torch.inference_mode():
                if self._top_k == 1:
                    post = (torch.argmax(head, dim=-1),)
                else:
                    post = tuple(torch.topk(head, self._top_k, dim=-1))
        return tuple(outs), post
