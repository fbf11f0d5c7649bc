"""The numerics plane: model-health statistics inside the fused train
step, NaN provenance and guarded training, counterpart of
``mxnet_tpu/numwatch.py``.

* A small float32 **stats pack** (one row a gradient-bearing parameter,
  in the executor's argument order, plus one model-level META row) in
  fixed storage that the fused step updates in place: per tensor the
  gradient's sum of squares, max-abs, nonfinite and zero counts, the
  weight's sum of squares and nonfinite count before the update, and
  the update's sum of squares. On a card :meth:`NumWatch.fold` runs
  inside the step's CUDA graph, so arming the plane adds no replay and
  no host sync. Each sum counts finite elements only.
* The pack reaches the host only every ``MXNET_TPU_NUMWATCH_EVERY_N``
  steps (:meth:`NumWatch.fetch`, one small device-to-host copy on the
  stream the replay ran on).
* **Provenance**: sticky ``first_bad_*`` columns hold the 1-based step
  at which each tensor's weights or gradients first went nonfinite, so
  a fetch names the first tensor to go bad (earliest step first; a bad
  weight before a bad gradient of the same step, since one backward
  fans a single NaN out to every gradient; then argument order).
* **Guarded training** (``MXNET_TPU_NUMWATCH_GUARD``): ``skip`` keeps
  the pre-step weights, optimizer states and metric sums, bit for bit,
  on a step whose gradients are not all finite, by a select on a device
  predicate (the fused step applies it); ``rollback`` restores the last
  healthy snapshot through the CheckpointManager when a fetch sees
  nonfinite weights. Both are counted and rate-limited.
* Fetched health feeds ``numwatch.*`` telemetry, the step-record
  extras the tracing detectors read, a bounded health ring the
  FlightRecorder dumps, and the :class:`~mxnet_tpu_torch.monitor.Monitor`
  facade.

Arming: ``MXNET_TPU_NUMWATCH=1``, or a default-stat ``Monitor``.
"""
from __future__ import annotations

import logging
import math
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from . import env as _env
from . import telemetry as _tel

_log = logging.getLogger(__name__)

__all__ = ["NumWatch", "NumericsError", "maybe_plane", "monitor_routable",
           "after_step", "health_rows", "COLS", "META"]

# -- stats-pack layout (as in the JAX package) --------------------------
# One (n_params + 1, NCOLS) float32 tensor. Rows 0..n-1 are the
# gradient-bearing parameters in argument order; the last row is META.
# first_bad_* hold the 1-based step at which the tensor first went
# nonfinite (0 = never); a float32 step count is exact up to 2^24.
COLS = ("g_sumsq", "g_maxabs", "g_nonfinite", "g_zero",
        "w_sumsq", "w_nonfinite", "upd_sumsq",
        "first_bad_param", "first_bad_grad")
(G_SUMSQ, G_MAXABS, G_NONFIN, G_ZERO,
 W_SUMSQ, W_NONFIN, UPD_SUMSQ, FB_PARAM, FB_GRAD) = range(len(COLS))
NCOLS = len(COLS)
META = ("step", "loss", "out_nonfinite", "skips")
(M_STEP, M_LOSS, M_OUT_NONFIN, M_SKIPS) = range(len(META))

# the last fetched health rows, process-wide: the FlightRecorder writes
# them into every dump (numwatch.jsonl)
_HEALTH_RING: deque = deque(maxlen=64)


class NumericsError(RuntimeError):
    """The rollback guard refused to go on: the model went nonfinite
    again inside the rollback cooldown."""


def health_rows() -> List[dict]:
    """The last fetched health rows (the crash dump's feed)."""
    return list(_HEALTH_RING)


def monitor_routable(mon) -> bool:
    """True for a ``Monitor`` whose statistic the pack expresses: the
    default ``norm(x)/sqrt(x.size)`` over weights and gradients."""
    return bool(getattr(mon, "pack_expressible", False))


def maybe_plane(names, sizes, monitor=None) -> Optional["NumWatch"]:
    """The plane over the parameters ``names`` (element counts
    ``sizes``) when ``MXNET_TPU_NUMWATCH`` is set or ``monitor`` is a
    routable Monitor (which is then attached), else None."""
    if monitor is not None and not monitor_routable(monitor):
        monitor = None
    if not _env.get("MXNET_TPU_NUMWATCH") and monitor is None:
        return None
    plane = NumWatch(names, sizes, monitor=monitor)
    if monitor is not None:
        monitor.attach_plane(plane)
    return plane


def after_step(plane: Optional["NumWatch"]):
    """The fit loop's per-batch entry point: one None check when the
    plane is off."""
    if plane is None:
        return None
    return plane.after_step()


def _flat(tensors):
    """The tensors' elements end to end as one float32 vector (one copy),
    so that each statistic is a few whole-vector kernels and one
    multi-tensor norm over its segments, not a kernel a tensor."""
    return torch.cat([t.reshape(-1).float() for t in tensors])


def _finite_only(x):
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


class NumWatch:
    """The numerics plane of one fused train step. :meth:`fold` runs in
    the step (inside its CUDA graph on a card) and returns the skip
    guard's predicate; :meth:`after_step` counts batches on the host and
    fetches the pack on the cadence."""

    def __init__(self, names, sizes, monitor=None):
        self.names = list(names)
        self.sizes = [max(int(s), 1) for s in sizes]
        self.n = len(self.names)
        guard = str(_env.get("MXNET_TPU_NUMWATCH_GUARD") or "")
        modes = {m.strip() for m in guard.split(",") if m.strip()}
        unknown = modes - {"skip", "rollback"}
        if unknown:
            raise ValueError(
                "MXNET_TPU_NUMWATCH_GUARD=%r: unknown action(s) %s "
                "(valid: skip, rollback)" % (guard, sorted(unknown)))
        self.skip_guard = "skip" in modes
        self.rollback_guard = "rollback" in modes
        self._every_n = max(1, int(_env.get("MXNET_TPU_NUMWATCH_EVERY_N")))
        self._max_skips = int(_env.get("MXNET_TPU_NUMWATCH_MAX_SKIPS"))
        self._cooldown = int(
            _env.get("MXNET_TPU_NUMWATCH_ROLLBACK_COOLDOWN"))
        self._monitor = monitor
        self._pack: Optional[torch.Tensor] = None
        self._copies = {}            # the other cards' packs, by card
        self._masks = {}             # card -> its counted rows (fsdp)
        self._folded = False         # a step has folded since the reset
        self._host_step = 0
        self._loss_available = False
        self._known_skips = 0
        self._rollbacks = 0
        self._last_body = None       # host copy of the last fetch
        self._last_prov = None
        self._ckpt = None
        self._last_rollback_step = None
        self._skip_cap_hit = False
        self._warned_no_ckpt = False

    # -- in the step ---------------------------------------------------------
    def device_pack(self, device, card=0) -> torch.Tensor:
        """The pack on ``device``, zeroed and placed there on first use;
        the same storage from then on (a captured graph writes it). Over
        several cards every card after the first (``card``) keeps a copy
        of its own; the first card's is the one the host reads."""
        if card == 0:
            if self._pack is None:
                self._pack = torch.zeros((self.n + 1, NCOLS),
                                         dtype=torch.float32, device=device)
            return self._pack
        if card not in self._copies:
            self._copies[card] = torch.zeros((self.n + 1, NCOLS),
                                             dtype=torch.float32,
                                             device=device)
        return self._copies[card]

    def stepped(self):
        """The host's note that a step folded (replays run no Python)."""
        self._folded = True

    def reset_pack(self):
        """Zero the pack (every card's copy) in place (after a rollback:
        the sticky stamps describe the abandoned timeline); the captured
        graph keeps writing the same storage."""
        for pack in [self._pack] + list(self._copies.values()):
            if pack is not None:
                pack.zero_()
        self._folded = False
        self._known_skips = 0
        self._last_body = None
        self._last_prov = None
        self._skip_cap_hit = False

    @staticmethod
    def partials(w_old, grads, w_new) -> torch.Tensor:
        """Each tensor's columns ``g_sumsq`` .. ``upd_sumsq`` (the pack's
        first seven) as one ``(len(grads), 7)`` float32 tensor: ``w_old``
        the weights before the update (a list, or their elements end to
        end in one float32 tensor), ``w_new`` after it."""
        numels = [g.numel() for g in grads]

        def per_tensor(flat, order):
            return torch.stack(torch._foreach_norm(flat.split(numels),
                                                   order))

        # x_safe != x exactly where x is NaN or Inf; an order-1 norm of a
        # 0/1 mask counts (exactly below 2^24 elements a tensor)
        g = _flat(grads)
        g_safe = _finite_only(g)
        g_nonfin = per_tensor((g_safe != g).float(), 1)
        g_zero = per_tensor((g == 0).float(), 1)
        g_sumsq = per_tensor(g_safe, 2) ** 2
        g_maxabs = per_tensor(g_safe, math.inf)
        w = w_old if isinstance(w_old, torch.Tensor) else _flat(w_old)
        w_safe = _finite_only(w)
        w_nonfin = per_tensor((w_safe != w).float(), 1)
        w_sumsq = per_tensor(w_safe, 2) ** 2
        upd_sumsq = per_tensor(_finite_only(_flat(w_new) - w), 2) ** 2
        return torch.stack([g_sumsq, g_maxabs, g_nonfin, g_zero, w_sumsq,
                            w_nonfin, upd_sumsq], dim=1)

    def _head(self, outs, labels):
        """The head's ``(NLL a row, rows, nonfinite count)``, float32:
        the NLL against the first label where the head is a 2-d
        probability output (the SoftmaxOutput family), else a 0-d zero
        (and 0 rows)."""
        out0 = outs[0] if outs else None
        lab0 = labels[0] if labels else None
        dev = next((t.device for t in (out0, lab0) if t is not None), None)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        self._loss_available = (out0 is not None and lab0 is not None
                                and out0.dim() == 2 and lab0.dim() == 1
                                and out0.is_floating_point())
        nll, rows = zero, zero
        if self._loss_available:
            p = out0.float()
            idx = lab0.long().clamp(0, p.shape[1] - 1)
            picked = p.gather(1, idx[:, None])[:, 0]
            nll = -torch.log(picked.clamp_min(1e-12))
            rows = torch.full((), float(nll.numel()), device=dev)
        out_nonfin = zero
        if out0 is not None and out0.is_floating_point():
            out_nonfin = (~torch.isfinite(out0)).sum().float()
        return nll, rows, out_nonfin

    def _finish(self, pack, part, loss, out_nonfin) -> torch.Tensor:
        """``part`` (:meth:`partials` over the whole arrays), the stamps
        and the META row into ``pack``; the skip guard's predicate."""
        n = self.n
        body = pack[:n]
        step_no = pack[n, M_STEP] + 1.0
        fb_p = torch.where((part[:, W_NONFIN] > 0) & (body[:, FB_PARAM] == 0),
                           step_no, body[:, FB_PARAM])
        fb_g = torch.where((part[:, G_NONFIN] > 0) & (body[:, FB_GRAD] == 0),
                           step_no, body[:, FB_GRAD])
        grads_ok = part[:, G_NONFIN].sum() == 0
        skips = pack[n, M_SKIPS]
        if self.skip_guard:
            skips = skips + (~grads_ok).float()
        meta = torch.stack([step_no, loss, out_nonfin, skips])
        body.copy_(torch.cat([part, fb_p[:, None], fb_g[:, None]], dim=1))
        pack[n, :len(META)].copy_(meta)
        return grads_ok

    def fold(self, w_old, grads, w_new, outs, labels) -> torch.Tensor:
        """Fold this step into the pack, in place and with no host sync:
        ``w_old`` the weights before the update (a list, or their
        elements end to end in one float32 tensor), ``w_new`` after it.
        Returns a 0-d bool tensor, True where every gradient is finite
        (the skip guard's predicate)."""
        pack = self.device_pack(grads[0].device)
        part = self.partials(w_old, grads, w_new)
        nll, _, out_nonfin = self._head(outs, labels)
        loss = nll.mean() if self._loss_available else nll
        return self._finish(pack, part, loss, out_nonfin)

    def _owned_mask(self, k, owned, device):
        """Card ``k``'s ``(n, 1)`` bool mask of the rows it counts,
        made at the first fold (a capture may not copy from the host)
        and kept."""
        mask = self._masks.get(k)
        if mask is None:
            mask = self._masks[k] = torch.tensor(
                [[bool(o)] for o in owned], device=device)
        return mask

    def fold_replicas(self, reps, cards, outs, labels, owned=None,
                      fsdp_groups=None):
        """The fold over the cards of a group bound over several contexts
        (inside the walk's streams, no host sync): ``cards`` holds, a
        card, its ``(w_old, grads, w_new)`` as :meth:`fold` takes them,
        over each parameter's rows that the card keeps (its shard where
        fsdp shards the parameter); ``outs`` and ``labels`` its slice of
        the batch. ``owned`` (a card, a bool a parameter; default all)
        says which rows a card counts: under fsdp a replicated parameter
        is counted once in each ``fsdp_groups`` line. Each card folds its
        partial statistics, the lines of ``fsdp_groups`` combine them in
        place (sums, and the max of the max-abs), and every card's head
        NLL, rows and nonfinite count are summed; then every card writes
        the same pack (the first card's is the one the host reads) and
        returns the same predicate. Returns the predicates, one a
        card."""
        heads, parts = [], []
        for k, (w_old, grads, w_new) in enumerate(cards):
            with reps.on(k):
                part = self.partials(w_old, grads, w_new)
                if owned is not None and not all(owned[k]):
                    part = torch.where(
                        self._owned_mask(k, owned[k], part.device), part,
                        0.0)
                parts.append(part.contiguous())
                nll, rows, out_nonfin = self._head(outs[k], labels[k])
                heads.append(torch.stack([nll.sum(), rows, out_nonfin]))
        if fsdp_groups is not None and len(fsdp_groups[0]) > 1:
            maxabs = []
            for k, part in enumerate(parts):
                with reps.on(k):
                    maxabs.append(part[:, G_MAXABS].contiguous())
            reps.sum_groups(parts, fsdp_groups)
            reps.extreme_(maxabs, groups=fsdp_groups)
            for k, (part, m) in enumerate(zip(parts, maxabs)):
                with reps.on(k):
                    part[:, G_MAXABS] = m
        reps.sum_(heads)
        oks = []
        for k, (part, head) in enumerate(zip(parts, heads)):
            with reps.on(k):
                loss = (head[0] / head[1].clamp_min(1.0)
                        if self._loss_available else head[0])
                oks.append(self._finish(self.device_pack(part.device, k),
                                        part, loss, head[2]))
        return oks

    # -- on the host ---------------------------------------------------------
    def bind_ckpt(self, manager):
        """The CheckpointManager the rollback guard restores through."""
        self._ckpt = manager

    def after_step(self):
        """Count the step; on the cadence fetch the pack and return the
        step-record extras (None on the other steps)."""
        self._host_step += 1
        if not self._folded or self._host_step % self._every_n:
            return None
        return self.fetch()

    def fetch(self):
        """The one device-to-host copy of the pack, on the current stream
        (the one the step ran on); telemetry, the health ring, provenance
        and the guards update from it."""
        if not self._folded:
            return None
        from .analysis import sanitizers as _san

        with _san.intentional_transfer():
            pack = self._pack.cpu().numpy()
        return self._ingest(pack)

    def _ingest(self, pack):
        n = self.n
        body = pack[:n]
        meta = pack[n]
        self._last_body = body
        grad_norm = float(np.sqrt(max(float(body[:, G_SUMSQ].sum()), 0.0)))
        nonfinite = int(body[:, G_NONFIN].sum() + body[:, W_NONFIN].sum())
        uw_max = 0.0
        for i in range(n):
            w_sq = float(body[i, W_SUMSQ])
            u_sq = float(body[i, UPD_SUMSQ])
            if w_sq > 0.0:
                uw_max = max(uw_max, math.sqrt(u_sq / w_sq))
        loss = float(meta[M_LOSS]) if self._loss_available else None
        skips = int(meta[M_SKIPS])
        self._last_prov = self._provenance(body)

        _tel.inc("numwatch.fetches")
        _tel.set_gauge("numwatch.grad_norm", grad_norm)
        _tel.set_gauge("numwatch.uw_max", uw_max)
        _tel.set_gauge("numwatch.nonfinite", float(nonfinite))
        if loss is not None:
            _tel.set_gauge("numwatch.loss", loss)
        d_skips = skips - self._known_skips
        if d_skips > 0:
            _tel.inc("numwatch.skipped_steps", d_skips)
        self._known_skips = skips

        extras = {"numwatch_grad_norm": grad_norm,
                  "numwatch_uw_max": uw_max,
                  "numwatch_nonfinite": nonfinite,
                  "numwatch_skips": skips,
                  "numwatch_rollbacks": self._rollbacks}
        if loss is not None:
            extras["numwatch_loss"] = loss
        if self._last_prov is not None:
            extras["numwatch_bad_tensor"] = self._last_prov[0]

        self._guard(body, meta, extras)

        _HEALTH_RING.append({
            "step": int(meta[M_STEP]), "host_step": self._host_step,
            "loss": loss, "grad_norm": grad_norm, "uw_max": uw_max,
            "nonfinite": nonfinite,
            "bad_tensor": (None if self._last_prov is None
                           else self._last_prov[0]),
            "skips": skips, "rollbacks": self._rollbacks})
        return extras

    def _provenance(self, body):
        """(name, kind, step) of the first tensor to go bad, or None."""
        best = None
        for i in range(self.n):
            for kind_rank, col, kind in ((0, FB_PARAM, "param"),
                                         (1, FB_GRAD, "grad")):
                s = float(body[i, col])
                if s <= 0:
                    continue
                key = (s, kind_rank, i)
                if best is None or key < best[0]:
                    best = (key, (self.names[i], kind, int(s)))
        return None if best is None else best[1]

    def provenance(self):
        """(name, kind, step) of the first tensor to go nonfinite, from
        the last fetch; None while the model is healthy."""
        return self._last_prov

    # -- guard actions -------------------------------------------------------
    def _guard(self, body, meta, extras):
        escalate = False
        skips = int(meta[M_SKIPS])
        if self.skip_guard and skips > self._max_skips \
                and not self._skip_cap_hit:
            self._skip_cap_hit = True
            _tel.inc("numwatch.skip_cap_exceeded")
            _log.error(
                "numwatch: skip guard dropped %d steps (cap %d): the model "
                "is not recovering%s", skips, self._max_skips,
                "; escalating to rollback" if self.rollback_guard else "")
            escalate = self.rollback_guard
        if not self.rollback_guard:
            return
        if self._ckpt is None:
            if not self._warned_no_ckpt:
                self._warned_no_ckpt = True
                _log.warning(
                    "numwatch: rollback guard armed but no "
                    "CheckpointManager is bound (set MXNET_TPU_CKPT_DIR or "
                    "call bind_ckpt); the guard is inert")
            return
        if float(body[:, W_NONFIN].sum()) > 0 or escalate:
            self._rollback(extras)
        else:
            # a clean fetch is the rollback target: persist it so the
            # guard never restores a poisoned periodic snapshot
            self._ckpt.save_now("healthy")

    def _rollback(self, extras):
        last = self._last_rollback_step
        if last is not None and self._host_step - last < self._cooldown:
            raise NumericsError(
                "numwatch: model nonfinite again %d steps after a rollback "
                "(cooldown %d); refusing to thrash the snapshot store: "
                "lower the lr or fix the data"
                % (self._host_step - last, self._cooldown))
        info = self._ckpt.rollback("numwatch")
        if info is None:
            _log.error("numwatch: rollback requested but the snapshot store "
                       "holds no restorable snapshot")
            return
        self._rollbacks += 1
        self._last_rollback_step = self._host_step
        _tel.inc("numwatch.rollbacks")
        self.reset_pack()
        extras["numwatch_rollback"] = True
        extras["numwatch_rollbacks"] = self._rollbacks
        _log.warning("numwatch: nonfinite params, rolled back to the last "
                     "healthy snapshot (saved at step %s); rollback #%d",
                     info.get("step"), self._rollbacks)

    def tensor_rows(self):
        """Per-tensor health dicts from the last fetch, argument order."""
        if self._last_body is None:
            return []
        body = self._last_body
        rows = []
        for i, name in enumerate(self.names):
            sz = self.sizes[i]
            w_sq = float(body[i, W_SUMSQ])
            u_sq = float(body[i, UPD_SUMSQ])
            rows.append({
                "name": name,
                "grad_l2": round(
                    math.sqrt(max(float(body[i, G_SUMSQ]), 0.0)), 6),
                "grad_maxabs": round(float(body[i, G_MAXABS]), 6),
                "nonfinite": int(body[i, G_NONFIN] + body[i, W_NONFIN]),
                "zero_frac": round(float(body[i, G_ZERO]) / sz, 4),
                "uw_ratio": (round(math.sqrt(u_sq / w_sq), 8)
                             if w_sq > 0 else 0.0),
                "first_bad": int(max(body[i, FB_PARAM],
                                     body[i, FB_GRAD]))})
        return rows

    # -- the monitor facade's feed -------------------------------------------
    def monitor_rows(self, re_prog, step):
        """The classic Monitor rows ``(step, name, stat)``, the default
        ``norm(x)/sqrt(x.size)`` of every weight (before the step's
        update) and its ``_grad`` twin matching ``re_prog``, from a fresh
        fetch of the pack."""
        self.fetch()
        if self._last_body is None:
            return []
        body = self._last_body
        rows = []
        for i, name in enumerate(self.names):
            sz = self.sizes[i]
            if re_prog.match(name):
                stat = math.sqrt(max(float(body[i, W_SUMSQ]), 0.0) / sz)
                rows.append((step, name, "%f" % stat))
            if re_prog.match(name + "_grad"):
                stat = math.sqrt(max(float(body[i, G_SUMSQ]), 0.0) / sz)
                rows.append((step, name + "_grad", "%f" % stat))
        return rows
