"""Graph executor, counterpart of ``mxnet_tpu/executor.py``.

Binding a Symbol yields an :class:`Executor` that evaluates the graph
node by node in topological order (:func:`make_graph_eval`, the same
walk and the same auxiliary-state slot order as the JAX package's
``make_graph_eval``). PyTorch runs eagerly, so there is nothing to
compile: each forward launches the ops' kernels on the current stream.

An inference forward runs under ``torch.inference_mode()``. A train
forward (``forward(is_train=True)``) records the autograd graph on
detached leaves of the bound arrays, ``requires_grad`` set where
``grad_req`` is not ``"null"``; ``backward`` runs autograd from the
heads (ones, or the given head gradients), writes or adds the
gradients into ``grad_arrays``, and only then commits the BatchNorm
moving statistics that the train forward computed, as the JAX package
commits them in its fused forward+backward (``executor.py:515-576``).

Model parallelism: bound with ``group2ctx`` (group name -> Context), a
node whose ``ctx_group`` attribute names a group runs on that group's
device, its inputs (and aux states) copied there; autograd copies the
gradients back along the same edges. Outputs come back to the bound
context.

Mixed precision (``compute_dtype``, default ``MXNET_COMPUTE_DTYPE``,
as ``executor.py:220-231, 326-369`` of the JAX package has it): every
floating argument but the labels is cast to the compute dtype
(bfloat16 or float16) on its way into the graph, and every floating
output is cast back to float32. The cast sits in the one graph function
that ``forward``, ``backward``, :meth:`Executor.run` (so ``FusedInfer``)
and the fused train step all evaluate, so they share the numerics.
Params, gradients and aux states stay float32: autograd through the
cast hands float32 gradients to the float32 leaves.

Several contexts (:class:`ReplicatedExecutor`, the executor group's):
one executor a context, walked in lock-step by one thread, the
BatchNorm statistics and the normalized losses over the global batch,
and the parameters' gradients summed across the replicas after the
backward.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import env as _env
from .base import MXNetError
from .context import Context
from .batch_layout import derive, follows_batch, join, part
from .ndarray import NDArray
from .ops.registry import OpContext

__all__ = ["Executor", "ReplicatedExecutor", "make_graph_eval",
           "remat_plan", "resolve_compute_dtype"]

#: the compute dtypes mixed precision takes, by the JAX package's names
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def make_graph_eval(symbol, node_device=None, remat=False, replicas=None,
                    node_apply=None, layouts=None):
    """The graph-eval function of a symbol: ``eval_graph(arg_list,
    aux_list, rng, is_train, internals=None) -> (outputs, new_aux)`` over
    tensors; a dict passed as ``internals`` receives every op output as
    ``"<node>_<output>"`` (the monitor's names). ``node_device(node)``,
    where given, names the device a node runs on (None: where its inputs
    are); its inputs and aux states are copied there. Returns
    ``(eval_graph, n_aux)``.

    ``replicas`` (:class:`~mxnet_tpu_torch.replicas.Replicas`) makes it
    the lock-step walk of a group bound over several contexts:
    ``arg_list``, ``aux_list`` and ``rng`` hold one entry a replica, each
    node runs once for all the replicas (its op's ``apply_replicas``, or
    ``apply`` replica by replica on its device), and the outputs and new
    aux states come back one list a replica (``internals`` get a list over
    the replicas a name). ``node_apply(node, octx, ins, aux)``, where
    given, runs first for every node of that walk and returns its
    ``(outputs, new aux)`` in the same form, or None to leave the node to
    the op (the tensor-parallel forward's split products,
    :mod:`mxnet_tpu_torch.parallel.tp_infer`). ``layouts`` (``{(node
    uid, output): layout or None}``, :func:`~mxnet_tpu_torch.batch_layout.
    derive`) gives each op's ``apply_replicas`` its inputs' batch
    layouts; without it every input's batch is its axis 0.

    ``remat=True`` is the mirrored backward (``MXNET_BACKWARD_DO_MIRROR``,
    the JAX package's segmented remat): the op nodes, in topological
    order, are cut into about sqrt(N) segments (:func:`remat_plan`) and
    each runs under ``torch.utils.checkpoint``, so a train forward keeps
    only the values that cross a segment boundary and the backward
    recomputes each segment's inside. A segment's recomputed moving
    statistics are discarded: the aux states come from the one forward.
    A random op runs outside the recomputed runs, its output kept, so
    its draw is made once. A call with ``internals``, or with gradients
    off, takes the plain walk. Over replicas a segment's recompute redoes
    its BatchNorms' cross-card sums (the values are those of the forward:
    the sums run in the same order on the same inputs), one recompute at
    a time (``Replicas.remat_lock``: autograd's device threads may ask for
    a segment together)."""
    nodes = symbol._topo()
    var_nodes = [n for n in nodes if n.is_variable]
    op_nodes = [n for n in nodes if not n.is_variable]
    aux_slots = {}
    slot = 0
    for n in op_nodes:
        k = len(n.op.list_auxiliary_states())
        if k:
            aux_slots[n.uid] = list(range(slot, slot + k))
            slot += k
    n_aux = slot
    out_index = [(n.uid, i) for n, i in symbol._outputs]

    def run_nodes(node_list, env, aux_out, octx, internals=None):
        """Evaluate ``node_list`` into ``env`` (uid -> outputs, indexed
        by output number) and ``aux_out``, in place."""
        for n in node_list:
            ins = [env[src.uid][i] for src, i in n.inputs]
            slots = aux_slots.get(n.uid, ())
            aux_in = [aux_out[s] for s in slots]
            if replicas is not None:
                done = (node_apply(n, octx, ins, aux_in)
                        if node_apply is not None else None)
                if done is None:
                    lays = None if layouts is None else [
                        layouts.get((src.uid, i)) for src, i in n.inputs]
                    try:
                        done = _apply_replicas(n.op, octx, ins, aux_in, lays)
                    except MXNetError as e:
                        raise MXNetError("node %s: %s" % (n.name, e)) \
                            from None
                outs, new_aux = done
            else:
                dev = node_device(n) if node_device is not None else None
                if dev is not None:
                    ins = [x.to(dev) for x in ins]
                    aux_in = [a.to(dev) for a in aux_in]
                outs, new_aux = n.op.apply(octx, ins, aux_in)
            for s, a in zip(slots, new_aux):
                aux_out[s] = a
            env[n.uid] = list(outs)
            if internals is not None:
                for name, o in zip(n.op.list_outputs(), outs):
                    internals["%s_%s" % (n.name, name)] = o

    if replicas is None:
        def octx_of(is_train, rng):
            return OpContext(is_train, rng)

        def by_slot(arg_list, aux_list):
            return list(arg_list), list(aux_list)

        def by_replica(outs, aux_out):
            return outs, aux_out
    else:
        def octx_of(is_train, rngs):
            replicas.begin()
            return [OpContext(is_train, r, replicas) for r in rngs]

        def by_slot(arg_list, aux_list):
            """Per replica lists -> per argument / aux slot lists over
            the replicas."""
            return ([list(v) for v in zip(*arg_list)],
                    [list(v) for v in zip(*aux_list)] if n_aux
                    else [])

        def by_replica(outs, aux_out):
            return ([list(v) for v in zip(*outs)],
                    [list(v) for v in zip(*aux_out)] if n_aux
                    else [[] for _ in range(replicas.n)])

    def eval_graph(arg_list, aux_list, rng, is_train, internals=None):
        args, aux_out = by_slot(arg_list, aux_list)
        env = {n.uid: [a] for n, a in zip(var_nodes, args)}
        run_nodes(op_nodes, env, aux_out, octx_of(is_train, rng),
                  internals)
        return by_replica([env[uid][i] for uid, i in out_index], aux_out)

    if not remat:
        return eval_graph, n_aux

    plans = remat_plan(symbol)
    lock = (replicas.remat_lock if replicas is not None
            else contextlib.nullcontext())

    def eval_graph_remat(arg_list, aux_list, rng, is_train, internals=None):
        if internals is not None or not torch.is_grad_enabled():
            return eval_graph(arg_list, aux_list, rng, is_train, internals)
        octx = octx_of(is_train, rng)
        args, aux_state = by_slot(arg_list, aux_list)
        store = {(n.uid, 0): a for n, a in zip(var_nodes, args)}
        for seg, in_keys, out_keys, recompute in plans:
            def seg_fn(in_vals, aux_vals, _seg=seg, _in=in_keys,
                       _out=out_keys):
                env = {}
                for (uid, i), v in zip(_in, in_vals):
                    env.setdefault(uid, {})[i] = v
                aux_out = list(aux_vals)
                with lock:
                    run_nodes(_seg, env, aux_out, octx)
                return [env[uid][i] for uid, i in _out], aux_out

            in_vals = [store[k] for k in in_keys]
            if recompute:
                # a recomputed run draws from no generator (its random
                # ops run outside it), so there is no RNG state to save,
                # which a CUDA-graph capture could not read
                out_vals, aux_state = checkpoint(
                    seg_fn, in_vals, aux_state, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                out_vals, aux_state = seg_fn(in_vals, aux_state)
            store.update(zip(out_keys, out_vals))
        return by_replica([store[k] for k in out_index], aux_state)

    return eval_graph_remat, n_aux


def _apply_replicas(op, ctxs, ins, aux_in, layouts=None):
    """One node over every replica: ``ins`` and ``aux_in`` hold a list
    over the replicas a slot, and so do the outputs and new aux states
    returned; ``layouts`` are the inputs' batch layouts (None: each
    input's batch is its axis 0)."""
    reps = ctxs[0].replicas
    ins_r = [[x[k] for x in ins] for k in range(reps.n)]
    aux_r = [[a[k] for a in aux_in] for k in range(reps.n)]
    fn = getattr(op, "apply_replicas", None)
    if fn is None:
        outs_r, aux_new_r = reps.each(op.apply, ctxs, ins_r, aux_r)
    else:
        outs_r, aux_new_r = fn(ctxs, ins_r, aux_r, layouts)
    return ([list(o) for o in zip(*outs_r)],
            [list(a) for a in zip(*aux_new_r)])


def remat_plan(symbol):
    """The mirrored backward's runs: ``[(nodes, in_keys, out_keys,
    recompute), ...]`` in order. The op nodes are cut as the JAX package
    cuts them (``max(2, isqrt(N))`` segments of ``ceil(N / segments)``
    nodes), then each random op (``Operator.draws_random``) becomes a run
    of its own that is not recomputed. ``in_keys`` are the ``(uid,
    output)`` values a run reads from outside it, ``out_keys`` those it
    makes that a later run or the graph's outputs consume, both
    sorted."""
    op_nodes = [n for n in symbol._topo() if not n.is_variable]
    out_index = [(n.uid, i) for n, i in symbol._outputs]
    n_seg = max(2, int(math.isqrt(len(op_nodes))))
    seg_size = max(1, (len(op_nodes) + n_seg - 1) // n_seg)
    runs = []
    for i in range(0, len(op_nodes), seg_size):
        cur = []
        for n in op_nodes[i:i + seg_size]:
            if n.op.draws_random:
                if cur:
                    runs.append((cur, True))
                runs.append(([n], False))
                cur = []
            else:
                cur.append(n)
        if cur:
            runs.append((cur, True))
    run_of = {n.uid: ri for ri, (run, _) in enumerate(runs) for n in run}
    consumed_later = [set() for _ in runs]
    for ri, (run, _) in enumerate(runs):
        for n in run:
            for src, i in n.inputs:
                src_run = run_of.get(src.uid, -1)   # -1: a variable
                if 0 <= src_run < ri:
                    consumed_later[src_run].add((src.uid, i))
    for uid, i in out_index:
        if run_of.get(uid, -1) >= 0:
            consumed_later[run_of[uid]].add((uid, i))
    plans = []
    for ri, (run, recompute) in enumerate(runs):
        in_keys = sorted({(src.uid, i) for n in run for src, i in n.inputs
                          if run_of.get(src.uid, -1) != ri})
        plans.append((run, in_keys, sorted(consumed_later[ri]), recompute))
    return plans


def grad_req_dict(grad_req, names) -> Dict[str, str]:
    """``grad_req`` (one string, a list in ``names`` order, or a dict by
    name whose missing names are ``"null"``) as a dict over ``names``."""
    if isinstance(grad_req, str):
        reqs = {n: grad_req for n in names}
    elif isinstance(grad_req, (list, tuple)):
        reqs = dict(zip(names, grad_req))
    else:
        reqs = {n: grad_req.get(n, "null") for n in names}
    bad = sorted({r for r in reqs.values()
                  if r not in ("write", "add", "null")})
    if bad:
        raise MXNetError("grad_req must be write, add or null, got %s" % bad)
    return reqs


_UNSET = object()   # compute_dtype not passed: read MXNET_COMPUTE_DTYPE


def resolve_compute_dtype(compute_dtype=_UNSET) -> Optional[torch.dtype]:
    """The torch dtype of ``compute_dtype``: ``MXNET_COMPUTE_DTYPE`` when
    not passed, None (float32) for an explicit None, else ``"bfloat16"``,
    ``"float16"`` or one of those torch dtypes. Any other value raises,
    naming the setting."""
    if compute_dtype is _UNSET:
        compute_dtype = _env.get("MXNET_COMPUTE_DTYPE")
    if compute_dtype is None:
        return None
    if isinstance(compute_dtype, torch.dtype):
        dtype = compute_dtype
    else:
        dtype = COMPUTE_DTYPES.get(str(compute_dtype))
    if dtype not in COMPUTE_DTYPES.values():
        raise MXNetError(
            "invalid compute dtype %r (MXNET_COMPUTE_DTYPE / "
            "compute_dtype); expected 'bfloat16' or 'float16'"
            % (compute_dtype,))
    return dtype


def _cast_graph(eval_graph, arg_names, label_names, dtype, replicas=None):
    """``eval_graph`` with its floating arguments, labels excepted, cast
    to ``dtype`` on the way in and its floating outputs cast to float32
    on the way out (the JAX package's ``_run_graph``); with ``replicas``,
    every replica's."""
    cast = [n not in label_names for n in arg_names]

    def cast_in(arg_list):
        return [a.to(dtype) if c and a.is_floating_point() else a
                for a, c in zip(arg_list, cast)]

    def cast_out(outs):
        return [o.float() if o.is_floating_point() else o for o in outs]

    def run_graph(arg_list, aux_list, rng, is_train, internals=None):
        if replicas is None:
            outs, aux = eval_graph(cast_in(arg_list), aux_list, rng,
                                   is_train, internals)
            return cast_out(outs), aux
        args = []
        for k, a in enumerate(arg_list):
            with replicas.on(k):
                args.append(cast_in(a))
        outs, aux = eval_graph(args, aux_list, rng, is_train, internals)
        cast = []
        for k, o in enumerate(outs):
            with replicas.on(k):
                cast.append(cast_out(o))
        return cast, aux

    return run_graph


class Executor:
    """A symbol bound to arrays on one device. ``args_grad`` (a list in
    ``list_arguments`` order or a dict by name, entries may be missing)
    holds the gradient arrays; ``grad_req`` is ``"write"``, ``"add"`` or
    ``"null"``, as one string, a list or a dict by name. An argument
    without a gradient array gets ``"null"``. ``group2ctx`` places the
    nodes of each ``ctx_group`` on that group's context;
    ``shared_exec`` is accepted and, as in the JAX package, shares
    nothing. ``compute_dtype`` (default: ``MXNET_COMPUTE_DTYPE``;
    None forces float32) runs the graph in bfloat16 or float16 with
    float32 params, gradients, aux states and outputs; ``label_names``
    (default: the arguments whose names end in ``label``) are never
    cast. ``MXNET_BACKWARD_DO_MIRROR``, read at bind (``mirror``),
    evaluates the graph as :func:`make_graph_eval`'s ``remat`` does."""

    def __init__(self, symbol, ctx: Context, args, args_grad=None,
                 grad_req="write", aux_states=None,
                 seed: Optional[int] = None, label_names=None,
                 group2ctx=None, shared_exec=None, compute_dtype=_UNSET):
        self._compute_dtype = resolve_compute_dtype(compute_dtype)
        self._group2ctx = dict(group2ctx or {})
        self._symbol = symbol
        # never cast; a plain bind falls back to the "*label" convention
        self._label_names = (list(label_names) if label_names is not None
                             else [n for n in symbol.list_arguments()
                                   if n.endswith("label")])
        self._ctx = ctx
        self._device = ctx.torch_device()
        self._seed = seed
        self._rng: Optional[torch.Generator] = None
        self.arg_names = symbol.list_arguments()
        if len(set(self.arg_names)) != len(self.arg_names):
            dups = sorted({n for n in self.arg_names
                           if self.arg_names.count(n) > 1})
            raise MXNetError(
                "duplicate argument name(s) %s: reuse one Variable "
                "instance instead of creating it twice" % dups)
        self.output_names = symbol.list_outputs()
        self.aux_names = symbol.list_auxiliary_states()
        self.arg_arrays = self._to_list(args, self.arg_names, "args")
        self.arg_dict = dict(zip(self.arg_names, self.arg_arrays))
        self.grad_arrays = self._to_list(args_grad or {}, self.arg_names,
                                         "args_grad", allow_missing=True)
        self.grad_dict = {n: g for n, g in zip(self.arg_names,
                                               self.grad_arrays)
                          if g is not None}
        reqs = grad_req_dict(grad_req, self.arg_names)
        self._grad_req = {n: reqs[n] if n in self.grad_dict else "null"
                          for n in self.arg_names}
        self.aux_arrays = self._to_list(aux_states or [], self.aux_names,
                                        "aux_states")
        self.aux_dict = dict(zip(self.aux_names, self.aux_arrays))
        node_device = None
        if self._group2ctx:
            group2dev = {g: c.torch_device()
                         for g, c in self._group2ctx.items()}

            def node_device(n):
                return group2dev.get(n.attrs.get("ctx_group"))
        #: MXNET_BACKWARD_DO_MIRROR at bind: the mirrored backward
        self.mirror = _env.get("MXNET_BACKWARD_DO_MIRROR")
        self._eval_graph, _ = make_graph_eval(symbol, node_device,
                                              remat=self.mirror)
        if self._compute_dtype is not None:
            self._eval_graph = _cast_graph(self._eval_graph, self.arg_names,
                                           set(self._label_names),
                                           self._compute_dtype)
        self._draws = self.draws_random()
        self._outputs: Optional[List[NDArray]] = None
        # the pending train forward: (heads, leaves by arg index, new aux)
        self._train = None
        self._monitor_callback: Optional[Callable] = None

    def _to_list(self, arrays, names, what, allow_missing=False):
        if isinstance(arrays, dict):
            out = [arrays.get(n) for n in names]
            missing = [n for n, a in zip(names, out) if a is None]
            if missing and not allow_missing:
                raise MXNetError("%s: missing arrays for %s"
                                 % (what, missing))
        else:
            out = list(arrays)
            if len(out) != len(names):
                raise MXNetError("%s: expected %d arrays, got %d"
                                 % (what, len(names), len(out)))
        for n, a in zip(names, out):
            if a is None and allow_missing:
                continue
            if not isinstance(a, NDArray):
                raise MXNetError("%s: '%s' must be an NDArray" % (what, n))
            if a.handle.device != self._device:
                raise MXNetError("%s: '%s' lives on %s, the executor on %s"
                                 % (what, n, a.context, self._ctx))
        return out

    # ------------------------------------------------------------------
    def _generator(self) -> torch.Generator:
        """The generator of the random ops (a train-mode Dropout, the
        sample ops), seeded with ``seed`` or, for an executor bound
        without one, at its first use from
        :mod:`mxnet_tpu_torch.random`'s stream, as the JAX package's
        executor takes its key."""
        if self._rng is None:
            if self._seed is None:
                from . import random as _random

                self._seed = _random.next_seed()
            self._rng = torch.Generator(device=self._device)
            self._rng.manual_seed(self._seed)
        return self._rng

    def draws_random(self) -> bool:
        """True where a forward draws from the executor's generator (a
        train-mode Dropout with p > 0, a sample op in either mode)."""
        return any(n.op.draws_random for n in self._symbol._topo()
                   if not n.is_variable)

    def run(self, arg_tensors, aux_tensors, is_train=False, internals=None):
        """Evaluate the graph on the given tensors without recording a
        graph (the fused inference step calls this with its packed
        params). An inference forward hands the ops the generator where
        the graph holds a random op (a sample op draws in either mode);
        a graph that draws nothing takes no seed."""
        rng = self._generator() if is_train or self._draws else None
        with torch.inference_mode():
            outs, _ = self._eval_graph(arg_tensors, aux_tensors, rng,
                                       is_train, internals)
        return self._home(outs)

    def _home(self, outs):
        """Outputs on the bound device (a placed node may leave them on
        its group's)."""
        if not self._group2ctx:
            return outs
        return [o.to(self._device) for o in outs]

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Run the forward pass; ``kwargs`` update named input arrays.
        ``is_train=True`` records the graph for :meth:`backward`."""
        for name, arr in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError("forward: unknown argument '%s'" % name)
            self.arg_dict[name][:] = arr
        self._train = None
        aux = [a.handle for a in self.aux_arrays]
        internals = {} if self._monitor_callback is not None else None
        if not is_train:
            outs = self.run([a.handle for a in self.arg_arrays], aux,
                            internals=internals)
        else:
            leaves = [a.handle.detach().requires_grad_(
                self._grad_req[n] != "null")
                for n, a in zip(self.arg_names, self.arg_arrays)]
            with torch.enable_grad():
                outs, new_aux = self._eval_graph(
                    leaves, aux, self._generator(), True, internals)
                outs = self._home(outs)
            self._train = (outs, leaves, new_aux)
        self._outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        for name, value in (internals or {}).items():
            self._monitor_callback(name, NDArray(value.detach(), self._ctx))
        return self._outputs

    def set_monitor_callback(self, callback: Callable[[str, NDArray], None]):
        """Call ``callback(name, array)`` on every op output of each
        forward, named ``"<node>_<output>"`` (a Monitor's
        ``stat_helper``)."""
        self._monitor_callback = callback

    def backward(self, out_grads=None):
        """Gradients of the heads of the last train forward into
        ``grad_arrays`` (by ``grad_req``), then the moving statistics
        into ``aux_arrays``. ``out_grads`` (an NDArray or a list, one per
        output) default to ones; SoftmaxOutput ignores its head
        gradient."""
        if self._train is None:
            raise MXNetError("backward called without forward(is_train=True)")
        outs, leaves, new_aux = self._train
        self._train = None
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            if len(out_grads) != len(outs):
                raise MXNetError("backward: %d head gradients for %d outputs"
                                 % (len(out_grads), len(outs)))
            heads = [g.handle.to(o.device, o.dtype)
                     for g, o in zip(out_grads, outs)]
        want = self._wanted()
        pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        grads = [None] * len(want)
        if want and pairs:
            grads = torch.autograd.grad([o for o, _ in pairs],
                                        [leaves[i] for i in want],
                                        [h for _, h in pairs],
                                        allow_unused=True)
        for i, g in zip(want, grads):
            self._write_grad(i, g)
        self._commit_aux(new_aux)

    def _wanted(self):
        """The argument indices with a gradient."""
        return [i for i, n in enumerate(self.arg_names)
                if self._grad_req[n] != "null"]

    def _write_grad(self, i, g):
        """Argument ``i``'s gradient ``g`` (None: unused) into its
        gradient array by its ``grad_req``."""
        dst = self.grad_arrays[i].handle
        if self._grad_req[self.arg_names[i]] == "add":
            if g is not None:
                dst.add_(g)
        else:
            self._grad_req_write(i, g, dst)

    @staticmethod
    def _grad_req_write(i, g, dst):
        """``dst`` becomes ``g``, or zeros where it is None."""
        if g is None:
            dst.zero_()
        else:
            dst.copy_(g)

    def _commit_aux(self, new_aux):
        for arr, new in zip(self.aux_arrays, new_aux):
            if new is not arr.handle:
                arr.handle.copy_(new)

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        """The dtype the graph computes in, None for float32."""
        return self._compute_dtype

    @property
    def outputs(self) -> List[NDArray]:
        if self._outputs is None:
            raise MXNetError("no forward has been run")
        return self._outputs

    # ------------------------------------------------------------------
    def copy_params_from(self, arg_params: Dict[str, NDArray],
                         aux_params: Optional[Dict[str, NDArray]] = None,
                         allow_extra_params: bool = False):
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                self.arg_dict[name][:] = arr
            elif not allow_extra_params:
                raise MXNetError("unknown param '%s'" % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name][:] = arr
            elif not allow_extra_params:
                raise MXNetError("unknown aux '%s'" % name)

    def reshape(self, partial_shaping: bool = False,
                allow_up_sizing: bool = False, fresh_args=(),
                **kwargs) -> "Executor":
        """Rebind to new input shapes. Each argument, gradient and aux
        array whose shape is unchanged is shared; the others are new
        zeros. ``grad_req``, the label names, the compute dtype and the
        seed carry over.
        Names in ``fresh_args`` always get new storage, so writes through
        the new executor cannot reach the old one's inputs."""
        from . import ndarray as nd

        fresh = set(fresh_args)
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args = []
        new_grads: Dict[str, NDArray] = {}
        for name, shape, arr, grad in zip(self.arg_names, arg_shapes,
                                          self.arg_arrays, self.grad_arrays):
            if shape == arr.shape and name not in fresh:
                new_args.append(arr)
                if grad is not None:
                    new_grads[name] = grad
            else:
                new_args.append(nd.zeros(shape, ctx=self._ctx,
                                         dtype=arr.handle.dtype))
                if grad is not None:
                    new_grads[name] = nd.zeros(shape, ctx=self._ctx,
                                               dtype=grad.handle.dtype)
        new_aux = [arr if shape == arr.shape
                   else nd.zeros(shape, ctx=self._ctx,
                                 dtype=arr.handle.dtype)
                   for shape, arr in zip(aux_shapes, self.aux_arrays)]
        return Executor(self._symbol, self._ctx, new_args, new_grads,
                        self._grad_req, new_aux, seed=self._seed,
                        label_names=self._label_names,
                        group2ctx=self._group2ctx,
                        compute_dtype=self._compute_dtype)

    def debug_str(self) -> str:
        """The graph, one node a line: name, op (``var`` for a variable)
        and the names of its inputs."""
        lines = ["Symbol outputs: %s" % self.output_names]
        for n in self._symbol._topo():
            kind = "var" if n.is_variable else n.op.op_name
            lines.append("  %-30s %s <- %s" % (
                n.name, kind, [src.name for src, _ in n.inputs]))
        return "\n".join(lines)


class ReplicatedExecutor:
    """The executors of a group bound over several contexts, run as one
    (ROADMAP.md Queue A item 10a): one :class:`Executor` a replica, each
    bound on its own device to an equal slice of the batch and to its own
    copy of every parameter, gradient and aux state. :meth:`forward`
    walks them in lock-step (``make_graph_eval``'s ``replicas``), under
    the executors' compute dtype and, on the CPU, the mirrored backward.
    :meth:`backward` runs one autograd pass over every replica's outputs,
    sums the gradients of ``exchange`` (the parameters) across the
    replicas into each replica's copy and commits each replica's moving
    statistics.

    ``flats`` hold, a replica, the flat buffers (one a dtype, in
    ``exchange`` order) of which those parameters' gradient arrays are
    views, so the exchange is one in-place cross-card sum a buffer; where
    a parameter's ``grad_req`` is "add", each pass's gradients are
    exchanged through a copy of that layout and then written or added.
    Input gradients are each replica's own slice's.

    ``shards`` (:class:`~mxnet_tpu_torch.replicas.ShardedParams`, the
    fsdp recipe) holds the parameters that are not in ``exchange`` but
    sharded: every forward first gathers their shards into each
    replica's full-width arrays, and every backward ends by reducing
    their gradients into each card's shard (a reduce-scatter); their
    full-width gradient arrays then hold the replica's own, unreduced
    gradients.

    ``inputs`` maps each data and label argument to its batch axis. From
    them every array of the graph gets its layout at bind
    (:func:`~mxnet_tpu_torch.batch_layout.derive`): how its rows follow
    the batch, along one axis or flattened with other axes (a time-major
    ``(T * N, C)`` output). :attr:`outputs` joins the replicas' slices of
    each output in the global order, and :meth:`backward` cuts each
    global head gradient the same way; an output that does not follow
    the batch (a value the cross-card form of an op made global) is the
    first replica's, and its head gradient goes to the first replica
    alone, as the gradients of the replicas' parameters are summed. An
    output whose layout cannot be derived raises, naming its node."""

    def __init__(self, execs, replicas, exchange, flats, inputs,
                 shards=None):
        ex0 = execs[0]
        if any(ex._group2ctx for ex in execs):
            raise MXNetError("group2ctx placement over several contexts: "
                             "the lock-step walk runs each replica's graph "
                             "on its own context; bind placed graphs on "
                             "one context")
        self.execs = list(execs)
        self.replicas = replicas
        #: each data and label argument's batch axis
        self.inputs = dict(inputs)
        self.arg_names = ex0.arg_names
        self.output_names = ex0.output_names
        self._exchange_names = list(exchange)
        self._exchange = [self.arg_names.index(n) for n in exchange]
        self._flats = flats
        self.shards = shards
        self._scratch = None
        local = {name: tuple(ex0.arg_dict[name].shape) for name in inputs}
        whole = {}
        for name, axis in inputs.items():
            shape = list(local[name])
            shape[axis] *= replicas.n
            whole[name] = tuple(shape)
        symbol = ex0._symbol
        layouts = derive(symbol, local, whole, self.inputs, replicas.n)
        self._out_layouts = [(node.name, layouts[(node.uid, i)])
                             for node, i in symbol._outputs]
        internals = symbol.get_internals()
        self._internal_layouts = dict(zip(
            internals.list_outputs(),
            [(node.name, layouts[(node.uid, i)])
             for node, i in internals._outputs]))
        #: every array's batch layout, by (node uid, output)
        self.layouts = layouts
        eval_graph, _ = make_graph_eval(
            symbol, remat=ex0.mirror, replicas=replicas, layouts=layouts)
        if ex0.compute_dtype is not None:
            eval_graph = _cast_graph(eval_graph, ex0.arg_names,
                                     set(ex0._label_names),
                                     ex0.compute_dtype, replicas)
        self._eval_graph = eval_graph
        self._train = None
        self._monitor_callback: Optional[Callable] = None

    def output_layout(self, i):
        """Output ``i``'s layout; raises where it cannot be derived."""
        name, layout = self._out_layouts[i]
        if layout is None:
            raise MXNetError(
                "output %s (node %s) over %d contexts: how its rows follow "
                "the batch cannot be derived from the graph, so its "
                "replicas' slices cannot be joined or given head gradients;"
                " read them with merge_multi_context=False, or bind it on "
                "one context" % (self.output_names[i], name,
                                 self.replicas.n))
        return layout

    def join_output(self, i, tensors, device=None) -> torch.Tensor:
        """Output ``i``'s parts (one a replica, or a batch shard) joined in
        the global order, on ``device`` (the first part's)."""
        return join(tensors, self.output_layout(i), device)

    @property
    def arg_arrays(self):
        """The first replica's arguments; a fsdp-sharded parameter's
        value joined from its master shards, since its bound array is
        the walk's workspace (the packed gradients after a backward)."""
        arrays = self.execs[0].arg_arrays
        if self.shards is None:
            return arrays
        return self._joined(arrays, self.shards.gather_value)

    @property
    def grad_arrays(self):
        """The first replica's gradients; a fsdp-sharded parameter's
        reduced gradient joined from its shards (its bound array holds
        the replica's own, and the gathered weights after a forward)."""
        arrays = self.execs[0].grad_arrays
        if self.shards is None:
            return arrays
        return self._joined(arrays, self.shards.gather_grad)

    def _joined(self, arrays, join):
        return [NDArray(join(n), arr.context)
                if arr is not None and n in self.shards.index else arr
                for n, arr in zip(self.arg_names, arrays)]

    def set_monitor_callback(self, callback: Callable[[str, NDArray], None]):
        """``callback(name, array)`` on every op output of each forward,
        the replicas' slices joined along its batch axis on the first
        replica's device (the first replica's, for an output that does
        not depend on the batch)."""
        self._monitor_callback = callback

    def forward(self, is_train: bool = False):
        execs = self.execs
        if self.shards is not None:
            self.replicas.begin()
            with torch.no_grad():
                self.shards.gather()
        aux = [[a.handle for a in ex.aux_arrays] for ex in execs]
        internals = {} if self._monitor_callback is not None else None
        self._train = None
        if not is_train:
            rngs = [ex._generator() if ex._draws else None for ex in execs]
            with torch.inference_mode():
                outs, _ = self._eval_graph(
                    [[a.handle for a in ex.arg_arrays] for ex in execs],
                    aux, rngs, False, internals)
        else:
            leaves = [[a.handle.detach().requires_grad_(
                ex._grad_req[n] != "null")
                for n, a in zip(ex.arg_names, ex.arg_arrays)]
                for ex in execs]
            with torch.enable_grad():
                outs, new_aux = self._eval_graph(
                    leaves, aux, [ex._generator() for ex in execs], True,
                    internals)
            self._train = (outs, leaves, new_aux)
        for ex, o in zip(execs, outs):
            ex._train = None
            ex._outputs = [NDArray(t.detach(), ex._ctx) for t in o]
        for name, values in (internals or {}).items():
            node, layout = self._internal_layouts[name]
            if layout is None:
                raise MXNetError("monitor: op output %s (node %s) over %d "
                                 "contexts: its layout cannot be derived"
                                 % (name, node, len(execs)))
            self._monitor_callback(name, NDArray(
                join([v.detach() for v in values], layout), execs[0]._ctx))

    def merge(self, tensors, axis: int) -> NDArray:
        """The replicas' slices of one array, joined along ``axis`` on the
        first replica's device."""
        ex0 = self.execs[0]
        return NDArray(torch.cat([t.to(ex0._device) for t in tensors],
                                 dim=axis), ex0._ctx)

    @property
    def outputs(self) -> List[NDArray]:
        """Every output over the whole batch, on the first replica's
        device, in the global order (raises for an output whose layout
        cannot be derived)."""
        per = [ex.outputs for ex in self.execs]
        ctx = self.execs[0]._ctx
        return [NDArray(self.join_output(i, [o[i].handle for o in per]),
                        ctx) for i in range(len(per[0]))]

    def backward(self, out_grads=None):
        """Every replica's gradients by ``grad_req``, the parameters'
        summed across the replicas, then the moving statistics. Head
        gradients (over the global batch) are cut into each replica's
        part by each output's layout; an output that does not follow the
        batch takes its head gradient (or ones) on the first replica
        alone: the cross-card op that made it whole carries it to the
        others, so a loss over it (MakeLoss, which ignores its head
        gradient) counts once."""
        if self._train is None:
            raise MXNetError("backward called without forward(is_train=True)")
        outs, leaves, new_aux = self._train
        self._train = None
        reps, execs = self.replicas, self.execs
        if out_grads is not None:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            if len(out_grads) != len(outs[0]):
                raise MXNetError("backward: %d head gradients for %d outputs"
                                 % (len(out_grads), len(outs[0])))
        layouts = [self.output_layout(i) if out_grads is not None
                   else self._out_layouts[i][1] for i in range(len(outs[0]))]
        want = execs[0]._wanted()
        ys, heads, xs = [], [], []
        for k in range(reps.n):
            with reps.on(k):
                for i, o in enumerate(outs[k]):
                    if not o.requires_grad:
                        continue
                    whole = layouts[i] is not None \
                        and not follows_batch(layouts[i])
                    if whole and k > 0:
                        continue
                    if out_grads is None:
                        h = torch.ones_like(o)
                    else:
                        g = out_grads[i].handle
                        if not whole:
                            g = part(g, layouts[i], k, reps.n)
                        h = g.to(o.device, o.dtype)
                    ys.append(o)
                    heads.append(h)
            xs.extend(leaves[k][i] for i in want)
        grads = [None] * len(xs)
        if want and ys:
            # on cards the whole backward runs on this thread: with one
            # autograd thread a card, a card's kernels and the first card's
            # thread's NCCL group call (a cross-card sum's backward) would
            # be launched into the same stream at once, which a fused
            # step's capture does not survive (segfaults on four H100s)
            single = (torch.autograd.set_multithreading_enabled(False)
                      if reps.cuda else contextlib.nullcontext())
            with single:
                grads = torch.autograd.grad(ys, xs, heads,
                                            allow_unused=True)
        # a grad_req="add" parameter accumulates: then this pass's
        # gradients are exchanged through a copy of the flat layout
        staged = any(execs[0]._grad_req[self.arg_names[i]] == "add"
                     for i in self._exchange)
        if staged and self._scratch is None:
            self._scratch = [[torch.empty_like(f) for f in flats]
                             for flats in self._flats]
        exchanged = set(self._exchange) if staged else ()
        # a fsdp-sharded parameter's full-width gradient is written: the
        # reduce adds it into the shard where its grad_req is "add"
        sharded = ({i for i, n in enumerate(self.arg_names)
                    if n in self.shards.index}
                   if self.shards is not None else ())
        for k, ex in enumerate(execs):
            g_k = grads[k * len(want):(k + 1) * len(want)]
            with reps.on(k):
                for i, g in zip(want, g_k):
                    if i in exchanged:
                        ex._grad_req_write(i, g, self._scratch_view(k, i))
                    elif i in sharded:
                        ex._grad_req_write(i, g, ex.grad_arrays[i].handle)
                    else:
                        ex._write_grad(i, g)
        # one in-place cross-card sum a flat buffer (or its copy)
        bufs = self._scratch if staged else self._flats
        for j in range(len(bufs[0])):
            if bufs[0][j].numel():
                reps.sum_([b[j] for b in bufs])
        if self.shards is not None:
            self.shards.reduce()
        for k, ex in enumerate(execs):
            with reps.on(k):
                for i in exchanged:
                    ex._write_grad(i, self._scratch_view(k, i))
                ex._commit_aux(new_aux[k])

    @property
    def flats(self):
        """A replica, its flat gradient buffers (one a dtype)."""
        return self._flats

    def _scratch_view(self, k, i):
        """Argument ``i``'s place in replica ``k``'s exchange copy: its
        gradient array's offset in its flat buffer."""
        g = self.execs[k].grad_arrays[i].handle
        for flat, scratch in zip(self._flats[k], self._scratch[k]):
            if g.untyped_storage().data_ptr() == \
                    flat.untyped_storage().data_ptr():
                off = g.storage_offset() - flat.storage_offset()
                return scratch[off:off + g.numel()].view_as(g)
        raise MXNetError("argument %s has no place in the exchange"
                         % self.arg_names[i])
