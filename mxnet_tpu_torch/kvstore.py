"""KVStore, counterpart of the single-process stores of
``mxnet_tpu/kvstore.py``.

* ``local`` (also ``local_update_cpu`` and ``local_allreduce_cpu``): one
  process; ``push`` sums a key's list of values (one per device) and
  hands the sum to the updater, or stores it; ``pull`` copies the stored
  value out.
* ``device`` / ``tpu_sync`` (:class:`TPUSyncKVStore`, any name with
  ``device`` or ``tpu``): the same API; the sum of a list of per-card
  values lands on the first value's card, and ``pull`` copies the stored
  value to every card of the ``out`` list.
* ``device_sync`` (:class:`DeviceSyncKVStore`): one process over several
  cards with the gradient exchange inside the training step. The
  executor group sums every card's gradients into each card's copy after
  the backward (an all-reduce over one flat buffer a card), so the
  training path never pushes; ``fit`` takes the fused step by default
  under this store (``MXNET_TPU_DEVICE_SYNC_FUSED``).

* ``dist_sync`` (:class:`KVStoreDist`, any other name with ``dist``):
  several processes started by ``tools/launch.py``, one
  ``torch.distributed`` world (:mod:`.parallel.distributed`). ``init``
  broadcasts rank 0's values; ``push`` sums a key's local values, then
  every process's (one all-reduce over a flat buffer of the pushed keys,
  NCCL for card tensors), and runs the updater on the sum, on the device
  that holds the store's copy; ``pull`` copies the store's value out.
  Every process applies the same update to the same sum, so the copies
  stay equal with no server. Without a launcher it is a one-worker world
  and behaves as ``device_sync``.
* ``dist_async`` (:class:`KVStoreDistAsync`, a name with ``dist`` and
  ``async``): the host parameter server of :mod:`.parallel.ps`, which
  applies each push as it comes.

Every store but a ``dist`` one of several workers may be subsumed by the
fused step (``fused_step_compatible``).
"""
from __future__ import annotations

import pickle
from typing import Callable, Dict, List, Optional

import torch

from . import telemetry as _tel
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "TPUSyncKVStore", "DeviceSyncKVStore", "KVStoreDist",
           "KVStoreDistAsync", "create"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu")


def _key_list(key):
    return [key] if isinstance(key, (int, str)) else list(key)


def _val_list(value, nkeys):
    """Per key, the list of its per-device values."""
    if isinstance(value, NDArray):
        return [[value]]
    if not isinstance(value, (list, tuple)):
        raise MXNetError("invalid kvstore value type %s" % type(value))
    if all(isinstance(v, NDArray) for v in value):
        if nkeys == 1:
            return [list(value)]
        if len(value) != nkeys:
            raise MXNetError("value count must match key count")
        return [[v] for v in value]
    return [list(v) if isinstance(v, (list, tuple)) else [v] for v in value]


def _tree_sum(tensors):
    """The balanced pairwise tree sum of the JAX package's ``_tree_sum``
    (pairs in order, an odd last one carried up), so that both packages
    add in the same order."""
    xs = list(tensors)
    while len(xs) > 1:
        half, odd = divmod(len(xs), 2)
        paired = [xs[2 * i] + xs[2 * i + 1] for i in range(half)]
        if odd:
            paired.append(xs[-1])
        xs = paired
    return xs[0]


class KVStore:
    """The single-process store."""

    def __init__(self, kv_type: str = "local"):
        self._type = kv_type
        self._store: Dict = {}
        self._updater: Optional[Callable] = None

    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    @property
    def fused_step_compatible(self) -> bool:
        """True where the fused train step may subsume this store's
        gradient aggregation: every single-process store, whose exchange
        the executor group runs inside the step."""
        return "dist" not in self._type

    @property
    def in_jit_gradient_exchange(self) -> bool:
        """True for a store that asks for the fused step by default
        (``device_sync``)."""
        return False

    def init(self, key, value):
        keys = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys))):
            if k in self._store:
                raise MXNetError("key %s already initialized" % k)
            self._store[k] = vlist[0].copyto(vlist[0].context)

    def _reduce(self, vlist: List[NDArray]) -> NDArray:
        """The sum of a key's per-device values, on the first value's
        device, added in the JAX package's tree order."""
        if len(vlist) == 1:
            return vlist[0]
        dev = vlist[0].handle.device
        return NDArray(_tree_sum([v.handle.to(dev) for v in vlist]),
                       vlist[0].context)

    def push(self, key, value, priority: int = 0):
        keys = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys))):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % k)
            merged = self._reduce(vlist)
            if self._updater is not None:
                self._updater(k, merged, self._store[k])
            else:
                self._store[k][:] = merged

    def pull(self, key, out=None, priority: int = 0):
        if out is None:
            raise MXNetError("pull requires out")
        keys = _key_list(key)
        for k, olist in zip(keys, _val_list(out, len(keys))):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % k)
            for o in olist:
                o[:] = self._store[k]

    def set_updater(self, updater: Callable):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on each push. With several workers it must
        pickle (the JAX package checks the same: every worker runs it, and
        ``dist_async`` ships it to the server)."""
        from .optimizer import get_updater

        if self.num_workers > 1:
            try:
                pickle.dumps(optimizer)
            except Exception as e:
                raise MXNetError("optimizer must be serializable for a "
                                 "dist kvstore: %s" % e) from e
        self.set_updater(get_updater(optimizer))

    # -- the dist controls ----------------------------------------------------
    def barrier(self):
        """Wait for every worker; a single process has none to wait
        for."""

    def send_command_to_servers(self, head: int, body: str):
        """The reference's command channel to the servers. No store here
        has a server tier that takes commands; a controller installed on
        the store (``_controller``) receives them in process, as in the
        JAX package."""
        controller = getattr(self, "_controller", None)
        if controller is not None:
            controller(int(head), body)

    def num_dead_node(self, node_id: int = 0) -> int:
        """Failed peers (``KVStore::get_num_dead_node``). A collective
        world has every process alive or has already failed (the launcher
        kills the job), so a reachable store reports 0."""
        return 0

    def set_barrier_before_exit(self, do_barrier: bool = True):
        """With ``do_barrier``, the interpreter's exit waits for every
        worker (an ``atexit`` hook, so that it runs once, at exit)."""
        import atexit

        if do_barrier and not getattr(self, "_exit_barrier", False):
            self._exit_barrier = True
            atexit.register(self._exit_barrier_hook)
        elif not do_barrier and getattr(self, "_exit_barrier", False):
            self._exit_barrier = False
            atexit.unregister(self._exit_barrier_hook)

    def _exit_barrier_hook(self):
        if getattr(self, "_exit_barrier", False):
            try:
                self.barrier()
            except (RuntimeError, MXNetError, OSError):
                pass    # a peer already gone: nothing left to wait for

    def _optimizer_updater(self):
        from .optimizer import Updater

        if not isinstance(self._updater, Updater):
            raise MXNetError("no optimizer set")
        return self._updater

    def save_optimizer_states(self, fname: str):
        """The updater's states to ``fname`` through a temporary file and
        a rename, so a crash mid-save leaves the old file whole."""
        from .checkpoint import atomic_write_bytes

        atomic_write_bytes(fname, self._optimizer_updater().get_states())

    def load_optimizer_states(self, fname: str):
        """States from ``fname`` into the updater, in place; a torn or
        foreign file raises naming it."""
        updater = self._optimizer_updater()
        with open(fname, "rb") as f:
            blob = f.read()
        try:
            updater.set_states(blob)
        except Exception as e:
            raise MXNetError("invalid optimizer-states file %s: %s "
                             "(partial/torn write?)" % (fname, e)) from e


class TPUSyncKVStore(KVStore):
    """``tpu_sync`` / ``device``: the reduce of a list of per-card values
    on the first value's card."""


class DeviceSyncKVStore(TPUSyncKVStore):
    """``device_sync``: one process over several cards with the gradient
    exchange inside the training step (the executor group's all-reduce
    after the backward). The store keeps the push/pull API for explicit
    use; ``fit`` under it asks for the fused step by default."""

    def __init__(self, kv_type: str = "device_sync"):
        super().__init__(kv_type)

    @property
    def in_jit_gradient_exchange(self) -> bool:
        return True

    def grad_reduce_sharding(self, mesh, param_sharding):
        """Where the exchanged gradient lands: on its param's placement
        (the executor group's ``param_sharding``: a reduce-scatter into
        the shards of an fsdp-sharded param, an all-reduce for a
        replicated one), the identity, as in the JAX package."""
        return param_sharding


def _flat_groups(tensors):
    """Positions of ``tensors`` grouped by (device, dtype), in order."""
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    return list(groups.values())


class KVStoreDist(KVStore):
    """``dist_sync``: several processes, one ``torch.distributed`` world.
    ``push`` sums a key's local values (several contexts of this
    process), then all-reduces across the processes, and the updater
    runs on the sum against the store's copy; every worker does the same
    on the same sum, so there is no server. The keys of a push are summed
    as one flat buffer a (device, dtype), one collective each. ``init``
    broadcasts rank 0's values the same way, and the store's copies are
    views of the broadcast buffers."""

    def __init__(self, kv_type: str = "dist_sync"):
        super().__init__(kv_type)
        from .parallel import distributed

        distributed.init_distributed()
        self._dist = distributed

    @property
    def rank(self) -> int:
        return self._dist.rank()

    @property
    def num_workers(self) -> int:
        return self._dist.num_workers()

    @property
    def fused_step_compatible(self) -> bool:
        """A one-worker world has no exchange between processes, so the
        fused step subsumes it as it does ``device_sync``'s."""
        return self.num_workers <= 1

    @property
    def in_jit_gradient_exchange(self) -> bool:
        """A one-worker world asks for the fused step, as
        ``device_sync`` does."""
        return self.num_workers <= 1

    @property
    def fused_fallback(self):
        """``(reason, detail)`` of the fused step's refusal with several
        workers (the JAX package's fallback reason; the port raises)."""
        if self.num_workers <= 1:
            return None
        return ("dist_host_exchange",
                "%s with %d workers all-reduces the gradients across "
                "processes (torch.distributed) and updates on the store "
                "between the backward and the next forward; the fused "
                "step's graph spans one process"
                % (self.type, self.num_workers))

    def grad_reduce_sharding(self, mesh, param_sharding):
        """As ``device_sync``'s (a one-worker world)."""
        return param_sharding

    def barrier(self):
        self._dist.barrier()

    def init(self, key, value):
        keys = _key_list(key)
        vals = _val_list(value, len(keys))
        for k in keys:
            if k in self._store:
                raise MXNetError("key %s already initialized" % k)
        copies = self._flat([vlist[0].handle for vlist in vals],
                            self._dist.broadcast)
        for k, vlist, t in zip(keys, vals, copies):
            self._store[k] = NDArray(t, vlist[0].context)

    def all_reduce(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sums of ``tensors`` over every process, as new tensors:
        views of one flat buffer a (device, dtype), summed by one
        collective. The inputs stay as they are."""
        return self._flat(tensors, self._dist.all_reduce)

    def _flat(self, tensors, fn):
        """Copies of ``tensors`` packed into one flat buffer a (device,
        dtype), ``fn`` run over each buffer with several workers, and the
        copies handed back as views of the buffers, in order."""
        out = [None] * len(tensors)
        with torch.no_grad():
            for group in _flat_groups(tensors):
                parts = [tensors[i] for i in group]
                flat = torch.cat([p.detach().reshape(-1) for p in parts])
                if self.num_workers > 1:
                    fn([flat])
                views = flat.split([p.numel() for p in parts])
                for i, p, v in zip(group, parts, views):
                    out[i] = v.view(p.shape)
        return out

    def push(self, key, value, priority: int = 0):
        keys = _key_list(key)
        vals = _val_list(value, len(keys))
        for k in keys:
            if k not in self._store:
                raise MXNetError("key %s not initialized" % k)
        summed = self.all_reduce([self._reduce(vlist).handle
                                  for vlist in vals])
        if _tel.enabled():
            _tel.inc("kvstore.push", len(keys))
            _tel.inc("kvstore.push_bytes",
                     sum(t.numel() * t.element_size() for t in summed))
        self._update(keys, [NDArray(t, self._store[k].context)
                            for k, t in zip(keys, summed)])

    def _update(self, keys, sums):
        """The updater on each key's sum against the store's copy (one
        multi-tensor update for an optimizer's), or the sum stored."""
        from .optimizer import Updater

        if isinstance(self._updater, Updater):
            self._updater.update_multi(
                [(k, g, self._store[k]) for k, g in zip(keys, sums)])
            return
        for k, g in zip(keys, sums):
            if self._updater is not None:
                self._updater(k, g, self._store[k])
            else:
                self._store[k][:] = g


class KVStoreDistAsync(KVStore):
    """``dist_async``: the reference's asynchronous parameter server
    (``kvstore_dist_server.h:199-207``). The server applies each worker's
    push at once with its optimizer, with no aggregation across workers
    and no barrier a step, and ``pull`` returns the weights as they are
    then: workers run at their own pace on possibly stale weights.

    The control plane is TCP on the host (:mod:`.parallel.ps`). Rank 0
    hosts the server thread unless a server process
    (:mod:`mxnet_tpu_torch.kvstore_server`) owns the address; every rank
    is a client. Rank and size come from the launcher's environment."""

    def __init__(self, kv_type: str = "dist_async"):
        super().__init__(kv_type)
        import os

        from .parallel import ps

        self._rank = int(os.environ.get("MXTPU_WORKER_RANK", "0") or 0)
        self._size = int(os.environ.get("MXTPU_NUM_WORKERS", "1") or 1)
        host, port = ps.ps_address()
        self._server = None
        if self._rank == 0:
            try:
                self._server = ps.ParameterServer(host, port, self._size)
            except OSError:
                # the address is served already: a DMLC_ROLE=server
                # process owns the store, and rank 0 is a client
                self._server = None
        self._client = ps.PSClient(host, port)
        self._client.call("hello", self._rank)

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def num_workers(self) -> int:
        return self._size

    @property
    def fused_step_compatible(self) -> bool:
        return False

    @property
    def fused_fallback(self):
        return ("dist_async_host",
                "dist_async pushes and pulls through the host TCP "
                "parameter server (parallel/ps.py) between the backward "
                "and the next forward; asynchronous staleness has no "
                "collective in a graph")

    def init(self, key, value):
        """Rank 0's values become the server's (another rank's only where
        the key is new), then, after a barrier, every rank's arrays take
        the server's values."""
        keys = _key_list(key)
        vals = _val_list(value, len(keys))
        for k, vlist in zip(keys, vals):
            self._client.call("init", self._rank, k,
                              vlist[0].asnumpy().copy())
        self.barrier()
        for k, vlist in zip(keys, vals):
            synced = self._client.call("pull", k)
            for v in vlist:
                v[:] = synced

    def set_optimizer(self, optimizer):
        """Collective: every rank calls it. Rank 0 alone ships the
        pickled optimizer, which the server runs on each push; the
        barrier keeps other ranks from pushing before it lands."""
        self._optimizer = optimizer
        if self._rank == 0:
            self._client.call("set_optimizer", pickle.dumps(optimizer))
        self.barrier()

    def push(self, key, value, priority: int = 0):
        keys = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys))):
            merged = self._reduce(vlist).asnumpy().copy()
            if _tel.enabled():
                _tel.inc("kvstore.push")
                _tel.inc("kvstore.push_bytes", merged.nbytes)
            self._client.call("push", k, merged)

    def pull(self, key, out=None, priority: int = 0):
        if out is None:
            raise MXNetError("pull requires out")
        keys = _key_list(key)
        for k, olist in zip(keys, _val_list(out, len(keys))):
            cur = self._client.call("pull", k)
            if _tel.enabled():
                _tel.inc("kvstore.pull")
                _tel.inc("kvstore.pull_bytes", cur.nbytes * len(olist))
            for o in olist:
                o[:] = cur

    def barrier(self):
        self._client.call("barrier")

    def num_dead_node(self, node_id: int = 0) -> int:
        """Ranks that said hello and then lost every connection
        (``KVStore::get_num_dead_node``): a supervisor's signal to
        restart from a checkpoint."""
        return int(self._client.call("num_dead"))

    def close(self):
        """Leave (``bye``: a closed connection without it counts as a
        death), then on rank 0 stop the server, self-hosted or a server
        process, and close this side."""
        try:
            self._client.call("bye", self._rank)
        except (MXNetError, OSError, ConnectionError):
            pass
        if self._rank == 0:
            try:
                self._client.call("stop")
            except (MXNetError, OSError, ConnectionError):
                pass    # the server is gone already
        if self._server is not None:
            self._server.close()
        self._client.close()


def create(name: str = "local") -> KVStore:
    """A store by type name, routed as the JAX package routes it:
    ``device_sync``; any name with ``tpu`` or ``device``; any other with
    ``async`` (``dist_async``); any other with ``dist`` (``dist_sync``);
    the ``local`` names. With telemetry on, exported metrics are labelled
    with the store's rank."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    lname = name.lower()
    if lname == "device_sync":
        kv = DeviceSyncKVStore(lname)
    elif "tpu" in lname or "device" in lname:
        kv = TPUSyncKVStore(lname)
    elif "async" in lname:
        kv = KVStoreDistAsync(lname)
    elif "dist" in lname:
        kv = KVStoreDist(lname)
    elif lname in _LOCAL:
        kv = KVStore(lname)
    else:
        raise MXNetError("unknown kvstore type %s" % name)
    if _tel.enabled():
        from . import tracing as _tracing

        _tracing.set_worker_rank(kv.rank)
    return kv
