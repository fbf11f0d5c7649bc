"""Asynchronous parameter server, counterpart of
``mxnet_tpu/parallel/ps.py`` (the reference's ``dist_async``:
``kvstore_dist_server.h:199-207``: the server applies each worker's
push at once, with no aggregation across workers and no barrier;
workers pull whatever the weights are then).

The synchronous store (``dist_sync``) is a collective over
``torch.distributed``. Asynchronous semantics cannot ride a collective,
so this tier keeps the reference's architecture: a key-value server on
the host owns the weights and runs the (pickled) optimizer on each
push.

Transport: length-prefixed pickles over TCP on ``MXTPU_PS_PORT``
(default: the coordinator's port + 1). Rank 0 hosts the server thread
unless a server process owns the address; every worker (rank 0 too) is
a client. Gradients travel as host numpy arrays.

The server lives on the host: its weights are numpy, and its optimizer
runs on tensors it places on ``cpu()`` explicitly (the port's default
context is ``gpu(0)``, and a server process has no card).

Trust model: unpickling lets any peer that can connect run code, the
reference's trusted-cluster assumption. ``MXTPU_PS_SECRET`` (which
``tools/launch.py`` generates a job unless one is set) adds an
HMAC-SHA256 tag to every frame; a frame with a missing or wrong tag is
dropped before ``pickle.loads`` sees it, and the server refuses to
start without a secret unless ``MXTPU_PS_INSECURE=1``.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import pickle
import socket
import struct
import threading
import time

import numpy as np

from ..base import MXNetError

_LEN = struct.Struct("!Q")


_SECRET_CACHE = False      # False = unresolved; None/bytes = resolved


def _secret():
    # resolved once per process (the value is immutable for the job's
    # lifetime): _send_msg/_recv_msg call this on EVERY frame and the
    # file branch would otherwise re-read the secret file per push/pull
    global _SECRET_CACHE
    if _SECRET_CACHE is not False:
        return _SECRET_CACHE
    s = os.environ.get("MXTPU_PS_SECRET", "")
    if not s:
        # ssh-launched workers get the secret as a 0600 file in the
        # shared job dir (tools/launch.py) so it never appears on a
        # remote command line (/proc/*/cmdline is world-readable)
        path = os.environ.get("MXTPU_PS_SECRET_FILE", "")
        if path:
            try:
                with open(path) as f:
                    s = f.read().strip()
            except OSError:
                s = ""
    _SECRET_CACHE = s.encode() if s else None
    return _SECRET_CACHE


def _send_msg(sock, obj):
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    key = _secret()
    tag = hmac.new(key, payload, hashlib.sha256).digest() if key else b""
    sock.sendall(_LEN.pack(len(payload)) + tag + payload)


def _recv_exact(sock, n):
    # chunked: a hostile length prefix must not make one recv() call
    # allocate the whole claimed frame up front
    parts = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def _max_frame():
    return int(os.environ.get("MXTPU_PS_MAX_FRAME", 1 << 30))


def _recv_msg(sock):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > _max_frame():
        # refuse before allocating: an unauthenticated peer's length
        # prefix is the one field read ahead of the HMAC check
        raise ConnectionError("PS frame length %d exceeds cap %d"
                              % (n, _max_frame()))
    # once a frame has started, the rest must arrive promptly: a peer
    # whose framing disagrees with ours (e.g. MXTPU_PS_SECRET set on
    # one side only) would otherwise park both ends forever mid-frame
    old_timeout = sock.gettimeout()
    sock.settimeout(60.0)
    try:
        key = _secret()
        if key:
            tag = _recv_exact(sock, hashlib.sha256().digest_size)
            payload = _recv_exact(sock, n)
            if not hmac.compare_digest(
                    tag, hmac.new(key, payload, hashlib.sha256).digest()):
                raise ConnectionError("PS frame failed HMAC check")
            return pickle.loads(payload)
        return pickle.loads(_recv_exact(sock, n))
    except socket.timeout:
        raise ConnectionError(
            "PS frame stalled mid-read (framing mismatch? check that "
            "MXTPU_PS_SECRET agrees on every rank)")
    finally:
        sock.settimeout(old_timeout)


def ps_address():
    """host:port of the parameter server, derived from the coordinator
    rendezvous (reference: DMLC_PS_ROOT_URI/PORT set by the tracker)."""
    coord = os.environ.get("MXTPU_COORDINATOR", "127.0.0.1:12421")
    host, _, port = coord.partition(":")
    ps_port = int(os.environ.get("MXTPU_PS_PORT", int(port or 12421) + 1))
    return host or "127.0.0.1", ps_port


class ParameterServer:
    """The server role. Weights live here; pushes update them in place
    under a lock (per-push optimizer update = the async mode's defining
    behavior); pulls return the current values."""

    def __init__(self, host, port, num_workers):
        if _secret() is None \
                and os.environ.get("MXTPU_PS_INSECURE") != "1":
            # frame auth on by default: a server
            # accepting unauthenticated pickle frames is remote code
            # execution for anyone who can reach the port. launch.py
            # generates and stages a per-job secret automatically, so
            # normal jobs never hit this; opting out is explicit.
            raise MXNetError(
                "parameter server refuses to start without a frame "
                "secret: set MXTPU_PS_SECRET (tools/launch.py generates "
                "one per job automatically) or explicitly accept "
                "unauthenticated peers with MXTPU_PS_INSECURE=1")
        self.num_workers = num_workers
        self._store = {}
        self._opt = None
        self._opt_states = {}
        self._alive = {}          # rank -> live connection count
        self._seen = set()        # ranks that ever said hello
        from ..analysis import sanitizers as _san
        self._lock = _san.maybe_instrument(threading.Lock(), "ps-store")
        self._barrier_count = 0
        self._barrier_gen = 0
        self._barrier_cv = _san.maybe_instrument(threading.Condition(),
                                                 "ps-barrier")
        self._stop = threading.Event()
        self._closed = False
        self._serve_threads = []  # appended only by the accept thread
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        #: the port served (the OS's choice when ``port`` is 0)
        self.port = self._sock.getsockname()[1]
        self._sock.listen(max(8, 2 * num_workers))
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self):
        try:
            self._sock.settimeout(0.2)
        except OSError:
            return    # close() won the race to the listening socket
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # 0.5s poll timeout: an idle serve thread wakes to check
            # _stop instead of parking in recv() forever — what lets
            # close() join them with a bounded timeout
            conn.settimeout(0.5)
            th = threading.Thread(target=self._serve, args=(conn,),
                                  daemon=True)
            self._serve_threads = \
                [t for t in self._serve_threads if t.is_alive()] + [th]
            th.start()

    def _apply_push(self, key, grad):
        from ..context import cpu
        from ..ndarray import array as nd_array

        with self._lock:
            if key not in self._store:
                raise MXNetError("push to uninitialized key %r" % (key,))
            if self._opt is None:
                # reference DataHandle without an updater: assign
                self._store[key] = grad
                return
            # on the host, whatever the default context: the server has
            # no card
            weight = nd_array(self._store[key], ctx=cpu())
            gnd = nd_array(grad, ctx=cpu())
            if key not in self._opt_states:
                self._opt_states[key] = self._opt.create_state(key, weight)
            self._opt.update(key, weight, gnd, self._opt_states[key])
            # one push at a time under the store lock is the async
            # tier's semantics (the reference applies each push
            # atomically); a copy, since the CPU array shares the
            # tensor's memory
            self._store[key] = weight.asnumpy().copy()

    def _serve(self, conn):
        hello_rank = None
        try:
            while not self._stop.is_set():
                try:
                    msg = _recv_msg(conn)
                except socket.timeout:
                    continue    # idle poll tick: re-check _stop
                except (ConnectionError, OSError):
                    return
                except (pickle.UnpicklingError, EOFError, ValueError,
                        struct.error):
                    # garbage frame (framing mismatch / hostile bytes):
                    # drop the connection, never the serve loop
                    return
                op = msg[0]
                if op == "init":
                    _, rank, key, val = msg
                    with self._lock:
                        # rank 0 is authoritative (reference: rank-0
                        # push + barrier seeds the server)
                        if rank == 0 or key not in self._store:
                            self._store[key] = np.asarray(val)
                    _send_msg(conn, ("ok",))
                elif op == "push":
                    _, key, grad = msg
                    # per-op errors go back as replies — an exception
                    # must not kill this serve thread (the client's
                    # connection would die with it)
                    try:
                        self._apply_push(key, np.asarray(grad))
                    except MXNetError as e:
                        _send_msg(conn, ("err", str(e)))
                    else:
                        _send_msg(conn, ("ok",))
                elif op == "pull":
                    _, key = msg
                    with self._lock:
                        val = self._store.get(key)
                        if val is not None:
                            val = val.copy()
                    # serialize + send OUTSIDE the lock: a stalled
                    # client mid-sendall must not block other workers'
                    # pushes on the store lock
                    if val is None:
                        _send_msg(conn, ("err", "key %r not initialized"
                                         % (key,)))
                    else:
                        _send_msg(conn, ("ok", val))
                elif op == "set_optimizer":
                    _, blob = msg
                    with self._lock:
                        # a repeat of the CURRENT optimizer (a late
                        # worker re-sending) must not wipe momentum /
                        # Adam state accumulated by earlier pushes —
                        # the reference only ever sends this command
                        # from rank 0 (kvstore_dist.h
                        # _send_command_to_servers). A genuinely new
                        # optimizer (different blob) replaces it and
                        # starts fresh state.
                        if blob != getattr(self, "_opt_blob", None):
                            self._opt = pickle.loads(blob)
                            self._opt_blob = blob
                            self._opt_states = {}
                    _send_msg(conn, ("ok",))
                elif op == "barrier":
                    with self._barrier_cv:
                        gen = self._barrier_gen
                        self._barrier_count += 1
                        if self._barrier_count >= self.num_workers:
                            self._barrier_count = 0
                            self._barrier_gen += 1
                            self._barrier_cv.notify_all()
                        else:
                            while self._barrier_gen == gen \
                                    and not self._stop.is_set():
                                self._barrier_cv.wait(timeout=0.2)
                    _send_msg(conn, ("ok",))
                elif op == "hello":
                    _, rank = msg
                    with self._lock:
                        self._seen.add(rank)
                        self._alive[rank] = self._alive.get(rank, 0) + 1
                    hello_rank = rank
                    _send_msg(conn, ("ok",))
                elif op == "bye":
                    # graceful leave: a worker that finishes and closes
                    # normally must NOT read as a crash to num_dead
                    _, rank = msg
                    with self._lock:
                        self._seen.discard(rank)
                        self._alive.pop(rank, None)
                    hello_rank = None
                    _send_msg(conn, ("ok",))
                elif op == "num_dead":
                    # reference KVStore::get_num_dead_node
                    # (kvstore_dist.h:149-158): ranks that joined and
                    # then lost every connection count as dead
                    with self._lock:
                        dead = sum(1 for r in self._seen
                                   if self._alive.get(r, 0) <= 0)
                    _send_msg(conn, ("ok", dead))
                elif op == "stop":
                    _send_msg(conn, ("ok",))
                    self._stop.set()
                    with self._barrier_cv:
                        self._barrier_cv.notify_all()
                    return
                else:
                    _send_msg(conn, ("err", "unknown op %r" % (op,)))
        finally:
            if hello_rank is not None:
                with self._lock:
                    self._alive[hello_rank] = \
                        self._alive.get(hello_rank, 1) - 1
            conn.close()

    def close(self):
        """Graceful shutdown: signal ``_stop``, wake barrier waiters,
        close the listening socket, then join the accept thread and
        every live serve thread with a bounded timeout (they poll
        ``_stop`` every 0.2s/0.5s respectively). Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        with self._barrier_cv:
            # a worker parked in the barrier predicate loop re-checks
            # _stop on wake; without this it would idle until its 0.2s
            # wait timeout instead of leaving immediately
            self._barrier_cv.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)
        stragglers = 0
        for th in list(self._serve_threads):
            th.join(timeout=2.0)
            stragglers += th.is_alive()
        self._serve_threads = []
        if self._thread.is_alive() or stragglers:
            import logging
            logging.getLogger(__name__).warning(
                "ParameterServer.close: %d thread(s) still alive after "
                "bounded join; leaking daemon thread(s) rather than "
                "hanging teardown",
                stragglers + self._thread.is_alive())


class PSClient:
    """One connection to the server; blocking request/response."""

    def __init__(self, host, port, timeout_s=60.0):
        deadline = time.time() + timeout_s
        last = None
        while True:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=600)
                break
            except OSError as e:       # server may not be up yet
                last = e
                if time.time() > deadline:
                    raise MXNetError(
                        "cannot reach parameter server %s:%d (%s)"
                        % (host, port, last))
                time.sleep(0.1)
        from ..analysis import sanitizers as _san
        self._lock = _san.maybe_instrument(threading.Lock(), "ps-client")

    def call(self, *msg):
        # the lock serializes whole request/response exchanges on the
        # one connection (interleaved frames from two threads would
        # corrupt the protocol); both directions are bounded by the
        # socket timeouts (600s connect-level, 60s mid-frame)
        with self._lock:
            _send_msg(self._sock, msg)
            resp = _recv_msg(self._sock)
        if resp[0] != "ok":
            raise MXNetError("parameter server error: %s" % (resp[1],))
        return resp[1] if len(resp) > 1 else None

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
