"""graftrace: concurrency static analysis of the port's threaded plane,
counterpart of ``mxnet_tpu/analysis/graftrace.py``.

The port's host-side threads: ``engine.py``'s worker pools behind two
condition variables, ``io.py``'s prefetchers and decode workers,
``io_pipeline.py``'s staging and FeedScheduler threads, ``serving.py``'s
batcher, ``tracing.py``'s MetricsServer and watchdog, ``telemetry.py``,
``replicas.py``'s per-card work, ``parallel/ps.py``'s parameter-server
socket threads, ``kvstore_server.py``, ``checkpoint.py``'s writer,
``_build.py``'s parallel ``nvcc`` and ``_nvrtc.py``. Four rule families,
the same Finding/fingerprint/baseline/suppression machinery as
:mod:`.graftlint` (this module registers its rules into it at import, so
the CLI and the gate run them with no further wiring):

``lock-order``
    Builds the static lock-acquisition graph of each module: an edge
    A -> B for every place lock B is acquired (directly, or through a
    same-module call resolved by the per-class call graph) while A is
    held (nested ``with`` regions). Cycles, the 2-cycle "method f takes
    A then B, method g takes B then A" included, are the classic ABBA
    deadlock; every edge of a cyclic component is a finding at its
    witness line. Suppress with ``# graft: lock-order-ok``.

``blocking-under-lock``
    Flags calls that can block indefinitely while a lock is held:
    ``queue.get``/``put`` with no timeout, socket
    ``accept``/``recv``/``sendall``/``connect``, ``.join()`` with no
    timeout, ``time.sleep``, a device sync (``torch.cuda.synchronize()``,
    an Event's or Stream's ``.synchronize()``, ``.item()`` /
    ``.tolist()`` / ``.cpu()`` / ``.numpy()`` / ``.asnumpy()``), a
    ``torch.distributed`` collective or ``barrier``, a ``.wait()`` with
    no timeout (a ``Work``'s included), and condition ``wait()`` with
    neither a predicate loop nor a timeout. One such call turns a lock
    into a convoy: every thread that touches the lock waits on the slow
    peer (and a lost wakeup becomes a hang instead of a stall).
    Interprocedural one module deep: calling a same-module function that
    blocks counts. Suppress with ``# graft: blocking-ok``. (A CUDA
    launch is asynchronous and does not block: the JAX package's
    dispatch entry has no counterpart here.)

``thread-lifecycle``
    (a) non-daemon ``Thread``/``Process`` created in a class with no
    ``join`` anywhere: nothing can ever reap it; (b) a thread/process
    *started in* ``__init__`` of a class with no
    ``close``/``stop``/``shutdown``/``__exit__``: no reachable teardown;
    (c) ``.join()`` with no timeout on a shutdown-path method
    (``close``, ``stop``, ``shutdown``, ``reset``, ``__del__``...): a
    wedged worker makes teardown hang forever; (d) a stop-event
    ``.set()`` *after* the ``join()`` it is supposed to unblock.
    Suppress with ``# graft: lifecycle-ok``.

``fork-safety``
    ``multiprocessing`` targets/args that capture unpicklable or
    fork-hostile state: a bound method target (pickles the whole
    ``self``, locks and engine included), a lambda target, ``self`` or a
    lock/engine/thread/socket attribute in ``args``; plus explicit
    ``fork`` start methods / ``os.fork()``: forking after worker threads
    exist duplicates held locks into the child (and an initialised CUDA
    context, which a forked child cannot use). Suppress with
    ``# graft: fork-ok``.

The runtime halves of these invariants are ``MXNET_TPU_SANITIZE=locks``
(instrumented-lock order checking) and ``=deadlock`` (stall watchdog) in
:mod:`.sanitizers`.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from . import graftlint
from .graftlint import Finding, _Module, _dotted  # noqa: F401

__all__ = ["RULES", "SUPPRESS_TAGS"]

RULES = ("lock-order", "blocking-under-lock", "thread-lifecycle",
         "fork-safety")

SUPPRESS_TAGS = {
    "lock-order": "lock-order-ok",
    "blocking-under-lock": "blocking-ok",
    "thread-lifecycle": "lifecycle-ok",
    "fork-safety": "fork-ok",
}

# threading/multiprocessing constructors that create a lock-like object
_LOCK_CTORS = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
})
_EVENT_CTORS = frozenset({"threading.Event", "Event"})
_THREAD_CTORS = frozenset({"threading.Thread", "Thread"})
_PROC_SUFFIX = ".Process"   # ctx.Process / multiprocessing.Process / mp.Process

_SOCKET_BLOCKING = frozenset({"accept", "recv", "recvfrom", "recv_into",
                              "sendall", "connect"})
_SYNC_BLOCKING = frozenset({"asnumpy", "item", "tolist", "cpu", "numpy",
                            "synchronize"})
_DEVICE_SYNC = frozenset({"torch.cuda.synchronize", "cuda.synchronize"})
# torch.distributed calls that wait for every rank
_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single", "barrier",
    "monitored_barrier", "broadcast", "broadcast_object_list", "reduce",
    "reduce_scatter", "reduce_scatter_tensor", "gather", "scatter",
    "send", "recv"})
_DIST_PREFIXES = ("dist.", "torch.distributed.", "_dist.")
_SHUTDOWN_METHODS = frozenset({"close", "stop", "shutdown", "reset",
                               "terminate", "_drain", "_cleanup", "join",
                               "__exit__", "__del__"})
# attribute-name fragments that mark a value as fork-hostile when it is
# shipped to a child process
_UNPICKLABLE_HINTS = ("lock", "mutex", "_cv", "cond", "engine", "thread",
                      "sock", "sanitizer")


def _looks_lockish(name: str) -> bool:
    n = name.lower().lstrip("_")
    return ("lock" in n or "mutex" in n or "cond" in n
            or n.endswith("_cv") or n == "cv")


def _has_timeout(call: ast.Call, min_pos: int = 1) -> bool:
    """True when the call passes a timeout (kwarg, or a positional
    beyond ``min_pos`` args — e.g. ``q.get(True, 5)``)."""
    for kw in call.keywords:
        if kw.arg == "timeout" and not (isinstance(kw.value, ast.Constant)
                                        and kw.value.value is None):
            return True
    return len(call.args) > min_pos


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _queueish(recv: str) -> bool:
    last = recv.split(".")[-1].lower()
    return "queue" in last or last == "q" or last.endswith("_q")


class _FnInfo:
    """Concurrency summary of one function/method scope."""

    def __init__(self, key, node, class_name):
        self.key = key
        self.node = node
        self.class_name = class_name
        # (lock_id, held_tuple, witness_node)
        self.acquires: List[Tuple[str, Tuple[str, ...], ast.AST]] = []
        # (witness_node, description, held_tuple)
        self.blocking: List[Tuple[ast.AST, str, Tuple[str, ...]]] = []
        # whether ANY classified blocking call exists (lock-held or not)
        self.block_reason: Optional[str] = None
        # (callee_key, witness_node, held_tuple)
        self.calls: List[Tuple[str, ast.AST, Tuple[str, ...]]] = []
        # fixpoint results
        self.all_acquired: Set[str] = set()
        self.may_block: Optional[str] = None


class _Conc:
    """Per-module concurrency model: lock universe, class map, per-
    function summaries with a transitive-closure pass over the
    same-module call graph."""

    def __init__(self, mod: _Module):
        self.mod = mod
        self.lock_names: Set[str] = set()     # bare attr/var names
        self.event_names: Set[str] = set()    # stop-event attr/var names
        self.classes: Dict[str, ast.ClassDef] = {}
        self.methods: Dict[str, ast.FunctionDef] = {}   # "Cls.meth"
        self.functions: Dict[str, ast.FunctionDef] = {}  # module level
        self._collect_defs(mod.tree)
        self._collect_lock_universe(mod.tree)
        self.fns: Dict[str, _FnInfo] = {}
        for key, node, cls in self._fn_scopes():
            info = _FnInfo(key, node, cls)
            self._scan(info)
            self.fns[key] = info
        self._fixpoint()

    # -- structure ---------------------------------------------------------
    def _collect_defs(self, tree):
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self.methods["%s.%s" % (node.name, item.name)] = item

    def _fn_scopes(self):
        for name, node in self.functions.items():
            yield name, node, None
        for key, node in self.methods.items():
            yield key, node, key.split(".", 1)[0]

    def _collect_lock_universe(self, tree):
        """Names assigned from threading lock/event constructors,
        anywhere in the module (``self.X = threading.Lock()``,
        module-level ``X = threading.Condition()``)."""
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            ctor = _dotted(node.value.func)
            bucket = None
            if ctor in _LOCK_CTORS:
                bucket = self.lock_names
            elif ctor in _EVENT_CTORS:
                bucket = self.event_names
            if bucket is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    bucket.add(t.id)
                elif isinstance(t, ast.Attribute):
                    bucket.add(t.attr)

    def lock_id(self, expr, class_name: Optional[str]) -> Optional[str]:
        """Stable per-module id of a lock expression, or None when the
        expression does not look like a lock. ``self.X`` is keyed by
        class (``Cls.X``); another object's attribute by attribute name
        (``*.X`` — all instances share one id, which is exactly the
        granularity a per-class acquisition order is defined at)."""
        d = _dotted(expr)
        if not d:
            return None
        parts = d.split(".")
        name = parts[-1]
        if not (_looks_lockish(name) or name in self.lock_names):
            return None
        if parts[0] == "self" and len(parts) == 2:
            return "%s.%s" % (class_name, name) if class_name else name
        if len(parts) == 1:
            return name
        return "*.%s" % name

    # -- per-function scan -------------------------------------------------
    def _scan(self, info: _FnInfo):
        conc = self

        def classify_blocking(node: ast.Call, held, in_pred):
            """Description of why this call blocks, or None."""
            d = _dotted(node.func)
            if d == "time.sleep":
                return "time.sleep()"
            if d in _DEVICE_SYNC:
                return "torch.cuda.synchronize() device sync"
            if d.startswith(_DIST_PREFIXES) \
                    and d.rsplit(".", 1)[-1] in _COLLECTIVES:
                return "torch.distributed collective %s()" % d
            if not isinstance(node.func, ast.Attribute):
                return None
            attr = node.func.attr
            recv = _dotted(node.func.value)
            if attr == "join":
                return None if _has_timeout(node, 0) \
                    else "%s.join() with no timeout" % (recv or "<expr>")
            if attr == "wait":
                rid = conc.lock_id(node.func.value, info.class_name)
                if rid is not None and rid in held:
                    # a condition waiting on ITS OWN lock: the sanctioned
                    # CV pattern needs a predicate loop or a timeout
                    if in_pred or _has_timeout(node, 0):
                        return None
                    return ("condition %s.wait() with neither predicate "
                            "loop nor timeout (lost wakeup = hang)" % recv)
                return None if _has_timeout(node, 0) \
                    else "%s.wait() with no timeout" % (recv or "<expr>")
            if attr in ("get", "put") and _queueish(recv):
                blk = _kw(node, "block")
                if isinstance(blk, ast.Constant) and blk.value is False:
                    return None
                min_pos = 1 if attr == "get" else 2
                return None if _has_timeout(node, min_pos) \
                    else "%s.%s() with no timeout" % (recv, attr)
            if attr in _SOCKET_BLOCKING:
                return "socket %s.%s()" % (recv or "<expr>", attr)
            if attr == "serve_forever":
                return "%s.serve_forever()" % (recv or "<expr>")
            if attr in _SYNC_BLOCKING and not node.args:
                return ".%s() device sync" % attr
            return None

        def callee_key(node: ast.Call) -> Optional[str]:
            if isinstance(node.func, ast.Name) \
                    and node.func.id in self.functions:
                return node.func.id
            if isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self" \
                    and info.class_name:
                key = "%s.%s" % (info.class_name, node.func.attr)
                if key in self.methods:
                    return key
            return None

        def visit(node, held, in_pred):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return  # nested scopes are summarized separately
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new_held = held
                for item in node.items:
                    visit(item.context_expr, held, in_pred)
                    lid = conc.lock_id(item.context_expr, info.class_name)
                    if lid is not None:
                        info.acquires.append((lid, new_held,
                                              item.context_expr))
                        if lid not in new_held:
                            new_held = new_held + (lid,)
                for b in node.body:
                    visit(b, new_held, in_pred)
                return
            if isinstance(node, ast.While):
                visit(node.test, held, in_pred)
                pred = not (isinstance(node.test, ast.Constant)
                            and bool(node.test.value))
                for b in node.body + node.orelse:
                    visit(b, held, in_pred or pred)
                return
            if isinstance(node, ast.Call):
                desc = classify_blocking(node, held, in_pred)
                if desc is not None:
                    if info.block_reason is None:
                        info.block_reason = desc
                    if held:
                        info.blocking.append((node, desc, held))
                else:
                    key = callee_key(node)
                    if key is not None:
                        info.calls.append((key, node, held))
            for child in ast.iter_child_nodes(node):
                visit(child, held, in_pred)

        for stmt in info.node.body:
            visit(stmt, (), False)

    # -- transitive closure over the same-module call graph ----------------
    def _fixpoint(self):
        for info in self.fns.values():
            info.all_acquired = {lid for lid, _h, _n in info.acquires}
            info.may_block = info.block_reason
        changed = True
        while changed:
            changed = False
            for info in self.fns.values():
                for key, _node, _held in info.calls:
                    callee = self.fns.get(key)
                    if callee is None:
                        continue
                    if not callee.all_acquired <= info.all_acquired:
                        info.all_acquired |= callee.all_acquired
                        changed = True
                    if info.may_block is None \
                            and callee.may_block is not None:
                        info.may_block = "%s() -> %s" % (key,
                                                         callee.may_block)
                        changed = True


def _conc(mod: _Module) -> _Conc:
    cached = getattr(mod, "_graftrace_conc", None)
    if cached is None:
        cached = mod._graftrace_conc = _Conc(mod)
    return cached


# ---------------------------------------------------------------------------
# rule: lock-order
# ---------------------------------------------------------------------------

def _check_lock_order(mod: _Module) -> List[Finding]:
    conc = _conc(mod)
    # (held, acquired) -> witness node of the first occurrence
    edges: Dict[Tuple[str, str], Tuple[ast.AST, str]] = {}
    for info in conc.fns.values():
        for lid, held, node in info.acquires:
            for h in held:
                if h != lid:
                    edges.setdefault((h, lid), (node, info.key))
        for key, node, held in info.calls:
            callee = conc.fns.get(key)
            if callee is None or not held:
                continue
            for h in held:
                for lid in callee.all_acquired:
                    if h != lid:
                        edges.setdefault(
                            (h, lid),
                            (node, "%s (via %s)" % (info.key, key)))
    if not edges:
        return []
    # every edge inside a strongly-connected component is part of some
    # acquisition cycle; iterative Tarjan (modules are small, but the
    # recursion limit is not ours to burn)
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    comp: Dict[str, int] = {}
    stack: List[str] = []
    on_stack: Set[str] = set()
    counter = [0]
    ncomp = [0]

    def strongconnect(root):
        work = [(root, iter(adj[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(adj[w])))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp[w] = ncomp[0]
                    if w == v:
                        break
                ncomp[0] += 1

    for v in adj:
        if v not in index:
            strongconnect(v)
    comp_size: Dict[int, int] = {}
    for v, c in comp.items():
        comp_size[c] = comp_size.get(c, 0) + 1

    findings: List[Finding] = []
    for (a, b), (node, where) in sorted(
            edges.items(), key=lambda kv: getattr(kv[1][0], "lineno", 0)):
        if comp[a] != comp[b] or comp_size[comp[a]] < 2:
            continue
        members = sorted(v for v, c in comp.items() if c == comp[a])
        f = mod.finding(
            "lock-order", node,
            "lock-order cycle: %s acquired while %s is held (in %s), but "
            "the reverse order also exists in this module — cycle over "
            "{%s} can deadlock" % (b, a, where, ", ".join(members)))
        if f is not None:
            findings.append(f)
    return findings


# ---------------------------------------------------------------------------
# rule: blocking-under-lock
# ---------------------------------------------------------------------------

def _check_blocking_under_lock(mod: _Module) -> List[Finding]:
    conc = _conc(mod)
    findings: List[Finding] = []
    for info in conc.fns.values():
        for node, desc, held in info.blocking:
            f = mod.finding(
                "blocking-under-lock", node,
                "%s while holding %s: every thread touching the lock "
                "convoys behind this call" % (desc, ", ".join(held)))
            if f is not None:
                findings.append(f)
        for key, node, held in info.calls:
            callee = conc.fns.get(key)
            if callee is None or not held or callee.may_block is None:
                continue
            f = mod.finding(
                "blocking-under-lock", node,
                "call may block while holding %s: %s -> %s"
                % (", ".join(held), key, callee.may_block))
            if f is not None:
                findings.append(f)
    return findings


# ---------------------------------------------------------------------------
# rule: thread-lifecycle
# ---------------------------------------------------------------------------

def _thread_kind(call: ast.Call) -> Optional[str]:
    d = _dotted(call.func)
    if d in _THREAD_CTORS:
        return "thread"
    if d.endswith(_PROC_SUFFIX) or d == "Process":
        return "process"
    return None


def _is_daemon(call: ast.Call) -> bool:
    v = _kw(call, "daemon")
    return isinstance(v, ast.Constant) and v.value is True


def _class_has_join(conc: _Conc, class_name: Optional[str],
                    fn_node) -> bool:
    """Any ``.join(`` call in the class (or, for module-level scopes,
    in the enclosing function) — the cheap 'a join path exists'
    approximation."""
    scope = conc.classes.get(class_name) if class_name else fn_node
    for node in ast.walk(scope):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "join":
            return True
    return False


def _class_has_teardown(conc: _Conc, class_name: str) -> bool:
    for meth in ("close", "stop", "shutdown", "join", "__exit__",
                 "__del__"):
        if "%s.%s" % (class_name, meth) in conc.methods:
            return True
    return False


def _check_thread_lifecycle(mod: _Module) -> List[Finding]:
    conc = _conc(mod)
    findings: List[Finding] = []

    def emit(node, msg):
        f = mod.finding("thread-lifecycle", node, msg)
        if f is not None:
            findings.append(f)

    for info in conc.fns.values():
        meth = info.key.rsplit(".", 1)[-1]
        started_kinds: List[Tuple[str, ast.Call]] = []
        join_lines: List[int] = []        # every thread-ish .join() call
        set_calls: List[Tuple[ast.Call, str]] = []
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            kind = _thread_kind(node)
            if kind is not None:
                started_kinds.append((kind, node))
                if not _is_daemon(node) \
                        and not _class_has_join(conc, info.class_name,
                                                info.node):
                    emit(node, "non-daemon %s with no join anywhere in "
                         "%s: nothing ever reaps it"
                         % (kind, info.class_name or info.key))
            if isinstance(node.func, ast.Attribute):
                if node.func.attr == "join":
                    join_lines.append(getattr(node, "lineno", 0))
                    if meth in _SHUTDOWN_METHODS \
                            and not _has_timeout(node, 0):
                        recv = _dotted(node.func.value)
                        emit(node, "unbounded %s.join() on shutdown "
                             "path %s(): a wedged worker hangs teardown "
                             "forever — join with a timeout (and "
                             "surface the leak)"
                             % (recv or "<expr>", info.key))
                elif node.func.attr == "set":
                    recv = _dotted(node.func.value)
                    name = recv.split(".")[-1]
                    if name in conc.event_names \
                            and ("stop" in name or "shutdown" in name
                                 or "exit" in name or "done" in name):
                        set_calls.append((node, recv))
        # line-number pass (ast.walk order is depth-wise, not textual):
        # a stop-event .set() textually after a join in the same scope
        # means the joined thread could never have seen the signal
        for node, recv in set_calls:
            prior = [l for l in join_lines
                     if l < getattr(node, "lineno", 0)]
            if prior:
                emit(node, "stop event %s.set() after the join at line "
                     "%d: the joined thread can never have seen the "
                     "stop signal — set before joining"
                     % (recv, min(prior)))
        if meth == "__init__" and info.class_name and started_kinds:
            started = {id(n) for n in ast.walk(info.node)
                       if isinstance(n, ast.Call)
                       and isinstance(n.func, ast.Attribute)
                       and n.func.attr == "start"}
            if started and not _class_has_teardown(conc, info.class_name):
                kind, node = started_kinds[0]
                emit(node, "%s started in %s.__init__ but the class has "
                     "no close()/stop()/shutdown(): no reachable "
                     "teardown path" % (kind, info.class_name))
    return findings


# ---------------------------------------------------------------------------
# rule: fork-safety
# ---------------------------------------------------------------------------

def _check_fork_safety(mod: _Module) -> List[Finding]:
    conc = _conc(mod)
    findings: List[Finding] = []

    def emit(node, msg):
        f = mod.finding("fork-safety", node, msg)
        if f is not None:
            findings.append(f)

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if d in ("os.fork",):
            emit(node, "os.fork() duplicates held locks and the CUDA "
                 "context into the child; use a spawn-context "
                 "multiprocessing worker")
            continue
        if d.endswith("get_context") or d.endswith("set_start_method"):
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and node.args[0].value == "fork":
                emit(node, "explicit 'fork' start method: forking after "
                     "worker threads exist duplicates held locks (and an "
                     "initialised CUDA context) into the child; use "
                     "'spawn'")
            continue
        if _thread_kind(node) != "process":
            continue
        target = _kw(node, "target")
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self":
            emit(node, "Process target is the bound method self.%s: "
                 "pickling it ships the whole object — locks, threads, "
                 "engine handles included — to the child; use a "
                 "module-level function" % target.attr)
        elif isinstance(target, ast.Lambda):
            emit(node, "Process target is a lambda: unpicklable under "
                 "the spawn start method")
        args_kw = _kw(node, "args")
        elts = args_kw.elts if isinstance(args_kw, (ast.Tuple,
                                                    ast.List)) else []
        for e in elts:
            if isinstance(e, ast.Name) and e.id == "self":
                emit(e, "Process args ship `self` to the child: the "
                     "whole object (locks and all) gets pickled")
            elif isinstance(e, ast.Attribute):
                name = e.attr.lower()
                if any(h in name for h in _UNPICKLABLE_HINTS) \
                        or e.attr in conc.lock_names:
                    emit(e, "Process args ship %s to the child: locks/"
                         "engines/sockets do not survive pickling (or "
                         "arrive as dead copies)" % _dotted(e))
    return findings


_RULE_FNS = {
    "lock-order": _check_lock_order,
    "blocking-under-lock": _check_blocking_under_lock,
    "thread-lifecycle": _check_thread_lifecycle,
    "fork-safety": _check_fork_safety,
}


def _register():
    """Install the concurrency families into graftlint's rule registry
    so its Config/driver/baseline/CLI machinery — and every existing
    gate built on them — runs these rules with no further wiring."""
    if RULES[0] in graftlint.RULES:
        return
    graftlint.RULES = tuple(graftlint.RULES) + RULES
    graftlint.SUPPRESS_TAGS.update(SUPPRESS_TAGS)
    graftlint._RULE_FNS.update(_RULE_FNS)


_register()
