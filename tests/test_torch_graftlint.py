"""The port's graftlint and graftrace (mxnet_tpu_torch/analysis) against
the JAX package's analyzers: the shared snippets of tests/test_graftlint.py
and tests/test_graftrace.py give the same (rule, line, scope) findings
from both, for the families both have (host-sync with the JAX value
sources written as torch ones, env-registry, and the four concurrency
families); torch-specific cases; fingerprints and the baseline; and the
gate over mxnet_tpu_torch/ against tools/graftlint_torch_baseline.json,
every accepted finding with its reason."""
import os
import sys

import pytest

from mxnet_tpu.analysis import graftlint as jgl
from mxnet_tpu.analysis import graftrace as jgr
from mxnet_tpu_torch import env as tenv
from mxnet_tpu_torch.analysis import graftlint as tgl
from mxnet_tpu_torch.analysis import graftrace as tgr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECLARED = {"MXNET_TPU_DECLARED"}
CONC = tuple(tgr.RULES)


def _keys(findings):
    return [(f.rule, f.line, f.scope) for f in findings]


def _lint(mod, src, path, rules):
    cfg = mod.Config(declared_env=DECLARED, rules=rules)
    return mod.analyze_source(src, path, cfg)


# ---------------------------------------------------------------------------
# shared snippets: (source for the JAX analyzer, the port's source where
# its value source is written in torch, path, rules)
# ---------------------------------------------------------------------------

BAD_ABBA = """
import threading

class W:
    def __init__(self):
        self.a_lock = threading.Lock()
        self.b_lock = threading.Lock()

    def f(self):
        with self.a_lock:
            with self.b_lock:
                pass

    def g(self):
        with self.b_lock:
            with self.a_lock:
                pass
"""

HS = ("host-sync",)
ENV = ("env-registry",)
SHARED = [
    # host-sync
    ("def step(x):\n    return np.asarray(x)\n", None, "pkg/engine.py", HS),
    ("def step(x):\n    return np.asarray(x)\n", None,
     "pkg/visualization.py", HS),
    ("def step(x):\n    return x.item()\n", None, "pkg/engine.py", HS),
    ("def step(x):\n    return x.tolist()\n", None, "pkg/engine.py", HS),
    ("def step(x):\n    return x.asnumpy()\n", None, "pkg/engine.py", HS),
    ("def step(a):\n    loss = jnp.mean(a)\n    return float(loss)\n",
     "def step(a):\n    loss = torch.mean(a)\n    return float(loss)\n",
     "pkg/engine.py", HS),
    ("def step(a):\n    ok = jnp.all(a)\n    if ok:\n        return 1\n",
     "def step(a):\n    ok = torch.all(a)\n    if ok:\n        return 1\n",
     "pkg/engine.py", HS),
    ("def step(n):\n    m = n + 1\n    if m:\n        return float(m)\n",
     None, "pkg/engine.py", HS),
    ("def step(a):\n    v = jnp.mean(a)\n    if v is None:\n"
     "        return 0\n    return v\n",
     "def step(a):\n    v = torch.mean(a)\n    if v is None:\n"
     "        return 0\n    return v\n", "pkg/engine.py", HS),
    ("def step(x):\n    return np.asarray(x)  # graft: host-sync\n", None,
     "pkg/engine.py", HS),
    ("def step(x):\n    # graft: host-sync\n    return np.asarray(x)\n",
     None, "pkg/engine.py", HS),
    ("def step(x):\n    a = np.asarray(x)\n    b = np.asarray(x)\n", None,
     "pkg/engine.py", HS),
    # env-registry
    ('x = os.environ.get("MXNET_TPU_FOO")\n', None, "pkg/x.py", ENV),
    ('x = os.getenv("MXNET_TPU_FOO")\n', None, "pkg/x.py", ENV),
    ('x = getenv("MXNET_TPU_FOO", 3)\n', None, "pkg/x.py", ENV),
    ('x = os.environ["MXNET_TPU_FOO"]\n', None, "pkg/x.py", ENV),
    ('a = os.environ.get("HOME")\nos.environ["MXNET_TPU_FOO"] = "1"\n',
     None, "pkg/x.py", ENV),
    ('v = env.get("MXNET_TPU_DECLARED")\n', None, "pkg/x.py", ENV),
    ('v = env.get("MXNET_TPU_MISSING")\n', None, "pkg/x.py", ENV),
    ('# graft: env-ok\nv = os.environ.get("MXNET_TPU_FOO")\n', None,
     "pkg/x.py", ENV),
    ('def f():\n    return os.getenv("MXNET_TPU_FOO")\n', None, "pkg/x.py",
     ENV),
    # lock-order
    (BAD_ABBA, None, "pkg/worker.py", CONC),
    (BAD_ABBA.replace("with self.b_lock:\n            with self.a_lock:",
                      "with self.a_lock:\n            with self.b_lock:"),
     None, "pkg/worker.py", CONC),
    ("""
import threading

class W:
    def __init__(self):
        self.a_lock = threading.Lock()
        self.b_lock = threading.Lock()

    def f(self):
        with self.a_lock:
            with self.b_lock:
                pass

    def h(self):
        with self.a_lock:
            pass

    def g(self):
        with self.b_lock:
            self.h()
""", None, "pkg/worker.py", CONC),
    (BAD_ABBA.replace(
        "with self.b_lock:\n            with self.a_lock:",
        "with self.b_lock:  # graft: lock-order-ok\n"
        "            with self.a_lock:  # graft: lock-order-ok"),
     None, "pkg/worker.py", CONC),
    # blocking-under-lock
    ("\nclass W:\n    def take(self):\n        with self._lock:\n"
     "            return self._queue.get()\n", None, "pkg/worker.py", CONC),
    ("\nclass W:\n    def take(self):\n        with self._lock:\n"
     "            return self._queue.get(timeout=0.5)\n\n"
     "    def take2(self):\n        return self._queue.get()\n", None,
     "pkg/worker.py", CONC),
] + [
    ("class W:\n    def f(self):\n        with self._lock:\n"
     "            %s\n" % call, None, "pkg/worker.py", CONC)
    for call in ("t.join()", "time.sleep(1)", "sock.recv(1024)",
                 "x.item()", "x.asnumpy()", "q.put(1)",
                 "self._cv.wait()", "ev.wait()", "t.join(5.0)")
] + [
    ("\ndef slow():\n    return sock.recv(4)\n\nclass W:\n    def f(self):\n"
     "        with self._lock:\n            return slow()\n", None,
     "pkg/worker.py", CONC),
    ("\nclass W:\n    def f(self):\n        with self._cv:\n"
     "            self._cv.wait()\n", None, "pkg/worker.py", CONC),
    ("\nclass W:\n    def f(self):\n        with self._cv:\n"
     "            while not self._ready:\n                self._cv.wait()\n",
     None, "pkg/worker.py", CONC),
    ("\nclass W:\n    def f(self):\n        with self._cv:\n"
     "            self._cv.wait(timeout=1.0)\n", None, "pkg/worker.py", CONC),
    ("\nclass W:\n    def f(self):\n        with self._lock:\n"
     "            t.join()  # graft: blocking-ok\n", None, "pkg/worker.py",
     CONC),
    # thread-lifecycle
    ("\nimport threading\n\nclass W:\n    def start(self):\n"
     "        self._t = threading.Thread(target=self._run)\n"
     "        self._t.start()\n", None, "pkg/worker.py", CONC),
    ("\nimport threading\n\nclass W:\n    def start(self):\n"
     "        self._t = threading.Thread(target=self._run, daemon=True)\n"
     "        self._t.start()\n", None, "pkg/worker.py", CONC),
    ("\nimport threading\n\nclass W:\n    def start(self):\n"
     "        self._t = threading.Thread(target=self._run)\n"
     "        self._t.start()\n\n    def stop(self):\n"
     "        self._t.join(timeout=5.0)\n", None, "pkg/worker.py", CONC),
    ("\nclass W:\n    def close(self):\n        self._t.join()\n", None,
     "pkg/worker.py", CONC),
    ("\nclass W:\n    def close(self):\n        self._t.join(timeout=5.0)\n",
     None, "pkg/worker.py", CONC),
    ("\nimport threading\n\nclass W:\n    def __init__(self):\n"
     "        self._t = threading.Thread(target=self._run, daemon=True)\n"
     "        self._t.start()\n", None, "pkg/worker.py", CONC),
    ("\nimport threading\n\nclass W:\n    def __init__(self):\n"
     "        self._t = threading.Thread(target=self._run, daemon=True)\n"
     "        self._t.start()\n\n    def close(self):\n"
     "        self._t.join(timeout=1.0)\n", None, "pkg/worker.py", CONC),
    ("\nimport threading\n\nclass W:\n    def __init__(self):\n"
     "        self._stop_event = threading.Event()\n\n    def close(self):\n"
     "        self._t.join(timeout=1.0)\n        self._stop_event.set()\n",
     None, "pkg/worker.py", CONC),
    ("\nimport threading\n\nclass W:\n    def __init__(self):\n"
     "        self._stop_event = threading.Event()\n\n    def close(self):\n"
     "        self._stop_event.set()\n        self._t.join(timeout=1.0)\n",
     None, "pkg/worker.py", CONC),
    # fork-safety
    ("\nimport multiprocessing\n\nclass W:\n    def spawn(self):\n"
     "        p = multiprocessing.Process(target=self._run)\n"
     "        p.start()\n        p.join(timeout=5.0)\n", None,
     "pkg/worker.py", CONC),
    ("\nimport multiprocessing\n\ndef main(w):\n"
     "    p = multiprocessing.Process(target=work, args=(w.engine_lock,))\n"
     "    p.start()\n    p.join(timeout=5.0)\n", None, "pkg/worker.py",
     CONC),
    ("\nimport multiprocessing\n\ndef work(q):\n    pass\n\nclass W:\n"
     "    def spawn(self):\n"
     "        p = multiprocessing.Process(target=work, args=(self.depth,))\n"
     "        p.start()\n        p.join(timeout=5.0)\n", None,
     "pkg/worker.py", CONC),
    ("import multiprocessing\nctx = multiprocessing.get_context('fork')\n",
     None, "pkg/worker.py", CONC),
    ("import multiprocessing\nctx = multiprocessing.get_context('spawn')\n",
     None, "pkg/worker.py", CONC),
    ("import os\npid = os.fork()\n", None, "pkg/worker.py", CONC),
    ("import multiprocessing\n"
     "p = multiprocessing.Process(target=lambda: None)\n", None,
     "pkg/worker.py", CONC),
]


@pytest.mark.parametrize("jax_src,torch_src,path,rules", SHARED)
def test_shared_snippets_give_the_jax_findings(jax_src, torch_src, path,
                                               rules):
    want = _keys(_lint(jgl, jax_src, path, rules))
    got = _keys(_lint(tgl, torch_src or jax_src, path, rules))
    assert got == want


def test_the_shared_snippets_find_something():
    """The comparison is not vacuous: most shared snippets have a
    finding, in every family."""
    found = set()
    hits = 0
    for jax_src, _, path, rules in SHARED:
        fs = _lint(jgl, jax_src, path, rules)
        hits += bool(fs)
        found |= {f.rule for f in fs}
    assert found == {"host-sync", "env-registry", "lock-order",
                     "blocking-under-lock", "thread-lifecycle",
                     "fork-safety"}
    assert hits >= 30


def test_rule_registry():
    assert set(tgr.RULES) <= set(tgl.RULES)
    assert set(tgl.RULES) == {"host-sync", "env-registry"} | set(tgr.RULES)
    assert tgl.Config().rules == set(tgl.RULES)
    for rule, tag in tgr.SUPPRESS_TAGS.items():
        assert tgl.SUPPRESS_TAGS[rule] == tag == jgr.SUPPRESS_TAGS[rule]
    assert tgl.SUPPRESS_TAGS["host-sync"] == jgl.SUPPRESS_TAGS["host-sync"]
    # the JAX families with no torch counterpart are named, not faked
    assert set(tgl.NOT_PORTED) == {"donation", "tracer"}
    assert not set(tgl.NOT_PORTED) & set(tgl.RULES)
    assert set(tgl.NOT_PORTED) <= set(jgl.RULES)


# ---------------------------------------------------------------------------
# torch-specific cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body,flagged", [
    ("return x.cpu()", True),
    ("return x.numpy()", True),
    ("torch.cuda.synchronize()", True),
    ("return float(x.handle)", True),
    ("return int(x._data)", True),
    ("s = torch.sum(x)\n    return float(s)", True),
    ("s = torch.sum(x) * 2\n    while s:\n        pass", True),
    # JAX hazards that are no hazard here
    ("return x.block_until_ready()", False),
    ("return jax.device_get(x)", False),
    # torch calls that make no tensor
    ("ok = torch.cuda.is_available()\n    if ok:\n        return 1", False),
    ("d = torch.device('cuda')\n    return bool(d)", False),
    ("return x.cpu(1)", False),
])
def test_host_sync_in_torch_terms(body, flagged):
    src = "def step(x):\n    %s\n" % body
    fs = _lint(tgl, src, "pkg/fused_step.py", HS)
    assert bool(fs) == flagged, fs
    assert all(f.rule == "host-sync" for f in fs)


@pytest.mark.parametrize("call,flagged", [
    ("torch.cuda.synchronize()", True),
    ("ev.synchronize()", True),
    ("torch.cuda.current_stream().synchronize()", True),
    ("dist.all_reduce(t)", True),
    ("torch.distributed.barrier()", True),
    ("dist.broadcast(t, src=0)", True),
    ("work.wait()", True),
    ("x.cpu()", True),
    ("x.tolist()", True),
    # a CUDA launch is asynchronous; bounded waits do not block forever
    ("torch.mm(a, b)", False),
    ("jnp.dot(a, b)", False),
    ("work.wait(timeout=datetime.timedelta(seconds=5))", False),
    ("ev.query()", False),
])
def test_blocking_under_lock_in_torch_terms(call, flagged):
    src = ("class W:\n    def f(self):\n        with self._lock:\n"
           "            %s\n" % call)
    fs = _lint(tgl, src, "pkg/worker.py", CONC)
    assert bool(fs) == flagged, fs
    assert all(f.rule == "blocking-under-lock" for f in fs)


def test_collective_in_a_callee_under_a_lock():
    src = ("import torch.distributed as dist\n\n"
           "def exchange(t):\n    dist.all_reduce(t)\n\n"
           "class Store:\n    def push(self, t):\n"
           "        with self._lock:\n            exchange(t)\n")
    fs = _lint(tgl, src, "pkg/kvstore.py", CONC)
    assert _keys(fs) == [("blocking-under-lock", 9, "Store.push")]
    assert "exchange -> torch.distributed collective" in fs[0].message


def test_env_registry_reads_the_port_registry():
    names = tgl.declared_env_names(
        os.path.join(ROOT, "mxnet_tpu_torch", "env.py"))
    assert names == set(tenv.declared())
    assert {"MXNET_TPU_AUTOTUNE", "MXNET_TPU_AUTOTUNE_BUDGET_S"} <= names
    assert "MXNET_TPU_PALLAS_CONV" not in names
    src = 'v = env.get("MXNET_TPU_PALLAS_CONV")\n'
    fs = tgl.analyze_source(src, "pkg/x.py", tgl.Config(rules=ENV))
    assert "mxnet_tpu_torch/env.py" in fs[0].message


# ---------------------------------------------------------------------------
# fingerprints and the baseline
# ---------------------------------------------------------------------------

def test_fingerprints_stable_under_line_drift():
    src = "def step(x):\n    return x.cpu()\n"
    f1 = _lint(tgl, src, "pkg/engine.py", HS)[0]
    f2 = _lint(tgl, "import os\n\n\n" + src, "pkg/engine.py", HS)[0]
    assert f1.line != f2.line and f1.fingerprint == f2.fingerprint
    dup = "def step(x):\n    a = x.cpu()\n    b = x.cpu()\n"
    fps = [f.fingerprint for f in _lint(tgl, dup, "pkg/engine.py", HS)]
    assert len(fps) == len(set(fps)) == 2


def test_baseline_keeps_reasons_and_partitions(tmp_path):
    fs = _lint(tgl, "def step(x):\n    return x.cpu()\n", "pkg/engine.py",
               HS)
    path = str(tmp_path / "baseline.json")
    tgl.save_baseline(path, fs, {fs[0].fingerprint: "a host tensor"})
    # rewriting keeps the reason the file gives
    tgl.save_baseline(path, fs)
    (entry,) = tgl.load_baseline_entries(path)
    assert entry["reason"] == "a host tensor"
    new, old = tgl.partition(fs, tgl.load_baseline(path))
    assert new == [] and len(old) == 1
    other = _lint(tgl, "def step(y):\n    return y.item()\n",
                  "pkg/engine.py", HS)
    assert len(tgl.partition(other, tgl.load_baseline(path))[0]) == 1


def test_parse_error_is_reported_not_raised():
    fs = tgl.analyze_source("def broken(:\n", "pkg/x.py",
                            tgl.Config(declared_env=DECLARED))
    assert [f.rule for f in fs] == ["parse-error"]


# ---------------------------------------------------------------------------
# the gate over the port
# ---------------------------------------------------------------------------

BASELINE = os.path.join(ROOT, "tools", "graftlint_torch_baseline.json")


def test_port_has_no_unbaselined_findings():
    fs = tgl.analyze_paths([os.path.join(ROOT, "mxnet_tpu_torch")],
                           root=ROOT)
    entries = tgl.load_baseline_entries(BASELINE)
    new, _ = tgl.partition(fs, {e["fingerprint"] for e in entries})
    assert new == [], "new graftlint findings in the port:\n%s" % "\n".join(
        repr(f) for f in new)
    # every accepted finding is still there and says why it stays
    assert {e["fingerprint"] for e in entries} == {f.fingerprint
                                                   for f in fs}
    assert all(len(e.get("reason", "").strip()) > 20 for e in entries)


def test_the_cli_gates_the_port(tmp_path, capsys):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import torch_graftlint
    finally:
        sys.path.pop(0)
    assert torch_graftlint.main([]) == 0
    bad = tmp_path / "engine.py"
    bad.write_text("def step(x):\n    return x.cpu()\n")
    assert torch_graftlint.main([str(bad)]) == 1
    assert "[host-sync]" in capsys.readouterr().out
    assert torch_graftlint.main(["--check-env-docs"]) == 0
