"""graftlint: AST static analysis of the port, counterpart of
``mxnet_tpu/analysis/graftlint.py``.

The same framework (findings, comment tags, scopes, fingerprints, the
baseline and its partition, a rule registry that
:mod:`.graftrace` extends with its concurrency rules) with the two rule
families that have a PyTorch counterpart:

``host-sync``
    In step-loop-reachable modules (engine, executor, fused_step,
    metric, io_pipeline) any host<->device synchronization must carry an
    explicit ``# graft: host-sync`` annotation: numpy conversion of a
    possibly-device value, ``.item()`` / ``.tolist()`` / ``.cpu()`` /
    ``.numpy()`` / ``.asnumpy()``, ``torch.cuda.synchronize()``, and
    ``float()``/``int()``/``bool()`` or Python truthiness on a value a
    ``torch.*`` call made (or an NDArray's ``_data`` / ``handle``). A
    silent sync in the step loop stalls the card behind the host.

``env-registry``
    Every ``MXNET_TPU_*`` read must go through
    :mod:`mxnet_tpu_torch.env` (``env.get``), whose declarations generate
    ``docs/env_vars_torch.md``: a raw ``os.environ`` / ``os.getenv`` read
    of an ``MXNET_TPU_*`` literal is a knob that ships undocumented.
    Reads through ``env.get`` of a name missing from the registry are
    findings too. Writes (staging a child process's environment) are out
    of scope. Suppress with ``# graft: env-ok``.

The JAX package's ``donation`` (a name read after a ``donate_argnums``
position deleted its buffer) and ``tracer`` (impure calls and Python
control flow on traced values inside ``jax.jit``) rules guard JAX's
buffer donation and tracing, which PyTorch has no counterpart of: the
port updates in place and runs eagerly or replays a CUDA graph. They are
not ported.

Annotations live in comments on the finding line or the line above::

    loss = float(loss_t)   # graft: host-sync

Accepted findings are carried in a baseline file
(``tools/graftlint_torch_baseline.json``), each with its reason:
fingerprints are stable under line-number drift (rule, file, enclosing
scope, normalized source line, occurrence index), so only *new* findings
fail the gate (``tests/test_torch_graftlint.py``). CLI:
``tools/torch_graftlint.py``.
"""
from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "Config", "analyze_source", "analyze_paths",
           "load_baseline", "save_baseline", "partition",
           "declared_env_names", "RULES", "NOT_PORTED"]

RULES = ("host-sync", "env-registry")

#: the JAX package's rule families with no PyTorch counterpart
NOT_PORTED = ("donation", "tracer")

# Rule id -> comment tag that suppresses it. ``# graft: <tag>``.
SUPPRESS_TAGS = {
    "host-sync": "host-sync",
    "env-registry": "env-ok",
}

# Default step-loop-reachable module set for the host-sync rule: code a
# training step executes per batch. Matched on file basename.
STEP_LOOP_FILES = frozenset({
    "engine.py", "executor.py", "fused_step.py", "metric.py",
    "io_pipeline.py",
})

_NP_CONVERT = frozenset({
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "_np.asarray", "_np.array", "np.ascontiguousarray", "np.asscalar",
})
_SYNC_METHODS = frozenset({"item", "tolist", "asnumpy", "cpu", "numpy"})
_DEVICE_SYNC = frozenset({"torch.cuda.synchronize", "cuda.synchronize"})
# torch namespaces and functions whose results are not tensors
_NOT_TENSOR_PREFIX = ("torch.cuda.", "torch.backends.", "torch.distributed.",
                      "torch.autograd.", "torch.profiler.", "torch.utils.",
                      "torch.testing.")
_NOT_TENSOR = frozenset({
    "torch.device", "torch.is_tensor", "torch.is_grad_enabled",
    "torch.get_default_dtype", "torch.Size", "torch.Generator",
    "torch.finfo", "torch.iinfo", "torch.promote_types",
    "torch.result_type", "torch.no_grad", "torch.enable_grad",
    "torch.inference_mode", "torch.is_floating_point",
})

_ENV_READERS = frozenset({"os.environ.get", "os.getenv", "environ.get",
                          "getenv"})
_ENV_REGISTRY_READERS = frozenset({"env.get", "_env.get", "env.is_set",
                                   "_env.is_set", "env.var", "_env.var"})


class Finding:
    """One rule violation at a source location."""

    __slots__ = ("rule", "path", "line", "col", "scope", "message",
                 "snippet", "fingerprint")

    def __init__(self, rule, path, line, col, scope, message, snippet,
                 fingerprint=""):
        self.rule = rule
        self.path = path
        self.line = line
        self.col = col
        self.scope = scope
        self.message = message
        self.snippet = snippet
        self.fingerprint = fingerprint

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "scope": self.scope, "message": self.message,
                "snippet": self.snippet, "fingerprint": self.fingerprint}

    def __repr__(self):
        return "%s:%d: [%s] %s" % (self.path, self.line, self.rule,
                                   self.message)


class Config:
    """Analyzer configuration; defaults match this repository's port."""

    def __init__(self, step_loop_files: Optional[Iterable[str]] = None,
                 declared_env: Optional[Iterable[str]] = None,
                 rules: Optional[Iterable[str]] = None):
        self.step_loop_files = frozenset(
            step_loop_files if step_loop_files is not None
            else STEP_LOOP_FILES)
        # None -> resolved lazily from mxnet_tpu_torch/env.py next to
        # this package (pure AST parse; the analyzer never imports the
        # tree it lints)
        self.declared_env = (frozenset(declared_env)
                             if declared_env is not None else None)
        self.rules = frozenset(rules if rules is not None else RULES)

    def env_names(self) -> frozenset:
        if self.declared_env is None:
            self.declared_env = frozenset(declared_env_names())
        return self.declared_env


def declared_env_names(env_path: Optional[str] = None) -> Set[str]:
    """Names declared in mxnet_tpu_torch/env.py, by AST (no import)."""
    if env_path is None:
        env_path = os.path.join(os.path.dirname(__file__), os.pardir,
                                "env.py")
    with open(env_path) as f:
        tree = ast.parse(f.read())
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and _dotted(node.func) in ("declare", "env.declare",
                                           "_env.declare") \
                and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            names.add(node.args[0].value)
    return names


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _dotted(node) -> str:
    """'torch.cuda.synchronize' for an Attribute/Name chain, '' else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _comment_tags(source: str) -> Dict[int, Set[str]]:
    """lineno -> set of ``# graft: tag[, tag]`` annotation tags."""
    tags: Dict[int, Set[str]] = {}
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type != tokenize.COMMENT:
                continue
            text = tok.string.lstrip("#").strip()
            if not text.startswith("graft:"):
                continue
            found = {t.strip() for t in text[len("graft:"):].split(",")}
            tags.setdefault(tok.start[0], set()).update(t for t in found
                                                        if t)
    except tokenize.TokenError:
        pass
    return tags


def _scope_walk(scope):
    """Walk a scope's nodes WITHOUT descending into nested function
    definitions (each nested def is analyzed as its own scope)."""
    todo = list(ast.iter_child_nodes(scope))
    while todo:
        n = todo.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            todo.extend(ast.iter_child_nodes(n))


def _truthy_value_names(test) -> Set[str]:
    """Names whose runtime VALUE a test converts to a Python bool:
    bare names, `not x` / and-or chains of them, and value comparisons
    (`x > 0`). Identity/membership tests (`x is None`, `k in d`) and
    names buried inside calls/attribute metadata (`x.dtype == f0`,
    `len(xs)`, `getattr(x, ...)`) do not sync and are excluded."""
    out: Set[str] = set()
    if isinstance(test, ast.Name):
        out.add(test.id)
    elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        out |= _truthy_value_names(test.operand)
    elif isinstance(test, ast.BoolOp):
        for v in test.values:
            out |= _truthy_value_names(v)
    elif isinstance(test, ast.Compare):
        if all(not isinstance(o, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for o in test.ops):
            for operand in [test.left] + list(test.comparators):
                if isinstance(operand, ast.Name):
                    out.add(operand.id)
    return out


def _scopes(tree) -> List[Tuple[str, ast.AST]]:
    """(qualname, node) for the module and every (async) function, the
    finding-scope granularity fingerprints key on."""
    out: List[Tuple[str, ast.AST]] = [("<module>", tree)]

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = prefix + child.name
                out.append((q, child))
                visit(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                visit(child, prefix + child.name + ".")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def _enclosing_scope(scopes, lineno) -> str:
    """Innermost function qualname containing ``lineno``."""
    best = "<module>"
    best_span = None
    for q, node in scopes:
        if q == "<module>":
            continue
        end = getattr(node, "end_lineno", node.lineno)
        if node.lineno <= lineno <= end:
            span = end - node.lineno
            if best_span is None or span <= best_span:
                best, best_span = q, span
    return best


class _Module:
    """Parsed module + everything the rules share."""

    def __init__(self, source: str, path: str, config: Config):
        self.source = source
        self.path = path
        self.config = config
        self.tree = ast.parse(source)
        self.lines = source.splitlines()
        self.tags = _comment_tags(source)
        self.scopes = _scopes(self.tree)
        self.basename = os.path.basename(path)

    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, rule: str, lineno: int) -> bool:
        tag = SUPPRESS_TAGS[rule]
        for ln in (lineno, lineno - 1):
            if tag in self.tags.get(ln, ()):
                return True
        return False

    def finding(self, rule: str, node, message: str) -> Optional[Finding]:
        line = getattr(node, "lineno", 1)
        if self.suppressed(rule, line):
            return None
        return Finding(rule, self.path, line,
                       getattr(node, "col_offset", 0),
                       _enclosing_scope(self.scopes, line), message,
                       self.snippet(line))


# ---------------------------------------------------------------------------
# rule: host-sync
# ---------------------------------------------------------------------------

def _makes_tensor(call: ast.Call) -> bool:
    d = _dotted(call.func)
    return (d.startswith("torch.") and not d.startswith(_NOT_TENSOR_PREFIX)
            and d not in _NOT_TENSOR)


def _device_tainted_names(scope) -> Set[str]:
    """Names assigned (anywhere in this scope) from a ``torch.*`` call
    or from an NDArray's ``_data`` / ``handle`` tensor: the
    local-dataflow approximation of 'this is a device value'."""
    tainted: Set[str] = set()

    def value_is_device(v) -> bool:
        if isinstance(v, ast.Call):
            return _makes_tensor(v)
        if isinstance(v, ast.Attribute):
            return v.attr in ("_data", "handle")
        if isinstance(v, ast.BinOp):
            return value_is_device(v.left) or value_is_device(v.right)
        if isinstance(v, ast.Name):
            return v.id in tainted
        return False

    for node in _scope_walk(scope):
        if isinstance(node, ast.Assign) and value_is_device(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    tainted.add(t.id)
        elif isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Name) \
                and value_is_device(node.value):
            tainted.add(node.target.id)
    return tainted


def _check_host_sync(mod: _Module) -> List[Finding]:
    if mod.basename not in mod.config.step_loop_files:
        return []
    findings: List[Finding] = []

    def emit(node, msg):
        f = mod.finding("host-sync", node, msg)
        if f is not None:
            findings.append(f)

    for qual, scope in mod.scopes:
        tainted = _device_tainted_names(scope)
        for node in _scope_walk(scope):
            if isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d in _NP_CONVERT and node.args and isinstance(
                        node.args[0], (ast.Name, ast.Attribute,
                                       ast.Subscript)):
                    emit(node, "%s() in step-loop code syncs (or "
                         "copies to) the host" % d)
                elif d in _DEVICE_SYNC:
                    emit(node, "torch.cuda.synchronize() in step-loop "
                         "code waits for the whole card")
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _SYNC_METHODS \
                        and not node.args:
                    emit(node, ".%s() in step-loop code blocks on "
                         "the device" % node.func.attr)
                elif isinstance(node.func, ast.Name) \
                        and node.func.id in ("float", "int", "bool") \
                        and len(node.args) == 1:
                    a = node.args[0]
                    if (isinstance(a, ast.Name) and a.id in tainted) \
                            or (isinstance(a, ast.Attribute)
                                and a.attr in ("_data", "handle")):
                        emit(node, "%s() on a device value forces a "
                             "host sync" % node.func.id)
            elif isinstance(node, (ast.If, ast.While)):
                test_names = _truthy_value_names(node.test) & tainted
                if test_names:
                    emit(node, "truthiness of device value%s %s "
                         "forces a host sync"
                         % ("s" if len(test_names) > 1 else "",
                            ", ".join(sorted(test_names))))
    return findings


# ---------------------------------------------------------------------------
# rule: env-registry
# ---------------------------------------------------------------------------

def _check_env_registry(mod: _Module) -> List[Finding]:
    if mod.basename == "env.py":
        return []
    findings: List[Finding] = []
    declared = mod.config.env_names()

    def emit(node, msg):
        f = mod.finding("env-registry", node, msg)
        if f is not None:
            findings.append(f)

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str) \
                    and node.args[0].value.startswith("MXNET_TPU_"):
                name = node.args[0].value
                if d in _ENV_READERS or d.endswith(".environ.get") \
                        or d.endswith(".getenv"):
                    emit(node, "%s(%r) bypasses the env registry: "
                         "declare in mxnet_tpu_torch/env.py and read via "
                         "env.get" % (d, name))
                elif d in _ENV_REGISTRY_READERS and name not in declared:
                    emit(node, "%s(%r): name is not declared in "
                         "mxnet_tpu_torch/env.py" % (d, name))
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load) \
                and _dotted(node.value) in ("os.environ", "environ"):
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str) \
                    and sl.value.startswith("MXNET_TPU_"):
                emit(node, "os.environ[%r] read bypasses the env "
                     "registry" % sl.value)
    return findings


_RULE_FNS = {
    "host-sync": _check_host_sync,
    "env-registry": _check_env_registry,
}


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _fingerprint(findings: List[Finding]) -> None:
    """Assign stable fingerprints: line numbers are excluded so pure
    drift doesn't invalidate a baseline; an occurrence index
    disambiguates identical lines in one scope."""
    seen: Dict[Tuple, int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col)):
        key = (f.rule, f.path, f.scope, f.snippet)
        k = seen.get(key, 0)
        seen[key] = k + 1
        raw = "|".join((f.rule, f.path, f.scope, f.snippet, str(k)))
        f.fingerprint = hashlib.sha1(raw.encode()).hexdigest()[:16]


def analyze_source(source: str, path: str,
                   config: Optional[Config] = None) -> List[Finding]:
    """Run every configured rule over one module's source."""
    config = config or Config()
    try:
        mod = _Module(source, path, config)
    except SyntaxError as e:
        return [Finding("parse-error", path, e.lineno or 1, 0, "<module>",
                        "syntax error: %s" % e.msg, "",
                        fingerprint="parse:%s" % path)]
    findings: List[Finding] = []
    for rule, fn in _RULE_FNS.items():
        if rule in config.rules:
            findings.extend(fn(mod))
    _fingerprint(findings)
    findings.sort(key=lambda f: (f.path, f.line, f.col))
    return findings


def iter_py_files(paths: Sequence[str]) -> List[str]:
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git", "_build",
                                        "_autotune")]
                out.extend(os.path.join(root, f) for f in files
                           if f.endswith(".py"))
    return sorted(set(out))


def analyze_paths(paths: Sequence[str],
                  config: Optional[Config] = None,
                  root: Optional[str] = None) -> List[Finding]:
    """Analyze every .py under ``paths``; finding paths are relative to
    ``root`` (default: cwd) so baselines are machine-independent."""
    config = config or Config()
    root = root or os.getcwd()
    findings: List[Finding] = []
    for fpath in iter_py_files(paths):
        with open(fpath, encoding="utf-8") as f:
            src = f.read()
        rel = os.path.relpath(fpath, root).replace(os.sep, "/")
        findings.extend(analyze_source(src, rel, config))
    findings.sort(key=lambda f: (f.path, f.line, f.col))
    return findings


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def load_baseline(path: str) -> Set[str]:
    """Accepted-finding fingerprints from a baseline file."""
    return {e["fingerprint"] for e in load_baseline_entries(path)}


def load_baseline_entries(path: str) -> List[dict]:
    """The baseline's entries, each a finding's dict and its ``reason``."""
    with open(path) as f:
        return json.load(f).get("findings", [])


def save_baseline(path: str, findings: Sequence[Finding],
                  reasons: Optional[Dict[str, str]] = None) -> None:
    """Write ``findings`` as the accepted set, each with its reason from
    ``reasons`` (fingerprint -> why it stays), else the reason the file
    already gives it, else an empty one (which the gate refuses)."""
    kept: Dict[str, str] = {}
    if os.path.exists(path):
        kept = {e["fingerprint"]: e.get("reason", "")
                for e in load_baseline_entries(path)}
    kept.update(reasons or {})
    data = {
        "comment": "graftlint accepted findings of the port, each with "
                   "its reason; regenerate with `python "
                   "tools/torch_graftlint.py --write-baseline`",
        "version": 1,
        "findings": [dict(f.to_dict(), reason=kept.get(f.fingerprint, ""))
                     for f in findings],
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")


def partition(findings: Sequence[Finding],
              baseline: Set[str]) -> Tuple[List[Finding], List[Finding]]:
    """(new, accepted) split against baseline fingerprints."""
    new = [f for f in findings if f.fingerprint not in baseline]
    old = [f for f in findings if f.fingerprint in baseline]
    return new, old
