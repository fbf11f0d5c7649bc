#!/usr/bin/env python
"""graftlint CLI for the PyTorch port: host-sync, env-registry and the
four concurrency rule families (graftrace) over ``mxnet_tpu_torch/``.

Usage::

    python tools/torch_graftlint.py                  # gate the port on its baseline
    python tools/torch_graftlint.py mxnet_tpu_torch/io.py --no-baseline
    python tools/torch_graftlint.py --write-baseline # accept today's findings
    python tools/torch_graftlint.py --write-env-docs # regen docs/env_vars_torch.md
    python tools/torch_graftlint.py --check-env-docs # verify docs in sync

With no paths it analyzes ``mxnet_tpu_torch/`` against
``tools/graftlint_torch_baseline.json``, where every accepted finding
carries its reason (``--write-baseline`` keeps the reasons the file
already gives; a new entry's reason is written by hand). Exit codes: 0
clean, 1 new findings, a baselined finding without a reason, or docs
drift; 2 usage error. Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from mxnet_tpu_torch.analysis import graftlint, graftrace  # noqa: E402,F401

BASELINE = os.path.join(_ROOT, "tools", "graftlint_torch_baseline.json")
PORT = os.path.join(_ROOT, "mxnet_tpu_torch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_graftlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: mxnet_tpu_torch/)")
    ap.add_argument("--baseline", default=BASELINE,
                    help="accepted-findings JSON file (default: %(default)s)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite --baseline with the current findings")
    ap.add_argument("--rules", help="comma list of rule ids to run "
                    "(default: all of %s)" % ", ".join(graftlint.RULES))
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--write-env-docs", action="store_true",
                    help="regenerate the block of docs/env_vars_torch.md "
                    "from mxnet_tpu_torch/env.py")
    ap.add_argument("--check-env-docs", action="store_true",
                    help="fail if docs/env_vars_torch.md is out of sync "
                    "with the port's env registry")
    args = ap.parse_args(argv)

    if args.write_env_docs or args.check_env_docs:
        from mxnet_tpu_torch import env

        doc_path = os.path.join(_ROOT, "docs", "env_vars_torch.md")
        in_sync = env.sync_docs(doc_path, check=args.check_env_docs)
        if args.check_env_docs and not in_sync:
            print("torch_graftlint: docs/env_vars_torch.md is OUT OF SYNC "
                  "with mxnet_tpu_torch/env.py; run `python "
                  "tools/torch_graftlint.py --write-env-docs`")
            return 1
        if args.write_env_docs and not in_sync:
            print("torch_graftlint: rewrote the generated block of %s"
                  % os.path.relpath(doc_path))
        if not args.paths:
            return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        bad = set(rules) - set(graftlint.RULES)
        if bad:
            print("torch_graftlint: unknown rule(s): %s"
                  % ", ".join(sorted(bad)))
            return 2
    config = graftlint.Config(rules=rules)
    findings = graftlint.analyze_paths(args.paths or [PORT], config,
                                       root=_ROOT)

    if args.write_baseline:
        graftlint.save_baseline(args.baseline, findings)
        print("torch_graftlint: wrote %d accepted finding(s) to %s"
              % (len(findings), args.baseline))
        return 0

    entries = []
    if not args.no_baseline and os.path.exists(args.baseline):
        entries = graftlint.load_baseline_entries(args.baseline)
    baseline = {e["fingerprint"] for e in entries}
    unexplained = [e for e in entries if not e.get("reason", "").strip()]
    new, accepted = graftlint.partition(findings, baseline)
    stale = baseline - {f.fingerprint for f in findings}

    if args.json:
        print(json.dumps({"new": [f.to_dict() for f in new],
                          "accepted": [f.to_dict() for f in accepted],
                          "stale_baseline": sorted(stale),
                          "without_reason": [e["fingerprint"]
                                             for e in unexplained]},
                         indent=1))
    else:
        for f in new:
            print("%s:%d: [%s] %s\n    %s"
                  % (f.path, f.line, f.rule, f.message, f.snippet))
        for e in unexplained:
            print("%s:%d: [%s] baselined without a reason\n    %s"
                  % (e["path"], e["line"], e["rule"], e["snippet"]))
        if accepted:
            print("torch_graftlint: %d baselined finding(s) suppressed"
                  % len(accepted))
        if stale:
            print("torch_graftlint: %d stale baseline entr%s (fixed "
                  "findings still in the baseline: rewrite it with "
                  "--write-baseline)"
                  % (len(stale), "y" if len(stale) == 1 else "ies"))
        print("torch_graftlint: %d new finding(s) in %d file(s)"
              % (len(new), len({f.path for f in new})))
    return 1 if new or unexplained else 0


if __name__ == "__main__":
    sys.exit(main())
