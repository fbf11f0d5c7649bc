"""Static analysis (graftlint/graftrace) and runtime sanitizers,
counterpart of ``mxnet_tpu/analysis``.

``graftlint`` is the AST framework with the host-sync and env-registry
rule families (the JAX package's donation and tracer families have no
PyTorch counterpart); ``graftrace`` registers the concurrency families
(lock-order / blocking-under-lock / thread-lifecycle / fork-safety) into
the same driver. Both are baseline-gated by
``tests/test_torch_graftlint.py``; CLI at ``tools/torch_graftlint.py``.
``sanitizers`` is the runtime half, armed with ``MXNET_TPU_SANITIZE``.
"""
from . import graftlint, sanitizers  # noqa: F401
from . import graftrace  # noqa: F401  (registers concurrency rules)
from .graftlint import Config, Finding, analyze_paths, analyze_source
from .sanitizers import (DeadlockWatchdog, DonationSanitizer,
                         InstrumentedLock, RetraceSanitizer,
                         SanitizerError)

__all__ = ["graftlint", "graftrace", "sanitizers", "Config", "Finding",
           "analyze_paths", "analyze_source", "SanitizerError",
           "RetraceSanitizer", "DonationSanitizer", "InstrumentedLock",
           "DeadlockWatchdog"]
