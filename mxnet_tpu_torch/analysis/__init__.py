"""Runtime sanitizers, counterpart of ``mxnet_tpu/analysis`` (its
``sanitizers`` module; the static passes, graftlint and graftrace, are
not ported). Armed with ``MXNET_TPU_SANITIZE``."""
from . import sanitizers  # noqa: F401
from .sanitizers import (DeadlockWatchdog, DonationSanitizer,
                         InstrumentedLock, RetraceSanitizer,
                         SanitizerError)

__all__ = ["sanitizers", "SanitizerError", "RetraceSanitizer",
           "DonationSanitizer", "InstrumentedLock", "DeadlockWatchdog"]
