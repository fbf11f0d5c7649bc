"""Operator library: registry, ops and kernels. Importing this package
registers every operator of the port."""
from .registry import (Operator, OpContext, Param, REQUIRED, OP_REGISTRY,
                       register_op, create_operator)
from . import kernels  # noqa: F401
from . import nn       # noqa: F401
from . import tensor   # noqa: F401

__all__ = ["Operator", "OpContext", "Param", "REQUIRED", "OP_REGISTRY",
           "register_op", "create_operator"]
