"""Module API (single device): bind, predict and fit."""
from .base_module import BaseModule, BatchEndParam
from .module import Module
from .executor_group import DataParallelExecutorGroup

__all__ = ["BaseModule", "BatchEndParam", "Module",
           "DataParallelExecutorGroup"]
