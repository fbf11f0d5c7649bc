"""Module API (single device, inference)."""
from .base_module import BaseModule
from .module import Module
from .executor_group import DataParallelExecutorGroup

__all__ = ["BaseModule", "Module", "DataParallelExecutorGroup"]
