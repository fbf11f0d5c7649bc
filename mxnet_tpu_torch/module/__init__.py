"""Module API (one context, or one replica a context over several):
bind, predict and fit; the bucketing, sequential and Python modules."""
from .base_module import BaseModule, BatchEndParam
from .module import Module
from .executor_group import DataParallelExecutorGroup
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule

__all__ = ["BaseModule", "BatchEndParam", "Module",
           "DataParallelExecutorGroup", "BucketingModule",
           "SequentialModule", "PythonModule", "PythonLossModule"]
