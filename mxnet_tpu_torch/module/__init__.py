"""Module API: the port of ``mxnet_tpu/module/``: ``BaseModule``,
``Module`` and its executor group, ``BucketingModule``,
``SequentialModule``, ``PythonModule`` and ``PythonLossModule``."""

from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule", "DataParallelExecutorGroup"]
