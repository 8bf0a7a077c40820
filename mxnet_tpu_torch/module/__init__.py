"""Module API: the port of ``mxnet_tpu/module/`` (``BaseModule``,
``Module`` and its executor group).  ``BucketingModule``,
``SequentialModule`` and the Python modules wait for ROADMAP §A15b."""

from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "Module", "DataParallelExecutorGroup"]
