"""Parallel training (counterpart of ``mxnet_tpu/parallel/``): the fused
training step ``DataParallelTrainer`` with its ``functional_optimizer``, and
the one-device ``mesh`` helpers. More devices, tensor, sequence and pipeline
parallelism wait for later slices (ROADMAP A2)."""
from .mesh import (Mesh, PartitionSpec, P, make_mesh, local_mesh, current_mesh,
                   set_default_mesh)
from .data_parallel import DataParallelTrainer, functional_optimizer, PendingScalar

__all__ = ["Mesh", "PartitionSpec", "P", "make_mesh", "local_mesh", "current_mesh",
           "set_default_mesh", "DataParallelTrainer", "functional_optimizer",
           "PendingScalar"]
