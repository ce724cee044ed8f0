"""Parallel training (counterpart of ``mxnet_tpu/parallel/``): meshes over one
device or the ranks of a ``torch.distributed`` job (``mesh``), the fused
training step ``DataParallelTrainer`` with its ``functional_optimizer`` and
its ZeRO-sharded update (``zero``), the tensor-parallel specs
(``tensor_parallel``: specs, the logical-role rules, the weight gather), the
Megatron collectives and partitioned programs (``megatron``), and
ring and Ulysses attention (``ring_attention``), the mixture of experts
with expert parallelism (``moe``), and the pipeline over a pp axis with
optional dp and tp axes (``pipeline``: ``PipelineTrainer``, the 1F1B
``schedule_1f1b`` and its interleaved chunks, GPipe's ``pipeline_apply``
and ``gpipe_schedule``, ``pipeline_spec``; tensor parallelism in the stages,
weight-sharded or partitioned, and ZeRO over dp), and the backward-overlapped
gradient reduction (``overlap``: the segment plan and the bucket reduce of
``DataParallelTrainer(overlap_grads=True)``)."""
from .mesh import (Mesh, PartitionSpec, P, make_mesh, local_mesh, current_mesh,
                   set_default_mesh, require_axis, axis_size, axis_index, activate,
                   active_mesh, sequence_axis)
from .data_parallel import DataParallelTrainer, functional_optimizer, PendingScalar
from .tensor_parallel import (column_parallel_spec, row_parallel_spec,
                              shard_params_megatron, tp_shard_dim, gather_tp, slice_tp,
                              shard_rules, apply_rules)
from .megatron import (copy_to_tp, reduce_from_tp, gather_from_sp, scatter_to_sp,
                       partial_grad, vocab_parallel_embedding, vocab_parallel_cross_entropy)
from . import zero
from .ring_attention import ring_attention, ulysses_attention
from . import moe
from .moe import (moe_ffn, expert_parallel_moe, topk_gating, load_balancing_loss,
                  load_balance_loss, dropped_tokens, wire_all_to_all,
                  all_to_all_wire_bytes, moe_capacity, expert_axis, collect_metrics)
from . import overlap
from . import pipeline
from .pipeline import (PipelineTrainer, pipeline_spec, pipeline_apply, gpipe_schedule,
                       schedule_1f1b)

__all__ = ["Mesh", "PartitionSpec", "P", "make_mesh", "local_mesh", "current_mesh",
           "set_default_mesh", "require_axis", "axis_size", "axis_index", "activate",
           "active_mesh", "sequence_axis", "DataParallelTrainer",
           "functional_optimizer", "PendingScalar", "column_parallel_spec",
           "row_parallel_spec", "shard_params_megatron", "tp_shard_dim", "gather_tp",
           "slice_tp", "shard_rules", "apply_rules",
           "copy_to_tp", "reduce_from_tp", "gather_from_sp", "scatter_to_sp",
           "partial_grad", "vocab_parallel_embedding", "vocab_parallel_cross_entropy", "zero", "ring_attention",
           "ulysses_attention", "moe", "moe_ffn", "expert_parallel_moe", "topk_gating",
           "load_balancing_loss", "load_balance_loss", "dropped_tokens", "wire_all_to_all",
           "all_to_all_wire_bytes", "moe_capacity", "expert_axis", "collect_metrics",
           "pipeline", "PipelineTrainer", "pipeline_spec", "pipeline_apply", "gpipe_schedule",
           "schedule_1f1b", "overlap"]
