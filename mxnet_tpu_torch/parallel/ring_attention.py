"""Sequence/context-parallel attention, re-exported from ``ops.attention``
(counterpart of ``mxnet_tpu/parallel/ring_attention.py``; the design notes
are there)."""
from ..ops.attention import (blockwise_attention, ring_attention, ulysses_attention,
                             flash_attention_op)

__all__ = ["blockwise_attention", "ring_attention", "ulysses_attention",
           "flash_attention_op"]
