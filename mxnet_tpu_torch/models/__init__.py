"""Model library (counterpart of ``mxnet_tpu/models``).

Ported so far: the BERT family and the sparse-MoE transformer LM of the
expert-parallel recipe. The vision zoo, LeNet and MLP wait for later
slices.
"""
from .bert import (BertModel, BertEncoder, TransformerEncoderCell,
                   bert_base, bert_large, bert_tiny)
from .moe_transformer import (MoEPositionwiseFFN, MoETransformerCell,
                              MoETransformerLM, moe_transformer_tiny)

__all__ = ["BertModel", "BertEncoder", "TransformerEncoderCell", "bert_base",
           "bert_large", "bert_tiny", "MoEPositionwiseFFN", "MoETransformerCell",
           "MoETransformerLM", "moe_transformer_tiny"]
