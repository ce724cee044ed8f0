"""Model library (counterpart of ``mxnet_tpu/models``).

Ported so far: LeNet and MLP (exported as the reference exports them,
``mxnet_tpu/models/__init__.py:15-16``), the BERT family and the sparse-MoE
transformer LM of the expert-parallel recipe. The vision zoo's re-exports
wait for the slice that ports the other zoo families (the ResNets are in
``gluon.model_zoo.vision``).
"""
from .lenet import LeNet, lenet
from .mlp import MLP, mlp
from .bert import (BertModel, BertEncoder, TransformerEncoderCell,
                   bert_base, bert_large, bert_tiny)
from .moe_transformer import (MoEPositionwiseFFN, MoETransformerCell,
                              MoETransformerLM, moe_transformer_tiny)

__all__ = ["LeNet", "lenet", "MLP", "mlp", "BertModel", "BertEncoder", "TransformerEncoderCell", "bert_base",
           "bert_large", "bert_tiny", "MoEPositionwiseFFN", "MoETransformerCell",
           "MoETransformerLM", "moe_transformer_tiny"]
