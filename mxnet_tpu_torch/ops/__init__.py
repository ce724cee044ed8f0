"""Operators: one plain torch function per MXNet op name.

Importing this package registers every ported op. The CUDA kernels and their
wrappers live in ``ops.cuda``; nothing there is built at import.
"""
from . import registry
from . import (elemwise, matrix, nn, reduce, attention, optimizer_ops,  # noqa: F401
               linalg, random_sample)  # (register ops)
from .registry import get_op, list_ops, register

__all__ = ["registry", "get_op", "list_ops", "register"]
