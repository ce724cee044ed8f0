"""Base utilities: the framework error, the env-var registry, dtype names.

Counterpart of ``mxnet_tpu/base.py:20-117``. Kept: ``MXNetError`` and the
typed ``MXNET_*`` environment registry. The mshadow dtype-code tables
have no counterpart: the file format (``serialization.py``) names dtypes,
as the reference's does. In their place sits ``torch_dtype``, which maps
the MXNet dtype names the Gluon layers pass around (``"float32"``,
``"bfloat16"``, numpy dtypes) onto ``torch.dtype``.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

import numpy as _np
import torch


class MXNetError(RuntimeError):
    """Error raised by the framework (name kept for API parity)."""


class _EnvRegistry:
    """Typed registry over MXNET_* environment variables."""

    def __init__(self) -> None:
        self._decls: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def declare(self, name: str, default: Any, typ: Callable[[str], Any],
                doc: str = "") -> None:
        with self._lock:
            self._decls.setdefault(name, (default, typ, doc))

    def get(self, name: str, default: Any = None,
            typ: Optional[Callable] = None) -> Any:
        if name in self._decls:
            ddefault, dtyp, _ = self._decls[name]
            default = default if default is not None else ddefault
            typ = typ or dtyp
        raw = os.environ.get(name)
        if raw is None:
            return default
        if typ is bool:
            return raw.lower() in ("1", "true", "yes", "on")
        return (typ or str)(raw)

    def items(self):
        return dict(self._decls)


env = _EnvRegistry()
env.declare("MXNET_DEFAULT_DTYPE", "float32", str, "Default dtype for new arrays")
env.declare("MXNET_FLASH_ATTENTION_MIN_SEQ", 1024, int,
            "Sequence length from which BERT attention takes the flash kernel")
env.declare("MXNET_SAFE_ACCUMULATION", True, bool,
            "Accumulate reductions in float32 even for bf16/f16 inputs")


_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """MXNet dtype name, numpy dtype or torch dtype -> torch.dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None


def default_dtype() -> torch.dtype:
    return torch_dtype(env.get("MXNET_DEFAULT_DTYPE"))
