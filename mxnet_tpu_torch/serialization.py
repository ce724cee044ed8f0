"""NDArray and parameter files: the reference's npz container.

Counterpart of ``mxnet_tpu/serialization.py:1-80``, a copy of its format:
a numpy ``.npz`` archive (no pickle) holding one array per entry and a
``__manifest__`` (JSON bytes) with ``magic`` ``"mxnet_tpu_ndarray_v1"`` and,
per entry, its ``key``, its dtype name and the archive ``slot`` of its array.
numpy has no bfloat16, so a bfloat16 array is stored as float32 with the
dtype ``"bfloat16"`` and cast back on load (exact: every bfloat16 value is a
float32 value). A list is stored under the keys ``__list__<i>`` and loads as
a list; a dict keeps its keys (``arg:``/``aux:`` prefixes verbatim). A file
written by either package loads in the other.

``save_ndarrays`` takes NDArrays, torch tensors or numpy arrays;
``load_tensors`` returns ``{key: torch.Tensor}`` on the CPU (or the list),
and ``load_ndarrays`` the same as NDArrays on ``ctx`` (default: the current
context, as the reference places them).
"""
from __future__ import annotations

import json
import os

import numpy as _np
import torch

from .base import MXNetError, torch_dtype

_MAGIC = "mxnet_tpu_ndarray_v1"
_LIST = "__list__"


def _to_numpy(arr):
    """(numpy array, dtype name) of an NDArray, tensor or array."""
    from .ndarray import NDArray
    if isinstance(arr, NDArray):
        arr = arr._data
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = _np.asarray(arr)
    return a, str(a.dtype)


def save_ndarrays(fname: str, data) -> None:
    """Write an NDArray, a list of them or a dict of them to ``fname``."""
    from .ndarray import NDArray
    if isinstance(data, (NDArray, torch.Tensor)):
        data = [data]
    if isinstance(data, (list, tuple)):
        keys = [f"{_LIST}{i}" for i in range(len(data))]
        vals = list(data)
    elif isinstance(data, dict):
        keys = list(data.keys())
        vals = list(data.values())
    else:
        raise MXNetError("save: expected NDArray, list, or dict")
    arrays = {}
    manifest = {"magic": _MAGIC, "entries": []}
    for i, (k, v) in enumerate(zip(keys, vals)):
        a, dt = _to_numpy(v)
        arrays[f"a{i}"] = a
        manifest["entries"].append({"key": k, "dtype": dt, "slot": f"a{i}"})
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        _np.savez(f, __manifest__=_np.frombuffer(
            json.dumps(manifest).encode(), dtype=_np.uint8), **arrays)
    os.replace(tmp, fname)


def load_tensors(fname: str):
    """The arrays of ``fname`` as CPU tensors: a list for a saved list, else
    a dict by key."""
    with _np.load(fname, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        if manifest.get("magic") != _MAGIC:
            raise MXNetError(f"{fname}: not a mxnet_tpu ndarray file")
        out = {}
        for e in manifest["entries"]:
            a = _np.ascontiguousarray(z[e["slot"]])
            out[e["key"]] = torch.from_numpy(a).to(torch_dtype(e["dtype"]))
    if out and all(k.startswith(_LIST) for k in out):
        return [out[f"{_LIST}{i}"] for i in range(len(out))]
    return out


def load_ndarrays(fname: str, ctx=None):
    """``load_tensors`` as NDArrays on ``ctx`` (default: the current
    context)."""
    from .context import current_context
    from .ndarray import NDArray
    ctx = ctx or current_context()
    loaded = load_tensors(fname)

    def wrap(t):
        return NDArray(t.to(ctx.torch_device), ctx)
    if isinstance(loaded, list):
        return [wrap(t) for t in loaded]
    return {k: wrap(t) for k, t in loaded.items()}
