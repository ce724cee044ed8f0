"""Fused multi-tensor SGD and Adam: CUDA kernels, wrappers, plain versions.

Counterpart of ``mxnet_tpu/ops/pallas/fused_optimizer.py``: the Pallas
kernels ``_sgd_kernel`` (:66, launched by ``fused_sgd_apply`` at :90) and
``_adam_kernel`` (:116, launched by ``fused_adam_apply`` at :153) become the
hand-written Hopper kernels of ``csrc/fused_optimizer.cu``, one launch per
call over the whole list of tensors, with no flatten copy.

- ``fused_sgd_apply(weights, grads, moms, lr, momentum, wd, out=None)`` ->
  ``(new_weights, new_moms)``: g = grad + wd*w; m = momentum*m + g;
  w = w - lr*m.
- ``fused_adam_apply(weights, grads, ms, vs, lr, beta1, beta2, eps, wd, t,
  out=None)`` -> ``(new_weights, new_ms, new_vs)``: the Adam step with the
  bias correction inside, w = w - lr*(m/c1) / (sqrt(v/c2) + eps),
  c1 = 1 - beta1**t, c2 = 1 - beta2**t.

The reference's fused training step (``mxnet_tpu/parallel/data_parallel.py``
``functional_optimizer``) does not use these rules but the registered update
ops' (``mxnet_tpu/ops/optimizer_ops.py``), which the same kernels carry as
other rules, each one launch over the list:

- ``fused_sgd_mom_update(weights, grads, moms, lr, momentum, wd,
  rescale_grad, clip_gradient, out=None)``: ``sgd_mom_update``'s rule,
  g = clip(rescale*grad) + wd*w; m = momentum*m - lr*g; w = w + m.
- ``fused_sgd_update(weights, grads, lr, wd, rescale_grad, clip_gradient,
  out=None)`` -> ``(new_weights,)``: ``sgd_update``'s, no state.
- ``fused_adam_update(weights, grads, ms, vs, lr, beta1, beta2, epsilon, wd,
  rescale_grad, clip_gradient, out=None)``: ``adam_update``'s, g =
  clip(rescale*grad + wd*w) and no bias correction (the caller folds it into
  lr, as ``_k_adam`` does).

clip is on when ``clip_gradient >= 0``, as in the reference's ``_clip``.
All take the reference's signatures and, like it, return new lists. The
keyword ``out`` (a tuple of lists in the order of the result) names the
tensors to write instead: ``out=(weights, moms)`` updates in place. For CUDA
tensors the wrapper launches the kernel or raises, and counts launches in
``fused_sgd_apply.launches`` / ``fused_adam_apply.launches``; for CPU tensors
it runs the plain version (``fused_sgd_apply_plain``,
``fused_adam_apply_plain``, and ``<name>_plain`` for the other three), the
same f32 arithmetic in PyTorch. ``table_stats`` counts the pointer tables
built and found in the cache (below).

The three rules of the fused step also take their scalars from memory:
``fused_sgd_update_hyper(weights, grads, hyper, out)``,
``fused_sgd_mom_update_hyper(weights, grads, moms, hyper, out)`` and
``fused_adam_update_hyper(weights, grads, ms, vs, hyper, out)``, where
``hyper`` is a float32 tensor of the 10 values of ``HYPER_FIELDS`` (lr,
momentum, wd, beta1, beta2, epsilon, c1, c2, rescale_grad, clip_gradient;
``hyper_values`` makes them) on the weights' device. On the card the
kernel reads them from device memory when it runs (``mxt_fused_*_hyper``),
so a CUDA graph that captured the launch takes the values written before
each replay; on the CPU the plain versions read them from the tensor. The
three rules' by-value signatures above call these with a ``hyper`` tensor
made from their floats, so each rule has one launching path, whose
``launches`` counter counts under graph replay too (``engine``). The
by-value kernel entry points (``mxt_fused_sgd``, ``mxt_fused_adam``) serve
``fused_sgd_apply`` and ``fused_adam_apply``.

The gate: the three ``*_hyper`` forms take ``skip``, None or a float32
tensor of one element on the weights' device (the float16 step's overflow
flag). Where it is nonzero the update writes nothing: every weight and
state keeps its value, bitwise. On the card the kernel reads it when it
runs (a block that sees it set returns first), so neither the launch nor a
replay of a captured one reads it on the host; on the CPU the plain
versions select the old values by ``torch.where`` on the same tensor,
without reading it either.

A pointer table is never built while a CUDA graph is being captured: the
copy of the table to the device would be captured with a host buffer that
does not outlive the call. A miss then raises ``MXNetError``; the
warm-up run before a capture builds every table, and the capture keeps the
tables it reads alive (``engine.keep_alive``).

Semantics to keep apart (ROADMAP B5, B6): this momentum rule is not
``sgd_mom_update``'s (which folds lr into the momentum), and this Adam
applies the bias correction itself, so eps lands elsewhere than in
``adam_update`` with a bias-corrected lr. ``gluon.Trainer`` never calls
these functions, as in the reference.

Each list holds contiguous tensors of one device; weights and grads share
one dtype, and the states (moms, or ms and vs) one dtype, each float32,
bfloat16 or float16; anything else raises. The device table of pointers is
cached by the tensors' data pointers, sizes and dtypes, so repeated calls on
the same tensors (an in-place update loop) copy nothing to the device beyond
the launch and skip the per-tensor checks, which cost more host time than
the kernel takes on the card: a call whose tensors have the pointers, sizes
and dtypes of an earlier checked call, and are contiguous, is taken to be
that call's tensors.
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

from ... import engine
from ...base import MXNetError
from . import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_CHUNK = 16384          # elements per thread block (csrc kChunk)
_TABLE_CACHE_SIZE = 16
_tables: "OrderedDict[tuple, tuple]" = OrderedDict()
table_stats = {"built": 0, "hits": 0}
# csrc Rule: the SGD rules of mxt_fused_sgd
_RULE_SGD_PALLAS, _RULE_SGD_MOM, _RULE_SGD = 0, 1, 2


def _library() -> ctypes.CDLL:
    lib = load_library("fused_optimizer", ["fused_optimizer.cu"])
    if lib.mxt_fused_sgd.argtypes is None:
        head = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int]
        lib.mxt_fused_sgd.argtypes = head + [ctypes.c_int] + [ctypes.c_float] * 5 \
            + [ctypes.c_void_p]
        lib.mxt_fused_adam.argtypes = head + [ctypes.c_float] * 9 + [ctypes.c_void_p]
        lib.mxt_fused_sgd.restype = ctypes.c_int
        lib.mxt_fused_adam.restype = ctypes.c_int
        lib.mxt_fused_sgd_hyper.argtypes = head + [ctypes.c_int] + [ctypes.c_void_p] * 3
        lib.mxt_fused_adam_hyper.argtypes = head + [ctypes.c_void_p] * 3
        lib.mxt_fused_sgd_hyper.restype = ctypes.c_int
        lib.mxt_fused_adam_hyper.restype = ctypes.c_int
        if lib.mxt_fused_hyper_floats() != len(HYPER_FIELDS):
            raise MXNetError("fused_optimizer: the library's Hyper has another size")
        lib.mxt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxt_cuda_error_string.restype = ctypes.c_char_p
        if lib.mxt_fused_chunk_elems() != _CHUNK:
            raise MXNetError("fused_optimizer: chunk size of the library differs")
    return lib


def _f32(x) -> np.float32:
    return np.float32(x)


# csrc struct Hyper, in order
HYPER_FIELDS = ("lr", "momentum", "wd", "beta1", "beta2", "epsilon", "c1", "c2",
                "rescale_grad", "clip_gradient")
_HYPER_DEFAULTS = dict(lr=0.0, momentum=0.0, wd=0.0, beta1=0.0, beta2=0.0, epsilon=0.0,
                       c1=1.0, c2=1.0, rescale_grad=1.0, clip_gradient=-1.0)


def hyper_values(**kw) -> List[float]:
    """The 10 values of ``HYPER_FIELDS`` as float32-rounded floats; fields
    not given take the value that leaves them out (c1 = c2 = rescale = 1,
    clip -1, the others 0)."""
    bad = set(kw) - set(HYPER_FIELDS)
    if bad:
        raise MXNetError(f"hyper_values: unknown fields {sorted(bad)}")
    return [float(_f32(kw.get(k, _HYPER_DEFAULTS[k]))) for k in HYPER_FIELDS]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _write_out(results, out):
    if out is None:
        return results
    with torch.no_grad():
        for dsts, srcs in zip(out, results):
            for d, s in zip(dsts, srcs):
                d.copy_(s)
    return tuple(list(dsts) for dsts in out)


def fused_sgd_apply_plain(weights, grads, moms, lr, momentum=0.0, wd=0.0,
                          out=None):
    """The SGD kernel's arithmetic in PyTorch, f32 inside."""
    lr, mom, wd = float(_f32(lr)), float(_f32(momentum)), float(_f32(wd))
    new_w, new_m = [], []
    for w, g, m in zip(weights, grads, moms):
        wf = w.float()
        gf = g.float() + wd * wf
        mf = mom * m.float() + gf
        new_w.append((wf - lr * mf).to(w.dtype))
        new_m.append(mf.to(m.dtype))
    return _write_out((new_w, new_m), out)


def _adam_scalars(lr, beta1, beta2, eps, wd, t):
    b1, b2 = _f32(beta1), _f32(beta2)
    return dict(lr=_f32(lr), b1=b1, b2=b2, eps=_f32(eps), wd=_f32(wd),
                omb1=np.float32(1) - b1, omb2=np.float32(1) - b2,
                c1=_f32(1.0 - float(beta1) ** t), c2=_f32(1.0 - float(beta2) ** t))


def fused_adam_apply_plain(weights, grads, ms, vs, lr, beta1=0.9, beta2=0.999,
                           eps=1e-8, wd=0.0, t: int = 1, out=None):
    """The Adam kernel's arithmetic in PyTorch, f32 inside."""
    s = {k: float(v) for k, v in _adam_scalars(lr, beta1, beta2, eps, wd, t).items()}
    new_w, new_m, new_v = [], [], []
    for w, g, m, v in zip(weights, grads, ms, vs):
        wf = w.float()
        gf = g.float() + s["wd"] * wf
        mf = s["b1"] * m.float() + s["omb1"] * gf
        vf = s["b2"] * v.float() + s["omb2"] * gf * gf
        w2 = wf - s["lr"] * (mf / s["c1"]) / (torch.sqrt(vf / s["c2"]) + s["eps"])
        new_w.append(w2.to(w.dtype))
        new_m.append(mf.to(m.dtype))
        new_v.append(vf.to(v.dtype))
    return _write_out((new_w, new_m, new_v), out)


def _clip(g, clip):
    return g if clip < 0 else torch.clamp(g, -clip, clip)


def fused_sgd_mom_update_plain(weights, grads, moms, lr, momentum=0.0, wd=0.0,
                               rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """``sgd_mom_update``'s arithmetic over the list, f32 inside."""
    lr, mom, wd, rs, clip = map(lambda v: float(_f32(v)),
                                (lr, momentum, wd, rescale_grad, clip_gradient))
    new_w, new_m = [], []
    for w, g, m in zip(weights, grads, moms):
        wf = w.float()
        gf = _clip(g.float() * rs, clip) + wd * wf
        mf = mom * m.float() - lr * gf
        new_w.append((wf + mf).to(w.dtype))
        new_m.append(mf.to(m.dtype))
    return _write_out((new_w, new_m), out)


def fused_sgd_update_plain(weights, grads, lr, wd=0.0, rescale_grad=1.0,
                           clip_gradient=-1.0, out=None):
    """``sgd_update``'s arithmetic over the list, f32 inside."""
    lr, wd, rs, clip = map(lambda v: float(_f32(v)), (lr, wd, rescale_grad, clip_gradient))
    new_w = [(w.float() - lr * (_clip(g.float() * rs, clip) + wd * w.float())).to(w.dtype)
             for w, g in zip(weights, grads)]
    return _write_out((new_w,), out)


def fused_adam_update_plain(weights, grads, ms, vs, lr, beta1=0.9, beta2=0.999,
                            epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                            out=None):
    """``adam_update``'s arithmetic over the list, f32 inside."""
    lr, b1, b2, eps, wd, rs, clip = map(
        lambda v: float(_f32(v)),
        (lr, beta1, beta2, epsilon, wd, rescale_grad, clip_gradient))
    omb1, omb2 = float(np.float32(1) - _f32(b1)), float(np.float32(1) - _f32(b2))
    new_w, new_m, new_v = [], [], []
    for w, g, m, v in zip(weights, grads, ms, vs):
        wf = w.float()
        gf = _clip(g.float() * rs + wd * wf, clip)
        mf = b1 * m.float() + omb1 * gf
        vf = b2 * v.float() + omb2 * gf * gf
        new_w.append((wf - lr * mf / (torch.sqrt(vf) + eps)).to(w.dtype))
        new_m.append(mf.to(m.dtype))
        new_v.append(vf.to(v.dtype))
    return _write_out((new_w, new_m, new_v), out)


def _read_hyper(hyper) -> dict:
    if hyper.dtype != torch.float32 or hyper.numel() != len(HYPER_FIELDS):
        raise MXNetError(f"hyper must hold the {len(HYPER_FIELDS)} float32 values of "
                         f"HYPER_FIELDS, got {hyper.dtype} {tuple(hyper.shape)}")
    return dict(zip(HYPER_FIELDS, hyper.reshape(-1).tolist()))


def _gated(old_lists, results, skip, out):
    """``results`` (new lists) where ``skip`` is zero, else the old values
    (``old_lists``), then written to ``out`` as ``_write_out`` does; the
    flag stays a tensor."""
    if skip is None:
        return _write_out(results, out)
    keep = skip.reshape(()) != 0
    gated = tuple([torch.where(keep, o, n) for o, n in zip(olds, news)]
                  for olds, news in zip(old_lists, results))
    return _write_out(gated, out)


def fused_sgd_update_hyper_plain(weights, grads, hyper, out=None, skip=None):
    """``fused_sgd_update_plain`` with the scalars read from ``hyper``,
    gated by ``skip``."""
    h = _read_hyper(hyper)
    return _gated((weights,), fused_sgd_update_plain(
        weights, grads, h["lr"], h["wd"], h["rescale_grad"], h["clip_gradient"]), skip, out)


def fused_sgd_mom_update_hyper_plain(weights, grads, moms, hyper, out=None, skip=None):
    """``fused_sgd_mom_update_plain`` with the scalars read from ``hyper``,
    gated by ``skip``."""
    h = _read_hyper(hyper)
    return _gated((weights, moms), fused_sgd_mom_update_plain(
        weights, grads, moms, h["lr"], h["momentum"], h["wd"], h["rescale_grad"],
        h["clip_gradient"]), skip, out)


def fused_adam_update_hyper_plain(weights, grads, ms, vs, hyper, out=None, skip=None):
    """``fused_adam_update_plain`` with the scalars read from ``hyper``,
    gated by ``skip``."""
    h = _read_hyper(hyper)
    return _gated((weights, ms, vs), fused_adam_update_plain(
        weights, grads, ms, vs, h["lr"], h["beta1"], h["beta2"], h["epsilon"], h["wd"],
        h["rescale_grad"], h["clip_gradient"]), skip, out)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, lists: Sequence[Sequence[torch.Tensor]], names, device):
    n = len(lists[0])
    for lst, lname in zip(lists, names):
        if len(lst) != n:
            raise MXNetError(f"{name}: {lname} has {len(lst)} tensors, "
                             f"weights {n}")
        dtypes = {t.dtype for t in lst}
        if len(dtypes) != 1:
            raise MXNetError(f"{name}: {lname} mixes dtypes {sorted(map(str, dtypes))}")
        if next(iter(dtypes)) not in _DTYPE_CODES:
            raise MXNetError(f"{name}: {lname} dtype {next(iter(dtypes))} not "
                             f"supported (float32, bfloat16, float16)")
        for i, t in enumerate(lst):
            if t.device != device:
                raise MXNetError(f"{name}: {lname}[{i}] on {t.device}, weights "
                                 f"on {device}")
            if not t.is_contiguous():
                raise MXNetError(f"{name}: {lname}[{i}] is not contiguous")
            if t.shape != lists[0][i].shape:
                raise MXNetError(f"{name}: {lname}[{i}] shape {tuple(t.shape)} "
                                 f"!= weight {tuple(lists[0][i].shape)}")


def _table(who, device, operands: List[Optional[Sequence[torch.Tensor]]], names):
    """The device table of rows (7 pointers, numel, first chunk) for the
    operand lists, the number of rows and of chunks. Checked and built at
    the first call on these tensors, then taken from the cache."""
    lists = [op for op in operands if op is not None]
    if any(len(op) != len(lists[0]) for op in lists):
        _check(who, lists, names, device)          # raises: lengths differ
    ptrs = tuple(tuple(map(torch.Tensor.data_ptr, op)) if op is not None else None
                 for op in operands)
    numels = tuple(map(torch.Tensor.numel, operands[0]))
    key = (device.index, numels, ptrs, tuple(op[0].dtype for op in lists))
    hit = _tables.get(key)
    if hit is not None and all(all(map(torch.Tensor.is_contiguous, op)) for op in lists):
        _tables.move_to_end(key)
        table_stats["hits"] += 1
        engine.keep_alive(hit[0])
        return hit
    if engine.capturing():
        raise MXNetError(f"{who}: no pointer table for these {', '.join(names)} "
                         f"while a CUDA graph is being captured; run the update once "
                         f"before the capture (the warm-up step builds every table)")
    _check(who, lists, names, device)
    rows, first = [], 0
    for i, numel in enumerate(numels):
        if numel == 0:
            continue
        rows.append([c[i] if c is not None else 0 for c in ptrs] + [numel, first])
        first += -(-numel // _CHUNK)
    table = torch.tensor(rows, dtype=torch.int64).to(device) if rows else None
    table_stats["built"] += 1
    _tables[key] = (table, len(rows), first)
    if len(_tables) > _TABLE_CACHE_SIZE:
        _tables.popitem(last=False)
    return _tables[key]


def _launch(who, fn, table, n_rows, n_chunks, codes, scalars, device):
    """One launch of ``fn``; ``scalars`` are floats (by value) or one
    device pointer (the hyper form)."""
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(table.data_ptr(), n_rows, n_chunks, *codes,
                               *scalars, stream)
    if err != 0:
        raise MXNetError(f"{who} kernel launch failed: "
                         f"{lib.mxt_cuda_error_string(err).decode()}")


def _new_lists(out, groups):
    if out is not None:
        if len(out) != len(groups):
            raise MXNetError(f"out must hold {len(groups)} lists")
        return tuple(list(o) for o in out)
    return tuple([torch.empty_like(t) for t in g] for g in groups)


def _hyper_ptr(who, hyper, device) -> int:
    if hyper.dtype != torch.float32 or hyper.numel() != len(HYPER_FIELDS) \
            or hyper.device != device or not hyper.is_contiguous():
        raise MXNetError(f"{who}: hyper must be a contiguous float32 tensor of the "
                         f"{len(HYPER_FIELDS)} values of HYPER_FIELDS on {device}, got "
                         f"{hyper.dtype} {tuple(hyper.shape)} on {hyper.device}")
    return hyper.data_ptr()


def _skip_ptr(who, skip, device) -> Optional[int]:
    if skip is None:
        return None
    if skip.dtype != torch.float32 or skip.numel() != 1 or skip.device != device:
        raise MXNetError(f"{who}: skip must be a float32 tensor of one element on "
                         f"{device}, got {skip.dtype} {tuple(skip.shape)} on {skip.device}")
    return skip.data_ptr()


def _sgd(who, rule, weights, grads, moms, scalars, out, hyper=None, skip=None):
    """One launch of an SGD ``rule`` over CUDA tensors (``moms`` None for
    the stateless rule), with ``scalars`` by value or, given ``hyper``, read
    from it -> (the new lists, whether it launched)."""
    device = weights[0].device
    if device.type != "cuda":
        raise MXNetError(f"{who}: unsupported device {device}")
    res = _new_lists(out, (weights, moms) if moms is not None else (weights,))
    if grads[0].dtype != weights[0].dtype or res[0][0].dtype != weights[0].dtype \
            or (moms is not None and res[1][0].dtype != moms[0].dtype):
        raise MXNetError(f"{who}: grads and out weights take the weights' dtype, "
                         f"out moms the moms'")
    out_m = res[1] if moms is not None else None
    names = ["weights", "grads", "moms", "out weights", "out moms"] if moms is not None \
        else ["weights", "grads", "out weights"]
    table, n_rows, n_chunks = _table(who, device,
                                     [weights, grads, moms, None, res[0], out_m, None], names)
    if n_rows:
        codes = (_DTYPE_CODES[weights[0].dtype],
                 _DTYPE_CODES[moms[0].dtype] if moms is not None else 0, rule)
        if hyper is None:
            _launch(who, "mxt_fused_sgd", table, n_rows, n_chunks, codes,
                    tuple(float(_f32(v)) for v in scalars), device)
        else:
            _launch(who, "mxt_fused_sgd_hyper", table, n_rows, n_chunks, codes,
                    (_hyper_ptr(who, hyper, device), _skip_ptr(who, skip, device)), device)
    return res, n_rows > 0


def _adam(who, weights, grads, ms, vs, scalars, out, hyper=None, skip=None):
    """One Adam launch over CUDA tensors with ``scalars`` = (lr, b1, b2, eps,
    wd, c1, c2, rescale, clip) by value or, given ``hyper``, read from it ->
    (the new lists, whether it launched)."""
    device = weights[0].device
    if device.type != "cuda":
        raise MXNetError(f"{who}: unsupported device {device}")
    res = _new_lists(out, (weights, ms, vs))
    if grads[0].dtype != weights[0].dtype or vs[0].dtype != ms[0].dtype \
            or res[0][0].dtype != weights[0].dtype \
            or {res[1][0].dtype, res[2][0].dtype} != {ms[0].dtype}:
        raise MXNetError(f"{who}: grads and out weights take the weights' dtype, "
                         f"vs and the out states the ms'")
    table, n_rows, n_chunks = _table(
        who, device, [weights, grads, ms, vs, *res],
        ["weights", "grads", "ms", "vs", "out weights", "out ms", "out vs"])
    if n_rows:
        codes = (_DTYPE_CODES[weights[0].dtype], _DTYPE_CODES[ms[0].dtype])
        if hyper is None:
            _launch(who, "mxt_fused_adam", table, n_rows, n_chunks, codes,
                    tuple(float(_f32(v)) for v in scalars), device)
        else:
            _launch(who, "mxt_fused_adam_hyper", table, n_rows, n_chunks, codes,
                    (_hyper_ptr(who, hyper, device), _skip_ptr(who, skip, device)), device)
    return res, n_rows > 0


def _hyper_tensor(weights, **kw) -> torch.Tensor:
    """The 10 values of ``hyper_values(**kw)`` on the weights' device."""
    return torch.tensor(hyper_values(**kw), dtype=torch.float32, device=weights[0].device)


def fused_sgd_apply(weights: List, grads: List, moms: List, lr: float,
                    momentum: float = 0.0, wd: float = 0.0, out=None):
    """One-launch SGD (+momentum, +wd) over a list of tensors ->
    ``(new_weights, new_moms)``."""
    if not weights:
        return [], []
    if weights[0].device.type == "cpu":
        return fused_sgd_apply_plain(weights, grads, moms, lr, momentum, wd, out)
    res, launched = _sgd("fused_sgd_apply", _RULE_SGD_PALLAS, weights, grads, moms,
                         (lr, momentum, wd, 1.0, -1.0), out)
    fused_sgd_apply.launches += launched
    return res


def fused_adam_apply(weights: List, grads: List, ms: List, vs: List, lr: float,
                     beta1=0.9, beta2=0.999, eps=1e-8, wd=0.0, t: int = 1,
                     out=None):
    """One-launch Adam over a list of tensors, bias correction inside ->
    ``(new_weights, new_ms, new_vs)``."""
    if not weights:
        return [], [], []
    if weights[0].device.type == "cpu":
        return fused_adam_apply_plain(weights, grads, ms, vs, lr, beta1, beta2,
                                      eps, wd, t, out)
    s = _adam_scalars(lr, beta1, beta2, eps, wd, t)
    res, launched = _adam("fused_adam_apply", weights, grads, ms, vs,
                          tuple(s[k] for k in ("lr", "b1", "b2", "eps", "wd", "c1", "c2"))
                          + (1.0, -1.0), out)
    fused_adam_apply.launches += launched
    return res


def fused_sgd_mom_update(weights: List, grads: List, moms: List, lr: float,
                         momentum: float = 0.0, wd: float = 0.0, rescale_grad=1.0,
                         clip_gradient=-1.0, out=None):
    """One-launch ``sgd_mom_update`` over a list -> ``(new_weights, new_moms)``."""
    if not weights:
        return [], []
    return fused_sgd_mom_update_hyper(weights, grads, moms, _hyper_tensor(
        weights, lr=lr, momentum=momentum, wd=wd, rescale_grad=rescale_grad,
        clip_gradient=clip_gradient), out)


def fused_sgd_update(weights: List, grads: List, lr: float, wd: float = 0.0,
                     rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """One-launch ``sgd_update`` over a list -> ``(new_weights,)``; no state."""
    if not weights:
        return ([],)
    return fused_sgd_update_hyper(weights, grads, _hyper_tensor(
        weights, lr=lr, wd=wd, rescale_grad=rescale_grad, clip_gradient=clip_gradient), out)


def fused_adam_update(weights: List, grads: List, ms: List, vs: List, lr: float,
                      beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                      clip_gradient=-1.0, out=None):
    """One-launch ``adam_update`` over a list (no bias correction: fold it
    into ``lr``) -> ``(new_weights, new_ms, new_vs)``."""
    if not weights:
        return [], [], []
    return fused_adam_update_hyper(weights, grads, ms, vs, _hyper_tensor(
        weights, lr=lr, beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient), out)


def fused_sgd_update_hyper(weights: List, grads: List, hyper: torch.Tensor, out=None,
                           skip=None):
    """``fused_sgd_update`` with its scalars in ``hyper`` and the gate
    ``skip`` (see the module docstring) -> ``(new_weights,)``."""
    if not weights:
        return ([],)
    if weights[0].device.type == "cpu":
        return fused_sgd_update_hyper_plain(weights, grads, hyper, out, skip)
    res, launched = _sgd("fused_sgd_update_hyper", _RULE_SGD, weights, grads, None, None,
                         out, hyper, skip)
    fused_sgd_update.launches += launched
    return res


def fused_sgd_mom_update_hyper(weights: List, grads: List, moms: List, hyper: torch.Tensor,
                               out=None, skip=None):
    """``fused_sgd_mom_update`` with its scalars in ``hyper`` and the gate
    ``skip`` -> ``(new_weights, new_moms)``."""
    if not weights:
        return [], []
    if weights[0].device.type == "cpu":
        return fused_sgd_mom_update_hyper_plain(weights, grads, moms, hyper, out, skip)
    res, launched = _sgd("fused_sgd_mom_update_hyper", _RULE_SGD_MOM, weights, grads, moms,
                         None, out, hyper, skip)
    fused_sgd_mom_update.launches += launched
    return res


def fused_adam_update_hyper(weights: List, grads: List, ms: List, vs: List,
                            hyper: torch.Tensor, out=None, skip=None):
    """``fused_adam_update`` with its scalars in ``hyper`` (c1 = c2 = 1: fold
    the bias correction into lr) and the gate ``skip`` -> ``(new_weights,
    new_ms, new_vs)``."""
    if not weights:
        return [], [], []
    if weights[0].device.type == "cpu":
        return fused_adam_update_hyper_plain(weights, grads, ms, vs, hyper, out, skip)
    res, launched = _adam("fused_adam_update_hyper", weights, grads, ms, vs, None, out,
                          hyper, skip)
    fused_adam_update.launches += launched
    return res


for _wrapper in (fused_sgd_apply, fused_adam_apply, fused_sgd_mom_update, fused_sgd_update,
                 fused_adam_update):
    _wrapper.launches = 0
    engine.register_counter(_wrapper, "launches")
del _wrapper
