"""Runtime-compiled CUDA kernels: ``mx.rtc.CudaModule``.

Counterpart of ``mxnet_tpu/rtc.py`` (``PallasModule`` :72, its kernel's
``launch`` :41-69, alias ``CudaModule`` :117), whose original is MXNet's
NVRTC-backed ``CudaModule`` (``include/mxnet/rtc.h``, ``python/mxnet/rtc.py``).
The source language is CUDA C, as in MXNet; the reference's Pallas source
strings have no meaning on the card, so ``PallasModule`` is not carried::

    mod = mx.rtc.CudaModule(source, exports=["scale3<float>"])
    axpy = mod.get_kernel("axpy", "const float *x, const float *y, float *z, int n",
                          out_shapes=[((n,), "float32")])
    (z,) = axpy.launch([x, y, n], mx.gpu(0), (blocks, 1, 1), (256, 1, 1))

- ``CudaModule(source, options=(), exports=())`` compiles ``source`` with
  NVRTC (``libnvrtc`` from ``$CUDA_HOME/lib64`` or ``/usr/local/cuda/lib64``,
  called through ctypes) to a cubin for ``sm_90a``. Each export is an NVRTC
  name expression (``"scale3<float>"``, ``"ns::f"``), so C++ kernels need no
  ``extern "C"``; an ``extern "C"`` kernel is found by its own name. An
  export whose name is not in the source raises before compiling, as the
  reference's does (:99-102); a compile error raises with NVRTC's log.
  Compiled modules are cached in the process by (source, options, exports).
- ``get_kernel(name, signature, *, out_shapes=None)`` parses a C signature
  (``"const float *x, float *y, int n"``: each argument a pointer or a
  scalar of ``float``, ``double``, ``__half``, ``__nv_bfloat16``, ``int``,
  ``int32_t``, ``int64_t``, ``int8_t``, ``uint8_t`` or ``char``, const or
  not) and names an exported or ``extern "C"`` kernel; an unknown name
  raises (reference :108-111).
- ``CudaKernel.launch(args, ctx, grid_dims, block_dims, shared_mem=0)``
  checks every argument against its parameter (an NDArray of the pointer's
  dtype on ``ctx``'s device, or a Python number for a scalar), then launches
  with the CUDA driver API (``cuModuleLoadData``, ``cuModuleGetFunction``,
  ``cuLaunchKernel``) on torch's current stream of that device, so it is
  ordered with torch's work and can be captured into a CUDA graph, and
  checks the result. With ``out_shapes``
  the kernel's last pointer parameters are outputs: ``launch`` allocates
  them (uninitialised: the kernel writes every element), passes them last
  and returns them as a tuple of NDArrays, the reference's call shape;
  ``args`` then holds the other parameters, in order. Without
  ``out_shapes`` the kernel writes its non-const pointers in place, as in
  MXNet, and ``launch`` returns None. ``CudaKernel.launches`` counts the
  launches of every rtc kernel.

Kernels run on CUDA devices only: without one, ``CudaModule`` raises
``MXNetError``, and so does a launch on ``cpu()``. The driver calls run on
the device's primary context, the one torch uses; a thread whose current
context is another gets it made current. Dynamic shared memory above 48 KiB
is allowed per function with ``cuFuncSetAttribute`` before the launch.

The launch path (the counterpart of the reference's ``launch``, :41-69) is
built for host time, which is what a launch costs beyond the kernel: the
first launch of a kernel on a device builds a launch plan (``_Plan``): the
``CUfunction``, the device's primary context, and one preallocated ctypes
slot per argument with the argv array that points at them. Each launch then
checks each argument with one comparison of its type and, for a tensor, of
its dtype and device index, writes the slots in place, and calls
``cuLaunchKernel``. The per-argument checks and their messages are those
of the first launch. A plan belongs to one kernel and one device; its slots
are written and launched under its lock, so threads do not share them
unguarded. ``timings`` keeps the seconds of NVRTC's parts: loading
``libnvrtc``, ``nvrtcCompileProgram``, and ``cuModuleLoadData``.

Bound: a kernel's work is whatever its source says; ``chip_smoke.py``
measures ``axpy`` (12 bytes an element, bound by bytes) and an empty
launch's host time. The example kernels at the end of this module, each
with a plain PyTorch version, are the ones the tests and ``chip_smoke.py``
launch; ``axpy`` streams 16-byte vectors (see its source).
"""
from __future__ import annotations

import ctypes
import os
import re
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .base import MXNetError, torch_dtype
from .context import Context
from .ndarray import NDArray

ARCH = "sm_90a"
_MAX_STATIC_SMEM = 48 * 1024
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

_C_TYPES = {"float": torch.float32, "double": torch.float64,
            "__half": torch.float16, "__nv_bfloat16": torch.bfloat16,
            "int": torch.int32, "int32_t": torch.int32, "int64_t": torch.int64,
            "int8_t": torch.int8, "uint8_t": torch.uint8, "char": torch.int8}
_SCALAR_CTYPES = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double,
                  torch.int32: ctypes.c_int32, torch.int64: ctypes.c_int64,
                  torch.int8: ctypes.c_int8, torch.uint8: ctypes.c_uint8}
_ARG = re.compile(r"^\s*(const)?\s*([A-Za-z_]\w*)\s*(\*)?\s*([A-Za-z_]\w*)?\s*$")
# seconds of NVRTC's parts, at their last run: libnvrtc loaded (once),
# nvrtcCompileProgram, cuModuleLoadData
timings: Dict[str, float] = {}
_EXTERN_C_KERNEL = re.compile(
    r'extern\s+"C"\s+__global__\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?void\s+'
    r'(?:__launch_bounds__\s*\([^)]*\)\s*)?([A-Za-z_]\w*)')


class KernelArg(NamedTuple):
    name: str
    dtype: torch.dtype
    is_pointer: bool
    is_const: bool


def parse_signature(signature: str) -> List[KernelArg]:
    """``"const float *x, float *y, int n"`` -> one ``KernelArg`` each
    (reference MXNet ``python/mxnet/rtc.py`` get_kernel's parser)."""
    if not signature.strip():
        return []
    out = []
    for i, part in enumerate(re.sub(r"\s+", " ", signature).split(",")):
        m = _ARG.match(part)
        if not m or m.group(2) == "const":
            raise MXNetError(f"invalid kernel argument {part.strip()!r} in "
                             f"{signature!r}: must be '[const] type [*] [name]'")
        const, ctype, star, name = m.groups()
        if ctype not in _C_TYPES:
            raise MXNetError(f"unsupported argument type {ctype!r} in {signature!r} "
                             f"(supported: {sorted(_C_TYPES)})")
        out.append(KernelArg(name or f"arg{i}", _C_TYPES[ctype], bool(star),
                             bool(const)))
    return out


def _cuda_lib_dirs() -> List[Path]:
    return [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")), Path("/usr/local/cuda")]


class _Nvrtc:
    """NVRTC through ctypes: source -> cubin and lowered export names."""

    def __init__(self):
        t0 = time.perf_counter()
        lib = None
        for root in _cuda_lib_dirs():
            for cand in sorted((root / "lib64").glob("libnvrtc.so*")):
                lib = ctypes.CDLL(str(cand))
                break
            if lib is not None:
                self.include = root / "include"
                break
        if lib is None:
            raise MXNetError("libnvrtc not found ($CUDA_HOME/lib64, "
                             "/usr/local/cuda/lib64): mx.rtc compiles CUDA C on "
                             "the GPU host")
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        for name, args in (
                ("nvrtcCreateProgram", [ctypes.POINTER(vp), ctypes.c_char_p,
                                        ctypes.c_char_p, ctypes.c_int, vp, vp]),
                ("nvrtcAddNameExpression", [vp, ctypes.c_char_p]),
                ("nvrtcCompileProgram", [vp, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]),
                ("nvrtcGetProgramLogSize", [vp, ctypes.POINTER(sz)]),
                ("nvrtcGetProgramLog", [vp, ctypes.c_char_p]),
                ("nvrtcGetCUBINSize", [vp, ctypes.POINTER(sz)]),
                ("nvrtcGetCUBIN", [vp, ctypes.c_char_p]),
                ("nvrtcGetLoweredName", [vp, ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_char_p)]),
                ("nvrtcDestroyProgram", [ctypes.POINTER(vp)])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        self.lib = lib
        timings["nvrtc_load_s"] = time.perf_counter() - t0

    def _check(self, res, what):
        if res != 0:
            raise MXNetError(f"NVRTC {what} failed: "
                             f"{self.lib.nvrtcGetErrorString(res).decode()}")

    def compile(self, source: str, options: Sequence[str],
                exports: Sequence[str]) -> Tuple[bytes, Dict[str, str]]:
        lib = self.lib
        prog = ctypes.c_void_p()
        self._check(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                           b"mx_rtc.cu", 0, None, None),
                    "nvrtcCreateProgram")
        try:
            for e in exports:
                self._check(lib.nvrtcAddNameExpression(prog, e.encode()),
                            f"nvrtcAddNameExpression({e!r})")
            opts = [f"--gpu-architecture={ARCH}", "-std=c++17"]
            if self.include.is_dir():
                opts.append(f"-I{self.include}")
            opts += list(options)
            argv = (ctypes.c_char_p * len(opts))(*(o.encode() for o in opts))
            t0 = time.perf_counter()
            res = lib.nvrtcCompileProgram(prog, len(opts), argv)
            timings["nvrtc_compile_s"] = time.perf_counter() - t0
            size = ctypes.c_size_t()
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value)
            lib.nvrtcGetProgramLog(prog, log)
            if res != 0:
                raise MXNetError(f"NVRTC could not compile the module "
                                 f"({lib.nvrtcGetErrorString(res).decode()}, "
                                 f"options {opts}):\n{log.value.decode(errors='replace')}")
            self._check(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                        "nvrtcGetCUBINSize")
            cubin = ctypes.create_string_buffer(size.value)
            self._check(lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
            lowered = {}
            for e in exports:
                name = ctypes.c_char_p()
                self._check(lib.nvrtcGetLoweredName(prog, e.encode(), ctypes.byref(name)),
                            f"nvrtcGetLoweredName({e!r})")
                lowered[e] = name.value.decode()
            return cubin.raw, lowered
        finally:
            lib.nvrtcDestroyProgram(ctypes.byref(prog))


class _Driver:
    """The CUDA driver API through ctypes, on each device's primary context."""

    def __init__(self):
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise MXNetError(f"the CUDA driver (libcuda.so.1) cannot be loaded: {e}") from None
        vp, u = ctypes.c_void_p, ctypes.c_uint
        for name, args in (
                ("cuInit", [u]),
                ("cuDeviceGet", [ctypes.POINTER(ctypes.c_int), ctypes.c_int]),
                ("cuDevicePrimaryCtxRetain", [ctypes.POINTER(vp), ctypes.c_int]),
                ("cuCtxGetCurrent", [ctypes.POINTER(vp)]),
                ("cuCtxSetCurrent", [vp]),
                ("cuModuleLoadData", [ctypes.POINTER(vp), vp]),
                ("cuModuleGetFunction", [ctypes.POINTER(vp), vp, ctypes.c_char_p]),
                ("cuFuncSetAttribute", [vp, ctypes.c_int, ctypes.c_int]),
                ("cuLaunchKernel", [vp, u, u, u, u, u, u, u, vp,
                                    ctypes.POINTER(vp), ctypes.POINTER(vp)]),
                ("cuGetErrorString", [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        self.lib = lib
        # The two calls of every launch, without argtypes: ctypes then
        # converts nothing (a plan passes ctypes objects and small ints),
        # which takes microseconds off each launch.
        raw = ctypes.CDLL("libcuda.so.1")
        self.launch_raw, self.ctx_get_raw = raw.cuLaunchKernel, raw.cuCtxGetCurrent
        self.launch_raw.restype = self.ctx_get_raw.restype = ctypes.c_int
        self._primary: Dict[int, ctypes.c_void_p] = {}
        self.check(lib.cuInit(0), "cuInit")

    def check(self, res, what):
        if res != 0:
            msg = ctypes.c_char_p()
            self.lib.cuGetErrorString(res, ctypes.byref(msg))
            raise MXNetError(f"{what} failed: "
                             f"{msg.value.decode() if msg.value else res} (CUresult {res})")

    def primary(self, index: int) -> ctypes.c_void_p:
        """The device's primary context, the one torch uses."""
        primary = self._primary.get(index)
        if primary is None:
            dev = ctypes.c_int()
            self.check(self.lib.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
            primary = ctypes.c_void_p()
            self.check(self.lib.cuDevicePrimaryCtxRetain(ctypes.byref(primary), dev),
                       "cuDevicePrimaryCtxRetain")
            self._primary[index] = primary
        return primary

    def make_current(self, primary: ctypes.c_void_p, current: ctypes.c_void_p,
                     current_ref) -> None:
        """``primary`` made current on this thread, if it is not already
        (``current`` receives the query, ``current_ref`` is its byref)."""
        res = self.ctx_get_raw(current_ref)
        if res != 0:
            self.check(res, "cuCtxGetCurrent")
        if current.value != primary.value:
            self.check(self.lib.cuCtxSetCurrent(primary), "cuCtxSetCurrent")


_lock = threading.Lock()
_nvrtc: Optional[_Nvrtc] = None
_driver: Optional[_Driver] = None
_compiled: Dict[tuple, "_Compiled"] = {}


def _get_nvrtc() -> _Nvrtc:
    global _nvrtc
    with _lock:
        if _nvrtc is None:
            _nvrtc = _Nvrtc()
        return _nvrtc


def _get_driver() -> _Driver:
    global _driver
    with _lock:
        if _driver is None:
            _driver = _Driver()
        return _driver


class _Compiled:
    """One compiled module: its cubin, lowered export names, and the module
    and functions loaded on each device."""

    def __init__(self, cubin: bytes, lowered: Dict[str, str]):
        self.cubin = ctypes.create_string_buffer(cubin, len(cubin))
        self.lowered = lowered
        self._modules: Dict[int, ctypes.c_void_p] = {}
        self._functions: Dict[Tuple[int, str], ctypes.c_void_p] = {}
        self._lock = threading.Lock()

    def function(self, driver: _Driver, index: int, symbol: str) -> ctypes.c_void_p:
        with self._lock:
            fn = self._functions.get((index, symbol))
            if fn is not None:
                return fn
            module = self._modules.get(index)
            if module is None:
                module = ctypes.c_void_p()
                t0 = time.perf_counter()
                driver.check(driver.lib.cuModuleLoadData(ctypes.byref(module), self.cubin),
                             "cuModuleLoadData")
                timings["module_load_s"] = time.perf_counter() - t0
                self._modules[index] = module
            fn = ctypes.c_void_p()
            driver.check(driver.lib.cuModuleGetFunction(ctypes.byref(fn), module,
                                                         symbol.encode()),
                         f"cuModuleGetFunction({symbol!r})")
            self._functions[(index, symbol)] = fn
            return fn


def _compile(source: str, options: Tuple[str, ...], exports: Tuple[str, ...]) -> _Compiled:
    key = (source, options, exports)
    with _lock:
        hit = _compiled.get(key)
    if hit is not None:
        return hit
    cubin, lowered = _get_nvrtc().compile(source, options, exports)
    with _lock:
        return _compiled.setdefault(key, _Compiled(cubin, lowered))


class CudaModule:
    """CUDA C compiled at run time (reference ``PallasModule``, MXNet
    ``CudaModule``); see the module docstring."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        if not isinstance(source, str):
            raise MXNetError("CudaModule takes CUDA C source as a string (a "
                             "Python kernel function has no meaning on the card)")
        self.source = source
        self.exports = tuple(exports)
        missing = [e for e in self.exports
                   if not re.search(r"\b%s\b" % re.escape(_base_name(e)), source)]
        if missing:
            raise MXNetError(f"exports not found in source: {missing}")
        if not torch.cuda.is_available():
            raise MXNetError("mx.rtc.CudaModule compiles and launches CUDA kernels "
                             "and no CUDA device is available")
        self._compiled = _compile(source, tuple(options), self.exports)
        self._kernels = set(self.exports) | set(_EXTERN_C_KERNEL.findall(source))

    def get_kernel(self, name: str, signature: str = "", *,
                   out_shapes=None) -> "CudaKernel":
        if name not in self._kernels:
            raise MXNetError(f"kernel '{name}' not found; available: "
                             f"{sorted(self._kernels)}")
        symbol = self._compiled.lowered.get(name, name)
        return CudaKernel(self._compiled, name, symbol, parse_signature(signature),
                          out_shapes)


def _base_name(expression: str) -> str:
    """'ns::scale3<float>' -> 'scale3'."""
    return expression.split("<")[0].split("::")[-1].strip().lstrip("&")


class _Plan:
    """What a launch of one kernel on one device reuses: the function, the
    device's primary context, one ctypes slot per argument and the argv
    array that points at them."""

    def __init__(self, kernel: "CudaKernel", index: int):
        driver = _get_driver()
        torch.cuda.init()
        with torch.cuda.device(index):
            self.primary = driver.primary(index)
            self.current = ctypes.c_void_p()
            self.current_ref = ctypes.byref(self.current)
            driver.make_current(self.primary, self.current, self.current_ref)
            self.fn = kernel._compiled.function(driver, index, kernel._symbol)
        self.driver = driver
        self.ctx_get, self.launch_fn = driver.ctx_get_raw, driver.launch_raw
        self.stream, self.stream_arg = None, None
        self.device = torch.device("cuda", index)
        self.slots = [ctypes.c_void_p() if a.is_pointer else _SCALAR_SLOT[a.dtype]()
                      for a in kernel.args]
        self.argv = (ctypes.c_void_p * max(len(self.slots), 1))(
            *(ctypes.addressof(v) for v in self.slots))
        self.smem_allowed = 0
        self.lock = threading.Lock()


class CudaKernel:
    """A launchable kernel of a ``CudaModule`` (reference ``PallasKernel``,
    MXNet ``CudaKernel``)."""

    launches = 0

    def __init__(self, compiled: _Compiled, name: str, symbol: str,
                 args: List[KernelArg], out_shapes=None):
        self._compiled = compiled
        self.name = name
        self._symbol = symbol
        self.args = args
        self._out_shapes = []
        pointers = [i for i, a in enumerate(args) if a.is_pointer]
        if out_shapes:
            if len(out_shapes) > len(pointers):
                raise MXNetError(f"kernel '{name}': {len(out_shapes)} outputs but "
                                 f"{len(pointers)} pointer arguments")
            for i, (shape, dtype) in zip(pointers[-len(out_shapes):], out_shapes):
                arg = args[i]
                if arg.is_const:
                    raise MXNetError(f"kernel '{name}': output '{arg.name}' is a "
                                     f"const pointer")
                if torch_dtype(dtype) != arg.dtype:
                    raise MXNetError(f"kernel '{name}': output '{arg.name}' is "
                                     f"{arg.dtype}, out_shapes says {dtype}")
                self._out_shapes.append((i, tuple(shape)))
        outputs = {i for i, _ in self._out_shapes}
        # (slot index, parameter) of each argument the caller gives, in order
        self._inputs = [(i, a) for i, a in enumerate(args) if i not in outputs]
        self._plans: Dict[int, _Plan] = {}
        self._plans_lock = threading.Lock()

    def _plan(self, index: int) -> _Plan:
        plan = self._plans.get(index)
        if plan is None:
            with self._plans_lock:
                plan = self._plans.get(index)
                if plan is None:
                    plan = self._plans[index] = _Plan(self, index)
        return plan

    def _refuse(self, p: KernelArg, value, index: int):
        """The message for an argument that failed its check."""
        if p.is_pointer:
            if not isinstance(value, NDArray):
                return f"'{p.name}' is a pointer and takes an NDArray, got {type(value)}"
            if value.dtype != p.dtype:
                return f"'{p.name}' is {p.dtype}, the array is {value.dtype}"
            return (f"'{p.name}' lies on {value._data.device}, the launch is on "
                    f"gpu({index})")
        if not isinstance(value, (int, float, np.number)) or isinstance(value, bool):
            return f"'{p.name}' is a scalar and takes a number, got {type(value)}"
        return f"{value!r} given for an integer argument"

    def launch(self, args: Sequence, ctx: Context, grid_dims, block_dims,
               shared_mem: int = 0):
        """Run the kernel on ``ctx``'s stream; see the module docstring."""
        inputs = self._inputs
        if len(args) != len(inputs):
            raise MXNetError(f"kernel '{self.name}' takes {len(inputs)} arguments "
                             f"({', '.join(p.name for _, p in inputs)}), got {len(args)}")
        for (_, p), value in zip(inputs, args):       # what needs no device
            if not _kind_ok(p, value):
                raise MXNetError(f"kernel '{self.name}': {self._refuse(p, value, -1)}")
        if not isinstance(ctx, Context) or ctx.device_type != "gpu":
            raise MXNetError(f"kernel '{self.name}': rtc kernels run on a CUDA "
                             f"device, ctx is {ctx}")
        index = ctx.device_id
        plan = self._plans.get(index)
        if plan is None:     # the first launch on this device: arguments first
            for (_, p), value in zip(inputs, args):
                if p.is_pointer and value._data.get_device() != index:
                    raise MXNetError(f"kernel '{self.name}': "
                                     f"{self._refuse(p, value, index)}")
            plan = self._plan(index)
        grid, block = _dims(grid_dims, "grid_dims"), _dims(block_dims, "block_dims")
        if type(shared_mem) is not int:
            shared_mem = int(shared_mem)
        outs = [torch.empty(shape, dtype=self.args[i].dtype, device=plan.device)
                for i, shape in self._out_shapes] if self._out_shapes else ()
        slots = plan.slots
        with plan.lock:
            for (i, p), value in zip(inputs, args):
                if p.is_pointer:
                    t = value._data
                    if t.get_device() != index:
                        raise MXNetError(f"kernel '{self.name}': "
                                         f"{self._refuse(p, value, index)}")
                    slots[i].value = t.data_ptr()
                else:
                    _set_scalar(slots[i], p.dtype, value)
            for (i, _), out in zip(self._out_shapes, outs):
                slots[i].value = out.data_ptr()
            if plan.ctx_get(plan.current_ref) != 0 \
                    or plan.current.value != plan.primary.value:   # not current
                plan.driver.make_current(plan.primary, plan.current, plan.current_ref)
            if shared_mem > _MAX_STATIC_SMEM and shared_mem > plan.smem_allowed:
                plan.driver.check(plan.driver.lib.cuFuncSetAttribute(
                    plan.fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                    shared_mem), f"cuFuncSetAttribute({self.name}, {shared_mem} bytes)")
                plan.smem_allowed = shared_mem
            stream = torch._C._cuda_getCurrentRawStream(index)
            if stream != plan.stream:
                plan.stream, plan.stream_arg = stream, ctypes.c_void_p(stream)
            res = plan.launch_fn(plan.fn, grid[0], grid[1], grid[2], block[0], block[1],
                                 block[2], shared_mem, plan.stream_arg, plan.argv, None)
        if res != 0:
            plan.driver.check(res, f"cuLaunchKernel({self.name})")
        CudaKernel.launches += 1
        if outs:
            return tuple(NDArray(o, ctx) for o in outs)
        return None


def _kind_ok(p: KernelArg, value) -> bool:
    """One argument against its parameter, without the device: an NDArray of
    the pointer's dtype, or a number (an integral one for an integer)."""
    if p.is_pointer:
        return isinstance(value, NDArray) and value._data.dtype == p.dtype
    if isinstance(value, bool) or not isinstance(value, (int, float, np.number)):
        return False
    return p.dtype.is_floating_point or float(value) == int(value)


def _dims(dims, what) -> Tuple[int, int, int]:
    dims = (dims,) if isinstance(dims, int) else tuple(map(int, dims))
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise MXNetError(f"{what} must be 1 to 3 positive sizes, got {dims}")
    return dims + (1,) * (3 - len(dims))


# the ctypes slot of each scalar type (16-bit floats travel as their bits)
_SCALAR_SLOT = {**_SCALAR_CTYPES, torch.float16: ctypes.c_uint16,
                torch.bfloat16: ctypes.c_uint16}


def _set_scalar(slot, dtype: torch.dtype, value) -> None:
    """Write ``value`` into its argument slot, as the kernel's type holds it."""
    if not dtype.is_floating_point:
        slot.value = int(value)
    elif dtype == torch.float16:
        slot.value = int(np.float16(value).view(np.uint16))
    elif dtype == torch.bfloat16:
        slot.value = torch.tensor(float(value), dtype=torch.bfloat16) \
            .view(torch.int16).item() & 0xFFFF
    else:
        slot.value = float(value)


# ---------------------------------------------------------------------------
# Example kernels, each with its plain PyTorch version. ``axpy`` and
# ``scale3`` are the reference's test kernels (tests/test_rtc_svrg.py:10-32);
# ``transpose`` uses a 2-D grid and dynamic shared memory; ``empty`` measures
# the cost of a launch.
# ---------------------------------------------------------------------------

EXAMPLES_SOURCE = r"""
// z = 2x + y. Bound by bytes (12 B an element): 16-byte vector loads and
// stores (float4, streaming: each byte is touched once). A block takes a
// tile of 4 float4 a thread (16 KiB of each operand, contiguous: the four
// vectors of a thread lie blockDim apart, so every warp-wide access is
// coalesced), all four of x and of y in flight before the first store, and
// walks the tiles grid-stride; the grid is sized to the data (one tile a
// block), capped by the SM count. When x, y and z share their offset from a
// 16-byte boundary, a scalar head of up to 3 elements aligns all three; a
// scalar tail takes what is left after the last whole vector. When they do
// not, the same arithmetic runs element by element. 2x is exact in f32, so
// round(2x + y) is the result with or without a fused multiply-add.
extern "C" __global__ void __launch_bounds__(256)
axpy(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ z, int n) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  const unsigned off = (unsigned)((size_t)x & 15);
  if (off != ((size_t)y & 15) || off != ((size_t)z & 15) || (off & 3)) {
    for (long long i = tid; i < n; i += threads) z[i] = 2.0f * x[i] + y[i];
    return;
  }
  const long long head = ((16 - off) & 15) / 4 < n ? ((16 - off) & 15) / 4 : n;
  if (tid < head) z[tid] = 2.0f * x[tid] + y[tid];
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x + head);
  const float4* __restrict__ y4 = reinterpret_cast<const float4*>(y + head);
  float4* __restrict__ z4 = reinterpret_cast<float4*>(z + head);
  const long long n4 = (n - head) / 4;
  const long long tile = 4LL * blockDim.x;
  for (long long base = blockIdx.x * tile + threadIdx.x; base < n4; base += gridDim.x * tile) {
    float4 a[4], b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = base + k * (long long)blockDim.x;
      if (i < n4) {
        a[k] = __ldcs(x4 + i);
        b[k] = __ldcs(y4 + i);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = base + k * (long long)blockDim.x;
      if (i < n4)
        __stcs(z4 + i, make_float4(2.0f * a[k].x + b[k].x, 2.0f * a[k].y + b[k].y,
                                   2.0f * a[k].z + b[k].z, 2.0f * a[k].w + b[k].w));
    }
  }
  for (long long j = head + 4 * n4 + tid; j < n; j += threads) z[j] = 2.0f * x[j] + y[j];
}

template <typename T>
__global__ void scale3(const T* x, T* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * T(3);
}

// y (cols, rows) = x (rows, cols)^T through a (b, b+1) tile of dynamic
// shared memory, for square b x b blocks on a 2-D grid.
extern "C" __global__ void transpose(const float* x, float* y, int rows, int cols) {
  extern __shared__ float tile[];
  const int b = blockDim.x;
  const int r = blockIdx.y * b + threadIdx.y, c = blockIdx.x * b + threadIdx.x;
  if (r < rows && c < cols) tile[threadIdx.y * (b + 1) + threadIdx.x] = x[(size_t)r * cols + c];
  __syncthreads();
  const int tr = blockIdx.x * b + threadIdx.y, tc = blockIdx.y * b + threadIdx.x;
  if (tr < cols && tc < rows) y[(size_t)tr * rows + tc] = tile[threadIdx.x * (b + 1) + threadIdx.y];
}

extern "C" __global__ void empty() {}
"""
EXAMPLES_EXPORTS = ("scale3<float>",)
AXPY_SIGNATURE = "const float *x, const float *y, float *z, int n"
SCALE3_SIGNATURE = "const float *x, float *y, int n"
TRANSPOSE_SIGNATURE = "const float *x, float *y, int rows, int cols"


def axpy_plain(x, y):
    return 2.0 * x + y


AXPY_THREADS = 256


def axpy_launch_dims(n: int, sm_count: int):
    """``(grid, block)`` for ``axpy`` on ``n`` elements: one block a tile of
    4096 elements (256 threads, 4 float4 each), at most 128 blocks an SM
    (a tile a block up to 2^26 elements on 132 SMs; more tiles a block
    beyond)."""
    blocks = max(1, min(-(-n // (AXPY_THREADS * 16)), 128 * sm_count))
    return (blocks, 1, 1), (AXPY_THREADS, 1, 1)


def scale3_plain(x):
    return x * 3.0


def transpose_plain(x):
    return x.t().contiguous()


__all__ = ["CudaModule", "CudaKernel", "KernelArg", "parse_signature", "ARCH",
           "EXAMPLES_SOURCE", "EXAMPLES_EXPORTS", "AXPY_SIGNATURE",
           "SCALE3_SIGNATURE", "TRANSPOSE_SIGNATURE", "axpy_plain", "axpy_launch_dims",
           "scale3_plain", "transpose_plain"]
