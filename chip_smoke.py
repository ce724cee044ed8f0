#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Run from the root of a checkout on a host with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit line.
2. build: compiles every hand-written kernel library from
   ``mxnet_tpu_torch/csrc`` with ``nvcc`` into ``build/`` (one ``nvcc`` per
   source, all started together) and prints the seconds and ``ptxas -v``.
3. kernel: holds each kernel against its plain PyTorch version on the card
   at the main path's shapes (and ragged, cross-attention, causal and
   low-precision cases), then times kernel, plain version and the PyTorch
   library call that computes the same function (a yardstick only; the port
   never calls it) with CUDA events, beside the least time the card could
   take for the work. The flash-attention forward (K1) and backward (dQ K2,
   dK/dV K3); the fused SGD/Adam updates (K4, K5) on a small ragged list
   here, on BERT-base's parameters in phase 7. For K2/K3 also the HMMA
   instructions of every instantiation in the built library (``cuobjdump
   -sass``; none, or local memory at D=64, fails the phase), their registers,
   stack, local and shared memory (``cuobjdump -res-usage``), the f32 bound
   of the 3xTF32 tensor-core route beside the FMA one, and the port's and
   SDPA's whole backward replayed from captured CUDA graphs.
4. serve: BERT-base at T=1024 (full published width, 12 layers, random
   weights from a seed loaded through ``convert.load_jax_params``) on
   ``gpu(0)`` in f32 with TF32 off answers requests of batch 1, 2, 4 and 8;
   every launch counter is set to 0 just before and read just after, and
   the flash kernel must have launched once per layer per request. One more
   batch-8 request runs under ``torch.profiler`` for the device time by
   kernel and the device's busy share. The batch-1 request is then answered
   on the CPU by the plain versions and the logits compared.
5. train: BERT-base at T=1024, batch 8, f32 with TF32 off, trained through
   Gluon (``autograd.record()``, ``SoftmaxCrossEntropyLoss`` over the MLM
   logits of every token, ``loss.backward()``, ``Trainer("adam", lr
   1e-4).step(8)``) on one batch for a warm-up and 4 timed steps; each step
   must launch K1, K2 and K3 once per layer (counters set to 0 just before
   the steps) and give a finite loss. Step time, tokens/s, loss, peak device
   memory, and one more step under ``torch.profiler``.
6. train check: one step of a 2-layer model of BERT-base width at T=1024,
   batch 1, same weights, on ``gpu(0)`` and on the CPU (plain versions):
   loss, every gradient and every weight after the Adam step compared.
7. fused update: ``fused_adam_apply`` and ``fused_sgd_apply`` on the
   trained BERT-base's 157 weights and last gradients with fresh zero
   states, t=1 then t=2 (counters set to 0 just before: one launch per
   call), against their plain versions; timed beside ``torch.optim``'s
   fused Adam and SGD and the bound.

It prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.
Without a CUDA device, or without the rest of the repository beside it, it
exits non-zero and prints no result. Its full results also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_TF32_FLOPS = 495e12  # tensor cores; an f32-accurate product by 3xTF32 takes 3

# Tolerances of the kernel against its plain version, same inputs on the
# card: both accumulate in f32 and differ only in the order of summation
# (f32), plus, in bf16/f16, where a 1-ulp difference flips the rounding of p
# or of the output (bf16 ulp is 2^-8 of the value).
TOL_O = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 4e-3}
TOL_LSE = 1e-4
# GPU against CPU logits, both f32 with TF32 off: only summation order
# differs, through 12 layers; logits are O(1).
TOL_LOGITS = 1e-3
# Backward kernels against their plain version, relative to the largest
# |gradient| of the tensor: both accumulate in f32 and differ in the order
# of summation over up to 1024 keys (f32); in bf16/f16 dS and P are rounded
# to the input dtype before each product, where a 1-ulp difference in S flips
# a rounding, and the results are rounded once more (bf16 ulp 2^-8).
TOL_BWD = {"float32": 1e-4, "bfloat16": 3e-2, "float16": 1e-2}
# Fused updates against their plain version, relative to each tensor's
# largest |value|: the same f32 formulas, apart from the compiler's fused
# multiply-adds (a few ulps).
TOL_FUSED = 1e-5
# One training step, GPU against CPU, f32 with TF32 off on both, the same
# weights and batch: only the order of summation differs (cuBLAS against
# the CPU's GEMMs, the kernels against their plain versions), through 2
# layers and a 30522-way decoder. Loss relative; each gradient relative to
# its tensor's largest |g|. Weights after one Adam step: Adam's first step
# moves each element by lr * g / (|g| + 3.2e-7), about lr, whatever the size
# of g, so an element whose gradient lies within the gradient tolerance of 0
# can step either way; those may differ by 2 lr, all others by f32 rounding.
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-3
TOL_TRAIN_W = 1e-6


def log(msg):
    print(msg, flush=True)


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi.splitlines()[0])
    return {"name": name, "count": count, "nvidia_smi": smi.splitlines()[0]}


def phase_build():
    """Every kernel library, one nvcc each, all started together."""
    import threading
    from mxnet_tpu_torch.ops import cuda as cuda_ops
    from mxnet_tpu_torch.ops.cuda import blocked_matmul as bm
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
    loaders = {"flash_attention_fwd": fa._library,
               "flash_attention_bwd": fa._bwd_library,
               "fused_optimizer": fo._library,
               "blocked_matmul": bm._library}
    errors = []

    def load(fn):
        try:
            fn()
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=load, args=(fn,)) for fn in loaders.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    if errors:
        raise errors[0]
    log(f"[build] {len(loaders)} libraries in {seconds:.2f} s (wall, in parallel)")
    out = {"wall_s": seconds}
    for name in loaders:
        info = cuda_ops.build_info.get(name, {})
        out[name] = info.get("seconds")
        log(f"[build] {name}: nvcc {info.get('seconds', float('nan')):.2f} s")
        kernel = None
        for line in info.get("ptxas", "").splitlines():
            if "Compiling entry function" in line:
                kernel = _short_kernel_name(line)
            elif "Used" in line or "spill" in line:
                log(f"  ptxas {kernel}: {line.strip().replace('ptxas info    : ', '')}")
    return out


def _short_kernel_name(line):
    """'flash_bwd_dq_kernel<f32, 64>' out of a ptxas 'Compiling entry' line."""
    import re
    mangled = line.split("'")[1] if "'" in line else line
    m = re.search(r"\d+(flash_\w+?_kernel|multi_tensor_update|blocked_matmul_kernel)I",
                  mangled)
    if not m:
        return mangled[-60:]
    rest, args = mangled[m.end():], []
    tokens = [(r"13__nv_bfloat16", "bf16"), (r"6__half", "f16"), (r"f", "f32"),
              (r"S\d*_", None), (r"Lb1E", "adam"), (r"Lb0E", "sgd"),
              (r"Li(\d+)E", "")]
    while rest and not rest.startswith("E"):
        for pat, name in tokens:
            t = re.match(pat, rest)
            if t:
                args.append(args[-1] if name is None else (name or t.group(1)))
                rest = rest[t.end():]
                break
        else:
            break
    return f"{m.group(1)}<{', '.join(args)}>"


def _time_ms(torch, fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attention_inputs(torch, gen, BH, T, Tk, D, dtype):
    dev = torch.device("cuda", 0)
    return tuple(torch.randn((BH, n, D), generator=gen, device=dev).to(dtype)
                 for n in (T, Tk, Tk))


def _bound_ms(BH, T, Tk, D, dtype_name, elem):
    flops = 4.0 * BH * T * Tk * D
    nbytes = elem * (2 * BH * T * D + 2 * BH * Tk * D) + 4 * BH * T
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernel(torch):
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}
    # (label, B, H, T, Tk, D, dtype, causal)
    cases = [("bert-base", 8, 12, 1024, 1024, 64, "float32", False),
             ("bert-base", 8, 12, 1024, 1024, 64, "float32", True),
             ("bert-base", 8, 12, 1024, 1024, 64, "bfloat16", False),
             ("bert-base", 8, 12, 1024, 1024, 64, "bfloat16", True),
             ("ragged", 2, 4, 1000, 1000, 64, "float32", False),
             ("ragged", 2, 4, 1000, 1000, 64, "float32", True),
             ("cross", 2, 2, 96, 224, 32, "float32", False),
             ("head128", 1, 4, 300, 300, 128, "float16", True)]
    worst = 0.0
    results = []
    with torch.no_grad():
        for label, B, H, T, Tk, D, dname, causal in cases:
            q, k, v = _attention_inputs(torch, gen, B * H, T, Tk, D, dtypes[dname])
            o, lse = fa.flash_attention_fwd(q, k, v, causal)
            torch.cuda.synchronize()
            o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal)
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            ok = err_o <= TOL_O[dname] and err_lse <= TOL_LSE
            log(f"[kernel] flash_attention_fwd {label} B={B} H={H} T={T} Tk={Tk} "
                f"D={D} {dname} causal={causal}: max|dO|={err_o:.3e} "
                f"(tol {TOL_O[dname]:.0e}) max|dLSE|={err_lse:.3e} "
                f"(tol {TOL_LSE:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention_fwd disagrees with its "
                                     f"plain version ({label}, {dname}, causal={causal})")
            if dname == "float32":
                worst = max(worst, err_o, err_lse)
            results.append({"case": label, "B": B, "H": H, "T": T, "Tk": Tk,
                            "D": D, "dtype": dname, "causal": causal,
                            "err_o": err_o, "err_lse": err_lse})

        timings = {}
        for dname in ("float32", "bfloat16"):
            B, H, T, D = 8, 12, 1024, 64
            q, k, v = _attention_inputs(torch, gen, B * H, T, T, D, dtypes[dname])
            q4, k4, v4 = (t.view(B, H, T, D) for t in (q, k, v))
            ms = _time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v), 20)
            plain_ms = _time_ms(torch, lambda: fa.flash_attention_fwd_plain(q, k, v), 5)
            lib_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
            bound, by = _bound_ms(B * H, T, T, D, dname, q.element_size())
            timings[dname] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                              "bound_ms": bound, "bound_by": by}
            log(f"[kernel] flash_attention_fwd B={B} H={H} T={T} D={D} {dname}: "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                f"bound {bound:.4f} ms ({by}), {4.0 * B * H * T * T * D / ms / 1e9:.2f} TFLOP/s")
    return {"cases": results, "max_abs_err_f32": worst, "timings": timings}


def _bwd_bound_ms(kind, BH, T, Tk, D, dtype_name, elem):
    """Least time for one backward kernel: its operations (dq: S, dP, dQ;
    dkv: S, dP, dV, dK, 2*BH*T*Tk*D each) or its bytes (q, k, v, dO, LSE and
    delta read once, its outputs written once), whichever is larger. In f32
    the operations are held to the 3xTF32 tensor-core route, three TF32
    products each at 495 TFLOP/s (``bound_ms``), with the 67 TFLOP/s FMA
    bound of the earlier kernels beside it (``fma_bound_ms``)."""
    products = 3 if kind == "dq" else 4
    flops = 2.0 * products * BH * T * Tk * D
    reads = elem * (2 * BH * T * D + 2 * BH * Tk * D) + 8 * BH * T
    writes = elem * (BH * T * D if kind == "dq" else 2 * BH * Tk * D)
    t_bytes = (reads + writes) / PEAK_BYTES_PER_S * 1e3
    out = {}
    if dtype_name == "float32":
        t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
        out["fma_bound_ms"] = max(flops / PEAK_FLOPS["float32"] * 1e3, t_bytes)
    else:
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    out["bound_ms"] = max(t_ops, t_bytes)
    out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return out


def _bwd_resources(fa):
    """For every instantiation of the two backward kernels in the built
    library: its HMMA instructions (``cuobjdump -sass``), registers, stack
    and local memory (``cuobjdump -res-usage``; spills live in local memory)
    and dynamic shared memory a block. Read from the library itself, so the
    same whether or not this process built it. Fails if a kernel has no
    HMMA or no resource line, or uses local memory at D=64."""
    import re
    import shutil
    from mxnet_tpu_torch.ops import cuda as cuda_ops
    lib = fa._bwd_library()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    path = str(cuda_ops.BUILD_DIR / "libflash_attention_bwd.so")

    def dump(flag):
        return subprocess.run([tool, flag, path], capture_output=True, text=True,
                              timeout=300, check=True).stdout
    kernels, name = {}, None
    for line in dump("-sass").splitlines():
        if "Function :" in line:
            name = _short_kernel_name(line.split("Function :", 1)[1].strip())
            kernels[name] = {"hmma": 0}
        elif name and re.search(r"\bHMMA\b", line):
            kernels[name]["hmma"] += 1
    name = None
    for line in dump("-res-usage").splitlines():
        if line.strip().startswith("Function "):
            name = _short_kernel_name(line.strip()[len("Function "):].rstrip(":"))
        elif name and "REG:" in line:
            usage = {k: int(v) for k, v in re.findall(r"([A-Z]+):(\d+)", line)}
            kernels.setdefault(name, {"hmma": 0}).update(
                registers=usage.get("REG"), stack_bytes=usage.get("STACK", 0),
                local_bytes=usage.get("LOCAL", 0))
            name = None
    codes = {"f32": 0, "bf16": 1, "f16": 2}
    failures = []
    for name, info in sorted(kernels.items()):
        m = re.match(r"flash_bwd_(dq|dkv)_kernel<(\w+), (\d+)>", name)
        if not m:
            continue
        info["smem_bytes"] = lib.mxt_flash_attention_bwd_smem_bytes(
            int(m.group(1) == "dkv"), int(m.group(3)), codes[m.group(2)])
        log(f"[kernel] {name}: {info['hmma']} HMMA, {info.get('registers')} registers, "
            f"{info.get('stack_bytes')} B stack, {info.get('local_bytes')} B local "
            f"memory, {info['smem_bytes']} B dynamic shared memory a block")
        if info["hmma"] == 0:
            failures.append(f"{name} has no HMMA instruction")
        if info.get("registers") is None:
            failures.append(f"{name} has no resource line in cuobjdump -res-usage")
        elif m.group(3) == "64" and info["stack_bytes"] + info["local_bytes"] > 0:
            failures.append(f"{name} uses {info['stack_bytes']} B stack and "
                            f"{info['local_bytes']} B local memory at D=64")
    for kind in ("dq", "dkv"):
        if not any(n.startswith(f"flash_bwd_{kind}_kernel<") for n in kernels):
            failures.append(f"flash_bwd_{kind}_kernel not found in the SASS")
    if failures:
        raise AssertionError("; ".join(failures))
    return kernels


def _graph_ms(torch, fn, iters=20):
    """Device time of one call of ``fn``: the call captured once in a CUDA
    graph, then replayed back to back between CUDA events, so the host's
    launches and allocations are out of the way. (``torch.profiler`` read
    the same times but, started many times in one process, once returned
    every kernel's time scaled down and once no device record at all.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _time_ms(torch, graph.replay, iters)


def phase_kernel_bwd(torch):
    """K2 and K3 against the plain backward, then timed."""
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}
    cases = [("bert-base", 8, 12, 1024, 1024, 64, "float32", False),
             ("bert-base", 8, 12, 1024, 1024, 64, "float32", True),
             ("bert-base", 8, 12, 1024, 1024, 64, "bfloat16", False),
             ("bert-base", 8, 12, 1024, 1024, 64, "bfloat16", True),
             ("ragged", 2, 4, 1000, 1000, 64, "float32", False),
             ("ragged", 2, 4, 1000, 1000, 64, "float32", True),
             ("cross", 2, 2, 96, 224, 32, "float32", False),
             ("head128", 1, 4, 300, 300, 128, "float16", True)]
    results, worst = [], {"dq": 0.0, "dkv": 0.0}
    with torch.no_grad():
        for label, B, H, T, Tk, D, dname, causal in cases:
            q, k, v = _attention_inputs(torch, gen, B * H, T, Tk, D, dtypes[dname])
            do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
            o, lse = fa.flash_attention_fwd(q, k, v, causal)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
            torch.cuda.synchronize()
            expect = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
            errs = {}
            for name, g, e in zip(("dq", "dk", "dv"), got, expect):
                rel = ((g.float() - e.float()).abs().max()
                       / e.float().abs().max().clamp_min(1e-30)).item()
                errs[name] = {"max_abs": (g.float() - e.float()).abs().max().item(),
                              "rel": rel}
            ok = all(e["rel"] <= TOL_BWD[dname] for e in errs.values())
            log(f"[kernel] flash_attention_bwd {label} B={B} H={H} T={T} Tk={Tk} "
                f"D={D} {dname} causal={causal}: "
                + " ".join(f"max|d{n[1:]}|={e['max_abs']:.3e} ({e['rel']:.1e} of max)"
                           for n, e in errs.items())
                + f" (tol {TOL_BWD[dname]:.0e} of max) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention_bwd disagrees with its plain "
                                     f"version ({label}, {dname}, causal={causal})")
            if dname == "float32":
                worst["dq"] = max(worst["dq"], errs["dq"]["max_abs"])
                worst["dkv"] = max(worst["dkv"], errs["dk"]["max_abs"],
                                   errs["dv"]["max_abs"])
            results.append({"case": label, "B": B, "H": H, "T": T, "Tk": Tk, "D": D,
                            "dtype": dname, "causal": causal, "errors": errs})

    resources = _bwd_resources(fa)
    timings = {}
    for dname in ("float32", "bfloat16"):
        B, H, T, D = 8, 12, 1024, 64
        BH = B * H
        q, k, v = _attention_inputs(torch, gen, BH, T, T, D, dtypes[dname])
        do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
        with torch.no_grad():
            o, lse = fa.flash_attention_fwd(q, k, v)
            delta = (do.float() * o.float()).sum(-1)
            dq_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, delta), 20)
            dkv_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta), 20)
            plain_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do), 5)
        q4, k4, v4 = (t.view(B, H, T, D).clone().requires_grad_() for t in (q, k, v))
        do4 = do.view(B, H, T, D)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(q4, k4, v4)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (q4, k4, v4), do4)
        with torch.no_grad():
            sdpa_fwd_ms = _time_ms(torch, sdpa_fwd, 20)
            # the port's whole backward, delta's torch ops included, read as
            # SDPA's is below
            port_ms = _graph_ms(torch, lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do))
        sdpa_both = _time_ms(torch, sdpa_fwd_bwd, 20)
        # SDPA's whole backward, its preprocessing of dO and O included:
        # forward+backward less the same forward, both replayed from graphs
        sdpa_graph_both = _graph_ms(torch, sdpa_fwd_bwd)
        sdpa_graph_fwd = _graph_ms(torch, sdpa_fwd)
        entry = {"plain_ms": plain_ms,
                 "library_ms": sdpa_graph_both - sdpa_graph_fwd,
                 "library_graph_fwd_bwd_ms": sdpa_graph_both,
                 "library_graph_fwd_ms": sdpa_graph_fwd,
                 "port_bwd_ms": port_ms,
                 "library_fwd_bwd_less_fwd_ms": sdpa_both - sdpa_fwd_ms,
                 "library_fwd_bwd_ms": sdpa_both, "library_fwd_ms": sdpa_fwd_ms}
        for kind, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
            entry[kind] = dict(ms=ms, **_bwd_bound_ms(kind, BH, T, T, D, dname,
                                                      q.element_size()))
        timings[dname] = entry
        fma = (f", FMA bound {entry['dq']['fma_bound_ms']:.4f} / "
               f"{entry['dkv']['fma_bound_ms']:.4f}" if dname == "float32" else "")
        log(f"[kernel] flash_attention_bwd B={B} H={H} T={T} D={D} {dname}: "
            f"dQ kernel {dq_ms:.4f} ms (bound {entry['dq']['bound_ms']:.4f}, "
            f"{entry['dq']['bound_by']}), dK/dV kernel {dkv_ms:.4f} ms (bound "
            f"{entry['dkv']['bound_ms']:.4f}, {entry['dkv']['bound_by']}){fma}; "
            f"together {dq_ms + dkv_ms:.4f} ms; plain (both) {plain_ms:.4f} ms")
        log(f"[kernel]   whole backward, replayed from a CUDA graph: port "
            f"{port_ms:.4f} ms (delta's torch ops included), SDPA "
            f"{entry['library_ms']:.4f} ms (forward+backward {sdpa_graph_both:.4f} "
            f"less forward {sdpa_graph_fwd:.4f}); SDPA forward+backward less "
            f"forward by CUDA events around host-paced calls "
            f"{entry['library_fwd_bwd_less_fwd_ms']:.4f} ({sdpa_both:.4f} less "
            f"{sdpa_fwd_ms:.4f})")
    return {"cases": results, "max_abs_err_f32": worst, "timings": timings,
            "resources": resources}


def _ragged_list(torch, gen, dtype, shapes):
    dev = torch.device("cuda", 0)
    return [torch.randn(s, generator=gen, device=dev).to(dtype) for s in shapes]


def _fused_errors(torch, got, expect):
    """Largest |kernel - plain| relative to each tensor's largest |plain|."""
    worst_rel, worst_abs = 0.0, 0.0
    for a, b in zip(sum(map(list, got), []), sum(map(list, expect), [])):
        if b.numel() == 0:
            continue
        d = (a.float() - b.float()).abs().max().item()
        worst_abs = max(worst_abs, d)
        worst_rel = max(worst_rel, d / max(b.float().abs().max().item(), 1e-30))
    return worst_rel, worst_abs


def phase_kernel_fused_ragged(torch):
    """K4 and K5 against their plain versions on a small ragged list: odd
    sizes, a chunk boundary, an empty and a misaligned tensor, three dtypes."""
    from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(1000, 77), (3,), (16384,), (16385,), (0,), (5, 1)]
    out = []
    for wname, sname in (("float32", "float32"), ("bfloat16", "float32"),
                         ("float16", "float16")):
        wd_t, sd_t = getattr(torch, wname), getattr(torch, sname)
        w = _ragged_list(torch, gen, wd_t, shapes)
        w.append(torch.randn(1001, generator=gen, device="cuda").to(wd_t)[1:])
        g = _ragged_list(torch, gen, wd_t, shapes + [(1000,)])
        m = [0.1 * t for t in _ragged_list(torch, gen, sd_t, shapes + [(1000,)])]
        v = [0.01 * t.abs() for t in _ragged_list(torch, gen, sd_t, shapes + [(1000,)])]
        tol = TOL_FUSED if wname == "float32" else 1e-2
        for name, fn, plain, args, kw in (
                ("fused_adam", fo.fused_adam_apply, fo.fused_adam_apply_plain,
                 (w, g, m, v), {"lr": 1e-2, "wd": 0.01, "t": 3}),
                ("fused_sgd", fo.fused_sgd_apply, fo.fused_sgd_apply_plain,
                 (w, g, m), {"lr": 1e-2, "momentum": 0.9, "wd": 0.01})):
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            rel, _ = _fused_errors(torch, got, plain(*args, **kw))
            ok = rel <= tol
            log(f"[kernel] {name} ragged list of {len(w)} ({wname} weights, "
                f"{sname} states): max|d| {rel:.2e} of max (tol {tol:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version")
            out.append({"kernel": name, "weights": wname, "states": sname,
                        "rel_err": rel})
    return out


def phase_serve(torch):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import load_jax_params, seeded_params
    from mxnet_tpu_torch.models import bert_base
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[serve] bert_base(max_length=1024) f32, TF32 off "
        f"(matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32})")
    T, n_layers = 1024, 12
    t0 = time.perf_counter()
    net = bert_base(max_length=T)
    params = seeded_params(net, seed=0)
    net.initialize(ctx=mx.gpu(0))
    load_jax_params(net, params)
    torch.cuda.synchronize()
    log(f"[serve] model ready in {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.size for p in params.values())} parameters")
    rs = np.random.RandomState(1)
    batches = [1, 1, 2, 4, 8]   # the first batch-1 request is the warm-up
    requests = [rs.randint(0, 30522, size=(b, T)).astype(np.int32) for b in batches]

    fa.flash_attention_fwd.launches = 0   # every kernel's count, just before
    torch.cuda.reset_peak_memory_stats()
    served = []
    first_logits = None
    for i, tokens in enumerate(requests):
        before = fa.flash_attention_fwd.launches
        t_start = time.perf_counter()
        logits = net(mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32"))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_start) * 1e3
        launched = fa.flash_attention_fwd.launches - before
        finite = bool(torch.isfinite(logits._data).all().item())
        B = tokens.shape[0]
        log(f"[serve] request {i} batch={B} T={T}: {ms:.2f} ms, "
            f"{B * T / ms * 1e3:.0f} tokens/s, flash launches {launched}, "
            f"logits {logits.shape} finite={finite}"
            + (" (warm-up)" if i == 0 else ""))
        if launched != n_layers:
            raise AssertionError(f"expected {n_layers} flash launches, got {launched}")
        if not finite or logits.shape != (B, T, 30522):
            raise AssertionError("bad logits")
        if i == 0:
            first_logits = logits.asnumpy()
        served.append({"batch": B, "ms": ms, "tokens_per_s": B * T / ms * 1e3,
                       "warmup": i == 0})
        del logits
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] launches {launches}; peak device memory {peak / 2**30:.3f} GiB")
    last = mx.nd.array(requests[-1], ctx=mx.gpu(0), dtype="int32")
    profile = _profile(torch, "batch=8 request", lambda: net(last))

    t0 = time.perf_counter()
    net_cpu = bert_base(max_length=T)
    net_cpu.initialize(ctx=mx.cpu())
    load_jax_params(net_cpu, params)
    ref = net_cpu(mx.nd.array(requests[0], ctx=mx.cpu(), dtype="int32")).asnumpy()
    diff = float(np.abs(ref - first_logits).max())
    log(f"[serve] batch-1 logits, GPU vs CPU: max|d|={diff:.3e} "
        f"(tol {TOL_LOGITS:.0e}, max|logit|={np.abs(ref).max():.3f}, "
        f"CPU run {time.perf_counter() - t0:.1f} s)")
    if not diff <= TOL_LOGITS:
        raise AssertionError("GPU logits disagree with the CPU run")
    return {"requests": served, "launches": launches, "peak_bytes": peak,
            "cpu_max_abs_diff": diff, "profile": profile}


def _kernel_group(name):
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "flash_attention_fwd"
    if "flash_bwd_dq_kernel" in low:
        return "flash_attention_bwd_dq"
    if "flash_bwd_dkv_kernel" in low:
        return "flash_attention_bwd_dkv"
    if "multi_tensor_update" in low:
        return "fused_optimizer"
    if "blocked_matmul_kernel" in low:
        return "blocked_matmul"
    if any(s in low for s in ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")):
        return "batchnorm"
    if any(s in low for s in ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                              "cudnn")):
        return "convolution (cuDNN)"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas")):
        return "matmul (cuBLAS)"
    if "pool" in low:
        return "pooling"
    return "other (elementwise, norms, copies)"


def _profile(torch, label, fn):
    """``fn()`` once under torch.profiler: device time by kernel group and
    the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        log("[profile] no device events recorded: device time not measured")
        return {"wall_us": wall_us, "device_us": None}
    device_us = sum(k[1] for k in kernels)
    groups, counts = {}, {}
    for name, us, n in kernels:
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us
        counts[g] = counts.get(g, 0) + n
    log(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{device_us / 1e3:.2f} ms ({100 * device_us / wall_us:.1f}%)")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {g}: {us / 1e3:.2f} ms in {counts[g]} launches "
            f"({100 * us / device_us:.1f}% of device time)")
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    for name, us, n in top:
        log(f"[profile]   {us / 1e3:8.3f} ms x{n:<4d} {name[:90]}")
    return {"wall_us": wall_us, "device_us": device_us, "groups_us": groups,
            "group_launches": counts,
            "top": [{"kernel": k, "us": us, "count": n} for k, us, n in top]}


def _bert_trainer(mx, net, lr):
    return (mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": lr}))


def _train_step(mx, net, loss_fn, trainer, x, y):
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def phase_train(torch):
    """BERT-base training at T=1024, batch 8, through Gluon on gpu(0)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import load_jax_params, seeded_params
    from mxnet_tpu_torch.models import bert_base
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, T, n_layers, V = 8, 1024, 12, 30522
    t0 = time.perf_counter()
    net = bert_base(max_length=T)
    params = seeded_params(net, seed=0)
    net.initialize(ctx=mx.gpu(0))
    load_jax_params(net, params)
    loss_fn, trainer = _bert_trainer(mx, net, 1e-4)
    rs = np.random.RandomState(2)
    x = mx.nd.array(rs.randint(0, V, size=(B, T)).astype(np.int32), ctx=mx.gpu(0),
                    dtype="int32")
    y = mx.nd.array(rs.randint(0, V, size=(B, T)).astype(np.int32), ctx=mx.gpu(0),
                    dtype="int32")
    torch.cuda.synchronize()
    log(f"[train] bert_base(max_length={T}) f32, TF32 off "
        f"(matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}), "
        f"{sum(p.size for p in params.values())} parameters in {len(params)} "
        f"tensors, Trainer adam lr 1e-4, batch {B}x{T}; ready in "
        f"{time.perf_counter() - t0:.2f} s")
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    for c in counters:           # every kernel's count, just before the path
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(5):           # step 0 is the warm-up
        before = [c.launches for c in counters]
        t_start = time.perf_counter()
        loss = _train_step(mx, net, loss_fn, trainer, x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_start) * 1e3
        launched = [c.launches - b for c, b in zip(counters, before)]
        value = float(loss.mean().asscalar())
        log(f"[train] step {i}: {ms:.2f} ms, {B * T / ms * 1e3:.0f} tokens/s, "
            f"loss {value:.6f}, launches fwd/dQ/dKV {launched}"
            + (" (warm-up)" if i == 0 else ""))
        if launched != [n_layers] * 3:
            raise AssertionError(f"expected {n_layers} launches of each flash "
                                 f"kernel per step, got {launched}")
        if not np.isfinite(value):
            raise AssertionError("training loss is not finite")
        steps.append({"ms": ms, "tokens_per_s": B * T / ms * 1e3, "loss": value,
                      "warmup": i == 0})
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] launches {launches}; peak device memory {peak / 2**30:.3f} GiB; "
        f"loss {steps[0]['loss']:.6f} -> {steps[-1]['loss']:.6f}")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError("the loss did not fall on a repeated batch")
    profile = _profile(torch, "training step, batch 8",
                       lambda: _train_step(mx, net, loss_fn, trainer, x, y))
    weights = [p.data()._data for p in net.collect_params().values()]
    grads = [p.grad()._data for p in net.collect_params().values()]
    return {"steps": steps, "launches": launches, "peak_bytes": peak,
            "profile": profile}, weights, grads


def _tiny_bert_step(mx, ctx, params, x, y):
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.models import BertModel
    net = BertModel(num_layers=2, max_length=1024)
    net.initialize(ctx=ctx)
    load_jax_params(net, params)
    loss_fn, trainer = _bert_trainer(mx, net, 1e-4)
    xs, ys = (mx.nd.array(a, ctx=ctx, dtype="int32") for a in (x, y))
    with mx.autograd.record():
        loss = loss_fn(net(xs), ys)
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net._collect_params_with_prefix().items()}
    trainer.step(1)
    weights = {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}
    return float(loss.asnumpy()[0]), grads, weights


def phase_train_check(torch):
    """One step of a 2-layer model of BERT-base width, GPU against CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.models import BertModel
    t0 = time.perf_counter()
    params = seeded_params(BertModel(num_layers=2, max_length=1024), seed=5)
    rs = np.random.RandomState(6)
    x = rs.randint(0, 30522, size=(1, 1024)).astype(np.int32)
    y = rs.randint(0, 30522, size=(1, 1024)).astype(np.int32)
    gpu = _tiny_bert_step(mx, mx.gpu(0), params, x, y)
    cpu = _tiny_bert_step(mx, mx.cpu(), params, x, y)
    loss_rel = abs(gpu[0] - cpu[0]) / abs(cpu[0])
    grad_rel = max(float(np.abs(gpu[1][k] - g).max()) / max(float(np.abs(g).max()), 1e-30)
                   for k, g in cpu[1].items())
    w_strict, loose, n_loose = 0.0, 0.0, 0
    for k, w in cpu[2].items():
        g = cpu[1][k]
        d = np.abs(gpu[2][k] - w)
        near0 = np.abs(g) <= TOL_TRAIN_GRAD * max(np.abs(g).max(), 1e-30)
        w_strict = max(w_strict, float(d[~near0].max()) if (~near0).any() else 0.0)
        if near0.any():
            loose = max(loose, float(d[near0].max()))
            n_loose += int((near0 & (g != 0)).sum())   # exact zeros do not move
    ok = (loss_rel <= TOL_TRAIN_LOSS and grad_rel <= TOL_TRAIN_GRAD
          and w_strict <= TOL_TRAIN_W and loose <= 2.0 * 1e-4 * 1.001)
    log(f"[train-check] 2 layers of BERT-base width, T=1024, batch 1, one Adam "
        f"step, GPU vs CPU: loss {gpu[0]:.6f} vs {cpu[0]:.6f} (rel {loss_rel:.2e}, "
        f"tol {TOL_TRAIN_LOSS:.0e}); gradients max|d| {grad_rel:.2e} of the "
        f"tensor's max (tol {TOL_TRAIN_GRAD:.0e}); weights max|d| {w_strict:.2e} "
        f"(tol {TOL_TRAIN_W:.0e}), {n_loose} elements with a nonzero |g| within "
        f"the gradient tolerance of 0 up to {loose:.2e} (tol 2 lr = 2e-4); "
        f"{'ok' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
    if not ok:
        raise AssertionError("GPU training step disagrees with the CPU run")
    return {"loss_gpu": gpu[0], "loss_cpu": cpu[0], "loss_rel": loss_rel,
            "grad_rel": grad_rel, "weight_max_abs": w_strict,
            "near_zero_grad_elements": n_loose, "near_zero_weight_max_abs": loose}


def phase_fused(torch, weights, grads):
    """K4 and K5 on the trained BERT-base's weights and last gradients."""
    from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
    n = sum(w.numel() for w in weights)
    log(f"[fused] BERT-base: {len(weights)} tensors, {n} f32 parameters")
    w0 = [w.detach().clone() for w in weights]
    g0 = [g.detach().clone() for g in grads]

    def zeros():
        return [torch.zeros_like(w) for w in w0]

    adam_kw = {"lr": 1e-4, "wd": 0.01}
    sgd_kw = {"lr": 1e-2, "momentum": 0.9, "wd": 0.01}
    m0, v0, mom0 = zeros(), zeros(), zeros()

    fo.fused_adam_apply.launches = 0      # every kernel's count, just before
    fo.fused_sgd_apply.launches = 0
    adam1 = fo.fused_adam_apply(w0, g0, m0, v0, t=1, **adam_kw)
    adam2 = fo.fused_adam_apply(adam1[0], g0, adam1[1], adam1[2], t=2, **adam_kw)
    sgd1 = fo.fused_sgd_apply(w0, g0, mom0, **sgd_kw)
    sgd2 = fo.fused_sgd_apply(sgd1[0], g0, sgd1[1], **sgd_kw)
    torch.cuda.synchronize()
    launches = {"fused_adam": fo.fused_adam_apply.launches,
                "fused_sgd": fo.fused_sgd_apply.launches}
    log(f"[fused] launches {launches} for 2 calls each")
    if launches != {"fused_adam": 2, "fused_sgd": 2}:
        raise AssertionError("expected exactly one launch per fused call")

    errs = {}
    for name, got, expect in (
            ("fused_adam", adam1, fo.fused_adam_apply_plain(w0, g0, m0, v0, t=1, **adam_kw)),
            ("fused_adam", adam2, fo.fused_adam_apply_plain(
                adam1[0], g0, adam1[1], adam1[2], t=2, **adam_kw)),
            ("fused_sgd", sgd1, fo.fused_sgd_apply_plain(w0, g0, mom0, **sgd_kw)),
            ("fused_sgd", sgd2, fo.fused_sgd_apply_plain(sgd1[0], g0, sgd1[1], **sgd_kw))):
        rel, abs_ = _fused_errors(torch, got, expect)
        prev = errs.get(name, (0.0, 0.0))
        errs[name] = (max(prev[0], rel), max(prev[1], abs_))
    for name, (rel, abs_) in errs.items():
        ok = rel <= TOL_FUSED
        log(f"[fused] {name} vs plain, t=1 and t=2: max|d| {abs_:.3e} "
            f"({rel:.2e} of the tensor's max, tol {TOL_FUSED:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")

    # the torch fused optimizers compute the same first step
    pw = [torch.nn.Parameter(w.clone()) for w in w0]
    for p, g in zip(pw, g0):
        p.grad = g.clone()
    lib_adam = torch.optim.Adam(pw, lr=adam_kw["lr"], weight_decay=adam_kw["wd"],
                                fused=True)
    lib_adam.step()
    d_adam = max((p.detach() - w).abs().max().item() for p, w in zip(pw, adam1[0]))
    ps = [torch.nn.Parameter(w.clone()) for w in w0]
    for p, g in zip(ps, g0):
        p.grad = g.clone()
    lib_sgd = torch.optim.SGD(ps, lr=sgd_kw["lr"], momentum=sgd_kw["momentum"],
                              weight_decay=sgd_kw["wd"], fused=True)
    lib_sgd.step()
    d_sgd = max((p.detach() - w).abs().max().item() for p, w in zip(ps, sgd1[0]))
    log(f"[fused] first step against torch.optim (fused=True): Adam max|dw| "
        f"{d_adam:.3e}, SGD max|dw| {d_sgd:.3e}")

    # timing: in place (out= the inputs), so the pointer table is cached
    wa, ma, va = [w.clone() for w in w0], zeros(), zeros()
    ws, ms = [w.clone() for w in w0], zeros()
    adam_ms = _time_ms(torch, lambda: fo.fused_adam_apply(
        wa, g0, ma, va, t=2, out=(wa, ma, va), **adam_kw), 10)
    sgd_ms = _time_ms(torch, lambda: fo.fused_sgd_apply(
        ws, g0, ms, out=(ws, ms), **sgd_kw), 10)
    adam_plain = _time_ms(torch, lambda: fo.fused_adam_apply_plain(
        w0, g0, m0, v0, t=2, **adam_kw), 3)
    sgd_plain = _time_ms(torch, lambda: fo.fused_sgd_apply_plain(w0, g0, mom0, **sgd_kw), 3)
    adam_lib = _time_ms(torch, lib_adam.step, 10)
    sgd_lib = _time_ms(torch, lib_sgd.step, 10)
    out = {"parameters": n, "tensors": len(w0), "launches": launches,
           "first_step_vs_torch": {"adam": d_adam, "sgd": d_sgd}}
    for name, ms, plain, lib, per in (("fused_adam", adam_ms, adam_plain, adam_lib, 28),
                                      ("fused_sgd", sgd_ms, sgd_plain, sgd_lib, 20)):
        bound = per * n / PEAK_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                     "bound_by": "bytes", "max_abs_err": errs[name][1],
                     "rel_err": errs[name][0]}
        log(f"[fused] {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.optim "
            f"fused {lib:.4f} ms, bound {bound:.4f} ms (bytes: {per} B x {n}), "
            f"{per * n / ms / 1e9:.3f} TB/s")
    return out


# --- K6 (mx.rtc), K7 (blocked matmul probe), ResNet-50 ----------------------

def phase_rtc(torch):
    """K6: the example kernels compiled with NVRTC and launched through
    ``mx.rtc``, each against its plain version; axpy timed on 2^26 f32."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    t0 = time.perf_counter()
    module = rtc.CudaModule(rtc.EXAMPLES_SOURCE, exports=rtc.EXAMPLES_EXPORTS)
    compile_ms = (time.perf_counter() - t0) * 1e3
    n = 1 << 26
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, y = (mx.nd.NDArray(torch.randn(n, generator=gen, device="cuda")) for _ in range(2))
    rows, cols = 1000, 777
    m = mx.nd.NDArray(torch.randn((rows, cols), generator=gen, device="cuda"))
    s_in = mx.nd.NDArray(torch.randn(4096, generator=gen, device="cuda"))
    s_out = mx.nd.zeros((4096,), ctx=mx.gpu(0))
    axpy = module.get_kernel("axpy", rtc.AXPY_SIGNATURE, out_shapes=[((n,), "float32")])
    scale3 = module.get_kernel("scale3<float>", rtc.SCALE3_SIGNATURE)
    transpose = module.get_kernel("transpose", rtc.TRANSPOSE_SIGNATURE,
                                  out_shapes=[((cols, rows), "float32")])
    empty = module.get_kernel("empty")
    grid_t = (-(-cols // 32), -(-rows // 32), 1)

    rtc.CudaKernel.launches = 0          # the rtc path: counts set to 0 just before
    (z,) = axpy.launch([x, y, n], mx.gpu(0), (1024, 1, 1), (256, 1, 1))
    scale3.launch([s_in, s_out, 4096], mx.gpu(0), (16, 1, 1), (256, 1, 1))
    (t,) = transpose.launch([m, rows, cols], mx.gpu(0), grid_t, (32, 32, 1),
                            shared_mem=32 * 33 * 4)
    (t64,) = transpose.launch([m, rows, cols], mx.gpu(0), grid_t, (32, 32, 1),
                              shared_mem=64 * 1024)     # above the 48 KiB default
    empty.launch([], mx.gpu(0), (1,), (1,))
    torch.cuda.synchronize()
    launches = rtc.CudaKernel.launches
    log(f"[rtc] NVRTC compile of the examples {compile_ms:.1f} ms; launches {launches}")
    if launches != 5:
        raise AssertionError(f"expected 5 rtc launches, got {launches}")
    errs = {"axpy": (z._data - rtc.axpy_plain(x._data, y._data)).abs().max().item(),
            "scale3": (s_out._data - rtc.scale3_plain(s_in._data)).abs().max().item(),
            "transpose": (t._data - rtc.transpose_plain(m._data)).abs().max().item(),
            "transpose_64KiB": (t64._data - rtc.transpose_plain(m._data)).abs().max().item()}
    log(f"[rtc] against the plain versions (exact: the same f32 arithmetic): {errs}")
    if any(v != 0.0 for v in errs.values()):
        raise AssertionError("an rtc kernel disagrees with its plain version")

    def run_axpy():
        axpy.launch([x, y, n], mx.gpu(0), (1024, 1, 1), (256, 1, 1))
    ms = _time_ms(torch, run_axpy, 20)
    plain_ms = _time_ms(torch, lambda: rtc.axpy_plain(x._data, y._data), 20)
    lib_ms = _time_ms(torch, lambda: torch.add(y._data, x._data, alpha=2.0), 20)
    bound = 12.0 * n / PEAK_BYTES_PER_S * 1e3
    empty_launch = lambda: empty.launch([], mx.gpu(0), (1,), (1,))   # noqa: E731
    for _ in range(10):
        empty_launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        empty_launch()
    torch.cuda.synchronize()
    empty_host_us = (time.perf_counter() - t0) * 1e3
    empty_device_us = _time_ms(torch, empty_launch, 1000) * 1e3
    log(f"[rtc] axpy on 2^26 f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.add {lib_ms:.4f} ms, bound {bound:.4f} ms (bytes: 12 B x 2^26), "
        f"{12.0 * n / ms / 1e9:.3f} TB/s; empty launch {empty_host_us:.2f} us "
        f"(host clock per launch over 1000, synced), {empty_device_us:.2f} us "
        f"(CUDA events per launch)")
    return {"compile_ms": compile_ms, "launches": launches, "errors": errs,
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "empty_launch_host_us": empty_host_us,
            "empty_launch_device_us": empty_device_us}


# ResNet-50 batch-32 convolutions the TPU probe timed (conv_kernel_probe.py
# CONVS): (N, Cin, H, W, Cout, k, stride), and the im2col product of each
# padded to 512 / 512 / 256 as the probe pads it.
PROBE_CONVS = [(32, 256, 14, 14, 256, 3, 1), (32, 512, 7, 7, 512, 3, 1),
               (32, 1024, 14, 14, 256, 1, 1)]
TOL_PROBE = 1e-2   # bf16: one rounding of an f32 sum, relative to the output's max


def _ceil_to(x, m):
    return (x + m - 1) // m * m


def _probe_shape(n, cin, h, w, cout, k, stride):
    m = n * (h // stride) * (w // stride)
    return _ceil_to(m, 512), _ceil_to(cin * k * k, 512), _ceil_to(cout, 256)


def _rel_err(got, expect):
    d = (got.float() - expect.float()).abs().max().item()
    return d, d / max(expect.float().abs().max().item(), 1e-30)


def _im2col_check(torch, activations, weights):
    """K7 on the im2col form of real ResNet-50 activations against the port's
    Convolution op (cuDNN), in bf16."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda import blocked_matmul as bm
    from mxnet_tpu_torch.ops.nn import convolution
    out = {}
    for name, x in activations.items():
        x, w = x.to(torch.bfloat16), weights[name].to(torch.bfloat16)
        n, cin, h, wd = x.shape
        cout, _, k, _ = w.shape
        if k == 1:
            cols = x.permute(0, 2, 3, 1).reshape(n * h * wd, cin)
        else:
            cols = F.unfold(x, k, padding=k // 2).transpose(1, 2).reshape(n * h * wd, cin * k * k)
        y = bm.blocked_matmul(cols.contiguous(), w.reshape(cout, -1).t().contiguous())
        y = y.reshape(n, h, wd, cout).permute(0, 3, 1, 2)
        ref = convolution(x, w, None, kernel=(k, k), num_filter=cout, pad=(k // 2, k // 2),
                          no_bias=True)
        d, rel = _rel_err(y, ref)
        out[name] = {"shape": list(x.shape), "weight": list(w.shape), "max_abs": d, "rel": rel}
        log(f"[probe] real data, {name}: im2col {tuple(cols.shape)} x "
            f"({cols.shape[1]}, {cout}) through K7 vs Convolution (cuDNN), bf16: "
            f"max|d| {d:.3e} ({rel:.1e} of max, tol {TOL_PROBE:.0e}) "
            f"{'ok' if rel <= TOL_PROBE else 'FAIL'}")
        if rel > TOL_PROBE:
            raise AssertionError(f"K7 on real im2col data disagrees with the convolution ({name})")
    return out


def phase_probe(torch, activations, weights):
    """K7, the port's counterpart of ``conv_kernel_probe.main``: the blocked
    matmul over the im2col forms of ResNet-50's batch-32 convolutions in
    bf16, against its plain version, torch.matmul and the convolution."""
    from mxnet_tpu_torch.ops.cuda import blocked_matmul as bm
    from mxnet_tpu_torch.ops.nn import convolution
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = []
    for conv in PROBE_CONVS:
        M, K, N = _probe_shape(*conv)
        a = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        b = (0.05 * torch.randn((K, N), generator=gen, device="cuda")).to(torch.bfloat16)
        cases.append((conv, (M, K, N), a, b))

    bm.blocked_matmul.launches = 0        # the probe path: counts set to 0 just before
    outs = [bm.blocked_matmul(a, b) for _, _, a, b in cases]
    real = _im2col_check(torch, activations, weights)
    torch.cuda.synchronize()
    launches = bm.blocked_matmul.launches
    log(f"[probe] K7 launches on the probe path: {launches}")
    if launches != len(cases) + len(activations):
        raise AssertionError(f"expected {len(cases) + len(activations)} K7 launches, "
                             f"got {launches}")
    results = []
    for (conv, (M, K, N), a, b), out in zip(cases, outs):
        d, rel = _rel_err(out, bm.blocked_matmul_plain(a, b))
        if rel > TOL_PROBE:
            raise AssertionError(f"K7 disagrees with its plain version at {(M, K, N)}")
        n, cin, h, w, cout, k, stride = conv
        x = torch.randn((n, cin, h, w), generator=gen, device="cuda").to(torch.bfloat16)
        wt = (0.05 * torch.randn((cout, cin, k, k), generator=gen, device="cuda")).to(torch.bfloat16)
        ms = _time_ms(torch, lambda: bm.blocked_matmul(a, b), 20)
        plain_ms = _time_ms(torch, lambda: bm.blocked_matmul_plain(a, b), 5)
        mm_ms = _time_ms(torch, lambda: torch.matmul(a, b), 20)
        conv_ms = _time_ms(torch, lambda: convolution(
            x, wt, None, kernel=(k, k), num_filter=cout, stride=(stride, stride),
            pad=(k // 2, k // 2), no_bias=True), 20)
        flops = 2.0 * M * K * N
        nbytes = 2.0 * (M * K + K * N + M * N)
        t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"] * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        fma_floor = flops / PEAK_FLOPS["float32"] * 1e3
        r = {"conv": list(conv), "mkn": [M, K, N], "max_abs_err": d, "rel_err": rel,
             "ms": ms, "plain_ms": plain_ms, "library_ms": mm_ms, "conv_ms": conv_ms,
             "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "fma_floor_ms": fma_floor, "tflops": flops / ms / 1e9}
        results.append(r)
        log(f"[probe] ({M},{K})x({K},{N}) bf16 from conv{k}x{k} {cin}->{cout} {h}x{w} bs{n}: "
            f"K7 {ms:.4f} ms ({r['tflops']:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"torch.matmul {mm_ms:.4f} ms, Convolution (cuDNN) {conv_ms:.4f} ms; bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), FMA-only floor "
            f"{fma_floor * 1e3:.1f} us; max|d| vs plain {d:.3e} ({rel:.1e} of max, tol "
            f"{TOL_PROBE:.0e}) ok")
    total = {key: sum(r[key] for r in results)
             for key in ("ms", "plain_ms", "library_ms", "conv_ms", "bound_ms", "fma_floor_ms")}
    by_bytes = sum(r["bound_ms"] for r in results if r["bound_by"] == "bytes")
    total["bound_by"] = "bytes" if 2 * by_bytes >= total["bound_ms"] else "operations"
    return {"launches": launches, "shapes": results, "real_data": real, "total": total,
            "max_abs_err": max(r["max_abs_err"] for r in results)}


TOL_RESNET_LOGITS = 1e-3     # GPU against CPU, relative to the logits' max
RESNET_TRAIN_GFLOP = 3 * 7.64   # per 224x224 image (bench.py:39-51, port's own copy)
TOL_TRAIN_RUNNING = 1e-5


def _resnet50(mx, ctx, params):
    """ResNet-50 v1 on ``ctx``: one batch-1 shape pass, then the seeded weights."""
    from mxnet_tpu_torch.convert import load_jax_params, seeded_params
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    net = resnet50_v1()
    net.initialize(ctx=ctx)
    net(mx.nd.zeros((1, 3, 224, 224), ctx=ctx))
    if params is None:
        params = seeded_params(net, seed=0)
    load_jax_params(net, params)
    return net, params


def phase_resnet_serve(torch):
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    net, params = _resnet50(mx, mx.gpu(0), None)
    torch.cuda.synchronize()
    log(f"[resnet-serve] resnet50_v1 f32, TF32 off (matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}), {sum(p.size for p in params.values())} "
        f"parameters in {len(params)} tensors; ready in {time.perf_counter() - t0:.2f} s")
    rs = np.random.RandomState(7)
    torch.cuda.reset_peak_memory_stats()
    served = []
    for batch in (1, 8, 32):
        images = rs.uniform(-1, 1, (batch, 3, 224, 224)).astype(np.float32)
        for i in range(4):          # the first of each batch size is its warm-up
            t_start = time.perf_counter()
            logits = net(mx.nd.array(images, ctx=mx.gpu(0)))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t_start) * 1e3
            ok = logits.shape == (batch, 1000) and bool(torch.isfinite(logits._data).all())
            log(f"[resnet-serve] batch={batch} request {i}: {ms:.2f} ms, "
                f"{batch / ms * 1e3:.1f} img/s, logits {logits.shape} finite={ok}"
                + (" (warm-up)" if i == 0 else ""))
            if not ok:
                raise AssertionError("bad ResNet-50 logits")
            served.append({"batch": batch, "ms": ms, "img_per_s": batch / ms * 1e3,
                           "warmup": i == 0})
    peak = torch.cuda.max_memory_allocated()
    log(f"[resnet-serve] peak device memory {peak / 2**30:.3f} GiB")
    x32 = mx.nd.array(rs.uniform(-1, 1, (32, 3, 224, 224)).astype(np.float32), ctx=mx.gpu(0))
    profile = _profile(torch, "resnet50 batch=32 request", lambda: net(x32))

    # the probe's real data: inputs of a 3x3 and a 1x1 convolution of stage 3
    acts, weights, hooks = {}, {}, []
    for name, conv in (("stage3 3x3 256->256", net.features[6][1].body[3]),
                       ("stage3 1x1 1024->256", net.features[6][1].body[0])):
        hooks.append(conv.register_forward_pre_hook(
            lambda blk, args, name=name: acts.__setitem__(name, args[0]._data.detach())))
        weights[name] = conv.weight.data()._data.detach()
    net(x32)
    for h in hooks:
        h.detach()

    images = rs.uniform(-1, 1, (2, 3, 224, 224)).astype(np.float32)
    gpu_logits = net(mx.nd.array(images, ctx=mx.gpu(0))).asnumpy()
    t0 = time.perf_counter()
    net_cpu, _ = _resnet50(mx, mx.cpu(), params)
    ref = net_cpu(mx.nd.array(images, ctx=mx.cpu())).asnumpy()
    diff = float(np.abs(ref - gpu_logits).max())
    scale = float(np.abs(ref).max())
    log(f"[resnet-serve] batch-2 logits, GPU vs CPU: max|d| {diff:.3e} ({diff / scale:.1e} "
        f"of max|logit| {scale:.3f}, tol {TOL_RESNET_LOGITS:.0e}); logits std "
        f"{ref.std():.4f}, mean {ref.mean():.4f} (CPU run {time.perf_counter() - t0:.1f} s)")
    if not diff <= TOL_RESNET_LOGITS * scale or not ref.std() > 0.1:
        raise AssertionError("ResNet-50 GPU logits disagree with the CPU run, or are trivial")
    return ({"requests": served, "peak_bytes": peak, "profile": profile,
             "cpu_max_abs_diff": diff, "cpu_rel_diff": diff / scale,
             "logits_std": float(ref.std())}, params, acts, weights)


def _sgd_trainer(mx, net):
    return (mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            mx.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}))


def _zero_last_gamma(params):
    """The seeded weights with the γ of each bottleneck's last BatchNorm set
    to 0, so that every block starts as the identity (Goyal et al. 2017,
    GluonCV's ``last_gamma``). From the plain seeded weights, SGD at lr 0.05
    and momentum 0.9 without warm-up drives the loss up after its first step."""
    return {k: np.zeros_like(v) if k.endswith("body.7.gamma") else v
            for k, v in params.items()}


def phase_resnet_train(torch, params):
    """ResNet-50 v1 training at batch 32, 224x224, f32, through Gluon, from
    the seeded weights with zero-γ residual branches."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B = 32
    net, _ = _resnet50(mx, mx.gpu(0), _zero_last_gamma(params))
    loss_fn, trainer = _sgd_trainer(mx, net)
    rs = np.random.RandomState(8)
    x = mx.nd.array(rs.uniform(-1, 1, (B, 3, 224, 224)).astype(np.float32), ctx=mx.gpu(0))
    y = mx.nd.array(rs.randint(0, 1000, (B,)).astype(np.int32), ctx=mx.gpu(0), dtype="int32")
    stem_mean = net.features[1].running_mean.data()._data.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(6):           # step 0 is the warm-up
        t_start = time.perf_counter()
        loss = _train_step(mx, net, loss_fn, trainer, x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_start) * 1e3
        value = float(loss.mean().asscalar())
        img_s = B / ms * 1e3
        log(f"[resnet-train] step {i}: {ms:.2f} ms, {img_s:.1f} img/s, "
            f"{img_s * RESNET_TRAIN_GFLOP / 1e3:.2f} TFLOP/s, loss {value:.6f}"
            + (" (warm-up)" if i == 0 else ""))
        if not np.isfinite(value):
            raise AssertionError("training loss is not finite")
        steps.append({"ms": ms, "img_per_s": img_s,
                      "tflops": img_s * RESNET_TRAIN_GFLOP / 1e3, "loss": value,
                      "warmup": i == 0})
    peak = torch.cuda.max_memory_allocated()
    moved = (net.features[1].running_mean.data()._data - stem_mean).abs().max().item()
    log(f"[resnet-train] peak device memory {peak / 2**30:.3f} GiB; loss "
        f"{steps[0]['loss']:.6f} -> {steps[-1]['loss']:.6f}; stem running_mean "
        f"moved by up to {moved:.3e}")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError("the loss did not fall on a repeated batch")
    if not moved > 0:
        raise AssertionError("the running stats did not change")
    profile = _profile(torch, "resnet50 training step, batch 32",
                       lambda: _train_step(mx, net, loss_fn, trainer, x, y))
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    sgd = _profile(torch, "resnet50 Trainer.step (SGD momentum, per parameter)",
                   lambda: trainer.step(B))
    return {"steps": steps, "peak_bytes": peak, "profile": profile, "sgd_profile": sgd,
            "running_mean_moved": moved}


def _narrow_resnet_step(mx, ctx, params, x, y):
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256])
    net.initialize(ctx=ctx)
    net(mx.nd.zeros((1,) + x.shape[1:], ctx=ctx))
    if params is None:
        from mxnet_tpu_torch.convert import seeded_params
        params = seeded_params(net, seed=9)
    load_jax_params(net, params)
    loss_fn, trainer = _sgd_trainer(mx, net)
    xs, ys = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx, dtype="int32")
    with mx.autograd.record():
        loss = loss_fn(net(xs), ys)
    loss.backward()
    keys = net._collect_params_with_prefix()
    grads = {k: p.grad().asnumpy() for k, p in keys.items() if p.grad_req != "null"}
    trainer.step(x.shape[0])
    state = {k: p.data().asnumpy() for k, p in keys.items()}
    return float(loss.asnumpy().mean()), grads, state, params


def phase_resnet_train_check(torch):
    """One SGD step of a narrow ResNet-50-style net, GPU against CPU.
    The biases of the 1x1 convolutions that feed a training-mode BatchNorm
    have a gradient of 0 in exact arithmetic (the BatchNorm subtracts the
    batch mean); what is left is rounding noise, held to 1e-5 of the net's
    largest gradient instead of its own max."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(10)
    x = rs.uniform(-1, 1, (4, 3, 64, 64)).astype(np.float32)
    y = rs.randint(0, 1000, (4,)).astype(np.int32)
    gpu = _narrow_resnet_step(mx, mx.gpu(0), None, x, y)
    cpu = _narrow_resnet_step(mx, mx.cpu(), gpu[3], x, y)
    loss_rel = abs(gpu[0] - cpu[0]) / abs(cpu[0])
    gmax = max(float(np.abs(g).max()) for g in cpu[1].values())
    grad_rel, noise = 0.0, 0.0
    for k, g in cpu[1].items():
        d = float(np.abs(gpu[1][k] - g).max())
        if k.endswith("body.0.bias") or k.endswith("body.6.bias"):
            noise = max(noise, d / gmax)
        else:
            grad_rel = max(grad_rel, d / max(float(np.abs(g).max()), 1e-30))
    w_abs, run_rel = 0.0, 0.0
    for k, w in cpu[2].items():
        d = float(np.abs(gpu[2][k] - w).max())
        if "running" in k:
            run_rel = max(run_rel, d / max(float(np.abs(w).max()), 1e-30))
        else:
            w_abs = max(w_abs, d)
    ok = (loss_rel <= TOL_TRAIN_LOSS and grad_rel <= TOL_TRAIN_GRAD and noise <= 1e-5
          and w_abs <= TOL_TRAIN_W and run_rel <= TOL_TRAIN_RUNNING)
    log(f"[resnet-train-check] ResNetV1 bottleneck, 1 block a stage, channels "
        f"[16, 32, 64, 128, 256], 64x64, batch 4, one SGD step, GPU vs CPU: loss "
        f"{gpu[0]:.6f} vs {cpu[0]:.6f} (rel {loss_rel:.2e}, tol {TOL_TRAIN_LOSS:.0e}); "
        f"gradients {grad_rel:.2e} of the tensor's max (tol {TOL_TRAIN_GRAD:.0e}), "
        f"pre-BatchNorm biases {noise:.2e} of the largest gradient (tol 1e-05); weights "
        f"max|d| {w_abs:.2e} (tol {TOL_TRAIN_W:.0e}); running mean/var {run_rel:.2e} "
        f"of max (tol {TOL_TRAIN_RUNNING:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("GPU ResNet training step disagrees with the CPU run")
    return {"loss_gpu": gpu[0], "loss_cpu": cpu[0], "loss_rel": loss_rel,
            "grad_rel": grad_rel, "pre_bn_bias_noise": noise, "weight_max_abs": w_abs,
            "running_rel": run_rel}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU host",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mxnet_tpu_torch")):
        print("chip_smoke: mxnet_tpu_torch/ not found beside chip_smoke.py",
              file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    device = phase_device(torch)
    build = phase_build()
    kernel = phase_kernel(torch)
    kernel_bwd = phase_kernel_bwd(torch)
    kernel_fused = phase_kernel_fused_ragged(torch)
    serve = phase_serve(torch)
    train, weights, grads = phase_train(torch)
    train_check = phase_train_check(torch)
    fused = phase_fused(torch, weights, grads)
    del weights, grads
    rtc = phase_rtc(torch)
    resnet_serve, resnet_params, acts, conv_weights = phase_resnet_serve(torch)
    probe = phase_probe(torch, acts, conv_weights)
    del acts, conv_weights
    resnet_train = phase_resnet_train(torch, resnet_params)
    resnet_train_check = phase_resnet_train_check(torch)
    f32 = kernel["timings"]["float32"]
    b32 = kernel_bwd["timings"]["float32"]
    src = "mxnet_tpu_torch/csrc/"
    ref = "mxnet_tpu/ops/pallas/"
    fwd_by_path = {"serve": serve["launches"]["flash_attention_fwd"],
                   "train": train["launches"]["flash_attention_fwd"]}
    entries = [
        ("flash_attention_fwd", "flash_attention_fwd.cu", "flash_attention.py:86",
         sum(fwd_by_path.values()), kernel["max_abs_err_f32"], f32["ms"],
         f32["plain_ms"], f32["bound_ms"], f32["bound_by"], f32["library_ms"],
         {"launches_by_path": fwd_by_path}),
        *[(f"flash_attention_bwd_{kind}", "flash_attention_bwd.cu",
           f"flash_attention.py:{line}", train["launches"][f"flash_attention_bwd_{kind}"],
           kernel_bwd["max_abs_err_f32"][kind], b32[kind]["ms"], b32["plain_ms"],
           b32[kind]["bound_ms"], b32[kind]["bound_by"], b32["library_ms"],
           {"plain_and_library_cover": "dQ and dK/dV together",
            "bound": "3xTF32 on the tensor cores (3 TF32 products at 495 TFLOP/s)",
            "fma_bound_ms": b32[kind]["fma_bound_ms"],
            "port_bwd_ms": b32["port_bwd_ms"],
            "library_fwd_bwd_less_fwd_ms": b32["library_fwd_bwd_less_fwd_ms"],
            "hmma": {n: r["hmma"] for n, r in kernel_bwd["resources"].items()
                     if n.startswith(f"flash_bwd_{kind}_kernel<")}})
          for kind, line in (("dq", 181), ("dkv", 229))],
        ("fused_sgd", "fused_optimizer.cu", "fused_optimizer.py:66",
         fused["launches"]["fused_sgd"], fused["fused_sgd"]["max_abs_err"],
         fused["fused_sgd"]["ms"], fused["fused_sgd"]["plain_ms"],
         fused["fused_sgd"]["bound_ms"], "bytes", fused["fused_sgd"]["library_ms"], {}),
        ("fused_adam", "fused_optimizer.cu", "fused_optimizer.py:116",
         fused["launches"]["fused_adam"], fused["fused_adam"]["max_abs_err"],
         fused["fused_adam"]["ms"], fused["fused_adam"]["plain_ms"],
         fused["fused_adam"]["bound_ms"], "bytes", fused["fused_adam"]["library_ms"], {}),
    ]
    pt = probe["total"]
    pr3 = [
        ("rtc_cuda_module", "mxnet_tpu_torch/rtc.py", "mxnet_tpu/rtc.py:61",
         rtc["launches"], rtc["max_abs_err"], rtc["ms"], rtc["plain_ms"], rtc["bound_ms"],
         "bytes", rtc["library_ms"],
         {"timed": "axpy (2x+y) on 2^26 f32 through CudaModule/launch",
          "library": "torch.add(y, x, alpha=2.0)", "nvrtc_compile_ms": rtc["compile_ms"],
          "empty_launch_host_us": rtc["empty_launch_host_us"]}),
        ("blocked_matmul", "mxnet_tpu_torch/csrc/blocked_matmul.cu",
         "benchmark/conv_kernel_probe.py:59", probe["launches"], probe["max_abs_err"],
         pt["ms"], pt["plain_ms"], pt["bound_ms"], pt["bound_by"], pt["library_ms"],
         {"timed": "sum over the three bf16 probe shapes",
          "library": "torch.matmul (bf16)", "conv_ms": pt["conv_ms"],
          "fma_floor_ms": pt["fma_floor_ms"],
          "shapes": [{k: r[k] for k in ("mkn", "ms", "plain_ms", "library_ms", "conv_ms",
                                        "bound_ms", "bound_by")} for r in probe["shapes"]]}),
    ]
    entries = [(name, src + source, ref + replaces, *rest)
               for name, source, replaces, *rest in entries] + pr3
    line = {"kernels": [dict({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "max_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain,
        "bound_ms": bound, "bound_by": by, "library_ms": lib}, **extra)
        for name, source, replaces, launches, err, ms, plain, bound, by, lib, extra
        in entries]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": device, "build_s": build, "kernel": kernel,
                   "kernel_bwd": kernel_bwd, "kernel_fused": kernel_fused,
                   "serve": serve, "train": train, "train_check": train_check,
                   "fused": fused, "rtc": rtc, "resnet_serve": resnet_serve,
                   "probe": probe, "resnet_train": resnet_train,
                   "resnet_train_check": resnet_train_check, "kernels": line["kernels"],
                   "seconds": time.perf_counter() - t0}, f, indent=1, default=float)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": device["name"],
                                             "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
