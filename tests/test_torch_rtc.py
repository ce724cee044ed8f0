"""``mx.rtc`` in the port (``mxnet_tpu_torch/rtc.py``): CUDA C compiled at
run time with NVRTC and launched on NDArrays.

On the CPU: signature parsing, the argument checks (count, kind, dtype,
device, const outputs), a missing export and a missing kernel, refusal
without CUDA, and the example kernels' plain versions against the
reference's ``PallasModule`` kernels of the same name
(``tests/test_rtc_svrg.py``), run with ``interpret=True``; equal in f32,
since both compute 2x+y and 3x elementwise. The checks that need a module
use a stand-in for the NVRTC compile, which this host cannot run.

The ``gpu`` tests compile the example kernels with NVRTC, launch them and
hold them against their plain versions (exact: the same f32 arithmetic;
``axpy`` also for n in {0, 1, 3, 4, 5, 2^20+3} and on views off a 16-byte
boundary), check that a kernel's launch plan is built once a device and
kept apart for another instantiation or device, and skip here. On the CPU:
the launch grid of ``axpy``, the grid/block fast path and the scalar
slots.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError
from torch_threads import one_torch_thread  # noqa: F401


def test_parse_signature():
    args = rtc.parse_signature("const float *x, float* y,  int n, __half s, "
                               "const int64_t *idx, __nv_bfloat16 *b")
    assert [(a.name, a.dtype, a.is_pointer, a.is_const) for a in args] == [
        ("x", torch.float32, True, True), ("y", torch.float32, True, False),
        ("n", torch.int32, False, False), ("s", torch.float16, False, False),
        ("idx", torch.int64, True, True), ("b", torch.bfloat16, True, False)]
    assert rtc.parse_signature("") == []
    assert [a.name for a in rtc.parse_signature("float*, int")] == ["arg0", "arg1"]


@pytest.mark.parametrize("bad", ["const", "float x y", "unsigned *p", "float **p",
                                 "const float *x,"])
def test_parse_signature_refuses(bad):
    with pytest.raises(MXNetError):
        rtc.parse_signature(bad)


def test_missing_export_raises_before_compiling():
    with pytest.raises(MXNetError, match="exports not found"):
        rtc.CudaModule(rtc.EXAMPLES_SOURCE, exports=["scale4<float>"])


def test_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        rtc.CudaModule(rtc.EXAMPLES_SOURCE, exports=rtc.EXAMPLES_EXPORTS)
    with pytest.raises(MXNetError, match="Python kernel function"):
        rtc.CudaModule(rtc.axpy_plain)


@pytest.fixture()
def module(monkeypatch):
    """The examples' module with the NVRTC compile stood in for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(rtc, "_compile", lambda source, options, exports:
                        rtc._Compiled(b"", {e: f"lowered_{e}" for e in exports}))
    return rtc.CudaModule(rtc.EXAMPLES_SOURCE, exports=rtc.EXAMPLES_EXPORTS)


def test_get_kernel_names(module):
    assert module.get_kernel("axpy", rtc.AXPY_SIGNATURE)._symbol == "axpy"
    assert module.get_kernel("scale3<float>", rtc.SCALE3_SIGNATURE)._symbol == \
        "lowered_scale3<float>"
    with pytest.raises(MXNetError, match="kernel 'nope' not found"):
        module.get_kernel("nope", "float *x")
    with pytest.raises(MXNetError, match="const pointer"):
        module.get_kernel("axpy", "const float *x, const float *y, const float *z, int n",
                          out_shapes=[((4,), "float32")])
    with pytest.raises(MXNetError, match="out_shapes says"):
        module.get_kernel("axpy", rtc.AXPY_SIGNATURE, out_shapes=[((4,), "int32")])


def test_launch_checks_arguments(module):
    kern = module.get_kernel("axpy", rtc.AXPY_SIGNATURE, out_shapes=[((8,), "float32")])
    x = mt.nd.array(np.ones(8, np.float32), ctx=mt.cpu())
    launches = rtc.CudaKernel.launches
    cases = [
        ([x, x], mt.gpu(0), "takes 3 arguments"),
        ([x, np.ones(8, np.float32), 8], mt.gpu(0), "takes an NDArray"),
        ([x, x.astype("float16"), 8], mt.gpu(0), "the array is torch.float16"),
        ([x, x, x], mt.gpu(0), "takes a number"),
        ([x, x, 8.5], mt.gpu(0), "integer argument"),
        ([x, x, 8], mt.cpu(), "run on a CUDA device"),
        ([x, x, 8], mt.gpu(0), "lies on cpu"),
    ]
    for args, ctx, match in cases:
        with pytest.raises(MXNetError, match=match):
            kern.launch(args, ctx, (1, 1, 1), (8, 1, 1))
    assert rtc.CudaKernel.launches == launches


@pytest.fixture(scope="module")
def ref_mx():
    import mxnet_tpu as mx
    return mx


def test_plain_axpy_matches_reference(ref_mx):
    src = """
def axpy(x_ref, y_ref, o_ref):
    o_ref[...] = 2.0 * x_ref[...] + y_ref[...]
"""
    rs = np.random.RandomState(0)
    x, y = (rs.standard_normal((8, 8)).astype(np.float32) for _ in range(2))
    kern = ref_mx.rtc.PallasModule(src).get_kernel("axpy", out_shapes=[((8, 8), "float32")])
    (z,) = kern.launch([ref_mx.nd.array(x), ref_mx.nd.array(y)], interpret=True)
    got = rtc.axpy_plain(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, z.asnumpy())


def test_plain_scale3_matches_reference(ref_mx):
    def scale3(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 3.0

    x = np.random.RandomState(1).standard_normal(4).astype(np.float32)
    kern = ref_mx.rtc.CudaModule(scale3).get_kernel("scale3", out_shapes=[((4,), "float32")])
    (out,) = kern.launch([ref_mx.nd.array(x)], interpret=True)
    np.testing.assert_array_equal(rtc.scale3_plain(torch.from_numpy(x)).numpy(),
                                  out.asnumpy())


def test_axpy_launch_dims():
    assert rtc.axpy_launch_dims(0, 132) == ((1, 1, 1), (256, 1, 1))
    assert rtc.axpy_launch_dims(4096, 132) == ((1, 1, 1), (256, 1, 1))
    assert rtc.axpy_launch_dims(4097, 132) == ((2, 1, 1), (256, 1, 1))
    assert rtc.axpy_launch_dims(1 << 26, 132) == ((1 << 14, 1, 1), (256, 1, 1))
    assert rtc.axpy_launch_dims(1 << 28, 132) == ((128 * 132, 1, 1), (256, 1, 1))


def test_dims_and_scalar_slots():
    assert rtc._dims((4, 2, 1), "grid") == (4, 2, 1)
    assert rtc._dims(7, "grid") == (7, 1, 1)
    assert rtc._dims([3, 2], "grid") == (3, 2, 1)
    for bad in ((0, 1, 1), (1, 2, 3, 4), ()):
        with pytest.raises(MXNetError, match="grid"):
            rtc._dims(bad, "grid")
    for dtype, value, bits in ((torch.float16, 0.5, 0x3800), (torch.bfloat16, -2.0, 0xC000),
                               (torch.int32, 7, 7), (torch.float32, 1.5, 1.5)):
        slot = rtc._SCALAR_SLOT[dtype]()
        rtc._set_scalar(slot, dtype, value)
        assert slot.value == bits


def test_plain_transpose():
    x = torch.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(rtc.transpose_plain(x).numpy(), x.numpy().T)


# --- on the card -------------------------------------------------------------

@pytest.fixture()
def gpu_module():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return rtc.CudaModule(rtc.EXAMPLES_SOURCE, exports=rtc.EXAMPLES_EXPORTS)


def _nd(a):
    return mt.nd.array(a, ctx=mt.gpu(0))


@pytest.mark.gpu
def test_gpu_axpy_with_outputs(gpu_module):
    n = 100_003
    rs = np.random.RandomState(2)
    x, y = (_nd(rs.standard_normal(n).astype(np.float32)) for _ in range(2))
    kern = gpu_module.get_kernel("axpy", rtc.AXPY_SIGNATURE, out_shapes=[((n,), "float32")])
    launches = rtc.CudaKernel.launches
    (z,) = kern.launch([x, y, n], mt.gpu(0), (64, 1, 1), (256, 1, 1))
    torch.cuda.synchronize()
    assert rtc.CudaKernel.launches == launches + 1
    assert z.shape == (n,) and z.ctx == mt.gpu(0)
    np.testing.assert_array_equal(z.asnumpy(), rtc.axpy_plain(x._data, y._data).cpu().numpy())


@pytest.mark.gpu
def test_gpu_template_export_in_place(gpu_module):
    x = _nd(np.arange(1000, dtype=np.float32))
    y = _nd(np.zeros(1000, np.float32))
    kern = gpu_module.get_kernel("scale3<float>", rtc.SCALE3_SIGNATURE)
    assert kern.launch([x, y, 1000], mt.gpu(0), (4,), (256,)) is None
    np.testing.assert_array_equal(y.asnumpy(), rtc.scale3_plain(x._data).cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("shared_mem", [32 * 33 * 4, 64 * 1024])
def test_gpu_transpose_2d_grid_dynamic_shared_memory(gpu_module, shared_mem):
    rows, cols = 300, 517
    x = _nd(np.random.RandomState(3).standard_normal((rows, cols)).astype(np.float32))
    kern = gpu_module.get_kernel("transpose", rtc.TRANSPOSE_SIGNATURE,
                                 out_shapes=[((cols, rows), "float32")])
    (y,) = kern.launch([x, rows, cols], mt.gpu(0), (-(-cols // 32), -(-rows // 32), 1),
                       (32, 32, 1), shared_mem=shared_mem)
    np.testing.assert_array_equal(y.asnumpy(), rtc.transpose_plain(x._data).cpu().numpy())


@pytest.mark.gpu
def test_gpu_half_scalars_and_compile_errors():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    src = r"""
#include <cuda_fp16.h>
extern "C" __global__ void scale_h(const __half* x, __half* y, __half s, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __hmul(x[i], s);
}
"""
    kern = rtc.CudaModule(src).get_kernel(
        "scale_h", "const __half *x, __half *y, __half s, int n",
        out_shapes=[((64,), "float16")])
    x = mt.nd.array(np.linspace(-2, 2, 64), ctx=mt.gpu(0), dtype="float16")
    (y,) = kern.launch([x, 0.5, 64], mt.gpu(0), (1,), (64,))
    np.testing.assert_array_equal(y.asnumpy(), (x._data * 0.5).cpu().numpy())
    with pytest.raises(MXNetError, match="could not compile"):
        rtc.CudaModule('extern "C" __global__ void broken() { undefined_call(); }')


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, (1 << 20) + 3])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (3, 3, 3), (1, 2, 0), (0, 0, 2)],
                         ids=["aligned", "same-4B", "same-12B", "mixed", "z-off"])
def test_gpu_axpy_sizes_and_offsets(gpu_module, n, offsets):
    """The float4 axpy against its plain version, exact, on every size class
    (head, vectors, tail) and on views 4-12 bytes off a 16-byte boundary."""
    gen = torch.Generator(device="cuda").manual_seed(n)
    base = [torch.randn(n + 4, generator=gen, device="cuda") for _ in range(3)]
    x, y, z = (b[o:o + n] for b, o in zip(base, offsets))
    before = base[2].clone()
    kern = gpu_module.get_kernel("axpy", rtc.AXPY_SIGNATURE)
    kern.launch([mt.nd.NDArray(x), mt.nd.NDArray(y), mt.nd.NDArray(z), n], mt.gpu(0),
                *rtc.axpy_launch_dims(n, _sms()))
    torch.cuda.synchronize()
    assert torch.equal(z, rtc.axpy_plain(x, y))
    o = offsets[2]          # nothing written before z or after it
    assert torch.equal(base[2][:o], before[:o])
    assert torch.equal(base[2][o + n:], before[o + n:])


@pytest.mark.gpu
def test_gpu_launch_plan_reused_and_kept_apart():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    mod = rtc.CudaModule(rtc.EXAMPLES_SOURCE, exports=("scale3<float>", "scale3<double>"))
    f32 = mod.get_kernel("scale3<float>", rtc.SCALE3_SIGNATURE)
    f64 = mod.get_kernel("scale3<double>", "const double *x, double *y, int n")
    x32 = _nd(np.arange(100, dtype=np.float32))
    y32 = _nd(np.zeros(100, np.float32))
    f32.launch([x32, y32, 100], mt.gpu(0), (1,), (128,))
    plan = f32._plans[0]
    slots = [id(s) for s in plan.slots]
    f32.launch([y32, x32, 100], mt.gpu(0), (1,), (128,))
    assert f32._plans == {0: plan} and [id(s) for s in plan.slots] == slots
    x64 = mt.nd.array(np.arange(100, dtype=np.float64), ctx=mt.gpu(0), dtype="float64")
    y64 = mt.nd.array(np.zeros(100), ctx=mt.gpu(0), dtype="float64")
    f64.launch([x64, y64, 100], mt.gpu(0), (1,), (128,))
    assert f64._plans[0] is not plan and f64._plans[0].fn.value != plan.fn.value
    with pytest.raises(MXNetError, match="the array is torch.float64"):
        f32.launch([x64, y32, 100], mt.gpu(0), (1,), (128,))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(y64.asnumpy(), 3 * np.arange(100))
    np.testing.assert_array_equal(x32.asnumpy(), 9 * np.arange(100, dtype=np.float32))
    if torch.cuda.device_count() > 1:
        x1 = mt.nd.array(np.ones(100, np.float32), ctx=mt.gpu(1))
        y1 = mt.nd.array(np.zeros(100, np.float32), ctx=mt.gpu(1))
        f32.launch([x1, y1, 100], mt.gpu(1), (1,), (128,))
        assert set(f32._plans) == {0, 1} and f32._plans[1] is not plan
        np.testing.assert_array_equal(y1.asnumpy(), np.full(100, 3, np.float32))
