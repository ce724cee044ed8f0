"""The port stands alone and never falls back to the CPU by itself.

- No file of ``mxnet_tpu_torch/``, and not ``chip_smoke.py``, imports jax or
  anything of the reference package ``mxnet_tpu`` (an AST scan of every
  module, plus a fresh interpreter that imports the whole port and finds
  neither loaded, plus two ranks spawned by ``_dist_util.launch_local`` that
  run a collective and find neither loaded, and two that run a ring
  attention and a sharded-update reduce-scatter and find neither loaded,
  and a fresh interpreter that loads a trainer states file and a
  ``.params`` file written by the reference and finds neither loaded; the
  telemetry registry, the tracing plane and the async feed are among the
  modules the fresh interpreter imports).
- With no CUDA device, the default context raises instead of running on the
  CPU; the kernel build raises without ``nvcc``; ``chip_smoke.py`` exits
  non-zero and prints no result without a card, and without the repository
  beside it.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "mxnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: pathlib.Path):
    """Absolute module names imported by ``path`` (relative ones resolved)."""
    rel = path.relative_to(ROOT).with_suffix("")
    package = list(rel.parts[:-1])
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module
                continue
            if node.level - 1 > len(package):
                yield "<outside the repository>"
                continue
            base = package[:len(package) - (node.level - 1)]
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod
            if not node.module:
                for alias in node.names:
                    yield f"{mod}.{alias.name}"


PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_reference_or_jax_imports(path):
    bad = [m for m in _imports(path)
           if _forbidden(m) or m == "<outside the repository>"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_fresh_interpreter_loads_neither_jax_nor_reference():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.models, "
            "mxnet_tpu_torch.convert, mxnet_tpu_torch.ops.cuda.flash_attention, "
            "mxnet_tpu_torch.ops.cuda.blocked_matmul, mxnet_tpu_torch.rtc, "
            "mxnet_tpu_torch.gluon.model_zoo.vision, mxnet_tpu_torch._dist_util, "
            "mxnet_tpu_torch.kvstore, mxnet_tpu_torch.parallel.megatron, "
            "mxnet_tpu_torch.parallel.tensor_parallel, mxnet_tpu_torch.parallel.zero, "
            "mxnet_tpu_torch.parallel.ring_attention, mxnet_tpu_torch.recipes, "
            "mxnet_tpu_torch.recipes.long_context, mxnet_tpu_torch.faults, "
            "mxnet_tpu_torch.elastic, mxnet_tpu_torch.elastic.manifest, "
            "mxnet_tpu_torch.parallel.step_program, mxnet_tpu_torch.parallel.moe, "
            "mxnet_tpu_torch.models.moe_transformer, mxnet_tpu_torch.recipes.moe, "
            "mxnet_tpu_torch.parallel.pipeline, mxnet_tpu_torch.elastic.state, "
            "mxnet_tpu_torch.parallel.overlap, mxnet_tpu_torch.kvstore.ps, "
            "mxnet_tpu_torch.elastic.coordinator, mxnet_tpu_torch.elastic.drill, "
            "mxnet_tpu_torch.checkpoint, mxnet_tpu_torch.metric, mxnet_tpu_torch.io, "
            "mxnet_tpu_torch.gluon.data, mxnet_tpu_torch.gluon.data.vision.transforms, "
            "mxnet_tpu_torch.models.lenet, mxnet_tpu_torch.models.mlp, "
            "mxnet_tpu_torch.serialization, mxnet_tpu_torch.ndarray.random, "
            "mxnet_tpu_torch.ndarray.linalg, mxnet_tpu_torch.ops.linalg, "
            "mxnet_tpu_torch.ops.random_sample, mxnet_tpu_torch.telemetry, "
            "mxnet_tpu_torch.telemetry.tracing, mxnet_tpu_torch.engine.async_feed\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_LOAD_STATES = r"""
import sys, numpy as np
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
net = mt.gluon.nn.Dense(3, in_units=4)
net.initialize(ctx=mt.cpu())
net.load_parameters(sys.argv[1] + "/ref.params")
tr = mt.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.5})
tr.load_states(sys.argv[1] + "/ref.states")
assert type(tr.optimizer).__name__ == "Adam", type(tr.optimizer)
assert type(tr.optimizer.lr_scheduler).__name__ == "FactorScheduler"
assert tr.optimizer.num_update == 2 and len(tr._updater.states) == 2
x = mt.nd.array(np.ones((2, 4), np.float32), ctx=mt.cpu())
with mt.autograd.record():
    loss = net(x).sum()
loss.backward()
tr.step(2)
blob = (b"(dp0\nVstates\np1\n(dp2\nI0\ncmxnet_tpu.ndarray.ndarray\nNDArray\n"
        b"p3\nss.")
try:
    tr._updater.set_states(blob)
except MXNetError as e:
    assert "mxnet_tpu.ndarray.ndarray.NDArray" in str(e)
else:
    raise AssertionError("a foreign global was not refused")
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")]
print(bad); sys.exit(1 if bad else 0)
"""


def test_reference_states_file_loads_without_jax_or_reference(tmp_path):
    """A ``Trainer.save_states`` file and a ``.params`` file written by the
    reference (Adam with a FactorScheduler, two steps) load into a port
    trainer in a fresh interpreter that then has neither the reference nor
    jax loaded; a blob naming another reference global is refused."""
    import mxnet_tpu as mx
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mx.cpu())
    tr = mx.gluon.Trainer(net.collect_params(), "adam", {
        "learning_rate": 0.01, "lr_scheduler": mx.lr_scheduler.FactorScheduler(step=1)})
    x = mx.nd.array(np.ones((2, 4), np.float32), ctx=mx.cpu())
    for _ in range(2):
        with mx.autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(2)
    net.save_parameters(str(tmp_path / "ref.params"))
    tr.save_states(str(tmp_path / "ref.states"))
    proc = subprocess.run([sys.executable, "-c", _LOAD_STATES, str(tmp_path)], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def rank_loaded_modules():
    """A spawned rank: one all-reduce, then the jax and reference modules it
    has loaded."""
    import torch.distributed as dist
    t = torch.ones(2)
    dist.all_reduce(t)
    return {"sum": t.tolist(),
            "bad": sorted(m for m in sys.modules if _forbidden(m.split(".")[0]))}


def test_spawned_rank_loads_neither_jax_nor_reference(tmp_path):
    from mxnet_tpu_torch import _dist_util
    got = _dist_util.launch_local("test_torch_isolation:rank_loaded_modules", 2,
                                  device="cpu", timeout=120,
                                  pythonpath=[str(ROOT / "tests")], workdir=str(tmp_path))
    assert got == [{"sum": [2.0, 2.0], "bad": []}] * 2


def rank_ring_modules():
    """A spawned rank of a ring: one causal ring attention and its backward
    over 2 ranks, one sharded-update reduce-scatter, then the jax and
    reference modules it has loaded."""
    from mxnet_tpu_torch.ops.attention import ring_attention
    from mxnet_tpu_torch.parallel import make_mesh, zero
    mesh = make_mesh({"sp": 2}, devices=[mt.cpu()])
    q = torch.ones(1, 1, 4, 8, requires_grad=True)
    ring_attention(q, q, q, "sp", causal=True, mesh=mesh).sum().backward()
    zero.reduce_scatter_bucket(torch.ones(4), "sp", 2, "int8", mesh)
    return sorted(m for m in sys.modules if _forbidden(m.split(".")[0]))


def test_spawned_ring_rank_loads_neither_jax_nor_reference(tmp_path):
    from mxnet_tpu_torch import _dist_util
    got = _dist_util.launch_local("test_torch_isolation:rank_ring_modules", 2,
                                  device="cpu", timeout=120,
                                  pythonpath=[str(ROOT / "tests")], workdir=str(tmp_path))
    assert got == [[], []]


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_context_raises_without_cuda(no_cuda):
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.current_context()
    with pytest.raises(MXNetError):
        mt.nd.array(np.zeros(3))
    with pytest.raises(MXNetError):
        mt.gpu(0).torch_device
    net = mt.gluon.nn.Dense(4, in_units=3)
    with pytest.raises(MXNetError):
        net.initialize()


def test_explicit_cpu_context(no_cuda):
    with mt.cpu():
        assert mt.current_context() == mt.cpu()
        x = mt.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert x.ctx == mt.cpu() and x._data.device.type == "cpu"
    assert str(mt.gpu(1)) == "gpu(1)" and mt.Context("cuda", 0) == mt.gpu(0)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from mxnet_tpu_torch.ops import cuda as cuda_ops
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(MXNetError, match="nvcc not found"):
        cuda_ops._nvcc()


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _run_chip_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
