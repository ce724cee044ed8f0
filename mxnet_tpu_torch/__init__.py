"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

The JAX package ``mxnet_tpu`` is the reference this package is held to: the
same module names and layout, the same public surface, tested op by op and
model by model against it on the CPU. Inside, it is PyTorch: ``Block`` is a
``torch.nn.Module``, ops are plain functions on tensors, devices and random
generators are explicit, and every Pallas TPU kernel on a ported path is a
CUDA kernel written by hand for Hopper (``csrc/``) with a plain PyTorch
version beside it.

Contexts: ``gpu(i)`` is the CUDA device ``cuda:i`` (in the reference ``gpu``
aliases the TPU). The default context is ``gpu(0)``; with no CUDA device it
raises ``MXNetError`` instead of running on the CPU, so host runs say
``ctx=mx.cpu()`` or ``with mx.cpu():``.

Ported so far: BERT inference and training through Gluon
(``models.bert_base(...)``, ``net.initialize(ctx=mx.gpu())``, ``net(tokens)``;
``autograd.record()``, ``loss.backward()``, ``gluon.Trainer(...).step(n)``),
with the flash-attention forward and backward and the fused SGD/Adam
updates as CUDA kernels; ResNet v1/v2 through the Gluon model zoo
(``gluon.model_zoo.vision.resnet50_v1()``) for inference and SGD training,
with deferred shape inference; the blocked conv-as-matmul probe kernel
(``ops.cuda.blocked_matmul``); ``rtc.CudaModule``, CUDA C compiled at run
time with NVRTC; and the fused training step on one device,
``parallel.DataParallelTrainer`` in float32, bfloat16 or float16 over
float32 parameters, whose update of every parameter is one launch of the
fused SGD/Adam kernel, with ``lr_scheduler`` and ``contrib.amp.LossScaler``;
the same step on a mesh of ``torch.distributed`` ranks (data, tensor and
sequence parallel: ``parallel.make_mesh({"dp": 2, "tp": 2, "sp": 2})``,
``parallel.shard_params_megatron``, ``data_spec=P("dp", "sp")``), and
``kvstore`` under ``gluon.Trainer`` (``local``, ``device``, ``nccl``,
``dist_sync``); the ZeRO-sharded update (``DataParallelTrainer(zero_update=True,
comm_dtype=...)``, ``parallel.zero``), ring and Ulysses attention
(``parallel.ring_attention``, ``parallel.ulysses_attention``) and the
long-context recipe (``recipes.get_recipe("long_context")``: ``LongContextLM``
on the causal flash kernels, ``LongContextTrainer`` over a ``{dp, sp}`` mesh);
elastic kill-and-resume (``elastic.SnapshotManager``, ``elastic.save_trainer``,
``elastic.resume_or_init``, ``elastic.run`` with ``PreemptionGuard``: an
asynchronous sharded snapshot of the fused step, restored in place on the
same mesh or, with the ZeRO state re-canonicalised, another data degree) and
the fault-injection plane with its bounded IO retry (``faults``); and the
mixture of experts (``parallel.moe``: capacity gating, the expert-parallel
FFN over an ``ep`` axis with its bf16/int8 all-to-all wire), the MoE
transformer (``models.MoETransformerLM``) and its recipe
(``recipes.get_recipe("moe")``: ``MoETrainer`` over a ``{dp, ep}`` mesh, the
experts sharded over ep, restorable across ep degrees); the pipeline
(``parallel.PipelineTrainer``: 1F1B, GPipe, interleaved stages, tp and ZeRO
in the stages, and its snapshot kind); the backward-overlapped gradient
reduction (``DataParallelTrainer(overlap_grads=True)``, ``parallel.overlap``)
and 2-bit gradient compression (``compression=``, and the dist stores'
``set_gradient_compression``); ``dist_async``'s parameter server
(``kvstore/ps.py``); the multi-host elastic coordinator and its drills
(``elastic.Coordinator``, ``elastic.drill``); ``checkpoint`` (step-indexed
checkpoints in the elastic format); and the Gluon training loop of
``examples/train_mnist.py``: a hybridized block's training pair (forward
and backward) as CUDA graphs under ``autograd.record()``,
``models.lenet``/``models.mlp``, the thirteen ``gluon.loss`` losses,
``gluon.data`` (``DataLoader`` with thread workers and pinned memory, the
vision datasets and transforms), ``metric`` and ``io`` (``NDArrayIter``,
``MNISTIter``, ``CSVIter``, ``PrefetchingIter``); the optimizers' 19
classes and update ops; and the rest of the tape and the array: higher-order
gradients (``autograd.grad(create_graph=True)``, through the flash kernels
too) and ``autograd.Function``, NDArray indexing and in-place writes,
``nd.random``, ``nd.linalg``, ``nd.save``/``nd.load`` and ``.params`` in the
reference's file format, nested ``name_scope`` and
``Trainer.save_states``/``load_states``. What is still to come is in
ROADMAP.md.

Quick start::

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.models import bert_base

    net = bert_base(max_length=1024)
    net.initialize(ctx=mx.gpu(0))
    logits = net(nd.array(token_ids, ctx=mx.gpu(0), dtype="int32"))

    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-4})
    with mx.autograd.record():
        loss = loss_fn(net(tokens), labels)
    loss.backward()
    trainer.step(batch_size)

    dpt = mx.parallel.DataParallelTrainer(net, loss_fn, "adam",
                                          {"learning_rate": 1e-4},
                                          dtype="bfloat16")
    loss = dpt.step(tokens, labels)     # float(loss) waits for the step
"""
from . import base
from .base import MXNetError
from . import telemetry
from . import engine
from .context import Context, cpu, gpu, num_gpus, current_context
from . import ops
from . import ndarray
from . import ndarray as nd
from . import autograd
from . import random
from . import initializer
from . import lr_scheduler
from . import optimizer
from . import gluon
from . import kvstore
from . import kvstore as kv
from . import rtc
from . import contrib
from . import parallel
from . import recipes
from . import faults
from . import elastic
from . import checkpoint
from . import metric
from . import io
from .ndarray import NDArray

__all__ = ["base", "MXNetError", "telemetry", "engine", "Context", "cpu", "gpu", "num_gpus",
           "current_context", "ops", "ndarray", "nd", "autograd", "random",
           "initializer", "lr_scheduler", "optimizer", "gluon", "kvstore", "kv", "rtc", "contrib",
           "parallel", "recipes", "faults", "elastic", "checkpoint", "metric", "io",
           "NDArray"]
