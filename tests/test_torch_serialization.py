"""Files and names of the port against the reference package.

- ``nd.save``/``nd.load`` (the npz container of ``serialization.py``,
  manifest ``mxnet_tpu_ndarray_v1``): a file written by either package
  loads in the other, lists as lists and dicts as dicts, every tensor
  bitwise, bfloat16 kept as bfloat16.
- ``Block.save_parameters``/``load_parameters`` (keys ``arg:<structural
  name>``) and ``ParameterDict.save``/``load`` (``strip_prefix``,
  ``restore_prefix``) across the packages, on a 2-layer BERT (units 64,
  T 128) and a small Dense net, bitwise.
- Nested ``name_scope`` prefixes: nets built in the same order in a fresh
  interpreter of each package have equal ``collect_params()`` keys, and the
  structural names stay those the converters key by.

Tolerance: none; everything compared here is bitwise.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import BertModel
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=512, num_layers=2, units=64, hidden_size=128, num_heads=2,
           max_length=128)


def _arrays(seed):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(3, 4).astype(np.float32),
            "i": rs.randint(-5, 5, (4,)).astype(np.int32),
            "h": rs.randn(2, 2).astype(np.float16),
            "u": rs.randint(0, 255, (5,)).astype(np.uint8)}


def _ref_nd(a, dtype=None):
    import mxnet_tpu as mx
    return mx.nd.array(a, ctx=mx.cpu(), dtype=dtype or a.dtype)


def _port_nd(a, dtype=None):
    return mt.nd.array(a, ctx=mt.cpu(), dtype=dtype or a.dtype)


def _np_of(x):
    """numpy of either package's NDArray, bfloat16 as float32, with its
    dtype name."""
    if isinstance(x, mt.nd.NDArray):
        return x.asnumpy(), str(x.dtype).rpartition(".")[2]
    a = np.asarray(x.asnumpy())
    name = str(a.dtype)
    return (a.astype(np.float32) if name == "bfloat16" else a), name


def _same(got, want):
    (g, gn), (w, wn) = _np_of(got), _np_of(want)
    assert gn == wn, (gn, wn)
    assert g.shape == w.shape
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("form", ["dict", "list", "single"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_nd_files_cross_load_bitwise(tmp_path, form, writer):
    import mxnet_tpu as mx
    arrays = _arrays(3)
    bf = np.random.RandomState(4).randn(3, 5).astype(np.float32)
    made = {"port": {k: _port_nd(a) for k, a in arrays.items()},
            "reference": {k: _ref_nd(a) for k, a in arrays.items()}}
    made["port"]["b"] = _port_nd(bf, "bfloat16")
    made["reference"]["b"] = _ref_nd(bf, "bfloat16")
    pick = {"dict": lambda d: d, "list": lambda d: [d[k] for k in sorted(d)],
            "single": lambda d: d["b"]}[form]
    path = str(tmp_path / "arrays.nd")
    (mt.nd.save if writer == "port" else mx.nd.save)(path, pick(made[writer]))
    with mt.cpu():
        got = mt.nd.load(path)
    back = mx.nd.load(path)
    want = pick(made["port"])
    for loaded in (got, back):
        if form == "dict":
            assert sorted(loaded) == sorted(want)
            for k in want:
                _same(loaded[k], want[k])
        else:
            want_list = want if form == "list" else [want]
            assert isinstance(loaded, list) and len(loaded) == len(want_list)
            for g, w in zip(loaded, want_list):
                _same(g, w)


def test_nd_load_places_on_ctx_and_refuses_other_files(tmp_path):
    path = str(tmp_path / "x.nd")
    mt.nd.save(path, {"a": _port_nd(np.ones(3, np.float32))})
    out = mt.nd.load(path, ctx=mt.cpu())
    assert out["a"].ctx == mt.cpu()
    np.savez(str(tmp_path / "other.npz"), __manifest__=np.frombuffer(
        json.dumps({"magic": "something else"}).encode(), dtype=np.uint8))
    with pytest.raises(MXNetError, match="not a mxnet_tpu ndarray file"):
        mt.nd.load(str(tmp_path / "other.npz"), ctx=mt.cpu())


def _port_bert(seed):
    from mxnet_tpu_torch.convert import load_jax_params, seeded_params
    net = BertModel(**CFG)
    net.initialize(ctx=mt.cpu())
    load_jax_params(net, seeded_params(net, seed=seed))
    return net


def _ref_bert(seed):
    import mxnet_tpu as mx
    from mxnet_tpu.models.bert import BertModel as RefBertModel
    from mxnet_tpu_torch.convert import seeded_params
    net = RefBertModel(**CFG)
    net.initialize(ctx=mx.cpu())
    weights = seeded_params(_port_bert(0), seed=seed)
    for key, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    return net


def _params_np(net):
    return {k: _np_of(p.data()) for k, p in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_params_file_cross_load_bert(tmp_path, direction):
    path = str(tmp_path / "bert.params")
    if direction == "port_to_reference":
        src, dst = _port_bert(7), _ref_bert(8)
    else:
        src, dst = _ref_bert(7), _port_bert(8)
    src.save_parameters(path)
    dst.load_parameters(path)
    want, got = _params_np(src), _params_np(dst)
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k][1] == want[k][1]
        np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)


def test_params_file_keys_are_the_references():
    import tempfile
    net = _port_bert(1)
    with tempfile.TemporaryDirectory() as d:
        net.save_parameters(d + "/n.params")
        with np.load(d + "/n.params") as z:
            manifest = json.loads(bytes(z["__manifest__"]).decode())
    keys = [e["key"] for e in manifest["entries"]]
    assert manifest["magic"] == "mxnet_tpu_ndarray_v1"
    assert keys == ["arg:" + k for k in net._collect_params_with_prefix()]


def test_load_parameters_refuses_missing_and_extra(tmp_path):
    path = str(tmp_path / "d.params")
    a = mt.gluon.nn.Dense(3, in_units=4)
    a.initialize(ctx=mt.cpu())
    a.save_parameters(path)
    b = mt.gluon.nn.HybridSequential()
    b.add(mt.gluon.nn.Dense(3, in_units=4))
    b.initialize(ctx=mt.cpu())
    with pytest.raises(MXNetError, match="missing"):
        b.load_parameters(path)
    b.load_parameters(path, allow_missing=True, ignore_extra=True)


def _dense_pair(pkg, seed):
    net = pkg.gluon.nn.Dense(3, in_units=4, prefix="enc_")
    net.initialize(ctx=pkg.cpu())
    rs = np.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(pkg.nd.array(rs.randn(*p.shape).astype(np.float32), ctx=pkg.cpu()))
    return net


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_parameter_dict_save_load_prefixes(tmp_path, writer):
    import mxnet_tpu as mx
    path = str(tmp_path / "pd.params")
    src = _dense_pair(mt if writer == "port" else mx, 5)
    dst = _dense_pair(mx if writer == "port" else mt, 6)
    src.collect_params().save(path, strip_prefix="enc_")
    with np.load(path) as z:
        keys = [e["key"] for e in json.loads(bytes(z["__manifest__"]).decode())["entries"]]
    assert sorted(keys) == ["arg:bias", "arg:weight"]
    dst.collect_params().load(path, restore_prefix="enc_")
    for name in ("enc_weight", "enc_bias"):
        np.testing.assert_array_equal(_np_of(dst.collect_params()[name].data())[0],
                                      _np_of(src.collect_params()[name].data())[0])
    with pytest.raises(Exception):
        dst.collect_params().load(path)          # no prefix: every name is extra


_SCOPES = r"""
import json, sys
pkg = __import__(sys.argv[1])
nn = pkg.gluon.nn

class Inner(pkg.gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.a = nn.Dense(3, in_units=2)
            self.b = nn.Dense(2, in_units=3)

class Net(pkg.gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.first = nn.Dense(2, in_units=2)
            self.inner = Inner()
            self.inner2 = Inner(prefix="custom_")
            self.seq = nn.HybridSequential()
            with self.seq.name_scope():
                self.seq.add(nn.Dense(2, in_units=2), nn.Dense(2, in_units=2))
        self.outside = nn.Dense(2, in_units=2)

out = []
for kw in ({"prefix": "mynet_"}, {}, {}):
    net = Net(**kw)
    out.append({"keys": list(net.collect_params().keys()), "prefix": net.prefix,
                "structural": list(net._collect_params_with_prefix().keys())})
print(json.dumps(out))
"""


def _scope_keys(package):
    proc = subprocess.run([sys.executable, "-c", _SCOPES, package], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_nested_name_scope_keys_match_the_reference():
    port, ref = _scope_keys("mxnet_tpu_torch"), _scope_keys("mxnet_tpu")
    assert port == ref
    assert "mynet_dense0_weight" in port[0]["keys"]
    assert "mynet_inner0_dense1_bias" in port[0]["keys"]
    assert "mynet_custom_dense0_weight" in port[0]["keys"]
    assert port[1]["prefix"] == "net0_" and "net0_inner0_dense0_weight" in port[1]["keys"]
    assert port[2]["prefix"] == "net1_" and "net1_dense0_weight" in port[2]["keys"]
    assert "dense2_weight" in port[2]["keys"]           # made outside the scope
    assert port[0]["structural"] == port[1]["structural"] == ref[2]["structural"]
    assert "inner.a.weight" in port[0]["structural"]


def test_name_scope_leaves_converter_names_alone():
    """BERT's structural names (what ``convert``, the tensor-parallel roles
    and the elastic manifests key by) are the same for two instances."""
    a, b = BertModel(**CFG), BertModel(**CFG)
    assert list(a._collect_params_with_prefix()) == list(b._collect_params_with_prefix())
    assert a.prefix != b.prefix
