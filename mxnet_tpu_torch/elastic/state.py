"""Trainer state capture and install for elastic snapshots.

Counterpart of ``mxnet_tpu/elastic/state.py``: the ``dp`` kind
(``DataParallelTrainer``, ``recipes.long_context.LongContextTrainer`` and
``recipes.moe.MoETrainer``) and the ``pp`` kind (``parallel.PipelineTrainer``,
with its tensor-parallel and ZeRO layouts).
``capture(trainer)`` gives ``{"leaves": {name: value}, "meta": {...}}``, the
schema ``SnapshotManager`` writes; ``install(trainer, meta, fetch, names)``
is its inverse, ``fetch(name)`` giving a leaf's global host array (a
``manifest.SnapshotReader``, or a dict lookup), ``names`` the leaves the
snapshot holds.

Leaves, with the reference's names (positional: Gluon parameter names carry
process-wide counters and never match across restarts):

    param.{i}                     parameter i of the trainer's list
    opt.p{i}.{k}                  optimizer state lane k of parameter i
    opt.b{j}.0                    ZeRO bucket j's per-element weight decay
    opt.b{j}.{k}, k >= 1          ZeRO bucket j's flat state lanes
    opt.x{i}.{k}                  state of a trainable parameter in no bucket
    rng                           the generators (``random.get_state_raw``)

and for the ``pp`` kind (the reference's ``_capture_pp``, :315-348):

    param.e.{i}  param.h.{i}      embed / head leaf i (replicated over pp)
    param.s.{i}                   cell leaf i of every layer, a global
                                  (n_layers, ...) stack in ``stack_order``
    opt.{e,s,h}.{i}.{k}           state lane k of each of those (none for a
                                  frozen leaf), stage lanes stacked the same way
    opt.z{e,s,h}.{j}.0            under ZeRO: bucket j's weight decay (padded,)
    opt.z{e,s,h}.{j}.{k}, k >= 1  its state lanes: (padded,), with a leading
                                  stage dim for the stage's buckets and a tp
                                  dim under partitioned tp (:665-791)
    rng

A device value is a ``Chunk``: this rank's part of the global leaf, its
``[[start, stop], ...]`` region, and whether this rank owns it (is at
coordinate 0 on every mesh axis that does not split the leaf, the
reference's ``replica_id == 0``): a tensor-parallel shard is written by one
rank of its tp coordinate, a ZeRO lane's shard by each data-parallel rank, a
replicated leaf by rank 0. Host values (the weight-decay lanes, ``rng``)
are written by rank 0. Meta is the reference's: ``format``, ``step``,
``optimizer``, ``mesh``, ``program`` (``parallel/step_program.py``),
``sched``, ``scaler``, ``kind``, ``n_params``, ``zero``, ``dp_degree`` and
``zero_plan``.

ZeRO lanes. The reference's bucket carry is ``(wd_vector, state)``
(``parallel/data_parallel.py:598-628``); the port's update cuts the shard
into per-parameter segments instead (``parallel/data_parallel.py``), so
``opt.b{j}.0`` is written from ``zero.wd_vector`` and the state lanes follow
in the order of the optimizer's state tuple, the reference's
``tree_leaves`` order (Adam: m, v). On install the saved weight-decay lane,
re-packed onto the trainer's plan, must equal the trainer's own, or install
raises: a resume never runs silently under another decay. A trainer with
``zero_update`` on a mesh of one device keeps whole-parameter state; its
lanes are those of the bucket plan at dp 1 (over the trainer's
``_zero_entries``), as the reference's. Across data
degrees the lanes are re-canonicalised (``_revector``,
``_restore_zero_carry``): each saved bucket split into per-parameter
segments by the saved plan (in the manifest) and re-packed under the new
one, zero-padded to its shard multiple.

A trainable parameter outside every bucket (``MoETrainer``'s experts, placed
over ep) keeps its whole state in ``opt.x{i}.{k}``, a chunk of the rank's
rows like its parameter's, so a snapshot restores across ep degrees.

A pipeline rank owns no stacked storage: it writes its stage's rows
[s L, (s + 1) L) of each stage leaf as a ``Chunk`` stacked from its layers'
leaves, and the embed and head once for the pp axis; a leaf split over tp
(weight-sharded, or a partitioned view shard) is this rank's part of its
tp dim, written at coordinate 0 of the other axes. Under partitioned tp the
globals are the leaves' view shapes (the fused qkv as (3, C, C)), which do
not depend on the tp degree: a tp 2 snapshot installs onto tp 4 (the
reference's :344-352, :487-541). Install (``_install_pp``) reads each
rank's region (rows permuted by ``_stack_perm`` when the saved
``stack_order`` differs) into its leaves and ``sync()`` fills the
Parameters; so a snapshot restores onto another (pp, dp, tp) layout.
Installing a partitioned snapshot into a trainer of the other tp mode
raises, naming ``tp_mode``. ZeRO lanes are re-canonicalised onto the
trainer's plans (``_restore_zero_carry``, stacked lanes row by row: across
dp degrees), then each rank copies its stage's, tp rank's and dp shard's
part; across pp or tp degrees they raise, as the reference's. ``meta`` adds
the reference's ``n_e``, ``n_s``, ``n_h``, ``n_layers``, ``n_stages``,
``virtual_stages``, ``stack_order``, ``zero``, ``dp_degree``, ``tp_mode``,
``tp_degree``, ``sequence_parallel`` and ``zero_plan_{e,s,h}``, and the
port's ``dropout_seed`` (the partitioned programs' dropout keys).
``LeafFetch`` serves a ``capture()``'s own leaves to ``install``
(``PipelineTrainer.load_state_dict``).

Install copies into the live tensors in place, under ``torch.no_grad()``,
and never rebinds them: the ZeRO segments are persistent views of the
weights and the state shards, the gradient buffers views into buckets, and
the fused update's pointer table is cached by data pointer
(``ops/cuda/fused_optimizer.py``). Each rank copies only the region of a
leaf it holds, through ``fetch.read_region`` where the fetch has it.

The ``elastic_state()`` / ``elastic_install()`` hooks let any other trainer
supply its own schema.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set

import numpy as _np
import torch

from ..base import MXNetError
from .. import random as _rng

__all__ = ["Chunk", "LeafFetch", "capture", "install", "sched_state", "install_sched"]


class Chunk:
    """This process's part of a global leaf: ``data`` covers ``index``
    (``[(start, stop), ...]`` per dim) of a leaf of global ``shape``;
    ``owner``: this process writes it."""

    __slots__ = ("data", "shape", "index", "owner")

    def __init__(self, data, shape, index, owner: bool):
        self.data = data
        self.shape = tuple(int(d) for d in shape)
        self.index = [(int(a), int(b)) for a, b in index]
        self.owner = bool(owner)

    def __repr__(self):
        return f"Chunk({tuple(self.data.shape)} at {self.index} of {self.shape}, " \
               f"owner={self.owner})"


# ---------------------------------------------------------------------------
# Optimizer schedule state
# ---------------------------------------------------------------------------

def sched_state(opt) -> Dict[str, Any]:
    """The host counters a resumed run needs for lr parity at step K+1:
    ``num_update``/``begin_num_update``, the per-index update counts and the
    lr scheduler's mutable fields."""
    d = {"num_update": int(opt.num_update),
         "begin_num_update": int(opt.begin_num_update),
         "index_update_count": {str(k): int(v) for k, v in opt._index_update_count.items()},
         "scheduler": None}
    sched = getattr(opt, "lr_scheduler", None)
    if sched is not None:
        d["scheduler"] = sched.state_dict()
    return d


def install_sched(opt, d: Dict[str, Any]):
    opt.num_update = int(d["num_update"])
    opt.begin_num_update = int(d.get("begin_num_update", 0))
    counts = {}
    for k, v in (d.get("index_update_count") or {}).items():
        try:
            k = int(k)
        except (TypeError, ValueError):
            pass
        counts[k] = int(v)
    opt._index_update_count = counts
    sched = getattr(opt, "lr_scheduler", None)
    if sched is not None and d.get("scheduler") is not None:
        sched.load_state_dict(d["scheduler"])


# ---------------------------------------------------------------------------
# Bucket plans and ZeRO re-canonicalisation
# ---------------------------------------------------------------------------

def _bucket_dict(b) -> Dict[str, Any]:
    return {"dtype": b.dtype, "indices": list(b.indices), "offsets": list(b.offsets),
            "sizes": list(b.sizes), "shapes": [list(s) for s in b.shapes],
            "padded_size": b.padded_size, "ndp": b.ndp}


def _bucket_from(d):
    from ..parallel.zero import BucketSpec
    return BucketSpec(dtype=d["dtype"], indices=tuple(d["indices"]),
                      offsets=tuple(d["offsets"]), sizes=tuple(d["sizes"]),
                      shapes=tuple(tuple(s) for s in d["shapes"]),
                      padded_size=int(d["padded_size"]), ndp=int(d["ndp"]))


def _revector(old_specs, old_flats, new_spec) -> _np.ndarray:
    """Re-pack one flat state lane from the saved bucket layout onto a new
    bucket's: each old flat vector split into per-parameter segments (saved
    offsets and sizes), the new bucket's members concatenated in its order
    and zero-padded to its ``padded_size``."""
    pieces: Dict[int, _np.ndarray] = {}
    for spec, flat in zip(old_specs, old_flats):
        flat = _np.asarray(flat).reshape(-1)
        for i, o, s in zip(spec.indices, spec.offsets, spec.sizes):
            pieces[i] = flat[o:o + s]
    try:
        parts = [pieces[i] for i in new_spec.indices]
    except KeyError as e:
        raise MXNetError(f"zero-state reshard: parameter slot {e} absent from the saved "
                         f"bucket plan: the trainable set changed between save and "
                         f"resume") from None
    out = _np.zeros((new_spec.padded_size,), parts[0].dtype)
    off = 0
    for p in parts:
        out[off:off + p.size] = p
        off += p.size
    return out


def _bucket_lane_count(names: Set[str], prefix: str) -> int:
    """How many ``{prefix}.{k}`` leaves the snapshot holds."""
    n = 0
    while f"{prefix}.{n}" in names:
        n += 1
    return n


def _missing(name) -> MXNetError:
    return MXNetError(f"snapshot is missing leaf {name!r}: saved with another trainer "
                      f"configuration (optimizer/zero/precision)")


def _fetch_np(fetch, name) -> _np.ndarray:
    try:
        return _np.asarray(fetch(name))
    except KeyError:
        raise _missing(name) from None


def _restore_zero_carry(prefix_fmt, old_specs, new_specs, fetch, names,
                        n_lanes: Optional[int] = None) -> List[List[_np.ndarray]]:
    """The full host lanes of every new bucket: ``[[lane_0, lane_1, ...], ...]``.

    ``prefix_fmt`` formats saved bucket ``j``'s leaf prefix (``"opt.b{j}"``).
    When the saved and new plans agree the lanes come back as saved;
    otherwise every flat lane is re-packed by ``_revector``, and a scalar
    lane comes from the saved bucket that holds the new bucket's first
    parameter. ``n_lanes``: the lanes a bucket of the trainer has; a
    snapshot with another count raises (optimizer mismatch)."""
    same = len(old_specs) == len(new_specs) and all(
        o.padded_size == n.padded_size and o.indices == n.indices and o.ndp == n.ndp
        for o, n in zip(old_specs, new_specs))
    old_lanes: List[List[_np.ndarray]] = []
    for j in range(len(old_specs)):
        prefix = prefix_fmt.format(j=j)
        old_lanes.append([_fetch_np(fetch, f"{prefix}.{k}")
                          for k in range(_bucket_lane_count(names, prefix))])
    for j, lanes in enumerate(old_lanes):
        if n_lanes is not None and len(lanes) != n_lanes:
            raise MXNetError(f"zero-state restore: saved bucket {j} has {len(lanes)} lanes, "
                             f"the trainer's buckets {n_lanes}: optimizer mismatch")
    if same:
        return [list(lanes) for lanes in old_lanes]
    out = []
    for new_spec in new_specs:
        j_scalar = next((jo for jo, s in enumerate(old_specs)
                         if new_spec.indices[0] in s.indices), 0)
        lanes = []
        for k in range(len(old_lanes[0]) if old_lanes else 0):
            lane = old_lanes[j_scalar][k]
            if lane.ndim == 0:
                lanes.append(lane)
                continue
            # a stacked lane (a pipeline's stage or tp rows) re-packs row by row
            lead = lane.shape[:-1]
            rows = [_revector(old_specs, [old[k][idx] for old in old_lanes], new_spec)
                    for idx in _np.ndindex(*lead)]
            lanes.append(_np.stack(rows).reshape(lead + (new_spec.padded_size,)))
        out.append(lanes)
    return out


# ---------------------------------------------------------------------------
# Placement: which region of a global leaf this rank holds
# ---------------------------------------------------------------------------

def _placement(shape, spec_dims, mesh):
    """``(index, owner)`` of this rank's part of a global leaf of ``shape``
    whose dims ``spec_dims`` (``[(dim, axes), ...]``) are split over mesh axes,
    in the mesh's axis order (``parallel.tensor_parallel.shard_tensor``)."""
    index = [(0, int(d)) for d in shape]
    if mesh is None or not mesh.distributed:
        return index, True
    split = set()
    for d, axes in spec_dims:
        axes = tuple(a for a in mesh.axis_names if a in axes)
        n, idx = 1, 0
        for a in axes:
            idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
            n *= mesh.axis_size(a)
            split.add(a)
        step = int(shape[d]) // n
        index[d] = (idx * step, (idx + 1) * step)
    owner = all(c == 0 for a, c in mesh.coords.items() if a not in split)
    return index, owner


def _param_chunk(tensor, p, mesh) -> Chunk:
    from ..parallel.tensor_parallel import spec_axes
    index, owner = _placement(p.shape, spec_axes(p.sharding) if p._mesh is not None else [],
                              mesh)
    return Chunk(tensor.detach(), p.shape, index, owner)


def _lane_chunk(tensor, spec, mesh, batch_axis) -> Chunk:
    """A ZeRO lane: this rank's shard of the bucket's flat vector (the whole
    vector at dp 1)."""
    if tensor.numel() == spec.padded_size:
        index, owner = _placement((spec.padded_size,), [], mesh)
    else:
        index, owner = _placement((spec.padded_size,), [(0, (batch_axis,))], mesh)
    return Chunk(tensor.detach(), (spec.padded_size,), index, owner)


def _zero_layout(trainer):
    """``(plan, states)``: the trainer's ZeRO bucket plan and, per bucket, its
    state lanes as tensors (this rank's shards), or, for a trainer that keeps
    whole-parameter state (a mesh of one device), the plan at dp 1 and None."""
    from ..parallel import zero as _zero
    if trainer._zero_buckets:
        return list(trainer._zero_plan), [zb["state"] for zb in trainer._zero_buckets]
    return list(_zero.plan_buckets(trainer._zero_entries(), 1, trainer._bucket_bytes)), None


def _wds(trainer):
    return [trainer.optimizer._get_wd(i) for i in range(len(trainer._plist))]


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------

def capture(trainer) -> Dict[str, Any]:
    """The snapshot schema of a trainer's whole training state: the leaves
    reference the live tensors (``SnapshotManager`` copies them), meta reads
    host counters only; no device work, no sync."""
    if hasattr(trainer, "elastic_state"):
        return trainer.elastic_state()
    if hasattr(trainer, "_plist") and hasattr(trainer, "_opt_state"):
        return _capture_dp(trainer)
    if hasattr(trainer, "_cell_plists"):
        return _capture_pp(trainer)
    raise MXNetError(f"cannot snapshot {type(trainer).__name__}; expected "
                     f"DataParallelTrainer, PipelineTrainer or an "
                     f"elastic_state()/elastic_install() provider")


def _common_meta(trainer) -> Dict[str, Any]:
    meta = {"format": 1, "step": trainer._t,
            "optimizer": type(trainer.optimizer).__name__,
            "mesh": {str(a): int(s) for a, s in trainer.mesh.shape.items()},
            "program": trainer._program.fingerprint,
            "sched": sched_state(trainer.optimizer), "scaler": None}
    scaler = getattr(trainer, "_scaler", None)
    if scaler is not None:
        meta["scaler"] = scaler.state_dict()
    return meta


def _capture_dp(trainer) -> Dict[str, Any]:
    from ..parallel import zero as _zero
    mesh = trainer.mesh
    leaves: Dict[str, Any] = {}
    for i, p in enumerate(trainer._plist):
        leaves[f"param.{i}"] = _param_chunk(p._param, p, mesh)
    plan = []
    if trainer._zero:
        plan, states = _zero_layout(trainer)
        wds = _wds(trainer)
        for j, b in enumerate(plan):
            leaves[f"opt.b{j}.0"] = _zero.wd_vector(b, wds)
            if states is not None:
                lanes = states[j]
            else:          # whole-parameter state: the bucket's flat lanes
                n = len(trainer._opt_state[b.indices[0]])
                lanes = [_zero.flatten_bucket(b, {i: trainer._opt_state[i][k]
                                                  for i in b.indices}) for k in range(n)]
            for k, lane in enumerate(lanes):
                leaves[f"opt.b{j}.{k + 1}"] = _lane_chunk(lane, b, mesh, trainer.batch_axis)
        in_bucket = {i for b in plan for i in b.indices}
        for i, (p, st) in enumerate(zip(trainer._plist, trainer._opt_state)):
            if i not in in_bucket:
                for k, leaf in enumerate(st):
                    leaves[f"opt.x{i}.{k}"] = _param_chunk(leaf, p, mesh)
    else:
        for i, (p, st) in enumerate(zip(trainer._plist, trainer._opt_state)):
            for k, leaf in enumerate(st):
                leaves[f"opt.p{i}.{k}"] = _param_chunk(leaf, p, mesh)
    leaves["rng"] = _rng.get_state_raw()
    meta = _common_meta(trainer)
    meta.update({"kind": "dp", "n_params": len(trainer._plist), "zero": trainer._zero,
                 "dp_degree": trainer._dp_degree,
                 "zero_plan": [_bucket_dict(b) for b in plan]})
    return {"leaves": leaves, "meta": meta}


def _owner(trainer, split) -> bool:
    """Whether this rank writes a pp leaf split over the axes ``split``: it is
    at coordinate 0 of every other axis (the reference's ``replica_id``)."""
    mesh = trainer.mesh
    return not mesh.distributed or all(c == 0 for a, c in mesh.coords.items()
                                       if a not in split)


def _tp_range(trainer, size) -> tuple:
    step = int(size) // trainer.n_tp
    return (trainer._tp_idx * step, (trainer._tp_idx + 1) * step)


def _leaf_chunk(tensor, trainer, view, dim) -> Chunk:
    """An embed or head leaf of global shape ``view``: this rank's tp part
    of ``dim`` (None: the whole leaf)."""
    index = [(0, int(d)) for d in view]
    if dim is not None:
        index[dim] = _tp_range(trainer, view[dim])
    return Chunk(tensor.detach(), view, index,
                 _owner(trainer, {trainer.tp_axis} if dim is not None else set()))


def _stage_chunk(tensors, trainer, view, dim) -> Chunk:
    """This stage's rows of a global (n_layers, *view) stage leaf in the
    trainer's stack order: its layers' tensors (their tp parts of ``dim``)
    stacked."""
    lo = trainer.stage * trainer.layers_per_stage
    data = torch.stack([t.detach() for t in tensors])
    index = [(lo, lo + data.shape[0])] + [(0, int(d)) for d in view]
    split = {trainer.pp_axis}
    if dim is not None:
        index[dim + 1] = _tp_range(trainer, view[dim])
        split.add(trainer.tp_axis)
    return Chunk(data, (trainer.n_layers,) + tuple(view), index, _owner(trainer, split))


def _zero_lane_chunk(tensor, trainer, spec, stacked) -> Chunk:
    """This rank's shard of a ZeRO state lane: global (padded,), with a
    leading stage dim for the stage's buckets and a tp dim under partitioned
    tp (the reference's carries, :665-791), split over dp."""
    lead, index, split = [], [], {trainer.dp_axis}
    if stacked:
        lead.append(trainer.n_stages)
        index.append((trainer.stage, trainer.stage + 1))
        split.add(trainer.pp_axis)
    if trainer._partitioned:
        lead.append(trainer.n_tp)
        index.append((trainer._tp_idx, trainer._tp_idx + 1))
        split.add(trainer.tp_axis)
    pos = trainer.mesh.axis_index(trainer.dp_axis) if trainer.mesh.distributed else 0
    S = spec.shard_size
    index.append((pos * S, (pos + 1) * S))
    data = tensor.detach().reshape((1,) * len(lead) + (S,))
    return Chunk(data, tuple(lead) + (spec.padded_size,), index, _owner(trainer, split))


def _capture_pp(trainer) -> Dict[str, Any]:
    from ..parallel import zero as _zero
    leaves: Dict[str, Any] = {}
    for tag, group, views in (("e", trainer._leaves_e, trainer._view_e),
                              ("h", trainer._leaves_h, trainer._view_h)):
        for i, lf in enumerate(group):
            leaves[f"param.{tag}.{i}"] = _leaf_chunk(lf.w, trainer, views[i], lf.dim)
            if not trainer._zero:
                for k, lane in enumerate(lf.state):
                    leaves[f"opt.{tag}.{i}.{k}"] = _leaf_chunk(lane, trainer, views[i], lf.dim)
    for i, view in enumerate(trainer._view_s):
        row = [r[i] for r in trainer._leaves_s]
        leaves[f"param.s.{i}"] = _stage_chunk([lf.w for lf in row], trainer, view, row[0].dim)
        if not trainer._zero:
            for k in range(len(row[0].state)):
                leaves[f"opt.s.{i}.{k}"] = _stage_chunk([lf.state[k] for lf in row], trainer,
                                                        view, row[0].dim)
    meta = _common_meta(trainer)
    if trainer._zero:
        for tag, wds in (("e", trainer._wd_e), ("s", trainer._wd_s), ("h", trainer._wd_h)):
            for j, zb in enumerate(trainer._zbuckets[tag]):
                leaves[f"opt.z{tag}.{j}.0"] = _zero.wd_vector(zb["spec"], wds)
                for k, lane in enumerate(zb["state"]):
                    leaves[f"opt.z{tag}.{j}.{k + 1}"] = _zero_lane_chunk(
                        lane, trainer, zb["spec"], tag == "s")
            meta[f"zero_plan_{tag}"] = [_bucket_dict(b)
                                        for b in getattr(trainer, f"_zplan_{tag}")]
    leaves["rng"] = _rng.get_state_raw()
    meta.update({"kind": "pp", "n_e": len(trainer._embed_plist),
                 "n_s": len(trainer._cell_plists[0]), "n_h": len(trainer._head_plist),
                 "n_layers": trainer.n_layers, "n_stages": trainer.n_stages,
                 "virtual_stages": trainer.virtual_stages,
                 "stack_order": list(trainer._stack_order), "zero": trainer._zero,
                 "dp_degree": trainer.n_dp, "tp_mode": trainer.tp_mode,
                 "tp_degree": trainer.n_tp, "sequence_parallel": trainer.sequence_parallel,
                 "dropout_seed": trainer._seed})
    return {"leaves": leaves, "meta": meta}


# ---------------------------------------------------------------------------
# Install
# ---------------------------------------------------------------------------

def install(trainer, meta: Dict[str, Any], fetch: Callable[[str], Any], names: Set[str]):
    """Install a snapshot into a freshly built trainer, in place. ``fetch``
    returns the global host value of a leaf; ``names`` is the set of leaf
    names the snapshot holds (without ``"rng"`` the generators are left as
    they are)."""
    kind = meta.get("kind")
    if kind not in ("dp", "pp") and hasattr(trainer, "elastic_install"):
        trainer.elastic_install(meta, fetch, names)
        return trainer
    if kind == "pp":
        if not hasattr(trainer, "_cell_plists"):
            raise MXNetError(f"snapshot holds pipeline state (kind 'pp', PipelineTrainer) "
                             f"but the target is {type(trainer).__name__}")
        with torch.no_grad():
            _install_pp(trainer, meta, fetch, names)
    elif kind != "dp":
        raise MXNetError(f"unknown snapshot kind {kind!r}")
    elif not (hasattr(trainer, "_plist") and hasattr(trainer, "_opt_state")):
        raise MXNetError(f"snapshot holds DataParallelTrainer state but the target is "
                         f"{type(trainer).__name__}")
    else:
        with torch.no_grad():
            _install_dp(trainer, meta, fetch, names)
    _install_host_state(trainer, meta, fetch, names)
    trainer.sync()
    return trainer


def _check(cond, msg):
    if not cond:
        raise MXNetError(msg)


def _install_host_state(trainer, meta, fetch, names):
    trainer._t = int(meta["step"])
    if meta.get("sched"):
        install_sched(trainer.optimizer, meta["sched"])
    else:
        trainer.optimizer.num_update = trainer._t
    scaler = getattr(trainer, "_scaler", None)
    if scaler is not None and meta.get("scaler"):
        scaler.load_state_dict(meta["scaler"])
    if "rng" in names:
        _rng.set_state_raw(_fetch_np(fetch, "rng"))


def _leaf_shape(fetch, name) -> tuple:
    man = getattr(fetch, "manifest", None)
    if man is None:
        return tuple(_fetch_np(fetch, name).shape)
    if name not in man["leaves"]:
        raise _missing(name)
    return tuple(man["leaves"][name]["shape"])


def _fetch_region(fetch, name, index) -> _np.ndarray:
    """Only ``index``'s region of a leaf: ``fetch.read_region`` where the
    fetch has it, else a slice of the whole."""
    if not hasattr(fetch, "read_region"):
        return _fetch_np(fetch, name)[tuple(slice(a, b) for a, b in index)]
    try:
        return fetch.read_region(name, index)
    except KeyError:
        raise _missing(name) from None


def _copy_into(dst: torch.Tensor, host, what: str):
    """``dst.copy_(host)`` in place, with ``_place_like``'s checks."""
    host = _np.ascontiguousarray(host)
    if tuple(host.shape) != tuple(dst.shape):
        raise MXNetError(f"snapshot leaf {what!r}: saved shape {tuple(host.shape)} != "
                         f"trainer shape {tuple(dst.shape)}: architecture mismatch")
    if not host.dtype.isnative or host.dtype.kind not in "fiub":
        raise MXNetError(f"snapshot leaf {what!r}: dtype {host.dtype} cannot be installed")
    dst.copy_(torch.from_numpy(host))


def _install_chunk(dst: torch.Tensor, fetch, name: str, chunk: Chunk):
    saved = _leaf_shape(fetch, name)
    if saved != chunk.shape:
        raise MXNetError(f"snapshot leaf {name!r}: saved shape {saved} != trainer shape "
                         f"{chunk.shape}: architecture mismatch")
    _copy_into(dst, _fetch_region(fetch, name, chunk.index), name)


def _install_dp(trainer, meta, fetch, names):
    _check(meta.get("optimizer") == type(trainer.optimizer).__name__,
           f"snapshot optimizer {meta.get('optimizer')!r} != trainer "
           f"{type(trainer.optimizer).__name__!r}")
    n = len(trainer._plist)
    _check(int(meta.get("n_params", -1)) == n,
           f"snapshot has {meta.get('n_params')} parameters, trainer has {n}: "
           f"architecture mismatch")
    _check(bool(meta.get("zero")) == bool(trainer._zero),
           "snapshot and trainer disagree on zero_update; construct the resuming "
           "trainer with the same zero_update setting")
    mesh = trainer.mesh
    # every shape before any copy: a mismatch leaves the trainer as it was
    for i, p in enumerate(trainer._plist):
        saved = _leaf_shape(fetch, f"param.{i}")
        _check(saved == tuple(p.shape), f"snapshot leaf 'param.{i}': saved shape {saved} "
                                        f"!= trainer shape {tuple(p.shape)}: architecture "
                                        f"mismatch")
    for i, p in enumerate(trainer._plist):
        chunk = _param_chunk(p._param, p, mesh)
        _copy_into(p._param, _fetch_region(fetch, f"param.{i}", chunk.index), f"param.{i}")
    if trainer._zero:
        _install_zero(trainer, meta, fetch, names)
        return
    for i, (p, st) in enumerate(zip(trainer._plist, trainer._opt_state)):
        for k, t in enumerate(st):
            _install_chunk(t, fetch, f"opt.p{i}.{k}", _param_chunk(t, p, mesh))


def _install_zero(trainer, meta, fetch, names):
    from ..parallel import zero as _zero
    from ..parallel.zero import unflatten_bucket
    mesh = trainer.mesh
    plan, states = _zero_layout(trainer)
    old_specs = [_bucket_from(d) for d in meta.get("zero_plan", [])]
    n_state = len(states[0]) if states else \
        (len(trainer._opt_state[plan[0].indices[0]]) if plan else 0)
    lanes = _restore_zero_carry("opt.b{j}", old_specs, plan, fetch, names,
                                n_lanes=1 + n_state)
    wds = _wds(trainer)
    for j, (b, blanes) in enumerate(zip(plan, lanes)):
        want = _zero.wd_vector(b, wds)
        if not _np.array_equal(_np.asarray(blanes[0], _np.float32), want):
            def values(lane):
                return ", ".join(f"{w:g}" for w in _np.unique(lane))
            raise MXNetError(f"snapshot bucket {j}'s weight-decay lane ({values(blanes[0])}) "
                             f"differs from the trainer's ({values(want)}): the resumed run "
                             f"would decay its weights differently; build the trainer with "
                             f"the saved wd and wd_mult")
        for k in range(n_state):
            full = _np.asarray(blanes[1 + k])
            if states is not None:
                dst = states[j][k]
                chunk = _lane_chunk(dst, b, mesh, trainer.batch_axis)
                lo, hi = chunk.index[0]
                _copy_into(dst, full[lo:hi], f"opt.b{j}.{k + 1}")
            else:
                for i, view in unflatten_bucket(b, torch.from_numpy(_np.ascontiguousarray(full))):
                    _copy_into(trainer._opt_state[i][k], view.numpy(), f"opt.b{j}.{k + 1}")
    in_bucket = {i for b in plan for i in b.indices}
    for i, (p, st) in enumerate(zip(trainer._plist, trainer._opt_state)):
        if i not in in_bucket:
            for k, t in enumerate(st):
                _install_chunk(t, fetch, f"opt.x{i}.{k}", _param_chunk(t, p, mesh))


def _stack_perm(old_order, new_order):
    """Row permutation mapping a stacked cell leaf saved under ``old_order``
    onto ``new_order`` (None when they agree): new row k holds global layer
    ``new_order[k]``, which the save put at row ``old_order.index(...)``."""
    if list(old_order) == list(new_order):
        return None
    pos = {m: r for r, m in enumerate(old_order)}
    try:
        return [pos[m] for m in new_order]
    except KeyError:
        raise MXNetError(f"snapshot and trainer stack orders cover different layer sets "
                         f"({sorted(pos)} vs {sorted(new_order)})") from None


def _install_pp(trainer, meta, fetch, names):
    _check(meta.get("optimizer") == type(trainer.optimizer).__name__,
           f"snapshot optimizer {meta.get('optimizer')!r} != trainer "
           f"{type(trainer.optimizer).__name__!r}")
    n_s = len(trainer._cell_plists[0])
    for key, have in (("n_e", len(trainer._embed_plist)), ("n_s", n_s),
                      ("n_h", len(trainer._head_plist)), ("n_layers", trainer.n_layers)):
        _check(int(meta.get(key, -1)) == int(have),
               f"snapshot {key}={meta.get(key)} != trainer {have}: architecture mismatch")
    _check(bool(meta.get("zero")) == bool(trainer._zero),
           "snapshot and trainer disagree on zero_update; construct the resuming trainer "
           "with the same zero_update setting")
    saved_mode = meta.get("tp_mode", "sharded")
    _check(saved_mode == trainer.tp_mode,
           f"snapshot was taken under tp_mode={saved_mode!r} but the resuming trainer uses "
           f"tp_mode={trainer.tp_mode!r}; partitioned snapshots store blocked view-shaped "
           f"leaves that only a partitioned trainer can install (and vice versa)")
    perm = _stack_perm(meta.get("stack_order") or list(range(trainer.n_layers)),
                       trainer._stack_order)
    if trainer._zero:
        same_pp = int(meta.get("n_stages", -1)) == trainer.n_stages and \
            int(meta.get("virtual_stages", 1)) == trainer.virtual_stages
        _check(same_pp and perm is None,
               f"ZeRO-over-pp optimizer state cannot reshard across pipeline degrees (saved "
               f"pp={meta.get('n_stages')}xv{meta.get('virtual_stages')}, trainer "
               f"pp={trainer.n_stages}xv{trainer.virtual_stages}); resume on the saved "
               f"pipeline layout, or save without zero_update")
        _check(int(meta.get("tp_degree", 1)) == trainer.n_tp,
               f"ZeRO optimizer state under partitioned tp is laid out per tp rank and cannot "
               f"reshard across tp degrees (saved tp={meta.get('tp_degree', 1)}, trainer "
               f"tp={trainer.n_tp}); resume on the saved tp degree, or save without "
               f"zero_update")
    groups = (("e", trainer._leaves_e, trainer._view_e), ("h", trainer._leaves_h,
                                                          trainer._view_h))
    # every shape before any copy: a mismatch leaves the trainer as it was
    for tag, group, views in groups:
        for i, view in enumerate(views):
            saved = _leaf_shape(fetch, f"param.{tag}.{i}")
            _check(saved == tuple(view), f"snapshot leaf 'param.{tag}.{i}': saved shape "
                                         f"{saved} != trainer shape {tuple(view)}: "
                                         f"architecture mismatch")
    for i, view in enumerate(trainer._view_s):
        want = (trainer.n_layers,) + tuple(view)
        saved = _leaf_shape(fetch, f"param.s.{i}")
        _check(saved == want, f"snapshot leaf 'param.s.{i}': saved shape {saved} != "
                              f"trainer shape {want}: architecture mismatch")

    def part(name, chunk):
        """This rank's part of a leaf (a stage leaf's rows in the trainer's
        order)."""
        if perm is None or len(chunk.shape) < 1 or chunk.shape[0] != trainer.n_layers \
                or not name.split(".")[1] == "s":
            return _fetch_region(fetch, name, chunk.index)
        return _fetch_np(fetch, name)[perm][tuple(slice(a, b) for a, b in chunk.index)]

    for tag, group, views in groups:
        for i, lf in enumerate(group):
            name = f"param.{tag}.{i}"
            _copy_into(lf.w.detach(), part(name, _leaf_chunk(lf.w, trainer, views[i], lf.dim)),
                       name)
            if not trainer._zero:
                for k, lane in enumerate(lf.state):
                    name = f"opt.{tag}.{i}.{k}"
                    _copy_into(lane, part(name, _leaf_chunk(lane, trainer, views[i], lf.dim)),
                               name)
    for i, view in enumerate(trainer._view_s):
        row = [r[i] for r in trainer._leaves_s]
        name = f"param.s.{i}"
        host = part(name, _stage_chunk([lf.w for lf in row], trainer, view, row[0].dim))
        for j, lf in enumerate(row):
            _copy_into(lf.w.detach(), host[j], name)
        if not trainer._zero:
            for k in range(len(row[0].state)):
                name = f"opt.s.{i}.{k}"
                host = part(name, _stage_chunk([lf.state[k] for lf in row], trainer, view,
                                               row[0].dim))
                for j, lf in enumerate(row):
                    _copy_into(lf.state[k], host[j], name)
    if trainer._zero:
        _install_pp_zero(trainer, meta, fetch, names)
    if "dropout_seed" in meta:
        trainer._seed = int(meta["dropout_seed"])


def _install_pp_zero(trainer, meta, fetch, names):
    """The ZeRO lanes of the three bucket groups, re-canonicalised onto the
    trainer's plans (across dp degrees), this rank's stage, tp and dp shard
    of each copied into its bucket state."""
    from ..parallel import zero as _zero
    for tag, wds in (("e", trainer._wd_e), ("s", trainer._wd_s), ("h", trainer._wd_h)):
        new_specs = list(getattr(trainer, f"_zplan_{tag}"))
        old_specs = [_bucket_from(d) for d in meta.get(f"zero_plan_{tag}", [])]
        zbs = trainer._zbuckets[tag]
        n_state = len(zbs[0]["state"]) if zbs else 0
        lanes = _restore_zero_carry(f"opt.z{tag}.{{j}}", old_specs, new_specs, fetch, names,
                                    n_lanes=1 + n_state)
        for j, (zb, blanes) in enumerate(zip(zbs, lanes)):
            want = _zero.wd_vector(zb["spec"], wds)
            if not _np.array_equal(_np.asarray(blanes[0], _np.float32).reshape(-1), want):
                raise MXNetError(f"snapshot bucket opt.z{tag}.{j}'s weight-decay lane differs "
                                 f"from the trainer's: the resumed run would decay its "
                                 f"weights differently; build the trainer with the saved wd "
                                 f"and wd_mult")
            for k, lane in enumerate(zb["state"]):
                chunk = _zero_lane_chunk(lane, trainer, zb["spec"], tag == "s")
                region = _np.asarray(blanes[1 + k])[tuple(slice(a, b) for a, b in chunk.index)]
                _copy_into(lane, region.reshape(tuple(lane.shape)), f"opt.z{tag}.{j}.{k + 1}")


class LeafFetch:
    """``install``'s ``fetch`` over a ``capture()``'s leaves: a ``Chunk``
    serves the regions it covers (``read_region``), a tensor or host value
    the whole leaf; ``manifest`` gives each leaf's global shape."""

    def __init__(self, leaves: Dict[str, Any]):
        self._leaves = leaves
        self.manifest = {"leaves": {
            name: {"shape": list(v.shape if isinstance(v, (Chunk, torch.Tensor))
                                 else _np.shape(v))} for name, v in leaves.items()}}

    @staticmethod
    def _host(v) -> _np.ndarray:
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return _np.asarray(v)

    def __call__(self, name: str) -> _np.ndarray:
        v = self._leaves[name]
        if isinstance(v, Chunk):
            return self.read_region(name, [(0, d) for d in v.shape])
        return self._host(v)

    def read_region(self, name: str, region) -> _np.ndarray:
        v = self._leaves[name]
        if not isinstance(v, Chunk):
            return self._host(v)[tuple(slice(a, b) for a, b in region)]
        if any(a < ca or b > cb for (a, b), (ca, cb) in zip(region, v.index)):
            raise MXNetError(f"snapshot leaf {name!r}: region {list(region)} is not in this "
                             f"process's part {v.index}")
        return self._host(v.data)[tuple(slice(a - ca, b - ca)
                                        for (a, b), (ca, _) in zip(region, v.index))]
