"""Meshes, sharding rules, sharded training and serving, and the
evaluator-stat reduction (port of ``d3d_tpu.parallel.mesh``).

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` with the
JAX mesh's axis names (:class:`Mesh`: its ``shape`` is a dict of axis
sizes, as a JAX mesh's is). Every rank of the job calls each function with
the same global inputs that the JAX call takes (the whole batch, all the
frames); each works on its own part, and each returns what the JAX call
returns, whole, gathering where the JAX function returns an array sharded
over the mesh. The collectives and their gradient conventions are in
:mod:`.comm`.

Training (:func:`shard_train_step`): ``dp`` splits the batch rows, the
statistics and normalisers of the batch are summed over it, and the
gradients too; ``sp`` (:func:`spatial_constrain`) runs the BEV canvas as
one slab of rows per rank with halo exchanges; ``tp`` stores each
tensor-parallel leaf and its optimizer moments as a 1/tp shard on each tp
rank, gathered whole for the forward (the ranks of a tp group compute the
same step); ``ep`` stores the Switch-MoE expert leaves as E/ep experts on
each rank, computed where they live (:func:`expert_constrain`).
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.placement_types import Replicate, Shard

from ..profiler import span
from ..utils import as_tensor
from .comm import SpatialHook, sharded

__all__ = [
    "Mesh", "shard_inference",
    "make_mesh", "batch_sharding", "replicate_sharding", "bev_sharding",
    "spatial_constrain", "expert_constrain", "shard_train_step",
    "param_partition_spec", "tp_param_report",
    "stats_to_arrays", "arrays_to_stats", "reduce_stats_arrays",
]

_COUNTERS = ("ngt", "ndt", "tp", "fp", "fn")
_ACC_FIELDS = ("acc_iou", "acc_angular", "acc_dist", "acc_box", "acc_var")


class Mesh(DeviceMesh):
    """A ``DeviceMesh`` whose ``shape`` is ``{axis name: size}`` (a JAX
    mesh's), so code written against the JAX package reads
    ``mesh.shape["dp"]``; ``axis_names`` is ``mesh_dim_names``."""

    @property
    def shape(self):
        return dict(zip(self.mesh_dim_names, super().shape))

    @property
    def axis_names(self):
        return self.mesh_dim_names


def _world():
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: call "
            "d3d_tpu_torch.parallel.initialize(...) (torchrun sets its "
            "environment) or torch.distributed.init_process_group first")
    return dist.get_world_size()


def _mesh(device_type, ranks, shape, names):
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs CUDA; pass device_type='cpu' "
                           "for a gloo mesh on the CPU")
    return Mesh(device_type, torch.as_tensor(ranks).reshape(shape),
                mesh_dim_names=names)


def make_mesh(n_devices=None, dp=None, tp=None, sp=None, devices=None,
              device_type="cuda"):
    """A ``('dp', 'sp', 'tp')`` mesh over the job's ranks (one device a
    rank; ``n_devices`` stands for the JAX function's device count and must
    be the world size). ``sp`` defaults to 1; tp defaults to 2 when the
    rest is even and > 1, else 1; an explicit ``dp`` fixes tp.

    :param devices: the global ranks to lay out (default all, in order)
    :param device_type: ``"cuda"`` (NCCL, the default) or ``"cpu"`` (gloo)
    """
    world = _world()
    ranks = list(range(world)) if devices is None else list(devices)
    n = len(ranks) if n_devices is None else n_devices
    if n != len(ranks) or n != world:
        raise ValueError("a mesh spans the job's %d ranks, got %d"
                         % (world, n))
    sp = 1 if sp is None else sp
    if n % sp:
        raise ValueError("sp must divide the device count")
    nd = n // sp
    if tp is None:
        tp = nd // dp if dp is not None \
            else (2 if nd % 2 == 0 and nd > 1 else 1)
    if dp is None:
        dp = nd // tp
    if dp * sp * tp != n:
        raise ValueError("dp * sp * tp must equal the device count")
    return _mesh(device_type, ranks, (dp, sp, tp), ("dp", "sp", "tp"))


def _placements(mesh, shard):
    """One placement a mesh axis: ``Shard(dim)`` for the axes in ``shard``
    ({axis: dim}), ``Replicate()`` for the rest."""
    return tuple(Shard(shard[a]) if a in shard else Replicate()
                 for a in mesh.mesh_dim_names)


def batch_sharding(mesh):
    """The batch (dim 0) over dp, replicated over the other axes."""
    return _placements(mesh, {"dp": 0})


def replicate_sharding(mesh):
    return _placements(mesh, {})


def bev_sharding(mesh):
    """A (B, C, W, H) BEV canvas (NCHW, x along dim 2): batch over dp,
    x-rows over sp where the mesh has it."""
    return _placements(mesh, {"dp": 0, "sp": 2})


def spatial_constrain(mesh):
    """The models' ``constrain`` hook that runs the BEV backbone spatially
    partitioned over the mesh's ``sp`` axis: each sp rank computes its
    slab of x-rows, 3x3 convolutions exchange halo rows with the
    neighbours (:class:`~.comm.SpatialHook`), and the head outputs are
    whole again before their reshape and the loss. Training through it
    runs in :func:`shard_train_step`, which sums the statistics over the
    slabs' batch too."""
    return SpatialHook(mesh.get_group("sp"))


class ExpertHook:
    """:func:`expert_constrain`'s hook: the Switch-MoE's experts split
    over ``group`` (the ``ep`` axis). :func:`~.moe.moe_mlp` given it
    computes each rank's experts where they live and exchanges the
    dispatched token blocks by all-to-all."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)


def expert_constrain(mesh, axis="ep"):
    """The hook :func:`~.moe.moe_mlp` (and SST's ``moe_constrain``) takes
    to run the experts split over the mesh's ``axis``."""
    return ExpertHook(mesh.get_group(axis))


def param_partition_spec(path, leaf, tp_size, ep_size=1, out_axis=None):
    """The tensor/expert-parallel rule of one parameter, the JAX rule on
    the port's names and layouts: a tuple of one mesh axis name or None a
    dim, ``()`` for replicated.

    :param path: the parameter's ``named_parameters()`` name
    :param out_axis: the weight's output-channel axis
        (:func:`~d3d_tpu_torch.models.fold.output_axes`: dim 0 of a
        ``Conv2d``/``Linear``, 1 of a ``ConvTranspose2d``, the last of
        SECOND's (K, C, Cout)); None for a leaf that is no kernel

    A ``moe_*`` leaf but the router shards its leading expert axis over
    ``ep`` when the mesh has one and it divides; a kernel shards its
    output channels over ``tp`` when they divide; everything else (biases,
    norms, 1-D leaves, kernels that do not divide) replicates.
    """
    name = path.rsplit(".", 1)[-1]
    if name.startswith("moe_") and name != "moe_router" and ep_size > 1 \
            and leaf.ndim >= 1 and leaf.shape[0] % ep_size == 0:
        return ("ep",) + (None,) * (leaf.ndim - 1)
    if out_axis is not None and leaf.ndim >= 2 and tp_size > 1 \
            and leaf.shape[out_axis] % tp_size == 0:
        spec = [None] * leaf.ndim
        spec[out_axis] = "tp"
        return tuple(spec)
    return ()


def _specs(model, tp, ep):
    """``{name: (spec, is a kernel)}`` of ``model``'s parameters."""
    from ..models.fold import output_axes

    axes = output_axes(model)
    return {name: (param_partition_spec(name, p, tp, ep, axes.get(name)),
                   name in axes)
            for name, p in model.named_parameters()}


def tp_param_report(model, mesh):
    """Audit the tp/ep layout of ``model``'s parameters: ``(sharded names,
    replicated kernel names)``, so an all-replicated layout shows."""
    sizes = mesh.shape
    sharded_, repl = [], []
    for name, (spec, kernel) in _specs(model, sizes.get("tp", 1),
                                       sizes.get("ep", 1)).items():
        if any(a in ("tp", "ep") for a in spec):
            sharded_.append(name)
        elif kernel:
            repl.append(name)
    return sharded_, repl


def _group(mesh, axis):
    return mesh.get_group(axis) if axis in mesh.mesh_dim_names else None


def _split_batch(batch, dp, rank):
    """This dp rank's rows of every tensor in ``batch`` (dicts recurse)."""
    def split(v):
        if isinstance(v, dict):
            return {k: split(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)) or v is None:
            return v
        v = as_tensor(v)
        if v.shape[0] % dp:
            raise ValueError("batch of %d rows does not split over dp=%d"
                             % (v.shape[0], dp))
        rows = v.shape[0] // dp
        return v[rank * rows:(rank + 1) * rows]
    return {k: split(v) for k, v in batch.items()}


class _Leaf:
    """One parameter of a sharded step: the mesh axis it is split over
    (None, "tp" or "ep") and the dim."""

    def __init__(self, param, spec):
        self.param = param
        self.axis = next((a for a in spec if a is not None), None)
        self.dim = spec.index(self.axis) if self.axis else None


def shard_train_step(train_step, mesh, donate=True, check_tp=True):
    """Run a ``make_train_step`` step over the mesh.

    The step (``step(batch) -> aux`` from any family's
    ``make_train_step``: PointPillars, SECOND, SST, CenterPoint, BEVSeg,
    VoxelNeXt or Mono3D) carries its ``model``, ``optimizer`` and
    ``backward``. The returned ``call(batch) -> aux`` takes the whole batch
    on every rank:

    - ``dp`` splits the batch rows; BatchNorm statistics, the losses'
      normalisers (positive, labelled-point and offset counts, the
      heatmap mean) and the MoE load-balance statistics are the whole
      batch's (:func:`~.comm.sharded`), and the gradients are summed
      over dp (and over sp, whose ranks each back-propagate their slab);
    - each parameter that :func:`param_partition_spec` partitions over
      ``tp`` is kept as a 1/tp shard along its output axis on each tp
      rank, with its optimizer state; it is gathered whole for the
      forward, and its summed gradient is cut back to the shard;
    - each ``moe_*`` expert leaf that partitions over ``ep`` is kept as
      E/ep experts; the model runs them where they live when it was built
      with :func:`expert_constrain`'s hook;
    - :class:`~d3d_tpu_torch.train.ClippedAdamW` clips by the global
      norm: the shards' squares are summed over their axis, each leaf
      counted once.

    The loss and the updated parameters equal the single-process step's
    on the whole batch up to float rounding; ``aux`` holds the whole
    batch's loss terms on every rank. Between steps a sharded leaf holds
    only its shard: ``call.full_state_dict()`` gathers the model's
    ``state_dict`` whole, and ``call.train_state()`` the ``(params,
    batch_stats, opt_state)`` that :class:`~d3d_tpu_torch.train.Trainer`
    checkpoints. A state restored into the model and optimizer before the
    first call is cut into shards by that call.

    :param donate: accepted for the JAX signature; it has no effect (the
        step updates the model and optimizer in place anyway)
    :param check_tp: with tp > 1, raise ``ValueError`` on the first call
        when no parameter partitions over tp
    """
    from ..train import ClippedAdamW

    model, optimizer = train_step.model, train_step.optimizer
    backward = train_step.backward
    global_aux = getattr(train_step, "global_aux", ())
    sizes = mesh.shape
    tp, ep = sizes.get("tp", 1), sizes.get("ep", 1)
    dp, sp = sizes.get("dp", 1), sizes.get("sp", 1)
    dp_group = _group(mesh, "dp")
    groups = {"tp": _group(mesh, "tp"), "ep": _group(mesh, "ep")}
    sum_groups = tuple(g for g in (dp_group, _group(mesh, "sp"))
                       if g is not None)
    dp_rank = mesh.get_local_rank("dp") if dp_group is not None else 0
    specs = _specs(model, tp, ep)
    leaves = [_Leaf(p, specs[n][0]) for n, p in model.named_parameters()]
    axis_of = {id(lf.param): lf.axis for lf in leaves}
    done = []

    def cut(lf, t):
        group = groups[lf.axis]
        return t.chunk(dist.get_world_size(group), lf.dim)[
            dist.get_rank(group)].contiguous()

    def shard_leaves():
        if check_tp and tp > 1 and not any(lf.axis == "tp" for lf in leaves):
            raise ValueError(
                "mesh has tp=%d but no parameter partitions over tp; "
                "check param_partition_spec against this model" % tp)
        for lf in (lf for lf in leaves if lf.axis):
            full_shape = lf.param.shape
            lf.param.data = cut(lf, lf.param.data)
            st = optimizer.state.get(lf.param, {})
            for key, v in st.items():
                if torch.is_tensor(v) and v.shape == full_shape:
                    st[key] = cut(lf, v)
        done.append(True)

    def whole(lf, t=None):
        """``t`` (default the leaf's shard) gathered whole over its axis."""
        t = lf.param.data if t is None else t
        group = groups[lf.axis]
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=lf.dim)

    def sq_norm(params, grads):
        parts = {None: 0.0, "tp": 0.0, "ep": 0.0}
        for p, g in zip(params, grads):
            parts[axis_of.get(id(p))] = parts[axis_of.get(id(p))] \
                + torch.sum(g * g)
        total = parts[None]
        for axis in ("tp", "ep"):
            if torch.is_tensor(parts[axis]):
                part = parts[axis].clone()
                dist.all_reduce(part, group=groups[axis])
                total = total + part
        return total

    def call(batch):
        if not done:
            shard_leaves()
        tp_leaves = [lf for lf in leaves if lf.axis == "tp"]
        shard_data = [lf.param.data for lf in tp_leaves]
        for lf in tp_leaves:
            lf.param.data = whole(lf)
        optimizer.zero_grad(set_to_none=True)
        try:
            with sharded((dp_group,) if dp_group is not None else (),
                         1.0 / (dp * sp)):
                aux = backward(_split_batch(batch, dp, dp_rank))
            grads = [torch.zeros_like(lf.param.data) if lf.param.grad is None
                     else lf.param.grad for lf in leaves]
        finally:
            for lf, data in zip(tp_leaves, shard_data):
                lf.param.data = data
        # one flat all-reduce of every gradient over dp and sp
        with span("train.all_reduce"):
            flat = torch.cat([g.reshape(-1) for g in grads])
            for group in sum_groups:
                dist.all_reduce(flat, group=group)
            off = 0
            for lf, g in zip(leaves, grads):
                full = flat[off:off + g.numel()].view(g.shape)
                off += g.numel()
                lf.param.grad = (cut(lf, full) if lf.axis == "tp"
                                 else full.clone())
        if isinstance(optimizer, ClippedAdamW):
            optimizer.step(sq_norm=sq_norm)
        else:
            optimizer.step()
        out = {}
        for k, v in aux.items():
            v = v.detach().clone()
            if k not in global_aux and dp_group is not None:
                dist.all_reduce(v, group=dp_group)
            out[k] = v
        return out

    def full_state_dict():
        """The model's ``state_dict`` with every sharded leaf gathered
        whole (a collective: every rank of the mesh calls it)."""
        sd = model.state_dict()
        if done:
            names = {id(p): n for n, p in model.named_parameters()}
            for lf in (lf for lf in leaves if lf.axis):
                sd[names[id(lf.param)]] = whole(lf)
        return sd

    def full_train_state():
        """``train.train_state(model, optimizer)`` with every sharded leaf
        and its optimizer state (the tensors of the shard's shape)
        gathered whole: what a checkpoint saves, and what a model and
        optimizer restored before the first step are cut from again (a
        collective: every rank of the mesh calls it)."""
        from ..train import train_state

        params, buffers, opt_state = train_state(model, optimizer)
        if not done:
            return params, buffers, opt_state
        names = {id(p): n for n, p in model.named_parameters()}
        index = {id(p): i for i, p in enumerate(
            p for g in optimizer.param_groups for p in g["params"])}
        params = dict(params)
        state = dict(opt_state["state"])
        for lf in (lf for lf in leaves if lf.axis):
            params[names[id(lf.param)]] = whole(lf)
            shape, st = lf.param.data.shape, state.get(index[id(lf.param)])
            if st is None:
                continue
            state[index[id(lf.param)]] = {
                k: whole(lf, v) if torch.is_tensor(v) and v.ndim
                and v.shape == shape else v for k, v in st.items()}
        return params, buffers, dict(opt_state, state=state)

    call.full_state_dict = full_state_dict
    call.train_state = full_train_state
    return call


def shard_inference(device_fn, mesh):
    """Data-parallel serving over the mesh's ``dp`` axis: ``call(points)``
    takes the (B, N, F) cloud batch on every rank; dp rank r runs
    ``device_fn`` (a detector's ``detect.device_fn``, weights replicated)
    on its B/dp frames, and the fixed-shape outputs are all-gathered in
    frame order, so every rank returns the (B, ...) stack of each output.
    B is padded to a dp multiple with copies of the last frame, whose
    outputs are dropped."""
    group = mesh.get_group("dp")
    dp, rank = dist.get_world_size(group), dist.get_rank(group)

    def call(points_batch):
        b = len(points_batch)
        per = -(-b // dp)
        own = [points_batch[min(i, b - 1)]
               for i in range(rank * per, (rank + 1) * per)]
        outs = [device_fn(p) for p in own]
        result = []
        for k in range(len(outs[0])):
            mine = torch.stack([o[k] for o in outs])
            wire = mine.to(torch.uint8) if mine.dtype == torch.bool else mine
            parts = [torch.empty_like(wire) for _ in range(dp)]
            dist.all_gather(parts, wire.contiguous(), group=group)
            whole = torch.cat(parts)[:b]
            result.append(whole.to(torch.bool) if mine.dtype == torch.bool
                          else whole)
        return tuple(result)

    return call


# ---------------------------------------------------------------------------
# evaluator-stat reduction
# ---------------------------------------------------------------------------

def stats_to_arrays(stats, classes, device=None):
    """DetectionEvalStats -> dict of tensors stacked over classes: ``ngt``
    (C,) int64, the counters (C, S) int64, the accuracies (C, S) float64
    (NaN where a class has no true positive at a threshold)."""
    out = {"ngt": torch.as_tensor([int(stats.ngt[k]) for k in classes],
                                  dtype=torch.int64)}
    for f in _COUNTERS[1:]:
        out[f] = torch.as_tensor(np.stack([getattr(stats, f)[k]
                                           for k in classes]).astype(np.int64))
    for f in _ACC_FIELDS:
        out[f] = torch.as_tensor(np.stack([getattr(stats, f)[k]
                                           for k in classes]).astype(
                                               np.float64))
    return {k: v.to(device) for k, v in out.items()}


def arrays_to_stats(arrays, classes, stats_cls=None):
    """Inverse of :func:`stats_to_arrays` (tensors or numpy arrays)."""
    from ..benchmarks import DetectionEvalStats

    arrays = {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
              for k, v in arrays.items()}
    stats = (stats_cls or DetectionEvalStats)()
    stats.ngt = {k: int(arrays["ngt"][i]) for i, k in enumerate(classes)}
    for f in _COUNTERS[1:] + _ACC_FIELDS:
        setattr(stats, f, {k: np.asarray(arrays[f][i])
                           for i, k in enumerate(classes)})
    return stats


def reduce_stats_arrays(arrays, group=None):
    """Merge the ranks' partial stats (:func:`stats_to_arrays` form) over
    ``group`` (default: the world): counters summed, accuracies the
    tp-weighted mean, NaN where no rank has a true positive (the
    reference's wmean merge, benchmarks.pyx:288-313, as collectives; the
    numpy twin is :func:`~.distributed.merge_stacked_stats`)."""
    out = {}
    for f in _COUNTERS:
        out[f] = arrays[f].clone()
        dist.all_reduce(out[f], group=group)
    tp_local = arrays["tp"]
    tp_total = torch.clamp_min(out["tp"], 1)
    for f in _ACC_FIELDS:
        s = torch.where(tp_local > 0, arrays[f] * tp_local, 0.0)
        dist.all_reduce(s, group=group)
        out[f] = torch.where(out["tp"] > 0, s / tp_total, float("nan"))
    return out
