"""Rank worker for the multi-rank tests of ``d3d_tpu_torch.parallel``
(``tests/test_torch_parallel.py``, ``test_torch_pipeline.py``,
``test_torch_distributed.py``).

Each test module starts one group of ranks (:class:`Group`): N processes
of this file, wired by a gloo process group whose rendezvous is a
``FileStore`` under the test's temporary directory. A rank reads the
inputs the parent wrote (``inputs.pt``: weights carried over from the JAX
package's flax models, batches made from numpy seeds), runs one case's
checks through the port only, and saves what the parent compares
(``<case>_<rank>.pt``). It imports neither JAX nor the JAX package.

Usage: python _torch_dist_worker.py CASE RANK WORLD OUTDIR
"""

import os
import signal
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from d3d_tpu_torch.parallel.launch import (  # noqa: E402
    GROUP_TIMEOUT_S, RankGroup)


class Group(RankGroup):
    """N ranks of one case, started together; :meth:`results` waits for
    them (killing the group on a failure or at ``timeout``) and returns
    each rank's saved results. A rank still running when the group is
    killed first writes every thread's stack to its log, which the
    failure quotes."""

    def __init__(self, case, world, outdir, timeout=GROUP_TIMEOUT_S):
        self.case, self.outdir = case, str(outdir)
        super().__init__(
            case, lambda r: [sys.executable, "-X", "faulthandler",
                             os.path.abspath(__file__), case, str(r),
                             str(world), self.outdir],
            world, outdir, timeout, env=dict(OMP_NUM_THREADS="1"))

    def _kill(self):
        """SIGABRT to the live ranks, which their faulthandler answers with
        their stacks, then the kill."""
        live = [p for p in self.procs if p.poll() is None]
        for p in live:
            p.send_signal(signal.SIGABRT)
        for p in live:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        super()._kill()

    def results(self):
        import torch

        self.wait()
        return [torch.load(os.path.join(self.outdir, f"{self.case}_{r}.pt"),
                           weights_only=False) for r in range(self.world)]


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _pp_setup(inputs, cfg_key="pp_cfg", sd_key="pp_state", constrain=None,
              riou_weight=0.1):
    """A PointPillars TINY model with the parent's weights, its optimizer
    and train step."""
    from d3d_tpu_torch.models import PointPillars, make_anchors
    from d3d_tpu_torch.models.pointpillars import make_train_step
    from d3d_tpu_torch.train import make_optimizer

    cfg = inputs[cfg_key]
    model = PointPillars(cfg, device="cpu", constrain=constrain)
    model.load_state_dict(inputs[sd_key])
    opt, _ = make_optimizer(list(model.parameters()), 10, base_lr=1e-3,
                            schedule="constant")
    step = make_train_step(model, opt, cfg, make_anchors(cfg, device="cpu"),
                           riou_weight=riou_weight)
    return model, opt, step


# ---------------------------------------------------------------------------
# dp x tp: PointPillars and SECOND sharded steps
# ---------------------------------------------------------------------------

def _second_setup(seed=0, b=4):
    import numpy as np
    import torch

    from d3d_tpu_torch.models import (SECOND, SECONDConfig, head_config,
                                      make_anchors, second_voxelize)
    from d3d_tpu_torch.models.second import make_train_step
    from d3d_tpu_torch.train import make_optimizer

    cfg = SECONDConfig(bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0),
                       grid=(32, 32, 8), max_voxels=512,
                       stage_channels=(8, 16, 32),
                       stage_sites=(512, 160, 24), subm_per_stage=1,
                       head_channels=16)
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(b):
        n = 2048
        pts = np.stack([rng.uniform(0, 16, n), rng.uniform(-8, 8, n),
                        rng.uniform(-3, 1, n), rng.random(n)
                        * (1.0 if i < b // 2 else 4.0)],
                       axis=1).astype(np.float32)
        frames.append(second_voxelize(torch.from_numpy(pts), cfg))
    feats, coords, valid = (torch.stack(t) for t in zip(*frames))
    gt, mask = _gt_boxes(rng, b)
    batch = dict(features=feats, coords=coords, valid=valid, gt_boxes=gt,
                 gt_labels=torch.zeros(mask.shape, dtype=torch.int64),
                 gt_mask=mask)

    def build():
        model = SECOND(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(3))
        opt, _ = make_optimizer(list(model.parameters()), 10, base_lr=1e-3,
                                schedule="constant")
        step = make_train_step(model, opt, cfg,
                               make_anchors(head_config(cfg), device="cpu"))
        return model, opt, step

    return build, batch


def _gt_boxes(rng, b, m=3):
    """Padded gt boxes: the first half of the frames has m boxes, the
    second half one, so the dp ranks' positive counts differ."""
    import numpy as np
    import torch

    gt = np.stack([np.stack([
        rng.random(m) * 12 + 2, rng.random(m) * 12 - 6, np.full(m, -1.0),
        np.full(m, 3.9), np.full(m, 1.6), np.full(m, 1.56),
        rng.random(m) * np.pi - np.pi / 2], axis=1) for _ in range(b)])
    mask = np.ones((b, m), bool)
    mask[b // 2:, 1:] = False
    return (torch.as_tensor(gt, dtype=torch.float32),
            torch.as_tensor(mask))


# the loss function each family's step calls, and the local count of what
# it normalises by (the spies below read it on each rank)
_FAMILY_LOSSES = {
    "centerpoint": ("centerpoint", "center_loss",
                    lambda a: int(a[1]["mask"].sum())),
    "bevseg": ("bevseg", "segmentation_loss",
               lambda a: int((a[1] != a[2].ignore_index).sum())),
    "voxelnext": ("voxelnext", "voxelnext_loss",
                  lambda a: int(a[1]["pos_mask"].sum())),
    "mono3d": ("mono3d", "mono3d_loss", lambda a: int(a[1]["mask"].sum())),
}


def _family_steps(inputs, mesh):
    """CenterPoint, BEVSeg (panoptic), VoxelNeXt and Mono3D TINY: each
    family's plain step on the whole batch against its sharded step on
    ``mesh``, and the count each rank's loss saw locally."""
    import importlib

    import torch

    from d3d_tpu_torch.parallel import shard_train_step
    from d3d_tpu_torch.train import make_optimizer

    out = {}
    for name, (cls, cfg, state, batch) in inputs["families"].items():
        modname, fn, count = _FAMILY_LOSSES[name]
        module = importlib.import_module(f"d3d_tpu_torch.models.{modname}")

        def build():
            model = cls(cfg, device="cpu")
            model.load_state_dict(state)
            opt, _ = make_optimizer(list(model.parameters()), 10,
                                    base_lr=1e-3, schedule="constant")
            return model, module.make_train_step(model, opt, cfg)

        model, step = build()
        res = {"plain_loss": {k: float(v) for k, v in step(batch).items()},
               "plain_state": _state(model), "plain_grads": _grads(model)}
        model, step = build()
        counts, orig = [], getattr(module, fn)

        def spy(*args, **kw):
            counts.append(count(args))
            return orig(*args, **kw)
        setattr(module, fn, spy)
        try:
            sharded = shard_train_step(step, mesh, check_tp=False)
            aux = sharded(batch)
        finally:
            setattr(module, fn, orig)
        res.update(sharded_loss={k: float(v) for k, v in aux.items()},
                   sharded_grads=_grads(model), local_count=counts[0],
                   sharded_state={k: v.clone() for k, v in
                                  sharded.full_state_dict().items()})
        out[name] = res
    return out


def _sharded_resume(inputs, mesh):
    """PointPillars TINY's dp2 x tp2 step in a Trainer with one checkpoint
    directory for every rank: two steps straight, against one step, then
    a fresh model and optimizer resumed from the checkpoint and one more
    step. Returns the start steps, the whole states and the files."""
    from d3d_tpu_torch.checkpoint import TrainCheckpointer
    from d3d_tpu_torch.parallel import shard_train_step
    from d3d_tpu_torch.train import Trainer

    batch = inputs["pp_batch"]
    directory = os.path.join(inputs["outdir"], "dp_tp_ckpt")

    def run(steps, ckpt):
        model, opt, step = _pp_setup(inputs)
        sharded = shard_train_step(step, mesh)
        trainer = Trainer(sharded, checkpointer=ckpt, log_every=0)
        start = trainer.restore_or(model, opt)
        trainer.run(model, opt, iter([batch] * steps), num_steps=steps,
                    start_step=start)
        return start, sharded.train_state()

    _, straight = run(2, None)
    first, _ = run(1, TrainCheckpointer(directory))
    start, resumed = run(1, TrainCheckpointer(directory))
    return dict(starts=(first, start), straight=straight, resumed=resumed,
                files=sorted(os.listdir(directory)))


def case_dp_tp(rank, world, inputs):
    import torch.distributed as dist
    from torch import nn

    from d3d_tpu_torch.parallel import (make_mesh, shard_train_step,
                                        tp_param_report)
    from d3d_tpu_torch.parallel.comm import batch_groups

    out = {}
    mesh = make_mesh(4, dp=2, tp=2, device_type="cpu")
    out["mesh_shape"] = mesh.shape
    out["axis_cases"] = {
        repr(kw): make_mesh(4, device_type="cpu", **kw).shape
        for kw in ({}, {"sp": 2}, {"sp": 4, "tp": 1}, {"dp": 4},
                   {"dp": 1, "sp": 2})}

    # PointPillars TINY: plain step on the whole batch vs the dp2 x tp2 one
    batch = inputs["pp_batch"]
    model, opt, step = _pp_setup(inputs)
    plain = step(batch)
    out["pp_plain_loss"] = {k: float(v) for k, v in plain.items()}
    out["pp_plain_state"] = _state(model)
    out["pp_plain_grads"] = _grads(model)

    model, opt, step = _pp_setup(inputs)
    npos = []
    import d3d_tpu_torch.models.pointpillars as pp
    orig = pp.detection_loss

    def spy(outputs, targets, cfg, anchors=None, riou_weight=0.0):
        npos.append(int(targets["pos"].sum()) if "pos" in targets
                    else int(targets["posf"].sum()))
        return orig(outputs, targets, cfg, anchors, riou_weight)

    bn_means = []
    h = model.blocks[0].register_forward_pre_hook(
        lambda m, a: bn_means.append(float(a[0].mean())))
    pp.detection_loss = spy
    try:
        sharded = shard_train_step(step, mesh)
        aux = sharded(batch)
    finally:
        pp.detection_loss = orig
        h.remove()
    out["pp_local_npos"] = npos[0]
    out["pp_canvas_mean"] = bn_means[0]
    out["pp_sharded_loss"] = {k: float(v) for k, v in aux.items()}
    out["pp_sharded_grads"] = _grads(model)
    out["tp_rank"] = mesh.get_local_rank("tp")
    shard_shapes = {}
    sharded_names, repl = tp_param_report(model, mesh)
    for name, p in model.named_parameters():
        if name in sharded_names:
            shard_shapes[name] = (tuple(p.shape),
                                  tuple(opt.state[p]["m"].shape))
    out["pp_tp_names"] = sharded_names
    out["pp_shard_shapes"] = shard_shapes
    out["pp_sharded_state"] = {
        k: v.clone() for k, v in sharded.full_state_dict().items()}
    out["no_groups_after"] = batch_groups() == ()

    # a second step keeps working from the shards
    aux2 = sharded(batch)
    out["pp_second_loss"] = float(aux2["total"])
    out["pp_resume"] = _sharded_resume(inputs, mesh)

    # check_tp: a model none of whose kernels divide by tp raises
    odd = nn.Linear(4, 7, bias=False)

    def fake(batch):
        raise AssertionError("not reached")
    fake.model, fake.optimizer, fake.backward = odd, None, fake
    try:
        shard_train_step(fake, mesh)({})
        out["check_tp"] = "no error"
    except ValueError as e:
        out["check_tp"] = str(e)

    # SECOND TINY: dp2 x tp2 against the plain step
    build, sbatch = _second_setup()
    model, opt, step = build()
    plain = step(sbatch)
    out["second_plain_loss"] = {k: float(v) for k, v in plain.items()}
    out["second_plain_state"] = _state(model)
    out["second_plain_grads"] = _grads(model)
    model, opt, step = build()
    sharded = shard_train_step(step, mesh)
    aux = sharded(sbatch)
    out["second_sharded_loss"] = {k: float(v) for k, v in aux.items()}
    out["second_sharded_grads"] = _grads(model)
    out["second_sharded_state"] = sharded.full_state_dict()
    out["second_tp_names"] = tp_param_report(model, mesh)[0]

    # the other families' steps (each carries model, optimizer, backward)
    out["families"] = _family_steps(inputs, mesh)
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# dp x sp: the BEV backbone on slabs of rows
# ---------------------------------------------------------------------------

_BOUNDS = (0.0, 16.0, -8.0, 8.0, -3.0, 1.0)


def _clouds(seed, b, n=2048):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.stack([np.stack([
        rng.random(n) * 16, rng.random(n) * 16 - 8, rng.random(n) * 4 - 3,
        rng.random(n)], axis=1) for _ in range(b)]).astype(np.float32))


def _halo_checks(hook, seed):
    """The halo convolution on ``hook``'s slabs against the whole canvas's
    SAME convolution, forward and backward, at the backbones' shape
    classes; the rows each sends and what it gathers."""
    import torch
    import torch.distributed as dist

    from d3d_tpu_torch.models.pointpillars import _conv_same

    g = torch.Generator().manual_seed(seed)
    results = []
    for k, stride, w, h, bias in ((3, 1, 16, 12, False), (3, 2, 16, 12,
                                                          False),
                                  (3, 2, 16, 13, False), (3, 1, 8, 9, True),
                                  (1, 1, 16, 12, False)):
        x = torch.randn(2, 3, w, h, generator=g, requires_grad=True)
        wt = torch.randn(4, 3, k, k, generator=g, requires_grad=True)
        b = torch.randn(4, generator=g) if bias else None
        ref = _conv_same(x, wt, stride)
        if b is not None:
            ref = ref + b[:, None, None]
        ct = torch.randn(ref.shape, generator=g)
        gx, gw = torch.autograd.grad((ref * ct).sum(), (x, wt))
        before = dict(hook.counts)
        slab = hook(x, "bev")
        y = hook.conv2d(slab, wt, stride, b)
        moved = {key: hook.counts[key] - before[key] for key in before}
        whole = hook.gather(y)
        sx, sw = torch.autograd.grad((whole * ct).sum(), (x, wt))
        sx, sw = sx.contiguous(), sw.contiguous()
        dist.all_reduce(sx, group=hook.group)
        dist.all_reduce(sw, group=hook.group)
        results.append(dict(
            shape=(k, stride, w, h, bias), slab=tuple(slab.shape),
            rank=hook.rank, size=hook.size,
            moved=moved, fwd=float((whole - ref).abs().max()),
            gx=float((sx - gx).abs().max()), gw=float((sw - gw).abs().max()),
            scale=float(ref.abs().max())))
    return results


def _family_forwards(mesh):
    """CenterPoint, BEVSeg (panoptic) and SST TINY with the spatial hook
    against the same models without it (inference)."""
    import dataclasses

    import torch

    from d3d_tpu_torch.models import (SST, BEVSeg, BEVSegConfig,
                                      CenterPoint, CenterPointConfig,
                                      SSTConfig, pillarize)
    from d3d_tpu_torch.models.bevseg import point_cell_coords
    from d3d_tpu_torch.parallel import spatial_constrain

    common = dict(bounds=_BOUNDS, grid=(32, 32), max_pillars=256,
                  max_points_per_pillar=16)
    pts = _clouds(11, 2)
    out = {}
    configs = dict(
        centerpoint=(CenterPoint, CenterPointConfig(
            **common, pfn_features=32, backbone_channels=(32, 64),
            backbone_blocks=(1, 1), upsample_channels=32, head_channels=16,
            window=9, top_k=8)),
        bevseg=(BEVSeg, BEVSegConfig(
            **common, pfn_features=16, enc_channels=(16, 32),
            enc_blocks=(1, 1), dec_channels=16, num_classes=4,
            ignore_index=0, panoptic=True, thing_classes=(1, 2),
            max_instances=8, center_sigma=1.0, center_radius=2.0)),
        sst=(SST, SSTConfig(**common, pfn_features=32, window=8,
                            capacity=16, depth=2, num_heads=2,
                            neck_channels=32)))
    for name, (cls, cfg) in configs.items():
        frames = [pillarize(p, dataclasses.replace(cfg)) for p in pts]
        args = [torch.stack(t) for t in zip(*frames)]
        if name == "bevseg":
            args.append(point_cell_coords(pts[..., :3], cfg))
        outs = []
        for con in (None, spatial_constrain(mesh)):
            model = cls(cfg, constrain=con, device="cpu",
                        generator=torch.Generator().manual_seed(5))
            with torch.no_grad():
                outs.append(model(*args))
        a, b = outs
        flat = (lambda o: list(o.values()) if isinstance(o, dict)
                else list(o) if isinstance(o, tuple) else [o])
        out[name] = max(float((x - y).abs().max()) / max(
            float(x.abs().max()), 1e-30) for x, y in zip(flat(a), flat(b)))
    return out


def case_dp_sp(rank, world, inputs):
    import torch.distributed as dist

    from d3d_tpu_torch.parallel import (make_mesh, shard_train_step,
                                        spatial_constrain)

    out = {}
    mesh_sp = make_mesh(4, dp=2, sp=2, tp=1, device_type="cpu")
    mesh_dp = make_mesh(4, dp=4, tp=1, device_type="cpu")
    batch = inputs["pp_batch"]

    model, opt, step = _pp_setup(inputs)
    out["dp_loss"] = {k: float(v) for k, v in
                      shard_train_step(step, mesh_dp)(batch).items()}
    out["dp_grads"] = _grads(model)

    hook = spatial_constrain(mesh_sp)
    model, opt, step = _pp_setup(inputs, constrain=hook)
    slabs = []
    h = model.blocks[0].register_forward_pre_hook(
        lambda m, a: slabs.append(tuple(a[0].shape)))
    out["sp_loss"] = {k: float(v) for k, v in
                      shard_train_step(step, mesh_sp)(batch).items()}
    h.remove()
    out["sp_grads"] = _grads(model)
    out["slab"] = slabs[0]
    out["step_counts"] = dict(hook.counts)

    out["halo_sp2"] = _halo_checks(spatial_constrain(mesh_sp), 7)
    mesh_sp4 = make_mesh(4, dp=1, sp=4, tp=1, device_type="cpu")
    out["halo_sp4"] = _halo_checks(spatial_constrain(mesh_sp4), 8)
    out["families"] = _family_forwards(mesh_sp4)
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# pp and ep: GPipe pipelines, the SST trunk, the Switch-MoE's experts
# ---------------------------------------------------------------------------

def _stage_fn(state, x, mb):
    from d3d_tpu_torch.parallel.moe import gelu_tanh

    return gelu_tanh(x @ state["w"] + state["b"])


def _sequential(state, x):
    for i in range(state["w"].shape[0]):
        x = _stage_fn({k: v[i] for k, v in state.items()}, x, 0)
    return x


def _pipeline_case(state, x, m, mesh, batch_axis=None):
    """Forward and gradients of sum(out^2) through pipeline_apply and
    through the sequential stack."""
    from d3d_tpu_torch.parallel import (microbatch, pipeline_apply,
                                        unmicrobatch)

    def run(fn):
        st = {k: v.clone().requires_grad_(True) for k, v in state.items()}
        xx = x.clone().requires_grad_(True)
        out = fn(st, xx)
        (out ** 2).sum().backward()
        return dict(out=out.detach(), x=xx.grad,
                    **{k: v.grad for k, v in st.items()})

    got = run(lambda st, xx: unmicrobatch(pipeline_apply(
        _stage_fn, st, microbatch(xx, m), mesh, batch_axis=batch_axis)))
    want = run(_sequential)
    return dict(err={k: float((got[k] - want[k]).abs().max())
                     for k in want},
                outputs=got["out"], grads={k: got[k] for k in state})


def _moe_case(inputs, mesh, group_size):
    from d3d_tpu_torch.parallel import moe_mlp

    res = {}
    for name, m in (("dense", None), ("mesh", mesh)):
        params = {k: v.clone().requires_grad_(True)
                  for k, v in inputs["moe_params"].items()}
        x = inputs["moe_x"].clone().requires_grad_(True)
        y, aux = moe_mlp(params, x, mesh=m, group_size=group_size)
        ((y ** 2).sum() + aux).backward()
        res[name] = dict(y=y.detach(), aux=float(aux), x=x.grad,
                         **{k: v.grad for k, v in params.items()})
    d, s = res["dense"], res["mesh"]
    return dict(y=s["y"], aux=s["aux"], dense_aux=d["aux"],
                err={k: float((s[k] - d[k]).abs().max())
                     for k in d if k != "aux"})


def _sst_moe_step(inputs, mesh):
    """An SST MoE step on a (dp2, ep2) mesh against the plain step."""
    from d3d_tpu_torch.models import SST, make_anchors
    from d3d_tpu_torch.models.pointpillars import make_train_step
    from d3d_tpu_torch.parallel import expert_constrain, shard_train_step
    from d3d_tpu_torch.train import make_optimizer

    cfg = inputs["sst_moe_cfg"]
    res = {}
    for name, con in (("plain", None), ("ep", expert_constrain(mesh))):
        model = SST(cfg, moe_constrain=con, device="cpu")
        model.load_state_dict(inputs["sst_moe_state"])
        opt, _ = make_optimizer(list(model.parameters()), 10,
                                base_lr=1e-3, schedule="constant")
        step = make_train_step(model, opt, cfg,
                               make_anchors(cfg, device="cpu"))
        if con is None:
            aux = step(inputs["sst_batch"])
            state = _state(model)
            res["plain_grads"] = _grads(model)
        else:
            sharded = shard_train_step(step, mesh)
            aux = sharded(inputs["sst_batch"])
            res["w1_local"] = tuple(model.blocks[0].moe_w1.shape)
            res["router_local"] = tuple(model.blocks[0].moe_router.shape)
            state = {k: v.clone()
                     for k, v in sharded.full_state_dict().items()}
        res[name] = dict(loss={k: float(v) for k, v in aux.items()},
                         state=state)
    return res


def case_pp_ep(rank, world, inputs):
    import torch
    import torch.distributed as dist

    from d3d_tpu_torch.models import SST
    from d3d_tpu_torch.models.sst import pipeline_sst_trunk
    from d3d_tpu_torch.parallel import (make_pp_mesh, microbatch,
                                        pipeline_apply, unmicrobatch)
    from d3d_tpu_torch.parallel.mesh import Mesh

    out = {}
    pipe = inputs["pipe"]
    pp4, pp2dp2 = make_pp_mesh(4, device_type="cpu"), \
        make_pp_mesh(2, dp=2, device_type="cpu")
    out["s2m4"] = _pipeline_case(pipe["s2"], pipe["x8"], 4, pp2dp2)
    out["s4m4"] = _pipeline_case(pipe["s4"], pipe["x8"], 4, pp4)
    out["s8m4"] = _pipeline_case(pipe["s8"], pipe["x8"], 4, pp4)
    out["dp_pp"] = _pipeline_case(pipe["s4b"], pipe["x12"], 3, pp2dp2,
                                  batch_axis="dp")
    try:
        pipeline_apply(_stage_fn, pipe["s6"], microbatch(pipe["x8"], 4), pp4)
        out["stage_count"] = "no error"
    except ValueError as e:
        out["stage_count"] = str(e)

    # SST TINY's trunk pipelined: pp4, and pp2 x dp2 on the batch axis
    cfg = inputs["sst_cfg"]
    batch = inputs["sst_batch"]
    args = (batch["features"], batch["coords"], batch["valid"])
    model = SST(cfg, device="cpu")
    model.load_state_dict(inputs["sst_state"])
    with torch.no_grad():
        pf0 = SST(cfg, stage="embed", device="cpu").requires_grad_(False)
        pf0.load_state_dict(inputs["sst_state"])
        pf0 = pf0(*args)
        trunk = SST(cfg, stage="trunk", device="cpu")
        trunk.load_state_dict(inputs["sst_state"])
        want = trunk(*args)
        for name, mesh, ba in (("trunk_pp4", pp4, None),
                               ("trunk_dp_pp", pp2dp2, "dp")):
            got = unmicrobatch(pipeline_sst_trunk(
                model, cfg, mesh, microbatch(pf0, 2),
                microbatch(batch["coords"], 2),
                microbatch(batch["valid"], 2), batch_axis=ba))
            out[name] = dict(got=got, err=float((got - want).abs().max()))

    # the Switch-MoE at ep2 (on a dp2 x ep2 mesh) and ep4
    ep2 = Mesh("cpu", torch.arange(4).reshape(2, 2),
               mesh_dim_names=("dp", "ep"))
    ep4 = Mesh("cpu", torch.arange(4), mesh_dim_names=("ep",))
    for name, mesh in (("ep2", ep2), ("ep4", ep4)):
        for gs in (None, 16):
            out[f"moe_{name}_{gs}"] = _moe_case(inputs, mesh, gs)
    out["sst_moe"] = _sst_moe_step(inputs, ep2)
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# evaluators, serving and the job on 2 ranks
# ---------------------------------------------------------------------------

def port_arrays(cols, frame):
    """A port Target3DArray from ``tests/test_torch_abstraction.py``'s
    twin columns (the JAX side's twin of the same values)."""
    from d3d_tpu_torch import abstraction as TA
    from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TK

    objs = []
    for i in range(len(cols["position"])):
        tag = TA.ObjectTag(TK(int(cols["label"][i])), TK,
                           float(cols["score"][i]))
        objs.append(TA.ObjectTarget3D(
            cols["position"][i], cols["quat"][i], cols["dimension"][i], tag,
            tid=0, position_var=cols["position_var"][i],
            dimension_var=cols["dimension_var"][i],
            orientation_var=float(cols["orientation_var"][i])))
    return TA.Target3DArray(objs, frame=frame)


def port_host_stats(evaluator, pid, nframes=3):
    """``tests/_distributed_worker.py``'s ``build_host_stats`` through the
    port's evaluator: the same frames of host ``pid``."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    from d3d_tpu_torch.abstraction import (ObjectTag, ObjectTarget3D,
                                           Target3DArray)
    from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass

    car = KittiObjectClass.Car
    rng = np.random.default_rng(100 + pid)
    r = Rotation.from_euler("Z", 0)
    for i in range(nframes):
        base = float(pid * 40 + i * 7)
        gt = Target3DArray([
            ObjectTarget3D([base, 0, 0], r, [2, 2, 2], ObjectTag(car)),
            ObjectTarget3D([base + 10, 0, 0], r, [2, 2, 2],
                           ObjectTag(car))], frame="t")
        dt = Target3DArray([
            ObjectTarget3D([base + rng.normal(0, 0.1), 0, 0], r, [2, 2, 2],
                           ObjectTag(car, scores=0.9))], frame="t")
        evaluator.add_stats(evaluator.calc_stats(gt, dt))
    return evaluator.get_stats()


def case_eval(rank, world, inputs):
    import torch
    import torch.distributed as dist

    from d3d_tpu_torch import benchmarks as TBM
    from d3d_tpu_torch import benchmarks_device as TBD
    from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TK
    from d3d_tpu_torch.models import (PointPillars, make_anchors,
                                      make_pointpillars_detector)
    from d3d_tpu_torch.parallel import (all_hosts_stats, initialize,
                                        make_global_mesh, make_mesh,
                                        process_count, process_index,
                                        stats_to_arrays)
    from d3d_tpu_torch.parallel.mesh import shard_inference
    from d3d_tpu_torch.train import shard_frames_across_hosts

    out = {}
    out["initialize_again"] = initialize(
        "file://" + os.path.join(inputs["outdir"], "again"), world, rank)
    out["process"] = (process_index(), process_count())
    out["frames"] = list(shard_frames_across_hosts(range(7)))
    out["global"] = [make_global_mesh(device_type="cpu").shape,
                     make_global_mesh(dp=2, tp=1, device_type="cpu").shape]
    mesh = make_mesh(2, dp=2, tp=1, device_type="cpu")

    # the detection evaluator over 5 frames, not a dp multiple
    det = inputs["det"]
    classes = [TK[c] for c in det["classes"]]
    ev = TBM.DetectionEvaluator(classes, [0.3, 0.5], pr_sample_count=10,
                                device="cpu")
    gts = [port_arrays(c, "t") for c in det["gt"]]
    dts = [port_arrays(c, "t") for c in det["dt"]]
    keys = [c.value for c in classes]
    out["det_mesh"] = stats_to_arrays(TBD.device_calc_stats(
        ev, gts, dts, mesh=mesh, device="cpu"), keys)
    out["det_plain"] = stats_to_arrays(TBD.device_calc_stats(
        ev, gts, dts, device="cpu"), keys)

    # the segmentation evaluators, 7 ragged frames
    seg = inputs["seg"]
    sev = TBM.SegmentationEvaluator(seg["classes"], min_points=2)
    pano = TBD.device_panoptic_stats(sev, *seg["frames"], mesh=mesh,
                                     device="cpu")
    sem = TBD.device_semantic_stats(sev, *seg["frames"][:2], mesh=mesh,
                                    device="cpu")
    out["seg"] = {f: dict(getattr(pano, f)) for f in
                  ("tp", "fp", "fn", "itp", "ifp", "ifn", "cumiou")}
    out["sem"] = {f: dict(getattr(sem, f)) for f in ("tp", "fp", "fn")}

    # per-host stats merged over the job
    hev = TBM.DetectionEvaluator([TK.Car], [0.3], pr_sample_count=8,
                                 device="cpu")
    merged = all_hosts_stats(port_host_stats(hev, rank), [TK.Car.value])
    out["merged"] = {k: v.numpy() for k, v in
                     stats_to_arrays(merged, [TK.Car.value]).items()}

    # data-parallel serving: 4 frames (and 3: padded) against eager calls
    cfg = inputs["pp_cfg"]
    model = PointPillars(cfg, device="cpu")
    model.load_state_dict(inputs["pp_state"])
    detect = make_pointpillars_detector(
        model, None, cfg, make_anchors(cfg, device="cpu"), [TK.Car],
        top_k=16, device="cpu")
    clouds = inputs["clouds"]
    for n in (4, 3):
        batched = shard_inference(detect.device_fn, mesh)(clouds[:n])
        eager = [detect.device_fn(c) for c in clouds[:n]]
        out[f"serve_{n}"] = dict(
            shapes=[tuple(t.shape) for t in batched],
            equal=all(torch.equal(batched[k][i], e[k])
                      for i, e in enumerate(eager)
                      for k in range(len(e))))
    dist.barrier()
    return out


CASES = {"dp_tp": case_dp_tp, "dp_sp": case_dp_sp, "pp_ep": case_pp_ep,
         "eval": case_eval}


def main():
    case, rank, world, outdir = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    import torch

    torch.set_num_threads(1)
    from d3d_tpu_torch.parallel import initialize, process_count

    store = os.path.join(outdir, f"{case}_store")
    assert initialize("file://" + store, world, rank, backend="gloo")
    assert process_count() == world
    inputs_path = os.path.join(outdir, "inputs.pt")
    inputs = (torch.load(inputs_path, weights_only=False)
              if os.path.exists(inputs_path) else {})
    inputs["outdir"] = outdir
    out = CASES[case](rank, world, inputs)
    torch.save(out, os.path.join(outdir, f"{case}_{rank}.pt"))
    torch.distributed.destroy_process_group()
    print(f"RANK {rank} OK", flush=True)


if __name__ == "__main__":
    main()
