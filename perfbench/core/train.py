"""The training mixes: the program's ``Trainer`` drives its train step
(data-parallel over the cell's cards through ``shard_train_step`` when
there are several) on augmented KITTI-like frames for ``seconds``; then
the reference follows the first three steps from the same weights and
frames.

On several cards the benchmark starts one process a card (the pattern of
``d3d_tpu_torch/parallel/launch.py``: started together, waited for under
one deadline, killed together on the first failure), rendezvous in a
``FileStore`` under ``TMPDIR``. ``shard_train_step`` takes the whole
global batch on every rank and keeps the rank's rows, so every rank makes
every rank's frames and pillarizes the whole batch, as the port's own
training example does.
"""

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import frames, trace, weights
from ..reference import boxes as refboxes
from ..reference import train as reftrain

__all__ = ["run"]

CHECK_STEPS = 3
GROUP_TIMEOUT_S = 330


def _tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _pools(cell, seed, world, workers=None):
    """Every rank's pool: ``world`` lists of (points, boxes) frames."""
    tr = cell["traffic"]
    return [frames.make_pool(seed, tr["pool_per_chip"], stream=q,
                             frame=tr["frame"], augmentation=tr["augmentation"],
                             workers=workers) for q in range(world)]


def _step_frames(pools, step, batch, keep=None):
    """The global batch of training step ``step``: each rank's next
    ``batch`` frames of its pool in rank order (``keep`` of them where a
    fault leaves the rest out)."""
    out = []
    for pool in pools:
        rows = [pool[(step * batch + j) % len(pool)] for j in range(batch)]
        out += rows[:keep or batch]
    return out


def _total_steps(cell, world):
    tr = cell["traffic"]
    return math.ceil(tr["epochs"] * tr["train_frames"]
                     / (tr["batch_per_chip"] * world))


def _seeded_state(cell, pools, template, seed, dev):
    """The benchmark's weights for ``template``'s keys, the heads
    calibrated on the reference's forward of rank 0's first frame."""
    conf, fam = cell["conf"], cell["family"]
    state = weights.make_state(template, fam.fan_in, fam.HEADS, seed, dev)
    with torch.no_grad():
        x = fam.ref_inputs(torch.from_numpy(pools[0][0][0]).to(dev),
                           conf["model"])
        raw = fam.ref_forward(state, conf["model"], [x])
    weights.calibrate(state, [o[0] for o in raw], fam.HEADS, **conf["heads"])
    return state


# ---------------------------------------------------------------------------
# the reference's three steps
# ---------------------------------------------------------------------------

def reference_steps(cell, state, pools, dev, world, keep=None, local=False):
    """The reference's first :data:`CHECK_STEPS` steps from ``state`` on
    the global batches (``local``: rank 0's rows alone, as a rank whose
    exchange is left out sees them; ``keep``: that many rows of each
    rank's batch). Returns (losses, first clipped gradient's norm by leaf,
    change's norm by leaf after the last step, the running statistics'
    change's norm by leaf after the first step)."""
    conf, fam = cell["conf"], cell["family"]
    model = conf["model"]
    tr, recipe = cell["traffic"], conf["training"]
    names = [k for k in state if not k.split(".")[-1].startswith(
        ("running_", "num_batches"))]
    params = {k: state[k].detach().clone().float() for k in names}
    init = {k: v.clone() for k, v in params.items()}
    buffers = {k: v for k, v in state.items() if k not in params}
    anchors = refboxes.anchors(fam.head_model(model)).to(dev)
    total = _total_steps(cell, world)
    opt = reftrain.AdamW(params, total, recipe["base_lr"],
                         clip=recipe["clip_norm"])
    losses, first, moved = [], None, None
    for k in range(CHECK_STEPS):
        rows = _step_frames(pools[:1] if local else pools, k,
                            tr["batch_per_chip"], keep)
        inputs, gts = [], []
        for pts, boxes in rows:
            inputs.append(fam.ref_inputs(torch.from_numpy(pts).to(dev), model))
            gts.append(torch.from_numpy(boxes).to(dev))
        leaves = {k2: v.clone().requires_grad_(True) for k2, v in
                  params.items()}
        st = dict(buffers, **leaves)
        stats = {}
        outputs = fam.ref_forward(st, model, inputs, stats=stats)
        with torch.no_grad():
            targets = [reftrain.assign(anchors, g, model["pos_iou"],
                                       model["neg_iou"]) for g in gts]
        loss = reftrain.loss(outputs, targets)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        clipped = opt.step(dict(zip(leaves, grads)))
        if first is None:
            first = {n: float(g.norm()) for n, g in clipped.items()}
            moved = reftrain.running_change(buffers, stats,
                                            recipe["bn_momentum"])
        del outputs, grads, leaves, st
    change = {n: float((params[n] - init[n]).norm()) for n in names}
    return losses, first, change, moved


def compare(prog, ref):
    """The numbers compared: the first step's relative loss gap (the later
    steps' losses carry the rounding that Adam's first, nearly sign-like
    updates amplify), and the worst leaf's gap of the first gradient's
    norm, of the change's norm after the last step and of the running
    statistics' change after the first step
    (:func:`reference.train.leaf_gaps`; leaves whose reference gradient is
    under a thousandth of the median leaf's are left out of the first
    two). Returns ({name: (value, worst leaf)}, every step's loss gap,
    the leaves left out)."""
    (pl, pg, pc, ps), (rl, rg, rc, rs) = prog, ref
    steps = [abs(a - b) / abs(b) for a, b in zip(pl, rl)]
    med = float(np.median(list(rg.values())))
    out = sorted(k for k, v in rg.items() if v < 1e-3 * med)
    return dict(loss_gap=(steps[0], None),
                grad_gap=reftrain.leaf_gaps(pg, rg, out),
                update_gap=reftrain.leaf_gaps(pc, rc, out),
                stats_gap=reftrain.leaf_gaps(ps, rs)), steps, out


# ---------------------------------------------------------------------------
# one rank of the program
# ---------------------------------------------------------------------------

def _batches(pools, cfg, fam, batch, dev, start=0, keep=None):
    """The program's feed: each global batch's frames to the card, through
    the port's voxelizer, stacked with their boxes."""
    step = start
    while True:
        feats, coords, valid, gts = [], [], [], []
        for pts, boxes in _step_frames(pools, step, batch, keep):
            f, c, v = fam.port_voxelize(torch.as_tensor(pts).to(dev), cfg)
            feats.append(f)
            coords.append(c)
            valid.append(v)
            gts.append(torch.as_tensor(boxes).to(dev))
        g = torch.stack(gts)
        yield dict(features=torch.stack(feats), coords=torch.stack(coords),
                   valid=torch.stack(valid), gt_boxes=g,
                   gt_labels=torch.zeros(g.shape[:2], dtype=torch.int64,
                                         device=dev),
                   gt_mask=torch.ones(g.shape[:2], dtype=torch.bool,
                                      device=dev))
        step += 1


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _running(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.split(".")[-1] in ("running_mean", "running_var")}


def _clipped_norms(model, clip):
    """The norm by leaf of the gradient as the optimizer took it: each
    parameter's ``.grad`` after the step (the step's gradient before
    clipping, all-reduced over the ranks) times the clip factor of their
    global norm. A parameter without a gradient counts as 0."""
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .detach().double() for n, p in model.named_parameters()}
    total = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
    scale = min(1.0, clip / total) if total > 0 else 1.0
    return {n: float(g.norm()) * scale for n, g in grads.items()}


def program_steps(cell, seed, dev, world, fault=None):
    """One rank's set-up of the program from ``seed`` and its first
    :data:`CHECK_STEPS` steps through the window's own call and feed.
    Returns a dict: ``prog`` (the numbers :func:`compare` takes), ``state``
    (the weights both sides start from), ``pools``, and the objects the
    window goes on with (``model``, ``opt``, ``trainer``, ``feed``,
    ``done``, the steps made)."""
    import torch.distributed as dist

    from d3d_tpu_torch.models.pointpillars import prepare_targets
    from d3d_tpu_torch.parallel import make_mesh, shard_train_step
    from d3d_tpu_torch.train import Trainer, make_optimizer

    conf, tr, fam = cell["conf"], cell["traffic"], cell["family"]
    recipe = conf["training"]
    _tf32(conf["precision"].get("tf32", False))
    batch = tr["batch_per_chip"]
    keep = batch // 2 if fault == "half_batch" else None
    pools = _pools(cell, seed, world, max(1, (os.cpu_count() or 1) // world)
                   if tr.get("workers") is None else tr["workers"])
    cfg = fam.port_config(conf)
    model = fam.port_model(cfg, dev)
    state = _seeded_state(cell, pools, model.state_dict(), seed, dev)
    if world > 1:
        for v in state.values():
            dist.broadcast(v, 0)
    model.load_state_dict(state)
    state = {k: v.clone() for k, v in state.items()}
    anchors = fam.port_anchors(cfg, dev)
    opt, _ = make_optimizer(model.parameters(), _total_steps(cell, world),
                            base_lr=recipe["base_lr"],
                            clip_norm=recipe["clip_norm"])
    inner = fam.port_train_step(model, opt, cfg, anchors)
    step_fn = (shard_train_step(inner, make_mesh(world, dp=world,
                                                 device_type=dev.type))
               if world > 1 else inner)
    if fault == "no_exchange":
        dist.all_reduce = lambda *a, **k: None
    if fault == "frozen":
        opt.step = lambda *a, **k: None
    losses = []

    def step(b):
        kept = _running(model) if fault == "stats_unmoved" else None
        aux = step_fn(b)
        if kept:
            with torch.no_grad():
                for n, buf in model.named_buffers():
                    if n in kept:
                        buf.copy_(kept[n])
        if len(losses) < CHECK_STEPS:
            losses.append(aux["total"].detach().clone())
        return aux

    trainer = Trainer(step, prep_fn=lambda b: prepare_targets(
        anchors, b, cfg=cfg, dense=True), log_every=0)
    feed = _batches(pools, cfg, fam, batch, dev, keep=keep)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = _running(model)
    done = trainer.run(model, opt, feed, num_steps=1)
    grad1 = _clipped_norms(model, recipe["clip_norm"])
    moved = {n: float((b.double() - stats0[n].double()).norm())
             for n, b in _running(model).items()}
    done = trainer.run(model, opt, feed, num_steps=CHECK_STEPS - 1,
                       start_step=done)
    change = {n: float((p.detach() - init[n]).norm())
              for n, p in model.named_parameters()}
    return dict(prog=([float(v) for v in losses], grad1, change, moved),
                state=state, pools=pools, model=model, opt=opt,
                trainer=trainer, feed=feed, done=done, keep=keep)


def rank_main(cell, seed, seconds, traced, dev, rank, world, log,
              fault=None):
    """One rank's run. Rank 0 returns (result fields, numbers compared);
    the others return None."""
    import torch.distributed as dist

    conf, tr = cell["conf"], cell["traffic"]
    batch = tr["batch_per_chip"]
    run = program_steps(cell, seed, dev, world, fault)
    prog, state, pools, keep = (run[k] for k in ("prog", "state", "pools",
                                                 "keep"))
    model, opt, trainer, feed, done = (run[k] for k in (
        "model", "opt", "trainer", "feed", "done"))
    del run
    _sync(dev)
    t0 = time.perf_counter()
    warm = tr["warm_steps"]
    done = trainer.run(model, opt, feed, num_steps=warm, start_step=done)
    _sync(dev)
    n_steps = torch.tensor([max(1, round(seconds * warm / (
        time.perf_counter() - t0)))], device=dev)
    if world > 1:
        dist.broadcast(n_steps, 0)
    n_steps = int(n_steps)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    if world > 1:
        dist.barrier()
    if traced:
        t0_ns = time.time_ns()
        w0 = time.perf_counter()
        with trace.profile() as prof:
            done = trainer.run(model, opt, feed, num_steps=tr["trace_steps"],
                               start_step=done)
            _sync(dev)
        tr_obj = trace.Trace(prof, t0_ns, time.perf_counter() - w0)
        del prof
        nccl = lambda n: "nccl" in n.lower()  # noqa: E731
        mine = dict(busy=tr_obj.busy_s(), wall=tr_obj.wall_s,
                    launches=tr_obj.launches(),
                    exposed=tr_obj.exposed_s(nccl),
                    nccl=tr_obj.kernel_s(nccl))
        if world > 1:
            dist.barrier()
    out["window_epoch"] = time.time()
    first_step = done
    w0 = time.perf_counter()
    done = trainer.run(model, opt, feed, num_steps=n_steps, start_step=done)
    _sync(dev)
    wall = time.perf_counter() - w0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    gathered = [None] * world
    report = dict(peak=peak, trace=mine if traced else None)
    if world > 1:
        dist.all_gather_object(gathered, report)
    else:
        gathered = [report]
    if rank != 0:
        return None
    out.update(
        memory_peak_bytes=max(g["peak"] for g in gathered),
        attempted=n_steps, failed=0, steps=n_steps, plain_s=wall,
        global_batch=batch * world,
        train_frames_per_s=n_steps * batch * world / wall)
    if traced:
        ranks = [g["trace"] for g in gathered]
        out.update(rank_traces=ranks, traced_steps=tr["trace_steps"],
                   busy_s=float(np.mean([r["busy"] for r in ranks])),
                   window_s=float(np.mean([r["wall"] for r in ranks])),
                   breakdown=dict(device_ops=tr_obj.top_ops(),
                                  idle_gaps=tr_obj.idle_gaps()))
    del trainer, opt, model, feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["window_flops"] = 3 * _forward_flops(cell, pools, first_step,
                                             n_steps, batch, keep, dev)
    t0 = time.perf_counter()
    _tf32(conf["precision"].get("tf32", False))
    ref = reference_steps(cell, state, pools, dev, world)
    log(f"check: the reference's {CHECK_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s")
    return out, _judge(cell, prog, ref, log)


def _forward_flops(cell, pools, first, steps, batch, keep, dev):
    """Forward FLOPs of the window's frames, by the family's count."""
    fam, model = cell["family"], cell["conf"]["model"]
    memo = {}
    total = 0
    with torch.no_grad():
        for k in range(first, first + steps):
            for pts, _ in _step_frames(pools, k, batch, keep):
                key = id(pts)
                if key not in memo:
                    memo[key] = fam.work(fam.ref_inputs(
                        torch.from_numpy(pts).to(dev), model), model)["flops"]
                total += memo[key]
    return total


def _judge(cell, prog, ref, log):
    nums, steps, left_out = compare(prog, ref)
    log(f"losses program {prog[0]} reference {ref[0]}; each step's gap "
        f"{steps}; leaves left out {left_out}; worst leaves: gradient "
        f"{nums['grad_gap'][1]}, change {nums['update_gap'][1]}, "
        f"statistics {nums['stats_gap'][1]}")
    limits = cell["conf"]["limits"]
    return {k: (v, limits[k]) for k, (v, _) in nums.items()}


def check_only(cell, seeds, dev, rank, world, log):
    """The output check alone on each of ``seeds``, in one process a
    rank: the program's set-up and first steps, then the reference's; no
    window. For reading the limits' lower readings over many seeds where
    set-up is long. Rank 0 logs each seed's numbers and returns (result
    fields, each number's largest over the seeds); the others None."""
    worst = {}
    for seed in seeds:
        run = program_steps(cell, seed, dev, world)
        prog, state, pools = run["prog"], run["state"], run["pools"]
        del run
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if rank == 0:
            ref = reference_steps(cell, state, pools, dev, world)
            nums = _judge(cell, prog, ref, log)
            log(f"seed {seed}: " + ", ".join(
                f"{k} {v!r}" for k, (v, _) in nums.items()))
            for k, (v, lim) in nums.items():
                worst[k] = (max(v, worst.get(k, (v, lim))[0]), lim)
        del prog, state, pools
        if world > 1:
            # ranks that share a card wait for rank 0's reference to end
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            import torch.distributed as dist

            dist.barrier()
    if rank != 0:
        return None
    return dict(memory_peak_bytes=0, attempted=len(seeds), failed=0,
                train_frames_per_s=0.0, setup_s=0.0,
                window_epoch=time.time()), worst


# ---------------------------------------------------------------------------
# the control and the faults planted in the reference (one process)
# ---------------------------------------------------------------------------

def run_control(cell, seed, dev, log, variant):
    """The reference put in the program's place: in TF32 (``tf32``), or
    with half of each rank's rows left out (``half_batch``), or with the
    exchange between ranks left out (``no_exchange``: rank 0's rows
    alone), judged against the reference. One process, one card."""
    conf, fam = cell["conf"], cell["family"]
    world = cell["entry"]["chips"]
    tr = cell["traffic"]
    pools = _pools(cell, seed, world, tr.get("workers"))
    template = fam.port_model(fam.port_config(conf), dev).state_dict()
    state = _seeded_state(cell, pools, template, seed, dev)
    _tf32(variant == "tf32")
    prog = reference_steps(
        cell, state, pools, dev, world, local=variant == "no_exchange",
        keep=tr["batch_per_chip"] // 2 if variant == "half_batch" else None)
    _tf32(conf["precision"].get("tf32", False))
    ref = reference_steps(cell, state, pools, dev, world)
    out = dict(memory_peak_bytes=0, attempted=CHECK_STEPS, failed=0,
               train_frames_per_s=0.0, setup_s=0.0, window_epoch=time.time())
    return out, _judge(cell, prog, ref, log)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(argv, world, log, timeout=GROUP_TIMEOUT_S):
    """Start one process a rank with ``argv`` + its rank, wait for them
    all under one deadline; on the first failure or at the deadline, kill
    the rest. Returns 0 when every rank exited 0, else the first failing
    rank's exit code (-1 at the deadline)."""
    procs = [subprocess.Popen(argv + ["--rank", str(r)]) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs
                      if p.poll() not in (None, 0)]
            if failed:
                log("a rank failed: stopping the others")
                return failed[0]
            if time.monotonic() > deadline:
                log("the ranks ran past their deadline: stopping them")
                return -1
            time.sleep(0.05)
        return next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def run(cell, seed, seconds, traced, dev, log, control=None, fault=None,
        rank=None, store=None, check_seeds=None):
    """One run of a training cell (or, with ``rank``, one rank of it).
    Returns (result fields, numbers compared as {name: (value, limit)}),
    None on ranks other than 0. With ``check_seeds`` the output check
    alone runs on that many seeds from ``seed`` (:func:`check_only`)."""
    world = cell["entry"]["chips"]
    if control is not None:
        return run_control(cell, seed, dev, log, control)

    def main_of(rank):
        if check_seeds:
            return check_only(cell, range(seed, seed + check_seeds), dev,
                              rank, world, log)
        return rank_main(cell, seed, seconds, traced, dev, rank, world, log,
                         fault)

    if world == 1:
        return main_of(0)
    if rank is not None:
        import torch.distributed as dist

        shared = dev.type == "cuda" and torch.cuda.device_count() < world
        dist.init_process_group(
            "nccl" if dev.type == "cuda" and not shared else "gloo",
            init_method=f"file://{store}/rendezvous", world_size=world,
            rank=rank)
        try:
            res = main_of(rank)
            if res is not None:
                out, compared = res
                out["compared"] = compared
                Path(store, "result.json").write_text(json.dumps(out))
        finally:
            dist.destroy_process_group()
        return None
    store = tempfile.mkdtemp(prefix="perfbench_store_")
    try:
        argv = [sys.executable, str(Path(__file__).resolve().parents[1]
                                    / "run.py")] + cell["argv"] + [
            "--store", store]
        if cell.get("overrides"):
            Path(store, "overrides.json").write_text(
                json.dumps(cell["overrides"]))
            argv += ["--overrides", str(Path(store, "overrides.json"))]
        rc = _launch(argv, world, log,
                     GROUP_TIMEOUT_S + 60 * (check_seeds or 0))
        if rc == 3:
            log("a rank found a forbidden module loaded: no result")
            raise SystemExit(3)
        if rc:
            raise RuntimeError("the ranks did not all finish")
        res = json.loads(Path(store, "result.json").read_text())
    finally:
        shutil.rmtree(store, ignore_errors=True)
    compared = {k: tuple(v) for k, v in res.pop("compared").items()}
    return res, compared
