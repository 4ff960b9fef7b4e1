"""The serving mixes: one closed-loop client sends one frame a request,
back to back, to the program's ``detect`` for ``seconds``; then the
reference judges a sample of what was served."""

import time

import numpy as np
import torch

from . import check, frames, trace, weights
from ..reference import boxes as refboxes

__all__ = ["run"]


def _classes():
    from d3d_tpu_torch.dataset.kitti import KittiObjectClass

    return [KittiObjectClass.Car]


def _rows(result):
    """A request's detections as rows [label, score, x, y, z, l, w, h,
    yaw]: the program's ``Target3DArray``, or rows already."""
    if isinstance(result, np.ndarray):
        return result.reshape(-1, 9)
    out = result.to_numpy()
    return out.reshape(-1, 9)


class Reference:
    """The plain model of one configuration, on the weights ``state``:
    every anchor's score, box and direction margin of a frame."""

    def __init__(self, fam, conf, state, dev):
        self.fam, self.conf, self.state, self.dev = fam, conf, state, dev
        self.model = conf["model"]
        self.anchors = refboxes.anchors(fam.head_model(self.model)).to(dev)

    @torch.no_grad()
    def raw(self, points, cast=lambda t: t):
        x = self.fam.ref_inputs(torch.from_numpy(points).to(self.dev),
                                self.model)
        return self.fam.ref_forward(self.state, self.model, [x], cast)

    @torch.no_grad()
    def anchors_out(self, points, cast=lambda t: t):
        cls, box, dirl = (o[0] for o in self.raw(points, cast))
        scores = torch.sigmoid(cls).max(dim=-1).values
        boxes = refboxes.decode(self.anchors, box, dirl)
        margin = dirl[:, 1] - dirl[:, 0]
        return (scores.double().cpu().numpy(), boxes.double().cpu().numpy(),
                margin.double().cpu().numpy())

    def detect(self, points, cast=lambda t: t):
        """The reference in the program's place (the control): the
        detector's selection on its own decode, rows as :func:`_rows`."""
        det = self.conf["detector"]
        scores, boxes, _ = self.anchors_out(points, cast)
        kept = refboxes.select(scores, boxes, det["top_k"],
                               det["iou_threshold"], det["score_threshold"])
        return np.concatenate([np.zeros((len(kept), 1)), kept], 1)


def _tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _alter(detect):
    """The answer altered where it is produced: each request's first
    detection moved 0.2 m along x."""
    def altered(points):
        rows = _rows(detect(points)).copy()
        if len(rows):
            rows[0, 2] += 0.2
        return rows
    return altered


def setup(cell, seed, dev, log, control=None, fault=None):
    """Frames, weights, the program's detector (or the control in its
    place), warmed up on every frame of the pool."""
    conf, traffic, fam = cell["conf"], cell["traffic"], cell["family"]
    _tf32(conf["precision"].get("tf32", False))
    t0 = time.perf_counter()
    pool = frames.make_pool(seed, traffic["pool"], frame=traffic["frame"],
                            workers=traffic.get("workers"))
    log(f"pool: {len(pool)} frames, points "
        f"{min(map(len, pool))}-{max(map(len, pool))}, "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cfg = fam.port_config(conf)
    port = fam.port_model(cfg, dev)
    state = weights.make_state(port.state_dict(), fam.fan_in, fam.HEADS,
                               seed, dev)
    ref = Reference(fam, conf, state, dev)
    weights.calibrate(state, [o[0] for o in ref.raw(pool[0])], fam.HEADS,
                      **conf["heads"])
    port.load_state_dict(state)
    if control == "tf32":
        del port
        detect = lambda pts: ref.detect(pts, lambda t: t)   # noqa: E731
        _tf32(True)
    else:
        detect = fam.port_detector(port, cfg, fam.port_anchors(cfg, dev),
                                   _classes(), conf["detector"], dev)
    if fault == "answer":
        detect = _alter(detect)
    t1 = time.perf_counter()
    log(f"weights and detector: {t1 - t0:.1f} s after the pool")
    for pts in pool:
        _rows(detect(pts))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(f"warm-up over the pool: {time.perf_counter() - t1:.1f} s")
    return pool, detect, ref


def window(detect, pool, seconds, start=0):
    """Closed loop for ``seconds``: (results, frame indices, latencies s,
    failed, wall s)."""
    results, idx, lat, failed = [], [], [], 0
    t_start = time.perf_counter()
    t_end = t_start + seconds
    i = start
    while True:
        f = i % len(pool)
        t0 = time.perf_counter()
        try:
            r = detect(pool[f])
        except Exception as exc:           # a request that failed counts
            r, failed = exc, failed + 1
        t1 = time.perf_counter()
        results.append(r)
        idx.append(f)
        lat.append(t1 - t0)
        i += 1
        if t1 >= t_end:
            return results, idx, lat, failed, t1 - t_start


def judge(results, idx, pool, ref, conf, seed, sample):
    """The largest :func:`check.frame_gap` over a sample drawn from the
    seed: for each of ``sample`` frames of the pool, one of its requests.
    Returns (gap, requests judged)."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
    det = conf["detector"]
    _tf32(conf["precision"].get("tf32", False))
    by_frame = {}
    for r, f in zip(results, idx):
        by_frame.setdefault(f, []).append(r)
    chosen = rng.permutation(sorted(by_frame))[:sample]
    gap, n = 0.0, 0
    for f in chosen:
        reqs = by_frame[f]
        r = reqs[rng.integers(len(reqs))]
        if isinstance(r, Exception):
            continue
        scores, boxes, margin = ref.anchors_out(pool[f])
        gap = max(gap, check.frame_gap(_rows(r), scores, boxes, margin,
                                       det["top_k"], det["iou_threshold"],
                                       det["score_threshold"]))
        n += 1
    return gap, n


def run(cell, seed, seconds, traced, dev, log, control=None, fault=None,
        rank=None, store=None):
    """One run of a serving cell. Returns (result fields, the numbers
    compared as {name: (value, limit)})."""
    conf, traffic, fam = cell["conf"], cell["traffic"], cell["family"]
    pool, detect, ref = setup(cell, seed, dev, log, control, fault)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out, results, idx, failed = {}, [], [], 0
    if traced:
        t0_ns = time.time_ns()
        with trace.profile() as prof:
            results, idx, _, failed, wall = window(
                detect, pool, traffic["trace_seconds"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        tr = out["trace"] = trace.Trace(prof, t0_ns, wall)
        out.update(traced_frames=list(idx), busy_s=tr.busy_s(),
                   window_s=wall, breakdown=dict(device_ops=tr.top_ops(),
                                                 idle_gaps=tr.idle_gaps()))
    out["window_epoch"] = time.time()
    r, i, lat, fl, wall = window(detect, pool, seconds, start=len(idx))
    results, idx, failed = results + r, idx + i, failed + fl
    out.update(plain_frames=i, plain_s=wall, pool=pool,
               memory_peak_bytes=(torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else 0),
               attempted=len(results), failed=failed,
               frames_per_s=(len(i) - fl) / wall,
               request_p95_ms=float(np.percentile(lat, 95)) * 1e3)
    del detect
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gap, n = judge(results, idx, pool, ref, conf, seed,
                   traffic["check_frames"])
    log(f"check: {n} requests judged in {time.perf_counter() - t0:.1f} s")
    out["correct"] = failed == 0 and n > 0
    compared = {"detection_gap": (gap, conf["limits"]["detection_gap"])}
    return out, compared
