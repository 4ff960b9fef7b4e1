"""Time the NMS kernels (K1, the scan K2/K3, K4), the whole ``nms2d`` call
and the rule-book build of one checkout of the PyTorch/CUDA port on the
card, for comparing two checkouts in turns (parent, change, change, parent,
one process each)::

    python3 scripts/bench_nms_kernels.py --root build/parent
    python3 scripts/bench_nms_kernels.py --root .

It imports ``d3d_tpu_torch`` and ``chip_smoke`` from ``--root`` (their
inputs and timers), builds that tree's kernels and prints one JSON line.
Every time is device ms by CUDA events over back-to-back launches (``ms``,
chip_smoke.py's measure) with CUPTI's kernel time beside it (``cupti_ms``,
torch.profiler):

- K1 at 100x100, 512x512 and 2048x2048 (the serving paths', the north
  star's and the nms2d-of-2048 path's boxes), through ``_launch`` and
  through its public wrapper (``public_ms``), and, where the tree has it,
  its bit-row form (``bits``) on the boxes in score order;
- the scan at n = 100, 512 and 2048: the route ``nms2d`` runs in the tree
  (``nms2d_route``: the parent's pack + scan of the bool matrix; this
  tree's scan of K1's bit rows with the scores and order) and the public
  bool route (``bool_route``), each with the scan kernel's own CUPTI time
  (``scan_cupti_ms``, kernels named ``scan``);
- the whole ``nms2d`` call at those n, with the kernels and memory
  operations one call puts on the card, counted by torch.profiler;
- K4 at n = 512, linear and gaussian (the soft-NMS path's);
- the rule-book build (``prepare_neighbor_maps``) of a SECOND request's
  five maps and of a training step's five joined maps (chip_smoke.py's
  model and frames), by events over back-to-back builds, around one build
  (``one_build_ms``) and by CUPTI.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch


def kernel_launches(fn):
    """(kernels, memory operations) one call of ``fn`` puts on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    mem = sum(e.count for e in rows if e.key.startswith(("Memcpy", "Memset")))
    return sum(e.count for e in rows) - mem, mem


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the checkout to time")
    root = Path(ap.parse_args().root).resolve()
    if not torch.cuda.is_available():
        print("bench_nms_kernels: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from d3d_tpu_torch.ops import _build, geometry_cuda, geometry_soa
    from d3d_tpu_torch.ops import nms_cuda
    from d3d_tpu_torch.ops.nms import _soft_nms_init, nms2d
    from d3d_tpu_torch.ops.sparse_conv import prepare_neighbor_maps

    dev = torch.device("cuda", 0)
    _build.build()
    bit_rows = hasattr(geometry_cuda, "_bits_launch")
    _, boxes512, scores512 = cs.north_star_frame()
    boxes2048, scores2048 = cs.bench_boxes(np.random.default_rng(7), 2048)
    t512, s512 = (torch.from_numpy(boxes512).to(dev),
                  torch.from_numpy(scores512).to(dev))
    t2048, s2048 = (torch.from_numpy(boxes2048).to(dev),
                    torch.from_numpy(scores2048).to(dev))
    cases = {"n100": (t512[:100].contiguous(), s512[:100].contiguous()),
             "n512": (t512, s512), "n2048": (t2048, s2048)}

    k1, scan, call = {}, {}, {}
    for name, (b, s) in cases.items():
        def launch(b=b):
            return geometry_cuda._launch(b, b)
        k1[name] = dict(
            ms=cs.time_launches(launch),
            cupti_ms=cs.cupti_ms(launch, ("rbox_iou",)),
            public_ms=cs.time_launches(
                lambda b=b: geometry_cuda.rbox_iou_matrix(b, b)))
        _, ov, pre = cs.nms_inputs(b, s, 0.25)
        neg, order = torch.sort(-s, stable=True)
        bo = b[order].contiguous()

        def bool_route(ov=ov, pre=pre):
            return nms_cuda._launch(ov, pre)
        row = dict(bool_route=dict(
            ms=cs.time_launches(bool_route),
            cupti_ms=cs.cupti_ms(bool_route),
            scan_cupti_ms=cs.cupti_ms(bool_route, ("scan",))))
        if bit_rows:
            bits = geometry_cuda._bits_launch(bo, 0.25)
            out = torch.empty(len(b), dtype=torch.bool, device=dev)

            def route(bits=bits, out=out, neg=neg, order=order):
                nms_cuda._scan_launch(bits, out, neg_scores=neg, order=order)

            def k1_bits(bo=bo):
                geometry_cuda._bits_launch(bo, 0.25)
            k1[name]["bits"] = dict(ms=cs.time_launches(k1_bits),
                                    cupti_ms=cs.cupti_ms(k1_bits,
                                                         ("rbox_bits",)))
            row["nms2d_route"] = dict(ms=cs.time_launches(route),
                                      cupti_ms=cs.cupti_ms(route),
                                      scan_cupti_ms=cs.cupti_ms(route,
                                                                ("scan",)))
        else:
            row["nms2d_route"] = row["bool_route"]
        scan[name] = row

        def whole(b=b, s=s):
            return nms2d(b, s, iou_threshold=0.25)
        kernels, mem = kernel_launches(whole)
        call[name] = dict(ms=cs.time_launches(whole),
                          cupti_ms=cs.cupti_ms(whole), kernels=kernels,
                          memory_ops=mem, kept=int((~whole()).sum()))

    iou = geometry_soa._rbox_iou_matrix_plain(t512, t512)
    pre, init = _soft_nms_init(s512, cs.SOFT_NMS_ARGS["score_threshold"])
    k4 = {}
    for method, param in cs.SOFT_NMS_CASES:
        args = (cs.SOFT_NMS_ARGS["iou_threshold"],
                cs.SOFT_NMS_ARGS["score_threshold"], param, method)

        def launch(args=args):
            return nms_cuda._soft_launch(iou, init, pre, *args)
        k4[method] = dict(ms=cs.time_launches(launch),
                          cupti_ms=cs.cupti_ms(launch, ("soft_nms",)),
                          suppressed=int(launch().sum()))

    # the rule books of a SECOND request's maps and a training step's
    model, frames = cs.second_model(dev)
    request = cs.second_layer_inputs(model, frames[0], dev)
    batch = cs.train_batch(dev, model.cfg, [cs.bench_points(
        np.random.default_rng(300 + i)) for i in range(2)])
    step = cs.stage_layer_inputs(model, batch["features"], batch["coords"],
                                 batch["valid"])
    rulebooks = {}
    for name, layers in (("request", request), ("training_step", step)):
        nbrs = cs.distinct_maps(layers)[1]

        def build(nbrs=nbrs):
            prepare_neighbor_maps(nbrs)
        kernels, mem = kernel_launches(build)
        rulebooks[name] = dict(ms=cs.time_launches(build, batch=20),
                               one_build_ms=cs.time_each(build, reps=20),
                               cupti_ms=cs.cupti_ms(build),
                               kernels=kernels, memory_ops=mem,
                               rows=[n.shape[0] for n in nbrs])
    print(json.dumps({"root": str(root), "card": cs.card_line(),
                      "k1": k1, "scan": scan, "nms2d": call, "k4_n512": k4,
                      "rulebooks": rulebooks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
