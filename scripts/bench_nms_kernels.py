"""Time the rotated-IoU kernel K1 and the soft-NMS kernel K4 of one
checkout of the PyTorch/CUDA port on the card, for comparing two checkouts
in turns (parent, change, change, parent, one process each)::

    python3 scripts/bench_nms_kernels.py --root build/parent
    python3 scripts/bench_nms_kernels.py --root .

It imports ``d3d_tpu_torch`` and ``chip_smoke`` from ``--root`` (their
inputs and timers), builds that tree's kernels and prints one JSON line:
K1 at 100x100, 512x512 and 2048x2048 (the north star's boxes and the
nms2d-of-2048 path's, as in chip_smoke.py) and K4 at n = 512, linear and
gaussian (the soft-NMS path's), each as device ms per launch by CUDA events
over back-to-back launches (``ms``, chip_smoke.py's measure: K1 on
descriptors where the tree's K1 takes them) and by CUPTI (``cupti_ms``),
and K1 through its public wrapper ``rbox_iou_matrix`` (``public_ms``).
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch


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
    from d3d_tpu_torch.ops.nms import _soft_nms_init

    dev = torch.device("cuda", 0)
    _build.build(["rbox_iou", "soft_nms"])
    _, boxes512, scores512 = cs.north_star_frame()
    boxes2048, _ = cs.bench_boxes(np.random.default_rng(7), 2048)
    t512 = torch.from_numpy(boxes512).to(dev)
    shapes = {"100x100": t512[:100].contiguous(), "512x512": t512,
              "2048x2048": torch.from_numpy(boxes2048).to(dev)}
    k1 = {}
    for name, b in shapes.items():
        if hasattr(geometry_cuda, "_descriptors_cuda"):  # K1 takes boxes
            def launch(b=b):
                return geometry_cuda._launch(b, b)
        else:  # K1 takes the wrapper's torch descriptors
            d = geometry_cuda.box_descriptors(b).contiguous()

            def launch(d=d):
                return geometry_cuda._launch(d, d)
        k1[name] = dict(
            ms=cs.time_launches(launch),
            cupti_ms=cs.cupti_ms(launch, ("rbox_iou",)),
            public_ms=cs.time_launches(
                lambda b=b: geometry_cuda.rbox_iou_matrix(b, b)))

    iou = geometry_soa._rbox_iou_matrix_plain(t512, t512)
    pre, init = _soft_nms_init(torch.from_numpy(scores512).to(dev),
                               cs.SOFT_NMS_ARGS["score_threshold"])
    k4 = {}
    for method, param in cs.SOFT_NMS_CASES:
        args = (cs.SOFT_NMS_ARGS["iou_threshold"],
                cs.SOFT_NMS_ARGS["score_threshold"], param, method)

        def launch(args=args):
            return nms_cuda._soft_launch(iou, init, pre, *args)
        k4[method] = dict(ms=cs.time_launches(launch),
                          cupti_ms=cs.cupti_ms(launch, ("soft_nms",)),
                          suppressed=int(launch().sum()))
    print(json.dumps({"root": str(root), "card": cs.card_line(),
                      "k1": k1, "k4_n512": k4}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
