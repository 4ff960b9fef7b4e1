"""SECOND serving request latency of the port on one GPU, made to compare
two checkouts on one card.

Run from anywhere::

    python3 scripts/second_latency.py [--root DIR] [--requests 40]
        [--label NAME]

It imports ``d3d_tpu_torch`` from ``--root`` (default: the checkout this
script lives in) and takes the seeded model and frames from this
checkout's ``chip_smoke.py`` (``second_model``: ``presets.second_kitti``
at full width, random weights from seed 0 with calibrated heads, four of
``bench.py``'s 120k-point frames), so two checkouts serve the same weights
and frames. It times ``--requests`` requests of ``make_second_detector``
after 5 of warm-up, in f32 (TF32 off) and in the bf16 preset, by the host
clock around each call (numpy in, numpy out: what a caller waits), and
prints one JSON line with the label, the card's name and power limit,
and per dtype the median, the 10th and 90th percentiles and every time.
Run the two checkouts in turns (A B B A A B B A) on one card, one process
each, and compare the runs' medians.
"""

import argparse
import enum
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

# the detectors' class list: an Enum, as detect tags its boxes with it (a
# checkout whose detect returns numpy columns takes it as well)
CLASSES = list(enum.Enum("Classes", "Car"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose d3d_tpu_torch is timed")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("second_latency: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import d3d_tpu_torch
    from d3d_tpu_torch.models import (SECOND, head_config, make_anchors,
                                      make_second_detector, presets)

    if Path(d3d_tpu_torch.__file__).resolve().parents[1] != root:
        print(f"second_latency: imported {d3d_tpu_torch.__file__}, not the "
              f"package of {root}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, frames = smoke.second_model(dev)
    cfg16 = presets.second_kitti()
    model16 = SECOND(cfg16, device=dev)
    model16.load_state_dict(model.state_dict())
    out = dict(label=args.label, root=str(root), card=smoke.card_line(),
               torch=torch.__version__, requests=args.requests)
    for name, m in (("f32", model), ("bf16", model16)):
        detect = make_second_detector(
            m, None, m.cfg, make_anchors(head_config(m.cfg), device=dev),
            CLASSES, device=dev)
        for i in range(5):
            detect(frames[i % 4])
        times = []
        for i in range(args.requests):
            t0 = time.perf_counter()
            detect(frames[i % 4])
            times.append((time.perf_counter() - t0) * 1e3)
        q = statistics.quantiles(times, n=10)
        out[name] = dict(median_ms=statistics.median(times), p10_ms=q[0],
                         p90_ms=q[-1], ms=times)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
