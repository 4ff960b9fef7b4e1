"""Tiny versions of the benchmark's configurations and mixes, for the CPU
tests: the same code paths at sizes a test run holds."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _conf(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())


PP_MODEL = dict(_conf("pointpillars_kitti_f32")["model"],
                bounds=[0.0, 20.48, -10.24, 10.24, -3.0, 1.0], grid=[64, 64],
                max_pillars=1500, max_points_per_pillar=16, pfn_features=16,
                backbone_channels=[16, 32, 64], backbone_blocks=[2, 2, 2],
                upsample_channels=16)
FRAME = {"objects": 6, "az_step_deg": 0.5}

SERVE = dict(model=PP_MODEL, pool=2, check_frames=2, trace_seconds=0.5,
             frame=FRAME, workers=1)
TRAIN = dict(model=PP_MODEL, pool_per_chip=4, batch_per_chip=2, frame=FRAME,
             workers=1, warm_steps=1, trace_steps=1)
