"""CPU tests of the SECOND cell at a tiny size: its result line, and the
output check failing on an answer altered where it is produced and on a
site cap that binds (the reference has none).

    python -m pytest perfbench/tests/test_perfbench_second.py -q
"""

import json

from perfbench.tests import _tiny
from perfbench.tests.test_perfbench_harness import _run

CELL = "second_kitti_f32.serve"
# the published structure on a 64x64 grid of 0.32 m cells: z 41 -> 21 ->
# 11 -> 5 -> 2, thin channels
MODEL = dict(
    json.loads((_tiny.ROOT / "perfbench" / "configs" / "second_kitti_f32.json")
               .read_text())["model"],
    bounds=[0.0, 20.48, -10.24, 10.24, -3.0, 1.0], grid=[64, 64, 40],
    max_voxels=3000, stage_channels=[8, 8, 16, 16],
    stage_sites=[3000, 8000, 4000, 2000],
    layout=dict(z_extent=41, down_padding=[[1, 1, 1], [1, 1, 1], [1, 1, 0]],
                out_channels=16, out_kernel=[1, 1, 3], out_stride=[1, 1, 2],
                out_sites=1500, bev_channels=[8, 16], bev_convs=[2, 2],
                bev_up_channels=[8, 8]))
SERVE = dict(_tiny.SERVE, model=MODEL)


def test_result_line():
    rc, res, _ = _run(["--workload", CELL, "--seed", "2147483999",
                       "--seconds", "0.5", "--trace", "1"], SERVE)
    assert rc == 0 and res["correct"] is True, res["checks"]
    assert {"launches_per_frame.serve", "mfu.serve",
            "idle_ms_network.serve"} <= set(res["metrics"])


def test_fault_and_binding_cap_fail_the_check():
    rc, res, _ = _run(["--workload", CELL, "--seed", "2147484001",
                       "--seconds", "0.5", "--fault", "answer"], SERVE)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["detection_gap"]["value"] > 0.1
    capped = dict(SERVE, model=dict(MODEL, stage_sites=[3000, 400, 4000,
                                                         2000]))
    rc, res, _ = _run(["--workload", CELL, "--seed", "2147484001",
                       "--seconds", "0.5"], capped)
    assert rc == 0 and res["correct"] is False, res["checks"]
