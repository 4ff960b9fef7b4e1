"""CPU tests of the benchmark: what it may import, its reference against
the port at tiny sizes, its work counts, its result line, and the output
check failing on faults planted in the timed path.

    python -m pytest perfbench/tests -q
"""

import ast
import contextlib
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import run as bench
from perfbench.core import check, frames, weights
from perfbench.core.serve import Reference, _classes
from perfbench.families import pointpillars as pp_fam
from perfbench.reference import pointpillars as pp_ref
from perfbench.tests import _tiny

PERFBENCH = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PERFBENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_imports_no_jax(path):
    """No file of the benchmark imports JAX, flax, optax or the JAX
    package, by whole top-level name; the reference imports nothing of
    the port either."""
    names = set(_imports(path))
    assert not names & set(bench.FORBIDDEN)
    if "reference" in path.parts:
        assert "d3d_tpu_torch" not in names


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "d3d_tpu_torch_like", object())
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "d3d_tpu.ops", object())
    assert bench.forbidden_modules() == ["d3d_tpu"]


def _weights(fam, conf, pool, seed=5):
    cfg = fam.port_config(conf)
    port = fam.port_model(cfg, torch.device("cpu"))
    state = weights.make_state(port.state_dict(), fam.fan_in, fam.HEADS,
                               seed, torch.device("cpu"))
    ref = Reference(fam, conf, state, torch.device("cpu"))
    weights.calibrate(state, [o[0] for o in ref.raw(pool[0])], fam.HEADS,
                      **conf["heads"])
    port.load_state_dict(state)
    return cfg, port.eval(), ref


def _conf(name, model):
    conf = json.loads((PERFBENCH / "configs" / f"{name}.json").read_text())
    conf["model"] = model
    return conf


@pytest.fixture(scope="module")
def pool():
    return frames.make_pool(12, 2, frame=_tiny.FRAME, workers=1)


def test_pointpillars_detections_match_reference(pool):
    conf = _conf("pointpillars_kitti_f32", _tiny.PP_MODEL)
    cfg, port, ref = _weights(pp_fam, conf, pool)
    detect = pp_fam.port_detector(port, cfg, pp_fam.port_anchors(
        cfg, torch.device("cpu")), _classes(), conf["detector"],
        torch.device("cpu"))
    det = conf["detector"]
    for pts in pool:
        rows = detect(pts).to_numpy().reshape(-1, 9)
        assert len(rows)
        gap = check.frame_gap(rows, *ref.anchors_out(pts), det["top_k"],
                              det["iou_threshold"], det["score_threshold"])
        assert gap < 1e-5


def test_train_step_matches_reference():
    """One rank's three program steps (Trainer over make_train_step)
    against the reference's, on the CPU."""
    from perfbench.core import train

    cell = bench.load_cell("pointpillars_kitti_f32.train_dp4",
                           overrides=_tiny.TRAIN)
    msgs = []
    out, compared = train.rank_main(cell, 21, 0.5, False,
                                    torch.device("cpu"), 0, 1, msgs.append)
    for name, (value, _) in compared.items():
        assert value < 1e-3, (name, value, msgs)
    assert out["train_frames_per_s"] > 0


def test_pointpillars_flops_by_hand():
    model = dict(_tiny.PP_MODEL, grid=[8, 6], backbone_channels=[4, 8],
                 backbone_blocks=[2, 1], upsample_channels=3,
                 pfn_features=5, max_pillars=7, max_points_per_pillar=2)
    macs = 7 * 2 * 9 * 5                       # PFN
    macs += 8 * 6 * 9 * (5 * 4 + 4 * 4)        # block 0 at 8x6
    macs += 8 * 6 * 4 * 3                      # its 1x1 upsample
    macs += 4 * 3 * 9 * 4 * 8                  # block 1 at 4x3
    macs += 4 * 3 * 4 * 8 * 3                  # its 2x2 transposed conv
    macs += 8 * 6 * 6 * 2 * (1 + 7 + 2)        # heads, 2 anchors a cell
    assert pp_ref.dense_flops(model) == 2 * macs


def _run(argv, overrides):
    buf_out, buf_err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf_out), \
            contextlib.redirect_stderr(buf_err):
        rc = bench.main(argv, device="cpu", overrides=overrides)
    lines = buf_out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), buf_err.getvalue()


def test_result_line_and_names():
    rc, res, err = _run(["--workload", "pointpillars_kitti_f32.serve",
                         "--seed", "2147483999", "--seconds", "0.5",
                         "--trace", "1"], _tiny.SERVE)
    assert rc == 0
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device",
            "breakdown"} <= set(res)
    assert res["correct"] is True
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes", "busy_s", "window_s"}
    assert err.strip().splitlines()[-1].startswith("[perfbench] check ")
    spec = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    metrics = spec["end_to_end"] + spec["per_layer"]
    for entry in spec["configs"] + spec["workloads"] + metrics:
        assert NAME.match(entry["name"])
    for m in metrics:
        assert UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert (PERFBENCH / "metrics" / f"{m['name']}.py").exists()
    for w in spec["workloads"]:
        assert (PERFBENCH / "traffic" / f"{w['traffic']}.json").exists()


def test_serving_fault_fails_the_check():
    """An answer altered where it is produced."""
    rc, res, _ = _run(["--workload", "pointpillars_kitti_f32.serve",
                       "--seed", "2147484001", "--seconds", "0.5",
                       "--fault", "answer"], _tiny.SERVE)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["detection_gap"]["value"] > 0.1


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "no_exchange",
                                   "stats_unmoved"])
def test_training_fault_fails_the_check(fault, monkeypatch):
    """Four CPU ranks (gloo) through the data-parallel cell's whole run,
    with the timed path broken underneath: a step that leaves its state
    unchanged, half of each rank's rows left out, the exchange between
    ranks left out, the BatchNorm running statistics left where they
    were."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc, res, err = _run(["--workload", "pointpillars_kitti_f32.train_dp4",
                         "--seed", "2147484003", "--seconds", "0.5",
                         "--fault", fault], _tiny.TRAIN)
    assert rc == 0, err[-2000:]
    assert res["correct"] is False, res["checks"]
    if fault == "stats_unmoved":
        gap = res["checks"]["stats_gap"]
        assert gap["value"] > gap["limit"], res["checks"]


@pytest.mark.parametrize("workload,overrides", [
    ("pointpillars_kitti_f32.serve", _tiny.SERVE),
    ("pointpillars_kitti_f32.train_dp4", _tiny.TRAIN)])
def test_forbidden_module_gives_no_result(workload, overrides, monkeypatch):
    """A JAX module loaded in the process that prints the result, or in
    one rank of four (gloo), ends the run with exit code 3 and no
    result."""
    import sys

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    saved = sys.modules.pop("jax", None)
    buf_out, buf_err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(buf_out), \
                contextlib.redirect_stderr(buf_err):
            rc = bench.main(["--workload", workload, "--seed", "2147484005",
                             "--seconds", "0.5", "--fault", "jax"],
                            device="cpu", overrides=overrides)
    except SystemExit as e:
        rc = e.code
    finally:
        sys.modules.pop("jax", None)
        if saved is not None:
            sys.modules["jax"] = saved
    assert rc == 3
    assert buf_out.getvalue().strip() == ""
    assert "forbidden module" in buf_err.getvalue()


def test_check_seeds_reads_each_seed():
    """The output check alone over seeds, no window (one CPU rank)."""
    from perfbench.core import train

    cell = bench.load_cell("pointpillars_kitti_f32.train_dp4",
                           overrides=_tiny.TRAIN)
    msgs = []
    out, compared = train.check_only(cell, [31, 32], torch.device("cpu"), 0,
                                     1, msgs.append)
    assert out["attempted"] == 2
    assert sum(m.startswith("seed ") for m in msgs) == 2
    assert set(compared) == {"loss_gap", "grad_gap", "update_gap",
                             "stats_gap"}
    for name, (value, limit) in compared.items():
        assert value <= limit, (name, value, msgs)


def test_frame_seeds_take_large_seeds():
    a = frames.kitti_like_points(frames.frame_seed(2 ** 31 + 17, 0, 3),
                                 az_step_deg=1.0)
    b = frames.kitti_like_points(frames.frame_seed(2 ** 31 + 17, 0, 3),
                                 az_step_deg=1.0)
    assert np.array_equal(a, b)
