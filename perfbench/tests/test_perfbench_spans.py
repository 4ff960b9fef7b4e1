"""CPU tests of the readers of the port's spans (``core/spans.py``): the
idle milliseconds and launches of each stage on a synthetic trace whose
answer is known, and the tiny serving run, whose idle metrics sum to its
traced window's idle time.

    python -m pytest perfbench/tests -q
"""

import contextlib
import io
import json

import pytest

from perfbench import run as bench
from perfbench.core import spans
from perfbench.core.trace import Trace, union
from perfbench.tests import _tiny

IDLE = ["idle_ms_voxelize.serve", "idle_ms_network.serve",
        "idle_ms_select.serve", "idle_ms_readout.serve",
        "idle_ms_unspanned.serve"]
LAUNCHES = ["launches_voxelize.serve", "launches_network.serve",
            "launches_select.serve"]


def _trace(host, device, wall_s):
    tr = Trace.__new__(Trace)
    tr.t0_ns, tr.wall_s, tr.host, tr.device = 0, wall_s, host, device
    tr.busy = union((s, e) for _, s, e in device)
    return tr


def _frame(t):
    """One request starting at ``t`` ns and lasting 1000 ns: its spans,
    three launches and the device's work (busy 150-300, 400-500 and
    700-750 after ``t``)."""
    host = [("d3d.detect", t, t + 1000),
            ("d3d.detect.upload", t + 10, t + 60),
            ("d3d.detect.voxelize", t + 60, t + 200),
            ("d3d.detect.network", t + 200, t + 600),
            ("d3d.detect.select", t + 600, t + 800),
            ("d3d.detect.readback", t + 800, t + 900),
            ("d3d.detect.assemble", t + 900, t + 980),
            ("cudaMemcpyAsync", t + 20, t + 30),
            ("cudaLaunchKernel", t + 210, t + 220),
            ("cuLaunchKernel", t + 610, t + 620),
            ("cudaLaunchHostFunc", t + 630, t + 640),
            ("aten::add", t + 300, t + 350)]
    device = [("memcpy", t + 150, t + 300), ("kernel", t + 400, t + 500),
              ("kernel", t + 700, t + 750)]
    return host, device


def test_synthetic_trace_gives_each_stage_its_idle_and_launches():
    host, device = [], []
    for t in (5000, 6000):
        h, d = _frame(t)
        host += h
        device += d
    ctx = dict(trace=_trace(host, device, 2000e-9), traced_frames=[0, 1])
    # a frame's idle: upload 10-60 and voxelize 60-150 -> 140 (with the
    # 10 ns before upload unspanned); network 300-400 and 500-600 -> 200;
    # select 600-700 and 750-800 -> 150; readout 800-980 -> 180;
    # unspanned 0-10 and 980-1000 -> 30
    want = dict(voxelize=140, network=200, select=150, readout=180,
                unspanned=30)
    for stage, ns in want.items():
        assert spans.idle_ms(ctx, stage) == pytest.approx(ns / 1e6)
    assert sum(want.values()) == 1000 - 300
    assert spans.launches(ctx, "voxelize") == 1
    assert spans.launches(ctx, "network") == 1
    assert spans.launches(ctx, "select") == 1
    assert spans.launches(ctx, "readout") == 0
    # the parent program records no spans: nothing to read
    bare = dict(ctx, trace=_trace([r for r in host if r[0][:3] != "d3d"],
                                  device, 2000e-9))
    assert spans.idle_ms(bare, "network") is None
    assert spans.launches(bare, "network") is None
    # no device operations (a CPU run): idle reads, launches do not
    cpu = dict(ctx, trace=_trace(host, [], 2000e-9))
    assert spans.idle_ms(cpu, "network") == pytest.approx(400 / 1e6)
    assert spans.launches(cpu, "network") is None


def test_serving_run_idle_metrics_sum_to_the_window(monkeypatch):
    seen = {}
    read = bench.read_metric

    def spy(name, ctx):
        seen["frames"] = len(ctx["traced_frames"])
        return read(name, ctx)

    monkeypatch.setattr(bench, "read_metric", spy)
    buf_out = io.StringIO()
    with contextlib.redirect_stdout(buf_out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = bench.main(["--workload", "pointpillars_kitti_f32.serve",
                         "--seed", "2147484011", "--seconds", "0.2",
                         "--trace", "1"], device="cpu",
                        overrides=_tiny.SERVE)
    assert rc == 0
    res = json.loads(buf_out.getvalue().strip().splitlines()[-1])
    metrics = res["metrics"]
    assert set(IDLE) <= set(metrics)
    assert not set(LAUNCHES) & set(metrics)
    dev = res["device"]
    idle_ms = (dev["window_s"] - dev["busy_s"]) * 1e3 / seen["frames"]
    assert sum(metrics[m]["value"] for m in IDLE) == pytest.approx(
        idle_ms, rel=1e-6)
    assert metrics["idle_ms_network.serve"]["value"] > 0
