"""The port's multi-process job, data-parallel evaluation and serving on 2
gloo ranks (``tests/_torch_dist_worker.py``), against the JAX package:
``initialize``'s non-degraded path and the job's rank and size,
``shard_frames_across_hosts``' defaults, ``make_global_mesh``,
``device_calc_stats(mesh=)`` over frames that are not a dp multiple
(counters exact, accuracies within 1e-6 of ``mesh=None`` and of the JAX
package's mesh path, ``tests/test_parallel.py``), the segmentation
functions with ``mesh=`` (counters exact, cumulative IoU within 1e-12 of
the host evaluator, ``tests/test_segmentation_device.py``),
``all_hosts_stats`` (equal on both ranks and to the sequential
``add_stats`` oracle of ``tests/_distributed_worker.py``) and
``shard_inference`` of a PointPillars TINY detector (equal to eager
requests)."""

import numpy as np
import pytest
import torch

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp

from d3d_tpu import benchmarks as JBM
from d3d_tpu import benchmarks_device as JBD
from d3d_tpu import parallel as JP
from d3d_tpu.dataset.kitti.utils import KittiObjectClass as JK
from d3d_tpu.models import PointPillars as JPointPillars
from d3d_tpu.models import PointPillarsConfig as JConfig

from d3d_tpu_torch.benchmarks import SegmentationEvaluator
from d3d_tpu_torch.models import PointPillarsConfig as TConfig
from d3d_tpu_torch.models import pointpillars_state_from_flax

from _distributed_worker import build_host_stats
from _torch_dist_worker import Group
from test_torch_abstraction import twin_arrays, twin_columns
from test_torch_benchmarks import _perturbed
from test_torch_segmentation import CLASSES as SEG_CLASSES, _frames

DET_CLASSES = ("Car", "Van")
PP_TINY = dict(bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0), grid=(32, 32),
               max_pillars=256, max_points_per_pillar=16, pfn_features=32,
               backbone_channels=(32,), backbone_blocks=(1,),
               upsample_channels=32)


def _det_bank(seed=5, nframes=5):
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for _ in range(nframes):
        gt = twin_columns(rng, 6, labels=(1, 2), spread=20.0)
        gts.append(gt)
        dts.append(_perturbed(rng, gt))
    return gts, dts


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    out = tmp_path_factory.mktemp("distributed")
    gts, dts = _det_bank()
    seg = _frames(4)
    rng = np.random.default_rng(9)
    clouds = np.stack([np.stack([
        rng.uniform(0, 16, 1024), rng.uniform(-8, 8, 1024),
        rng.uniform(-3, 1, 1024), rng.uniform(0, 1, 1024)], axis=1)
        for _ in range(4)]).astype(np.float32)
    cfg = JConfig(**PP_TINY)
    variables = jax.jit(JPointPillars(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 16, 9), jnp.float32),
        jnp.zeros((1, 256, 2), jnp.int32), jnp.zeros((1, 256), bool))
    torch.save(dict(
        outdir=str(out), det=dict(classes=DET_CLASSES, gt=gts, dt=dts),
        seg=dict(classes=SEG_CLASSES, frames=seg),
        pp_cfg=TConfig(**PP_TINY),
        pp_state=pointpillars_state_from_flax(variables),
        clouds=torch.as_tensor(clouds)), out / "inputs.pt")
    group = Group("eval", 2, out)

    # the JAX package's mesh path and the host oracles meanwhile
    jev = JBM.DetectionEvaluator([JK[c] for c in DET_CLASSES], [0.3, 0.5],
                                 pr_sample_count=10)
    jg = [twin_arrays(c, frame="t")[0] for c in gts]
    jd = [twin_arrays(c, frame="t")[0] for c in dts]
    keys = [JK[c].value for c in DET_CLASSES]
    jax_det = {k: np.asarray(v) for k, v in JP.stats_to_arrays(
        JBD.device_calc_stats(jev, jg, jd,
                              mesh=JP.make_mesh(2, dp=2, tp=1)),
        keys).items()}
    host = SegmentationEvaluator(SEG_CLASSES, min_points=2)
    for g, p, gi, pi in zip(*seg):
        host.add_stats(host.calc_stats(g, p, gi, pi))
    oracle = JBM.DetectionEvaluator([JK.Car], [0.3], pr_sample_count=8)
    for pid in range(2):
        build_host_stats(oracle, pid)
    merge = {k: np.asarray(v) for k, v in JP.stats_to_arrays(
        oracle.get_stats(), [JK.Car.value]).items()}
    return dict(ranks=group.results(), jax_det=jax_det,
                seg_host=host.get_stats(), merge_oracle=merge)


def test_initialize_process_and_frame_defaults(case):
    for rank, r in enumerate(case["ranks"]):
        assert r["initialize_again"] is False
        assert r["process"] == (rank, 2)
        assert r["frames"] == list(range(rank, 7, 2))


def test_global_mesh_spans_the_world(case):
    for r in case["ranks"]:
        assert r["global"] == [{"dp": 1, "tp": 2}, {"dp": 2, "tp": 1}]


def _same_det(got, want, ctx):
    for k in ("ngt", "ndt", "tp", "fp", "fn"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{ctx} {k}")
    for k in ("acc_iou", "acc_angular", "acc_dist", "acc_box", "acc_var"):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                      err_msg=f"{ctx} {k}")
        ok = ~np.isnan(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=1e-6,
                                   err_msg=f"{ctx} {k}")


def test_device_calc_stats_mesh_equals_plain_and_jax(case):
    for r in case["ranks"]:
        assert int(r["det_mesh"]["tp"].sum()) > 0
        _same_det(r["det_mesh"], r["det_plain"], "mesh vs plain")
        _same_det(r["det_mesh"], case["jax_det"], "mesh vs jax")


def test_segmentation_mesh_equals_the_host_evaluator(case):
    want = case["seg_host"]
    for r in case["ranks"]:
        for f in ("tp", "fp", "fn", "itp", "ifp", "ifn"):
            for k in SEG_CLASSES:
                assert r["seg"][f][k] == getattr(want, f)[k], (f, k)
        for f in ("tp", "fp", "fn"):
            for k in SEG_CLASSES:
                assert r["sem"][f][k] == getattr(want, f)[k], (f, k)
        for k in SEG_CLASSES:
            assert r["seg"]["cumiou"][k] == pytest.approx(
                want.cumiou[k], rel=1e-12, abs=0.0), k
        assert any(r["seg"]["itp"][k] > 0 for k in SEG_CLASSES)


def test_all_hosts_stats_equal_on_both_and_to_the_oracle(case):
    a, b = (r["merged"] for r in case["ranks"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k, w in case["merge_oracle"].items():
        g = a[k]
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                          err_msg=k)
            ok = ~np.isnan(w)
            np.testing.assert_allclose(g[ok], w[ok], rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("n", [4, 3])
def test_shard_inference_equals_eager_requests(case, n):
    for r in case["ranks"]:
        res = r[f"serve_{n}"]
        assert res["equal"]
        assert all(s[0] == n for s in res["shapes"])
