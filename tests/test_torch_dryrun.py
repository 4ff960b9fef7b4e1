"""``d3d_tpu_torch.dryrun`` against the JAX package's entry points
(``__graft_entry__.py``).

The dry run's 8 gloo ranks (dp2 x sp2 x tp2; pp 4 x dp 2; dp 4 x ep 2)
start from the flax init of the JAX function's PointPillars, carried over
by ``models/convert.py``, and draw every input from the same numpy
generator. The JAX side runs ``shard_train_step`` on ``make_mesh(8,
sp=2)`` over the 8 virtual CPU devices of ``tests/conftest.py`` on the
same ``_make_batch`` arrays, and the self-match AP is the JAX
evaluator's exactly.

The port's one-step loss is held within 1e-5 (relative) of the JAX
package's float64 step on ``make_mesh(8, dp=4, sp=2, tp=1)``: the same 8
devices and sp split, whose loss equals the JAX one-device and dp4 x tp2
steps' to 1e-14. On the dry run's own dp2 x sp2 x tp2 mesh the JAX
package's loss is 9.5e-5 off those, in float64 too (XLA:CPU's SPMD
partitioning of the constrained canvas with tp-split weights; ROADMAP
queue 3, F5), so there the port is held to ``tests/test_parallel.py``'s
own sp bound, rtol 2e-4.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _limits import time_limit

import jax
import jax.numpy as jnp
import optax

import __graft_entry__ as graft
from d3d_tpu import parallel as JP
from d3d_tpu.abstraction import ObjectTag as JTag
from d3d_tpu.abstraction import ObjectTarget3D as JTarget
from d3d_tpu.abstraction import Target3DArray as JArray
from d3d_tpu.benchmarks import DetectionEvaluator as JEvaluator
from d3d_tpu.benchmarks_device import device_calc_stats as j_device_stats
from d3d_tpu.dataset.kitti.utils import KittiObjectClass as JK
from d3d_tpu.models import PointPillars as JPointPillars
from d3d_tpu.models import PointPillarsConfig as JConfig
from d3d_tpu.models import make_anchors as j_make_anchors
from d3d_tpu.models import make_train_step as j_make_train_step

from d3d_tpu_torch import dryrun


def _jax_loss(cfg, variables, batch, mesh, dtype):
    """The JAX package's ``shard_train_step`` loss (the dry run's step)
    on ``mesh``, in ``dtype``."""
    c = dataclasses.replace(cfg, dtype=dtype)
    cast = (lambda t: jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64)
        if dtype == "float64" and np.asarray(a).dtype == np.float32
        else jnp.asarray(a), t))
    opt = optax.adam(1e-3)
    step = j_make_train_step(
        JPointPillars(c, constrain=JP.spatial_constrain(mesh)), opt, c,
        j_make_anchors(c), riou_weight=0.1)
    params = cast(variables["params"])
    _, _, _, aux = JP.shard_train_step(step, mesh, donate=False)(
        params, cast(variables["batch_stats"]), opt.init(params),
        cast(batch))
    return float(aux["total"])


def _jax_dryrun():
    """The JAX function's step, serving draws and evaluator on 8 devices:
    its loss on the dry run's mesh (float32) and on dp4 x sp2 (float64)
    and its self-match AP; the port's 8 ranks run meanwhile from its flax
    init."""
    from scipy.spatial.transform import Rotation

    cfg = JConfig(**dryrun.DRYRUN_CONFIG)
    mesh = JP.make_mesh(8, sp=2)
    dp = mesh.devices.shape[0]
    rng = np.random.default_rng(0)
    batch = graft._make_batch(rng, cfg, b=max(2 * dp, dp))
    variables = JPointPillars(cfg).init(
        jax.random.PRNGKey(0), batch["features"], batch["coords"],
        batch["valid"])
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(
            dryrun.dryrun_multichip, 8, device="cpu",
            weights={"pointpillars": jax.tree.map(np.asarray, variables)})
        loss = _jax_loss(cfg, variables, batch, mesh, "float32")
        loss64 = _jax_loss(cfg, variables, batch,
                           JP.make_mesh(8, dp=4, sp=2, tp=1), "float64")
        rng.random(4 * 2048 * dp)  # the serving clouds' draws
        frames = []
        for _ in range(2 * dp):
            arr = JArray(frame="velo")
            for i in range(3):
                arr.append(JTarget(
                    rng.uniform(2, 14, 3) * [1, 1, 0] + [0, -7 + i * 5, -1],
                    Rotation.from_euler("Z", rng.uniform(-3, 3)),
                    [3.9, 1.6, 1.56],
                    JTag(JK.Car, scores=float(rng.uniform(0.3, 1)))))
            frames.append(arr)
        ev = JEvaluator([JK.Car], [0.5])
        ev.add_stats(j_device_stats(ev, frames, frames, mesh=mesh))
        want = dict(loss=loss, loss64=loss64, ap=float(ev.ap()[JK.Car]))
        return dict(got=port.result(), want=want)


@pytest.fixture(scope="module")
@time_limit(120)
def runs():
    return _jax_dryrun()


def test_sharded_loss_equals_the_jax_sharded_step(runs):
    got, want = runs["got"], runs["want"]
    assert got["mesh"] == {"dp": 2, "sp": 2, "tp": 2}
    np.testing.assert_allclose(got["loss"], want["loss64"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-4)


def test_self_match_ap_equals_the_jax_evaluator(runs):
    assert runs["got"]["ap"] == runs["want"]["ap"]
    assert runs["got"]["ap"] > 0.99


def test_pipeline_and_expert_branches_run(runs):
    """n % 4 == 0: the SST trunk's GPipe step and SST-MoE's ep step ran,
    their asserts (finite, non-zero block gradients; moe_w1 split over ep)
    held on every rank, and their losses are finite."""
    got = runs["got"]
    assert np.isfinite(got["pp_loss"]) and got["pp_loss"] > 0
    assert np.isfinite(got["ep_loss"])
    assert {"train", "serve", "eval", "pp", "ep"} <= set(got["seconds"])
    # gloo ranks take the kernels' plain versions: nothing launched
    assert not any(got["launches"].values())


def test_sharded_serving_keeps_what_nms2d_keeps(runs):
    """``shard_inference``'s gathered outputs: the dp axis's 2 frames at
    top-k 16, each keep mask equal to ``nms2d`` on the gathered boxes
    (exactly: the same boxes on the same CPU), and no kernel route taken
    on gloo ranks."""
    from d3d_tpu_torch.models.inference import _bev
    from d3d_tpu_torch.ops.nms import nms2d

    boxes, scores, keep = runs["got"]["serve"]
    assert boxes.shape == (2, 16, 7) and scores.shape == (2, 16)
    assert keep.dtype == torch.bool and bool(keep.any())
    for b, s, k in zip(boxes, scores, keep):
        assert torch.equal(k, ~nms2d(_bev(b), s, iou_threshold=0.5,
                                     iou_method="rbox"))
    assert not any(runs["got"]["routes"].values())


def test_batch_equals_the_jax_batch():
    cfg = JConfig(**dryrun.DRYRUN_CONFIG)
    want = graft._make_batch(np.random.default_rng(0), cfg, b=2)
    got = dryrun._make_batch(np.random.default_rng(0), cfg, 2, "cpu")
    for k, v in want.items():
        if k == "features":
            # tests/test_torch_pointpillars.py's bound: the pillar
            # centroid's 16-point sum in another order
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=0, atol=2e-6)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                          err_msg=k)


def test_entry_shapes_equal_the_jax_entry():
    def run():
        fn, args = graft.entry()
        return fn(*args)

    want = [o.shape for o in jax.eval_shape(run)]
    fn, args = dryrun.entry(device="cpu")
    assert [tuple(t.shape) for t in args] == \
        [(1, 8000, 24, 9), (1, 8000, 2), (1, 8000)]
    assert [tuple(o.shape) for o in fn(*args)] == want


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(1)
