"""The port's ``parallel`` package against the JAX package's: the mesh
rules and stat merges in this process, and sharded training on gloo ranks
(``tests/_torch_dist_worker.py``): PointPillars TINY, SECOND TINY and the
CenterPoint, BEVSeg, VoxelNeXt and Mono3D TINY steps on a dp2 x tp2 mesh
of 4 ranks, and PointPillars on a dp2 x sp2 mesh with its BEV backbone
split into slabs of rows.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``,
with the flax weights carried to the port by ``models/convert.py``. The
batches' halves differ in their box counts and their points' intensity
scale, so a per-rank positive count or a per-rank BatchNorm would show.
The tolerances are the JAX tests' (``tests/test_parallel.py``): rtol 1e-6
/ atol 1e-7 on the dp x tp loss, rtol 2e-4 on the sp loss. The JAX
package's float32 loss on this batch is itself 1.6e-6 (dp2 x tp2) and
4.4e-6 (one device) off its float64 run, so at 1e-6 the port's float32
loss is held to the JAX package's float64 step on the dp2 x tp2 mesh.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _limits import time_limit

import jax
import jax.numpy as jnp
import optax

from d3d_tpu import parallel as JP
from d3d_tpu.benchmarks import DetectionEvaluator as JEvaluator
from d3d_tpu.dataset.kitti.utils import KittiObjectClass as JK
from d3d_tpu.models import PointPillars as JPointPillars
from d3d_tpu.models import PointPillarsConfig as JConfig
from d3d_tpu.models import SECOND as JSECOND, SECONDConfig as JSConfig
from d3d_tpu.models import SST as JSST, SSTConfig as JSSTConfig
from d3d_tpu.models import make_anchors as j_make_anchors
from d3d_tpu.models.pointpillars import make_train_step as j_make_train_step
from d3d_tpu.models.pointpillars import pillarize as j_pillarize

import d3d_tpu_torch.parallel as TP
from d3d_tpu_torch.benchmarks import DetectionEvaluator as TEvaluator
from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TK
from d3d_tpu_torch.models import PointPillars as TPointPillars
from d3d_tpu_torch.models import PointPillarsConfig as TConfig
from d3d_tpu_torch.models import SECOND as TSECOND, SECONDConfig as TSConfig
from d3d_tpu_torch.models import SST as TSST, SSTConfig as TSSTConfig
from d3d_tpu_torch.models import (pointpillars_params_from_flax,
                                  pointpillars_state_from_flax,
                                  second_params_from_flax,
                                  sst_params_from_flax)
from d3d_tpu_torch.parallel import mesh as TMesh
from d3d_tpu_torch.train import shard_frames_across_hosts

from _torch_dist_worker import Group

TINY = dict(bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0), grid=(32, 32),
            max_pillars=256, max_points_per_pillar=16, pfn_features=32,
            backbone_channels=(32, 64), backbone_blocks=(1, 1),
            upsample_channels=32)


def _pp_batch(seed=0, b=4):
    """The parent's PointPillars batch (JAX pillarize of seeded clouds;
    the second half's intensities 4x, one gt box instead of three)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([np.stack([
        rng.random(2048) * 16, rng.random(2048) * 16 - 8,
        rng.random(2048) * 4 - 3,
        rng.random(2048) * (1.0 if i < b // 2 else 4.0)], axis=1)
        for i in range(b)]).astype(np.float32)
    cfg = JConfig(**TINY)
    feats, coords, valid = jax.vmap(
        lambda p: j_pillarize(p, cfg))(jnp.asarray(pts))
    m = 3
    gt = np.stack([np.stack([
        rng.random(m) * 12 + 2, rng.random(m) * 12 - 6, np.full(m, -1.0),
        np.full(m, 3.9), np.full(m, 1.6), np.full(m, 1.56),
        rng.random(m) * np.pi - np.pi / 2], axis=1)
        for _ in range(b)]).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[b // 2:, 1:] = False
    return dict(features=np.asarray(feats), coords=np.asarray(coords),
                valid=np.asarray(valid), gt_boxes=gt,
                gt_labels=np.zeros((b, m), np.int32), gt_mask=mask)


def _to_torch(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
@time_limit(120)
def pp_jax():
    """JAX PointPillars TINY variables and batch; the JAX shard_train_step
    losses on dp2 x tp2, dp4 and dp2 x sp2."""
    batch = _pp_batch()
    cfg = JConfig(**TINY)
    model = JPointPillars(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    batch["features"], batch["coords"],
                                    batch["valid"])
    opt = optax.adam(1e-3)

    def loss(mesh, constrain=None, dtype="float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        step = j_make_train_step(JPointPillars(c, constrain=constrain),
                                 opt, c, j_make_anchors(c), riou_weight=0.1)
        fn = JP.shard_train_step(step, mesh, donate=False, check_tp=False)
        cast = (lambda t: jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64)
            if dtype == "float64" and np.asarray(a).dtype == np.float32
            else jnp.asarray(a), t))
        params = cast(variables["params"])
        _, _, _, aux = fn(params, cast(variables["batch_stats"]),
                          opt.init(params), cast(batch))
        return float(aux["total"])

    sp_mesh = JP.make_mesh(4, dp=2, sp=2, tp=1)
    return dict(batch=batch, variables=variables,
                loss_tp=loss(JP.make_mesh(4, dp=2, tp=2), dtype="float64"),
                loss_dp=loss(JP.make_mesh(4, dp=4, tp=1)),
                loss_sp=loss(sp_mesh, JP.spatial_constrain(sp_mesh)))


_BOUNDS = (0.0, 16.0, -8.0, 8.0, -3.0, 1.0)
CP_TINY = dict(bounds=_BOUNDS, grid=(32, 32), max_pillars=256,
               max_points_per_pillar=16, pfn_features=32,
               backbone_channels=(32, 64), backbone_blocks=(1, 1),
               upsample_channels=32, head_channels=16, window=9, top_k=8)
BEV_TINY = dict(bounds=_BOUNDS, grid=(32, 32), max_pillars=256,
                max_points_per_pillar=16, pfn_features=16,
                enc_channels=(16, 32), enc_blocks=(1, 1), dec_channels=16,
                num_classes=4, ignore_index=0, panoptic=True,
                thing_classes=(1, 2), max_instances=8, center_sigma=1.0,
                center_radius=2.0)
VN_TINY = dict(bounds=_BOUNDS, grid=(32, 32, 8), max_voxels=512,
               stage_channels=(8, 16, 32), stage_sites=(512, 256, 128),
               subm_per_stage=1, bev_sites=128, head_channels=16,
               num_classes=2, top_k=16)
MONO_TINY = dict(image_size=(96, 128), stride=4,
                 backbone_channels=(8, 16, 32), head_channels=16,
                 num_classes=2, top_k=8,
                 dim_priors=((3.88, 1.63, 1.53), (0.84, 0.66, 1.76)))
FAMILIES = ("centerpoint", "bevseg", "voxelnext", "mono3d")


def _family_batches(b=4):
    """Batches of 4 frames whose halves differ: the first two frames hold
    three boxes (BEVSeg: three instances, few unlabelled points), the
    last two one box (one instance, a third of the points unlabelled)
    and 4x the intensities. Pillars and voxels by the port (held to the
    JAX package's in the families' own test files)."""
    from d3d_tpu_torch.models import (bevseg_pillarize, pillarize,
                                      point_cell_coords, voxelnext_voxelize)
    from d3d_tpu_torch.models import BEVSegConfig as TBC
    from d3d_tpu_torch.models import CenterPointConfig as TCC
    from d3d_tpu_torch.models import VoxelNeXtConfig as TVC

    rng = np.random.default_rng(16)
    n = 2048
    clouds = np.stack([np.stack([
        rng.random(n) * 16, rng.random(n) * 16 - 8, rng.random(n) * 4 - 3,
        rng.random(n) * (1.0 if i < b // 2 else 4.0)], axis=1)
        for i in range(b)]).astype(np.float32)
    m = 3
    gt = np.stack([np.stack([
        rng.random(m) * 12 + 2, rng.random(m) * 12 - 6, np.full(m, -1.0),
        np.full(m, 3.9), np.full(m, 1.6), np.full(m, 1.56),
        rng.random(m) * np.pi - np.pi / 2], axis=1)
        for _ in range(b)]).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[b // 2:, 1:] = False
    labels = rng.integers(0, 2, (b, m)).astype(np.int32)
    boxes = dict(gt_boxes=gt, gt_labels=labels, gt_mask=mask)

    def stack(fn, cfg):
        frames = [fn(torch.from_numpy(c), cfg) for c in clouds]
        return {k: torch.stack([f[i] for f in frames]).numpy()
                for i, k in enumerate(("features", "coords", "valid"))}

    out = {"centerpoint": dict(stack(pillarize, TCC(**CP_TINY)),
                               gt_boxes=gt, gt_labels=np.zeros_like(labels),
                               gt_mask=mask),
           "voxelnext": dict(stack(voxelnext_voxelize, TVC(**VN_TINY)),
                             **boxes)}
    bcfg = TBC(**BEV_TINY)
    sem = np.full((b, n), 3, np.int32)
    inst = np.zeros((b, n), np.int32)
    pts = clouds.copy()
    for i in range(b):
        for k in range(3 if i < b // 2 else 1):
            s = slice(k * 200, (k + 1) * 200)
            pts[i, s, :2] = gt[i, k, :2] + rng.normal(0, 0.4, (200, 2))
            sem[i, s], inst[i, s] = 1 + k % 2, k + 1
        sem[i, rng.random(n) < (0.04 if i < b // 2 else 0.33)] = 0
    out["bevseg"] = dict(
        stack(bevseg_pillarize, bcfg), points=pts, labels=sem,
        inst_ids=inst, point_coords=np.stack([point_cell_coords(
            torch.from_numpy(p[:, :3]), bcfg).numpy() for p in pts]))
    k = np.array([[60.0, 0.0, 64.0], [0.0, 60.0, 48.0], [0.0, 0.0, 1.0]],
                 np.float32)
    cam = gt[..., [1, 2, 0, 3, 4, 5, 6]] * [-1, -1, 1, 1, 1, 1, 1]
    cam[..., 1] = 1.5
    out["mono3d"] = dict(
        images=rng.random((b, *MONO_TINY["image_size"], 3)).astype(
            np.float32),
        intrinsics=np.stack([k] * b), gt_boxes=cam.astype(np.float32),
        gt_labels=labels, gt_mask=mask)
    return out


@pytest.fixture(scope="module")
@time_limit(120)
def fam_jax():
    """The families' batches, flax weights (CenterPoint, BEVSeg,
    VoxelNeXt) carried to the port, and the JAX package's
    ``shard_train_step`` loss on a dp2 x tp2 mesh of its CPU devices;
    Mono3D, which the JAX package does not shard, from the port's own
    seeded initialisation."""
    from d3d_tpu.models import BEVSeg as JB, BEVSegConfig as JBC
    from d3d_tpu.models import CenterPoint as JC, CenterPointConfig as JCC
    from d3d_tpu.models import VoxelNeXt as JV
    from d3d_tpu.models.bevseg import make_train_step as jb_step
    from d3d_tpu.models.centerpoint import make_train_step as jc_step
    from d3d_tpu.models.voxelnext import VoxelNeXtConfig as JVC
    from d3d_tpu.models.voxelnext import make_train_step as jv_step
    from d3d_tpu_torch.models import (BEVSeg, BEVSegConfig, CenterPoint,
                                      CenterPointConfig, Mono3D,
                                      Mono3DConfig, VoxelNeXt,
                                      VoxelNeXtConfig,
                                      bevseg_state_from_flax,
                                      centerpoint_state_from_flax,
                                      voxelnext_state_from_flax)

    batches = _family_batches()
    mesh = JP.make_mesh(4, dp=2, tp=2)
    opt = optax.adam(1e-3)
    fams, losses = {}, {}
    for name, jcls, jcfg, jstep, tcls, tcfg, conv, args in (
            ("centerpoint", JC, JCC(**CP_TINY), jc_step, CenterPoint,
             CenterPointConfig(**CP_TINY), centerpoint_state_from_flax,
             ("features", "coords", "valid")),
            ("bevseg", JB, JBC(**BEV_TINY), jb_step, BEVSeg,
             BEVSegConfig(**BEV_TINY), bevseg_state_from_flax,
             ("features", "coords", "valid", "point_coords")),
            ("voxelnext", JV, JVC(**VN_TINY), jv_step, VoxelNeXt,
             VoxelNeXtConfig(**VN_TINY), voxelnext_state_from_flax,
             ("features", "coords", "valid"))):
        batch = batches[name]
        model = jcls(jcfg)
        variables = jax.jit(model.init)(
            jax.random.PRNGKey(0), *(jnp.asarray(batch[k]) for k in args))
        fn = JP.shard_train_step(jstep(model, opt, jcfg), mesh,
                                 donate=False, check_tp=False)
        _, _, _, aux = fn(variables["params"], variables["batch_stats"],
                          opt.init(variables["params"]),
                          {k: jnp.asarray(v) for k, v in batch.items()})
        losses[name] = {k: float(v) for k, v in aux.items()}
        fams[name] = (tcls, tcfg, conv(variables), _to_torch(batch))
    mcfg = Mono3DConfig(**MONO_TINY)
    mono = Mono3D(mcfg, device="cpu",
                  generator=torch.Generator().manual_seed(4))
    fams["mono3d"] = (Mono3D, mcfg, mono.state_dict(),
                      _to_torch(batches["mono3d"]))
    return dict(families=fams, losses=losses)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, pp_jax, fam_jax):
    """The dp x tp and dp x sp groups' results (4 ranks each, in turn)."""
    out = tmp_path_factory.mktemp("parallel")
    torch.save(dict(pp_cfg=TConfig(**TINY),
                    pp_state=pointpillars_state_from_flax(pp_jax["variables"]),
                    pp_batch=_to_torch(pp_jax["batch"]),
                    families=fam_jax["families"]), out / "inputs.pt")
    dp_tp = Group("dp_tp", 4, out)
    dp_sp = Group("dp_sp", 4, out)
    return dict(dp_tp=dp_tp.results(), dp_sp=dp_sp.results())


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_all_equals_the_jax_package():
    assert sorted(TP.__all__) == sorted(JP.__all__)
    assert "shard_inference" in TMesh.__all__


def test_microbatch_round_trip():
    x = {"a": torch.arange(24.0).reshape(6, 4), "b": torch.arange(6)}
    mb = TP.microbatch(x, 3)
    assert mb["a"].shape == (3, 2, 4) and mb["b"].shape == (3, 2)
    back = TP.unmicrobatch(mb)
    for k in x:
        assert torch.equal(back[k], x[k])
    with pytest.raises(ValueError, match="divisible"):
        TP.microbatch(x, 4)


def test_initialize_without_a_group_or_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert TP.initialize() is False
    assert TP.initialize(num_processes=1) is False
    assert TP.process_count() == 1 and TP.process_index() == 0


def test_shard_frames_across_hosts_single_process_defaults():
    assert list(shard_frames_across_hosts(range(7))) == list(range(7))
    assert list(shard_frames_across_hosts(range(7), 1, 3)) == [1, 4]


def test_mesh_needs_a_group_and_a_cuda_default():
    with pytest.raises(RuntimeError, match="process group"):
        TP.make_mesh()


class _Shape:
    """A stand-in mesh: the rules read only ``mesh.shape``."""

    def __init__(self, **shape):
        self.shape = shape


def _leaf_names(params, from_flax):
    """{JAX leaf path: port parameter name} through the bridge: each flax
    leaf filled with its own index comes out under the port's name."""
    flat = jax.tree_util.tree_leaves_with_path(params)
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(np.shape(x), i, np.float32) for i, (_, x) in
         enumerate(flat)])
    port = from_flax(tagged)
    by_index = {int(v.reshape(-1)[0]): k for k, v in port.items()
                if v.numel() and (v == v.reshape(-1)[0]).all()}
    return {JP.mesh._path_str(p): by_index.get(i)
            for i, (p, _) in enumerate(flat)}


def _sst_moe_params():
    cfg = dict(bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0), grid=(32, 32),
               max_pillars=256, max_points_per_pillar=16, pfn_features=32,
               window=8, capacity=16, depth=2, num_heads=2, neck_channels=32,
               moe_experts=2)
    model = JSST(JSSTConfig(**cfg))
    feats = jnp.zeros((1, 256, 16, 9), jnp.float32)
    coords = jnp.zeros((1, 256, 2), jnp.int32)
    valid = jnp.zeros((1, 256), bool)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), feats, coords,
                                 valid)["params"]
    return params, TSST(TSSTConfig(**cfg), device="cpu"), sst_params_from_flax


def _second_params():
    cfg = dict(bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0), grid=(32, 32, 8),
               max_voxels=512, stage_channels=(8, 16, 32),
               stage_sites=(512, 160, 24), subm_per_stage=1,
               head_channels=16)
    model = JSECOND(JSConfig(**cfg))
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 512, 4), jnp.float32),
        jnp.zeros((1, 512, 3), jnp.int32), jnp.zeros((1, 512), bool))[
            "params"]
    return params, TSECOND(TSConfig(**cfg), device="cpu"), \
        second_params_from_flax


def _pp_params():
    cfg = JConfig(**TINY)
    params = jax.jit(JPointPillars(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 16, 9), jnp.float32),
        jnp.zeros((1, 256, 2), jnp.int32), jnp.zeros((1, 256), bool))[
            "params"]
    return params, TPointPillars(TConfig(**TINY), device="cpu"), \
        pointpillars_params_from_flax


@pytest.mark.parametrize("family", ["pointpillars", "second", "sst_moe"])
@pytest.mark.parametrize("axes", [dict(dp=4, tp=2), dict(dp=4, ep=2),
                                  dict(dp=2, tp=2, ep=2)])
def test_partition_rules_name_the_jax_leaves(family, axes):
    """param_partition_spec / tp_param_report shard the same leaves as the
    JAX rules on the bridged model, on the same mesh axes."""
    params, model, from_flax = dict(
        pointpillars=_pp_params, second=_second_params,
        sst_moe=_sst_moe_params)[family]()
    names = _leaf_names(params, from_flax)
    devices = np.asarray(jax.devices()[:int(np.prod(list(axes.values())))])
    jmesh = jax.sharding.Mesh(devices.reshape(*axes.values()),
                              tuple(axes))
    j_sharded, j_repl = JP.tp_param_report(params, jmesh)
    t_sharded, t_repl = TP.tp_param_report(model, _Shape(**axes))
    assert sorted(names[p] for p in j_sharded) == sorted(t_sharded)
    assert sorted(names[p] for p in j_repl) == sorted(t_repl)
    if axes.get("tp", 1) > 1:
        assert t_sharded


def test_partition_spec_axes():
    w = torch.zeros(8, 4, 3, 3)
    assert TP.param_partition_spec("a.weight", w, 2, out_axis=0) == \
        ("tp", None, None, None)
    assert TP.param_partition_spec("a.weight", w, 2, out_axis=1) == \
        (None, "tp", None, None)
    assert TP.param_partition_spec("a.weight", w, 3, out_axis=0) == ()
    assert TP.param_partition_spec("b.bias", torch.zeros(8), 2) == ()
    assert TP.param_partition_spec("x.moe_w1", torch.zeros(4, 2, 2), 2,
                                   ep_size=2) == ("ep", None, None)
    assert TP.param_partition_spec("x.moe_router", torch.zeros(4, 2), 2,
                                   ep_size=2) == ()


def _twin_stats(seed):
    """One frame's stats by the JAX and the port evaluators (the frames of
    ``tests/test_parallel.py``'s ``_frame_stats``)."""
    from scipy.spatial.transform import Rotation

    from d3d_tpu import abstraction as JA
    from d3d_tpu_torch import abstraction as TA

    rng = np.random.default_rng(100 + seed)
    noise = rng.normal(0, 0.1)
    out = []
    for A, K, E in ((JA, JK, JEvaluator), (TA, TK, TEvaluator)):
        r = Rotation.from_euler("Z", 0)
        gt = A.Target3DArray([
            A.ObjectTarget3D([seed, 0, 0], r, [2, 2, 2],
                             A.ObjectTag(K.Car)),
            A.ObjectTarget3D([seed + 10, 0, 0], r, [2, 2, 2],
                             A.ObjectTag(K.Car))], frame="t")
        dt = A.Target3DArray([
            A.ObjectTarget3D([seed + noise, 0, 0], r, [2, 2, 2],
                             A.ObjectTag(K.Car, scores=0.9))], frame="t")
        kw = {} if E is JEvaluator else dict(device="cpu")
        out.append(E([K.Car], [0.3], pr_sample_count=8, **kw).calc_stats(
            gt, dt))
    return out


def test_stat_arrays_and_merge_equal_the_jax_package():
    classes = [JK.Car.value]
    pairs = [_twin_stats(i) for i in range(4)]
    j_arrays = [JP.stats_to_arrays(j, classes) for j, _ in pairs]
    t_arrays = [TP.stats_to_arrays(t, classes) for _, t in pairs]
    for ja, ta in zip(j_arrays, t_arrays):
        assert set(ja) == set(ta)
        for k in ja:
            np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]),
                                       rtol=1e-12, err_msg=k)
    j_stacked = {k: np.stack([np.asarray(a[k]) for a in j_arrays])
                 for k in j_arrays[0]}
    t_stacked = {k: np.stack([a[k].numpy() for a in t_arrays])
                 for k in t_arrays[0]}
    jm, tm = JP.merge_stacked_stats(j_stacked), \
        TP.merge_stacked_stats(t_stacked)
    for k in jm:
        if k in ("ngt", "ndt", "tp", "fp", "fn"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
        else:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-12,
                                       err_msg=k)
    back = TP.arrays_to_stats(tm, classes)
    ref = JP.arrays_to_stats(jm, classes)
    assert back.ngt == ref.ngt
    for f in ("tp", "fp", "fn", "ndt"):
        np.testing.assert_array_equal(getattr(back, f)[classes[0]],
                                      getattr(ref, f)[classes[0]])
    np.testing.assert_allclose(back.acc_iou[classes[0]],
                               ref.acc_iou[classes[0]], rtol=1e-12)


def test_all_hosts_stats_single_process_is_a_copy():
    _, t = _twin_stats(0)
    merged = TP.all_hosts_stats(t, [TK.Car.value])
    assert merged is not t
    np.testing.assert_array_equal(merged.tp[TK.Car.value],
                                  t.tp[TK.Car.value])
    np.testing.assert_array_equal(np.isnan(merged.acc_iou[TK.Car.value]),
                                  np.isnan(t.acc_iou[TK.Car.value]))


# ---------------------------------------------------------------------------
# dp x tp on 4 ranks
# ---------------------------------------------------------------------------

def test_make_mesh_axis_resolution(ranks):
    want = {repr(kw): dict(JP.make_mesh(4, **kw).shape)
            for kw in ({}, {"sp": 2}, {"sp": 4, "tp": 1}, {"dp": 4},
                       {"dp": 1, "sp": 2})}
    for r in ranks["dp_tp"]:
        assert r["axis_cases"] == want
        assert r["mesh_shape"] == {"dp": 2, "sp": 1, "tp": 2}


def test_dp_tp_loss_equals_the_single_process_and_jax_steps(ranks, pp_jax):
    for r in ranks["dp_tp"]:
        got = r["pp_sharded_loss"]["total"]
        np.testing.assert_allclose(got, r["pp_plain_loss"]["total"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got, pp_jax["loss_tp"], rtol=1e-6,
                                   atol=1e-7)
        for k in r["pp_plain_loss"]:
            np.testing.assert_allclose(r["pp_sharded_loss"][k],
                                       r["pp_plain_loss"][k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        assert np.isfinite(r["pp_second_loss"])


def test_sharded_trainer_resumes_from_one_shared_checkpoint(ranks):
    """A dp2 x tp2 Trainer run checkpointed into one directory by its four
    ranks (rank 0 writes the tp leaves and their Adam moments gathered
    whole) and resumed by a fresh model and optimizer equals the straight
    run, bit for bit: the gather and the cut move values exactly."""
    for r in ranks["dp_tp"]:
        res = r["pp_resume"]
        assert res["starts"] == (0, 1)
        assert res["files"] == ["step_1.pt", "step_2.pt"]
        (p1, b1, o1), (p2, b2, o2) = res["straight"], res["resumed"]
        assert p1.keys() == p2.keys() and b1.keys() == b2.keys()
        for k in p1:
            assert p1[k].shape == r["pp_plain_state"][k].shape, k
            assert torch.equal(p1[k], p2[k]), k
        for k in b1:
            assert torch.equal(b1[k], b2[k]), k
        assert (o1["count"], o1["mini_step"]) == (o2["count"],
                                                  o2["mini_step"])
        assert o1["state"].keys() == o2["state"].keys()
        for i, st in o1["state"].items():
            for k, v in st.items():
                assert torch.equal(torch.as_tensor(v),
                                   torch.as_tensor(o2["state"][i][k])), (i, k)


def test_dp_halves_differ_in_positives_and_statistics(ranks):
    """The two dp rows see different positive counts and canvas
    statistics, so the equal losses above need the global ones."""
    by_dp = {}
    for rank, r in enumerate(ranks["dp_tp"]):
        by_dp.setdefault(rank // 2, []).append(
            (r["pp_local_npos"], r["pp_canvas_mean"]))
    (a, b) = (by_dp[0][0], by_dp[1][0])
    assert a[0] != b[0]
    assert abs(a[1] - b[1]) > 0.1 * max(abs(a[1]), abs(b[1]))


def _assert_state_close(got, want, atol=1e-5):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        if w.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=atol, err_msg=k)
        else:
            assert torch.equal(g, w), k


def test_dp_tp_parameters_and_statistics_equal_the_single_process_step(
        ranks):
    """Updated parameters and BatchNorm running statistics on every rank
    (gathered whole) within 1e-5 of the single-process step's."""
    for r in ranks["dp_tp"]:
        _assert_state_close(r["pp_sharded_state"], r["pp_plain_state"])
        moved = [k for k in r["pp_plain_state"] if "running_mean" in k]
        assert moved


@pytest.mark.parametrize("family", ["pp", "second"])
def test_dp_tp_gradients_equal_the_single_process_step(ranks, family):
    """Each leaf's gradient after the sharded step (summed over dp; a tp
    leaf's own shard of it) within 1e-5 of its largest entry of the
    single-process step's: the halves' positive counts and BatchNorm
    statistics differ, so per-rank ones would not pass."""
    for r in ranks["dp_tp"]:
        got, want = r[f"{family}_sharded_grads"], r[f"{family}_plain_grads"]
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            if g.shape != w.shape:
                axis = [d for d in range(w.ndim) if g.shape[d] != w.shape[d]]
                assert len(axis) == 1, k
                w = w.chunk(2, axis[0])[r["tp_rank"]]
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-5 * float(w.abs().max()),
                                       err_msg=k)


def test_tp_leaves_hold_half_their_output_channels(ranks):
    axes = None
    for r in ranks["dp_tp"]:
        assert len(r["pp_tp_names"]) >= 5
        for name, (shape, m_shape) in r["pp_shard_shapes"].items():
            full = r["pp_plain_state"][name].shape
            axes = [d for d in range(len(full)) if shape[d] != full[d]]
            assert len(axes) == 1 and shape[axes[0]] * 2 == full[axes[0]]
            assert m_shape == shape
    assert axes is not None


def test_check_tp_raises_on_an_all_replicated_model(ranks):
    for r in ranks["dp_tp"]:
        assert "no parameter partitions over tp" in r["check_tp"]


def test_second_dp_tp_step_equals_the_single_process_step(ranks):
    for r in ranks["dp_tp"]:
        assert r["second_tp_names"]
        np.testing.assert_allclose(r["second_sharded_loss"]["total"],
                                   r["second_plain_loss"]["total"],
                                   rtol=1e-6, atol=1e-7)
        _assert_state_close(r["second_sharded_state"],
                            r["second_plain_state"])


@pytest.mark.parametrize("family", FAMILIES)
def test_family_sharded_step_equals_the_single_process_step(ranks, family):
    """CenterPoint, BEVSeg (panoptic), VoxelNeXt and Mono3D steps carry
    what ``shard_train_step`` reads; on dp2 x tp2 their loss terms equal
    the plain step's on the whole batch (rtol 1e-6), each leaf's summed
    gradient is within 3e-5 of its largest entry (a head bias sums 4 096
    float32 terms a frame in two halves: 1.02e-5 seen; a bias before a
    batch-statistics BatchNorm, whose gradient is zero but for rounding,
    is held to 3e-7 of the step's largest entry instead: 6e-8 seen) and
    the updated state within 1e-5 (but for such a bias, which Adam's first
    step moves by lr times the sign of its rounding), though the dp
    halves' normalisers differ (a per-rank count would be off by a
    factor, not by rounding)."""
    counts = {}
    for rank, r in enumerate(ranks["dp_tp"]):
        got = r["families"][family]
        assert set(got["sharded_loss"]) == set(got["plain_loss"])
        for k, want in got["plain_loss"].items():
            np.testing.assert_allclose(got["sharded_loss"][k], want,
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        top = max(float(w.abs().max()) for w in got["plain_grads"].values())
        for k, w in got["plain_grads"].items():
            g = got["sharded_grads"][k]
            if g.shape != w.shape:
                axis = [d for d in range(w.ndim) if g.shape[d] != w.shape[d]]
                w = w.chunk(2, axis[0])[r["tp_rank"]]
            scale = max(float(w.abs().max()), 1e-2 * top)
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=3e-5 * scale, err_msg=k)
        noise = {k for k, w in got["plain_grads"].items()
                 if float(w.abs().max()) < 1e-6 * top}
        _assert_state_close(
            {k: v for k, v in got["sharded_state"].items() if k not in noise},
            {k: v for k, v in got["plain_state"].items() if k not in noise})
        counts.setdefault(rank // 2, got["local_count"])
    assert counts[0] != counts[1], counts


@pytest.mark.parametrize("family", ["centerpoint", "bevseg", "voxelnext"])
def test_family_sharded_loss_equals_the_jax_sharded_step(ranks, fam_jax,
                                                        family):
    """The port's sharded loss against the JAX package's
    ``shard_train_step`` on the same mesh shape, weights and batch (both
    float32: rtol 1e-5)."""
    want = fam_jax["losses"][family]
    for r in ranks["dp_tp"]:
        got = r["families"][family]["sharded_loss"]
        for k in ("total",) + tuple(k for k in want if k in got
                                    and k != "total"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# dp x sp on 4 ranks
# ---------------------------------------------------------------------------

def test_sp_loss_equals_the_dp_only_and_jax_sp_steps(ranks, pp_jax):
    for r in ranks["dp_sp"]:
        got = r["sp_loss"]["total"]
        assert np.isfinite(got)
        np.testing.assert_allclose(got, r["dp_loss"]["total"], rtol=2e-4)
        np.testing.assert_allclose(got, pp_jax["loss_sp"], rtol=2e-4)
        np.testing.assert_allclose(r["dp_loss"]["total"],
                                   pp_jax["loss_dp"], rtol=2e-4)


def test_sp_gradients_equal_the_dp_only_step(ranks):
    """Each leaf's summed gradient within 2e-4 of its largest entry: a
    gather whose backward summed the ranks' cotangents would double it."""
    for r in ranks["dp_sp"]:
        assert set(r["sp_grads"]) == set(r["dp_grads"])
        for k, want in r["dp_grads"].items():
            scale = float(want.abs().max())
            np.testing.assert_allclose(r["sp_grads"][k].numpy(),
                                       want.numpy(), rtol=0,
                                       atol=2e-4 * scale, err_msg=k)


def test_sp_canvas_slab_and_collectives(ranks):
    """The backbone sees (B/2, C, W/2, H) slabs; a step moves halo rows
    only and gathers the three head outputs, never the canvas."""
    for r in ranks["dp_sp"]:
        assert r["slab"] == (2, TINY["pfn_features"], 16, 32)
        assert r["step_counts"]["gather"] == 3
        assert r["step_counts"]["halo_calls"] == 2
        assert r["step_counts"]["halo"] in (1, 2)


def _same(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


@pytest.mark.parametrize("sp", ["halo_sp2", "halo_sp4"])
def test_halo_convolution_equals_the_whole_canvas(ranks, sp):
    """Forward exactly, input and weight gradients (summed over the ranks)
    within float32 rounding of the whole canvas's, at every backbone
    shape class; each rank sends only its edge rows."""
    for r in ranks["dp_sp"]:
        for c in r[sp]:
            k, stride, w, h, _ = c["shape"]
            assert c["slab"][2] == w // c["size"]
            assert c["fwd"] <= 1e-6 * c["scale"], c
            assert c["gx"] <= 1e-5 * c["scale"], c
            assert c["gw"] <= 2e-5 * c["scale"] * c["slab"][0] * h, c
            hb, ha = _same(w, k, stride)
            rows = (ha if c["rank"] > 0 else 0) + \
                (hb if c["rank"] < c["size"] - 1 else 0)
            assert c["moved"] == {"halo": rows,
                                  "halo_calls": int(bool(hb or ha)),
                                  "gather": 0}, c


def test_spatial_hook_in_every_bev_family(ranks):
    """CenterPoint, BEVSeg (panoptic) and SST on sp4 slabs equal the same
    models on the whole canvas (inference, relative to each output)."""
    for r in ranks["dp_sp"]:
        for name, err in r["families"].items():
            assert err < 1e-5, (name, err)
