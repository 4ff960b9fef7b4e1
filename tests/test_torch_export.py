"""The port's detector export (``export.py``) on the CPU: PointPillars,
SST, Mono3D (two inputs) and VoxelNeXt detectors traced by
``torch.export`` with their weights baked in, saved, loaded and run. The
loaded artifact equals the eager ``device_fn`` bit for bit and the JAX
package's exported detector (``d3d_tpu.export``) on the same flax weights
within the detector tests' tolerances; the hand kernels are
``d3d_tpu_torch::`` op nodes of the graph, each op passes
``torch.library.opcheck`` with CPU inputs, and an artifact loads in a
process that never imports the port's model code nor JAX.

One module-scoped bank per family holds both packages' detectors, so each
JAX program compiles once."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from _limits import run_python

import jax
import jax.numpy as jnp
import torch

from d3d_tpu import export as jexport
from d3d_tpu.dataset.kitti.utils import KittiObjectClass
from d3d_tpu.models import (SST, Mono3D, PointPillars, PointPillarsConfig,
                            VoxelNeXt, make_anchors, make_mono3d_detector,
                            make_pointpillars_detector, make_sst_detector,
                            make_voxelnext_detector, pillarize,
                            voxelnext_voxelize)

from d3d_tpu_torch import export as texport
from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TClass
from d3d_tpu_torch.models import convert
from d3d_tpu_torch.models import inference as TI
from d3d_tpu_torch.models import mono3d as TM
from d3d_tpu_torch.models import pointpillars as TP
from d3d_tpu_torch.models import sst as TS
from d3d_tpu_torch.models import voxelnext as TV
from d3d_tpu_torch.ops import geometry_cuda, nms_cuda, rulebook
from d3d_tpu_torch.ops import sparse_conv_cuda, stage_maps

from tests.test_mono3d import K, TINY as MONO
from tests.test_sst import TINY as SST_TINY
from tests.test_torch_second import _randomize
from tests.test_voxelnext import TINY as VNEXT

ROOT = Path(__file__).resolve().parents[1]
PP = PointPillarsConfig(
    bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0), grid=(32, 32),
    max_pillars=256, max_points_per_pillar=16, pfn_features=32,
    backbone_channels=(32, 64), backbone_blocks=(1, 1),
    upsample_channels=32)
CLASSES = [KittiObjectClass.Car, KittiObjectClass.Pedestrian]
T_CLASSES = [TClass.Car, TClass.Pedestrian]
FAMILIES = ("pointpillars", "sst", "mono3d", "voxelnext")
# the kernels' ops each family's CPU graph holds (CPU stage loops build no
# rule book: the CUDA graphs add d3d_tpu_torch::subm_conv_rulebook)
NMS_OPS = {"d3d_tpu_torch.rbox_overlap_bits.default",
           "d3d_tpu_torch.nms_scan_sorted.default"}
# the BEV layers' epilogue: in place after the pillar net's linear layer
# and each convolution, and into the upsamplings' slices of the heads'
# input (SST has no upsampling)
EPILOGUE = "d3d_tpu_torch.bn_relu.default"
GRAPH_OPS = dict(pointpillars=NMS_OPS | {
                     EPILOGUE, "d3d_tpu_torch.bn_relu_into.default"},
                 sst=NMS_OPS | {EPILOGUE}, mono3d=set(),
                 voxelnext=NMS_OPS | {"d3d_tpu_torch.subm_conv.default"})


def _cloud(rng, n=2048):
    return np.stack([rng.random(n) * 16, rng.random(n) * 16 - 8,
                     rng.random(n) * 4 - 3, rng.random(n)],
                    axis=1).astype(np.float32)


def _variables(model, *args):
    """Randomized flax variables of ``model`` (BatchNorm statistics
    included), built from the tree's shapes only."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    return _randomize({k: shapes[k] for k in ("params", "batch_stats")},
                      np.random.default_rng(2))


def _family(name, rng):
    """(JAX detector, port detector, inputs) on the same flax weights."""
    if name == "mono3d":
        image = rng.random((96, 128, 3)).astype(np.float32)
        var = _variables(Mono3D(MONO), image[None])
        jdet = make_mono3d_detector(Mono3D(MONO), var, MONO, CLASSES)
        tcfg = TM.Mono3DConfig(**dataclasses.asdict(MONO))
        tdet = TM.make_mono3d_detector(
            TM.Mono3D(tcfg, device="cpu"),
            convert.mono3d_state_from_flax(var), tcfg, T_CLASSES,
            device="cpu")
        return jdet, tdet, (image, K)
    pts = _cloud(rng)
    if name == "voxelnext":
        var = _variables(VoxelNeXt(VNEXT), *(a[None] for a in
                                             voxelnext_voxelize(pts, VNEXT)))
        jdet = make_voxelnext_detector(VoxelNeXt(VNEXT), var, VNEXT, CLASSES,
                                       score_threshold=0.0)
        tcfg = TV.VoxelNeXtConfig(**dataclasses.asdict(VNEXT))
        tdet = TI.make_voxelnext_detector(
            TV.VoxelNeXt(tcfg, device="cpu"),
            convert.voxelnext_state_from_flax(var), tcfg, T_CLASSES,
            score_threshold=0.0, device="cpu")
        return jdet, tdet, (pts,)
    cfg, jmodel, jmake, tconf, tmodel, state, tmake = dict(
        pointpillars=(PP, PointPillars, make_pointpillars_detector,
                      TP.PointPillarsConfig, TP.PointPillars,
                      convert.pointpillars_state_from_flax,
                      TI.make_pointpillars_detector),
        sst=(SST_TINY, SST, make_sst_detector, TS.SSTConfig, TS.SST,
             convert.sst_state_from_flax, TI.make_sst_detector))[name]
    var = _variables(jmodel(cfg), *(a[None] for a in pillarize(pts, cfg)))
    jdet = jmake(jmodel(cfg), var, cfg, make_anchors(cfg), CLASSES[:1],
                 score_threshold=0.0, top_k=32)
    tcfg = tconf(**dataclasses.asdict(cfg))
    tdet = tmake(tmodel(tcfg, device="cpu"), state(var), tcfg,
                 TP.make_anchors(tcfg, device="cpu"), T_CLASSES[:1],
                 score_threshold=0.0, top_k=32, device="cpu")
    return jdet, tdet, (pts,)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request, tmp_path_factory):
    """One family's detectors, its port artifact (exported, saved, loaded)
    and the JAX package's artifact's outputs."""
    name = request.param
    rng = np.random.default_rng(FAMILIES.index(name))
    jdet, tdet, inputs = _family(name, rng)
    path = tmp_path_factory.mktemp("export") / f"{name}.zip"
    exported = texport.export_detector(tdet.device_fn, inputs,
                                       meta={"family": name})
    exported.save(path)
    jpath = path.with_suffix(".jax.zip")
    jexport.save_detector(jdet.device_fn,
                          inputs if len(inputs) > 1 else inputs[0], jpath)
    jout = jexport.load_detector(jpath)(*(jnp.asarray(a) for a in inputs))
    return dict(name=name, tdet=tdet, inputs=inputs, path=path,
                exported=exported, loaded=texport.load_detector(path),
                jax=[np.asarray(a) for a in jout])


def test_roundtrip_equals_eager(family):
    """The loaded artifact's outputs equal the eager device_fn's bit for
    bit; meta, input shapes and platform survive the save."""
    want = family["tdet"].device_fn(*family["inputs"])
    loaded = family["loaded"]
    got = loaded(*family["inputs"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert loaded.meta == {"family": family["name"]}
    assert loaded.input_shapes == tuple(np.shape(a)
                                        for a in family["inputs"])
    assert loaded.input_shape == np.shape(family["inputs"][0])
    assert loaded.platforms == ("cpu",)


def test_matches_the_jax_export(family):
    """Against the JAX package's exported detector on the same weights:
    keep masks and labels exact, boxes within 1e-4 and scores within 1e-5
    (the detector tests' tolerances: f32 network outputs through exp)."""
    got = [t.numpy() for t in family["loaded"](*family["inputs"])]
    want = family["jax"]
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2], want[2])
    if len(got) > 3:
        np.testing.assert_array_equal(got[3], want[3])


def test_graph_holds_the_kernel_ops(family):
    """The hand kernels stay op nodes of the traced graph."""
    ops = {str(n.target) for n in family["exported"].program.graph.nodes
           if str(n.target).startswith("d3d_tpu_torch")}
    assert ops == GRAPH_OPS[family["name"]]


def test_wrong_input_raises(family):
    """Another shape, count or device type raises ValueError."""
    loaded = family["loaded"]
    first = np.asarray(family["inputs"][0])
    bad = np.zeros((first.shape[0] + 1,) + first.shape[1:], first.dtype)
    with pytest.raises(ValueError):
        loaded(bad, *family["inputs"][1:])
    with pytest.raises(ValueError):
        loaded(*family["inputs"], first)
    with pytest.raises(ValueError):
        loaded(first.astype(np.float64), *family["inputs"][1:])


def test_platform_must_be_the_traced_device(family):
    """platforms names the device traced on; another raises."""
    with pytest.raises(ValueError, match="cpu"):
        texport.export_detector(family["tdet"].device_fn, family["inputs"],
                                platforms=("cuda",))


def test_loads_without_model_code(tmp_path):
    """A fresh process loads an artifact (VoxelNeXt's, which holds the
    most kernel ops) and reproduces the eager outputs, importing neither
    the port's models nor JAX. It runs on this process's torch threads:
    the eager outputs' last bits follow the thread count."""
    _, tdet, args = _family("voxelnext", np.random.default_rng(5))
    path = texport.save_detector(tdet.device_fn, args, tmp_path / "v.zip",
                                 meta={"family": "voxelnext"})
    inputs = tmp_path / "inputs.npz"
    want = tmp_path / "want.npz"
    np.savez(inputs, *args)
    np.savez(want, *[t.numpy() for t in tdet.device_fn(*args)])
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        f"torch.set_num_threads({torch.get_num_threads()})\n"
        "from d3d_tpu_torch.export import load_detector\n"
        f"det = load_detector({str(path)!r})\n"
        f"x = np.load({str(inputs)!r})\n"
        f"w = np.load({str(want)!r})\n"
        "out = det(*[x[f'arr_{i}'] for i in range(len(x.files))])\n"
        "same = all(np.array_equal(o.numpy(), w[f'arr_{i}'])\n"
        "           for i, o in enumerate(out))\n"
        "mods = [m for m in sys.modules if m.startswith("
        "('d3d_tpu_torch.models', 'jax', 'flax', 'd3d_tpu.'))\n"
        "    or m == 'd3d_tpu']\n"
        "print(json.dumps(dict(same=same, mods=mods, meta=det.meta)))\n")
    res = run_python(code, ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == dict(same=True, mods=[], meta={"family": "voxelnext"})


def _op_cases():
    """CPU inputs for each registered op (the wrappers' own shapes)."""
    rng = np.random.default_rng(9)
    boxes = torch.from_numpy(np.concatenate([
        rng.uniform(0, 8, (70, 2)), rng.uniform(1, 3, (70, 2)),
        rng.uniform(-3, 3, (70, 1))], 1).astype(np.float32))
    scores = torch.from_numpy(rng.random(70).astype(np.float32))
    neg, order = torch.sort(-scores, stable=True)
    bits = geometry_cuda._rbox_overlap_bits_plain(boxes[order], 0.1)
    overlap = torch.from_numpy(rng.random((12, 12)) < 0.3)
    pre = torch.from_numpy(rng.random(12) < 0.2)
    iou = torch.from_numpy(rng.random((12, 12)).astype(np.float32))
    nbr = torch.from_numpy(rng.integers(-1, 10, (8, 27)).astype(np.int32))
    nbr2 = torch.from_numpy(rng.integers(-1, 10, (5, 27)).astype(np.int32))
    ops = torch.ops.d3d_tpu_torch
    return {
        "rbox_iou_matrix": (ops.rbox_iou_matrix, (boxes[:9], boxes[9:20])),
        "rbox_overlap_bits": (ops.rbox_overlap_bits, (boxes, 0.1)),
        "nms_scan": (ops.nms_scan, (overlap, pre)),
        "nms_scan_blocked": (ops.nms_scan_blocked, (overlap, pre)),
        "nms_scan_sorted": (ops.nms_scan_sorted,
                            (bits, order, neg, 0.2, None)),
        "nms_scan_sorted_pre": (ops.nms_scan_sorted,
                                (bits, order, neg, 0.2,
                                 nms_cuda._pre_suppression(-neg, 0.2))),
        "soft_nms_scan": (ops.soft_nms_scan,
                          (iou, iou[0], pre, 0.3, 0.1, 0.5, "gaussian")),
        "subm_conv": (ops.subm_conv,
                      (torch.randn(10, 4), nbr, None, torch.randn(27, 4, 3),
                       torch.from_numpy(rng.random(8) < 0.8))),
        "subm_conv_rulebook": (ops.subm_conv_rulebook, ([nbr, nbr2],)),
        "build_stage_maps": (ops.build_stage_maps, _stage_maps_case(rng)),
    }


def _stage_maps_case(rng):
    """Two frames of 40 sites (30 and 20 valid) on a 6 x 5 x 9 grid, the
    JAX module's ``coords // 2`` after stage 0 and spconv's window after
    stage 1: the op's (coords, valid, plan)."""
    coords = torch.from_numpy(rng.integers(0, 5, (2, 40, 3)).astype(np.int32))
    valid = torch.from_numpy(np.arange(40) < np.array([[30], [20]]))
    plan = stage_maps._plan(40, (6, 5, 9), [
        stage_maps.Down(2, 30), stage_maps.Down((1, 1, 2), 20, (1, 1, 3), 0),
        None])
    return coords, valid, plan


def test_stage_maps_fake_gives_the_plain_shapes():
    """Under FakeTensorMode the stage maps' op gives the shapes and dtypes
    of the plain route's outputs (the CPU kernel's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    coords, valid, plan = _stage_maps_case(np.random.default_rng(4))
    real = torch.ops.d3d_tpu_torch.build_stage_maps(coords, valid, plan)
    with FakeTensorMode() as mode:
        fake = torch.ops.d3d_tpu_torch.build_stage_maps(
            mode.from_tensor(coords), mode.from_tensor(valid), plan)
    assert len(fake) == len(real) == 9
    assert [(f.shape, f.dtype) for f in fake] == [(r.shape, r.dtype)
                                                   for r in real]


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_opcheck(case):
    """torch.library.opcheck on each op with CPU inputs: schema, fake
    (meta) implementation and tracing."""
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)


def test_cpu_ops_count_no_launch():
    """The ops' CPU implementations are the plain versions and count no
    launch."""
    counters = (geometry_cuda.rbox_iou_matrix, nms_cuda.nms_scan,
                nms_cuda.nms_scan_blocked, nms_cuda.soft_nms_scan,
                sparse_conv_cuda.subm_conv, rulebook.subm_conv_rulebook,
                stage_maps.build_stage_maps)
    before = [f.launches for f in counters]
    for op, args in _op_cases().values():
        op(*args)
    assert [f.launches for f in counters] == before
