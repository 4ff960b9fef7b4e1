"""The port's public box API (``d3d_tpu_torch.ops.box``) against
``d3d_tpu.ops.box`` on the same inputs: IoU matrices of the four methods
(float64 within 1e-12 of the largest value, float32 within K1's 2e-5 and
+0.0 where JAX gives 0), their gradients (float64, 1e-9 of each input's
largest), keep masks of every ``box2d_nms`` combination (exact, on boxes
whose pairwise IoU stays clear of the threshold), crops (exact), signed
distances, the numpy/tensor conventions and the validation errors; and
the guard of the forward-only K1 matrix."""

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import torch

from d3d_tpu.ops import box as JB
from d3d_tpu.ops import geometry as G

from d3d_tpu_torch.ops import box as TB
from d3d_tpu_torch.ops import geometry_cuda, geometry_soa, nms_cuda

METHODS = ("box", "rbox", "grbox", "drbox")
ADVERSARIAL = np.array([
    [[1.0, 2.0, 3.0, 1.5, 0.3], [1.0, 2.0, 3.0, 1.5, 0.3]],
    [[0.0, 0.0, 2.0, 2.0, 0.0], [2.0, 0.0, 2.0, 2.0, 0.0]],
    [[0.0, 0.0, 4.0, 4.0, 0.2], [0.1, 0.1, 1.0, 1.0, 0.7]],
    [[0.0, 0.0, 3.0, 1.0, 0.0], [0.0, 0.0, 3.0, 1.0, np.pi / 2]],
    [[0.0, 0.0, 1.0, 1.0, 0.0], [10.0, 10.0, 1.0, 1.0, 0.0]],
])


def _boxes(rng, n, spread):
    return np.stack([rng.random(n) * spread, rng.random(n) * spread,
                     rng.random(n) * 3 + 1, rng.random(n) * 3 + 1,
                     rng.random(n) * np.pi], axis=1)


@pytest.fixture(scope="module")
def iou_boxes():
    rng = np.random.default_rng(11)
    return (np.concatenate([_boxes(rng, 30, 10.0), ADVERSARIAL[:, 0]]),
            np.concatenate([_boxes(rng, 25, 10.0), ADVERSARIAL[:, 1]]))


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("method", METHODS)
def test_iou_matches_jax(iou_boxes, method, precise):
    """precise=True on float64 boxes (float64 through and through),
    precise=False on float32 boxes (float32; "rbox" is K1's matrix
    entry)."""
    dt = np.float64 if precise else np.float32
    b1, b2 = (b.astype(dt) for b in iou_boxes)
    want = JB.box2d_iou(b1, b2, method=method, precise=precise)
    got = TB.box2d_iou(b1, b2, method=method, precise=precise, device="cpu")
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype == dt and got.shape == (35, 30)
    if precise:
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
        if method in ("box", "rbox"):  # disjoint pairs: exactly +0.0
            zero = want == 0
            assert zero.any() and np.all(got[zero] == 0)
            assert not np.signbit(got[zero]).any()


def test_precise_casts_back_to_the_input_dtype(iou_boxes):
    b1, b2 = (b.astype(np.float32) for b in iou_boxes)
    got = TB.box2d_iou(b1, b2, method="rbox", device="cpu")
    want = TB.box2d_iou(b1.astype(np.float64), b2.astype(np.float64),
                        method="rbox", device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float32))


# the JAX functions whose gradients box2d_iou's are held to. For "rbox"
# the JAX package's box2d_iou differentiates geometry_soa.rbox_iou, whose
# backward takes XLA:CPU ~90 s to compile; tests/test_geometry_soa.py holds
# its gradients to those of geometry.rbox_iou, which stands in here
_JAX_GRAD_FNS = {"box": G.aabox_iou, "rbox": G.rbox_iou,
                 "grbox": G.rbox_giou, "drbox": G.rbox_diou}


@pytest.mark.parametrize("method", METHODS)
def test_iou_gradients_match_jax(iou_boxes, method):
    """d sum(box2d_iou) / d boxes, precise (float64), on the random boxes
    (the adversarial ones sit on kinks)."""
    b1, b2 = (b[:-len(ADVERSARIAL)] for b in iou_boxes)
    fn = _JAX_GRAD_FNS[method]
    g1, g2 = jax.grad(lambda a, b: fn(a[:, None], b[None]).sum(),
                      argnums=(0, 1))(jnp.asarray(b1), jnp.asarray(b2))
    t1 = torch.from_numpy(b1).requires_grad_()
    t2 = torch.from_numpy(b2).requires_grad_()
    out = TB.box2d_iou(t1, t2, method=method)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
    out.sum().backward()
    for got, want in ((t1.grad, g1), (t2.grad, g2)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-9 * np.abs(want).max()


def _clear_of_threshold(boxes, thr, margin=1e-4):
    """Drop boxes until no pairwise IoU, rotated or axis-aligned, lies
    within ``margin`` of ``thr``, where one rounding could flip a bit."""
    b = jnp.asarray(boxes, jnp.float64)
    near = np.zeros((len(boxes),) * 2, bool)
    for fn in (G.rbox_iou, G.aabox_iou):
        near |= np.abs(np.asarray(fn(b[:, None], b[None])) - thr) < margin
    np.fill_diagonal(near, False)
    return np.delete(boxes, np.unique(np.nonzero(np.triu(near))[1]), axis=0)


@pytest.fixture(scope="module")
def nms_inputs():
    rng = np.random.default_rng(12)
    boxes = _clear_of_threshold(_boxes(rng, 120, 22.0).astype(np.float32),
                                0.3)
    return boxes, rng.random(len(boxes)).astype(np.float32)


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("sup,param", [("hard", 0.0), ("linear", 0.5),
                                       ("gaussian", 0.5)])
@pytest.mark.parametrize("iou_method", ["box", "rbox"])
def test_nms_matches_jax(nms_inputs, iou_method, sup, param, precise):
    boxes, scores = nms_inputs
    kw = dict(iou_method=iou_method, supression_method=sup,
              iou_threshold=0.3, score_threshold=0.1,
              supression_param=param, precise=precise)
    want = JB.box2d_nms(boxes, scores, **kw)
    counts = (nms_cuda.nms_scan.launches, nms_cuda.soft_nms_scan.launches,
              geometry_cuda.rbox_iou_matrix.launches)
    got = TB.box2d_nms(boxes, scores, device="cpu", **kw)
    assert (nms_cuda.nms_scan.launches, nms_cuda.soft_nms_scan.launches,
            geometry_cuda.rbox_iou_matrix.launches) == counts
    assert isinstance(got, np.ndarray) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(boxes)


def test_nms_class_scores_and_empty(nms_inputs, rng):
    boxes, _ = nms_inputs
    scores = rng.random((len(boxes), 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TB.box2d_nms(boxes, scores, iou_method="rbox", iou_threshold=0.3,
                     device="cpu"),
        JB.box2d_nms(boxes, scores, iou_method="rbox", iou_threshold=0.3))
    out = TB.box2d_nms(np.zeros((0, 5)), np.zeros((0,)), device="cpu")
    assert out.shape == (0,) and out.dtype == bool
    t = TB.box2d_nms(torch.zeros((0, 5)), torch.zeros(0))
    assert isinstance(t, torch.Tensor) and t.shape == (0,)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(13)
    pts = (rng.random((800, 3)) * [12.0, 12.0, 3.0]).astype(np.float32)
    b2 = _boxes(rng, 6, 12.0).astype(np.float32)
    b3 = np.concatenate([b2[:, :2], rng.random((6, 1)) * 3, b2[:, 2:4],
                         rng.random((6, 1)) + 1, b2[:, 4:5]], 1).astype(
        np.float32)
    return pts, b2, b3


def test_crops_match_jax(cloud):
    pts, b2, b3 = cloud
    want = JB.box2dr_crop(pts[:, :2], b2)
    got = TB.box2dr_crop(pts[:, :2], b2, device="cpu")
    assert len(got) == len(want) == 6 and sum(map(len, got)) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tens = TB.box2dr_crop(torch.from_numpy(pts[:, :2]), torch.from_numpy(b2))
    for g, w in zip(tens, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)
    for axis in (0, 1, 2):
        want = JB.box3dp_crop(pts, b3, project_axis=axis)
        got = TB.box3dp_crop(pts, b3, project_axis=axis, device="cpu")
        assert got.dtype == bool
        np.testing.assert_array_equal(got, want)


def test_distances_match_jax(cloud, rng):
    pts, b2, b3 = cloud
    np.testing.assert_allclose(
        TB.box2dr_pdist(pts[:, :2], b2, device="cpu"),
        JB.box2dr_pdist(pts[:, :2], b2), rtol=0, atol=2e-5)
    for axis in (0, 2):
        np.testing.assert_allclose(
            TB.box3dr_pdist(pts, b3, project_axis=axis, device="cpu"),
            JB.box3dr_pdist(pts, b3, project_axis=axis), rtol=0, atol=2e-5)
    p64, b64 = pts.astype(np.float64), b3.astype(np.float64)
    want = JB.box3dr_pdist(p64, b64)
    got = TB.box3dr_pdist(p64, b64, device="cpu")
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    s1, s2 = rng.random((10, 2)), rng.random((10, 2))
    np.testing.assert_allclose(TB.seg1d_iou(s1, s2, device="cpu"),
                               JB.seg1d_iou(s1, s2), rtol=1e-15)
    for p in (rng.random(10), rng.random((10, 1))):
        np.testing.assert_array_equal(TB.seg1d_pdist(p, s1, device="cpu"),
                                      JB.seg1d_pdist(p, s1))


def test_validation_matches_jax():
    z5, z4 = np.zeros((3, 5)), np.zeros((3, 4))
    cases = [
        lambda m: m.box2d_iou(z4, z5),
        lambda m: m.box2d_iou(z5[0], z5),
        lambda m: m.box2d_iou(z5, z5, method="nope"),
        lambda m: m.box2d_nms(z5, np.zeros(2)),
        lambda m: m.box2d_nms(z5, np.zeros(3), iou_method="grbox"),
        lambda m: m.box2d_nms(z5, np.zeros(3), supression_method="soft"),
        lambda m: m.box2dr_pdist(np.zeros((3, 2)), z5, method="box"),
        lambda m: m.box2dr_pdist(np.zeros((3, 2)), z4),
        lambda m: m.box3dp_crop(np.zeros((3, 3)), np.zeros((1, 7)),
                                project_axis=3),
    ]
    for case in cases:
        with pytest.raises(ValueError):
            case(JB)
        with pytest.raises(ValueError):
            case(TB)


def test_numpy_goes_to_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    b = np.zeros((2, 5), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TB.box2d_iou(b, b)
    with pytest.raises(RuntimeError, match="CUDA"):
        TB.box2d_nms(b, np.zeros(2, np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        TB.box2dr_crop(np.zeros((3, 2), np.float32), b)
    # CPU tensors stay on the CPU
    out = TB.box2d_iou(torch.from_numpy(b), torch.from_numpy(b))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"


# ---------------------------------------------------------------------------
# K1's matrix is forward-only: it raises under autograd rather than hand
# back a matrix with no gradient
# ---------------------------------------------------------------------------

def test_k1_matrix_raises_under_grad():
    b = torch.tensor([[0.0, 0.0, 2.0, 2.0, 0.0], [1.0, 0.0, 2.0, 2.0, 0.3]])
    with pytest.raises(RuntimeError, match="forward-only"):
        geometry_cuda.rbox_iou_matrix(b.clone().requires_grad_(), b)
    with pytest.raises(RuntimeError, match="forward-only"):
        geometry_cuda.rbox_iou_matrix(b, b.clone().requires_grad_())
    # without a gradient to lose it runs (the plain version on the CPU)
    with torch.no_grad():
        iou = geometry_cuda.rbox_iou_matrix(b.clone().requires_grad_(), b)
    assert iou.shape == (2, 2)
    assert torch.equal(geometry_cuda.rbox_iou_matrix(b, b), iou)


def test_differentiable_routes_stay_differentiable():
    """The routes the error names: precise=True, and on the CPU the float32
    matrix too (the dispatcher sends CPU tensors to the plain version, as
    the JAX package's CPU route is XLA, not Pallas); NMS detaches."""
    rng = np.random.default_rng(14)
    b = torch.from_numpy(_boxes(rng, 6, 3.0)).requires_grad_()
    TB.box2d_iou(b, b.detach(), method="rbox").sum().backward()
    g64 = b.grad.clone()
    b.grad = None
    b32 = b.detach().float().requires_grad_()
    TB.box2d_iou(b32, b32.detach(), method="rbox",
                 precise=False).sum().backward()
    np.testing.assert_allclose(b32.grad.numpy(), g64.numpy(), atol=1e-3)
    assert geometry_soa.rbox_iou_matrix(b32, b32).requires_grad
    keep = TB.box2d_nms(b32, torch.rand(6), iou_method="rbox",
                        precise=False)
    assert not keep.requires_grad
