"""The BEV layers' inference route (``models/pointpillars.py`` ``_fused``):
with no gradients, running statistics and the whole canvas, each layer is
its linear part and one epilogue pass, BatchNorm and ReLU
(``ops/epilogue.py`` ``bn_relu``), on NCHW-contiguous maps, the
upsamplings written into their slices of the heads' input. Held here, on
the CPU (the epilogue's plain version), to the layers as they are written,
with randomised BatchNorm statistics, in every model that shares the
layers; to flax's BatchNorm formula bit for bit; the training route bit
for bit to the layers' own arithmetic; the statistics' cache counted by
its ``bev.fold`` spans.

The tolerance of the route against the written layers: 2e-6 of the
largest output, plus 2e-6 absolute (the largest difference seen over these
five cases and three BatchNorm seeds is 7.7e-7 of the largest output,
CenterPoint's). The written layers' ``F.batch_norm`` computes ``x * a +
b`` with ``a = scale / sqrt(var + eps)`` and ``b = bias - mean * a``,
where the route computes flax's ``(x - mean) * (rsqrt(var + eps) * scale)
+ bias``: float32 rounding, a few ulps a layer over a dozen layers.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _limits  # noqa: F401  (one torch thread a process)

from d3d_tpu_torch.models import BEVSeg, CenterPoint, SST
from d3d_tpu_torch.models import PointPillars, PointPillarsConfig
from d3d_tpu_torch.models import make_anchors, make_pointpillars_detector
from d3d_tpu_torch.models import pillarize
from d3d_tpu_torch.models.bevseg import BEVSegConfig
from d3d_tpu_torch.models.centerpoint import CenterPointConfig
from d3d_tpu_torch.models.pointpillars import (_PFN, _bn_train, _conv_same,
                                               _ConvBlock, _head, _Upsample,
                                               scatter_to_bev)
from d3d_tpu_torch.models.sst import SSTConfig
from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass
from d3d_tpu_torch.ops.epilogue import bn_relu

BOUNDS = (0.0, 16.0, -8.0, 8.0, -3.0, 1.0)
# three levels, two of them transposed convolutions
PP = PointPillarsConfig(bounds=BOUNDS, grid=(32, 32), max_pillars=256,
                        max_points_per_pillar=16, pfn_features=16,
                        backbone_channels=(16, 32, 32),
                        backbone_blocks=(2, 1, 1), upsample_channels=32)
CP = CenterPointConfig(bounds=BOUNDS, grid=(32, 32), max_pillars=256,
                       max_points_per_pillar=16, pfn_features=16,
                       backbone_channels=(16, 32), backbone_blocks=(1, 1),
                       upsample_channels=32, head_channels=8, window=9,
                       top_k=8)
SST_CFG = SSTConfig(bounds=BOUNDS, grid=(32, 32), max_pillars=256,
                    max_points_per_pillar=16, pfn_features=16, window=8,
                    capacity=16, depth=2, num_heads=2, neck_channels=16)
SEG = BEVSegConfig(bounds=BOUNDS, grid=(32, 32), max_pillars=256,
                   max_points_per_pillar=8, pfn_features=8,
                   enc_channels=(8, 16), enc_blocks=(1, 2), dec_channels=8,
                   num_classes=3)
RTOL = 2e-6
FOLD = "d3d.bev.fold"


def _points(seed, n=2048):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 16, n), rng.uniform(-8, 8, n),
                     rng.uniform(-3, 1, n), rng.uniform(0, 1, n)],
                    axis=1).astype(np.float32)


@torch.no_grad()
def _randomize_bn(model, seed):
    """Every BatchNorm's statistics and affine drawn away from identity
    (mean != 0, var != 1), so a dropped mean or a wrong fold axis shows."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            c = mod.num_features
            mod.running_mean.copy_(torch.randn(c, generator=gen) * 0.5)
            mod.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
            mod.weight.copy_(torch.rand(c, generator=gen) + 0.5)
            mod.bias.copy_(torch.randn(c, generator=gen) * 0.2)
    return model


def _inputs(cfg, seed=0):
    f, c, v = pillarize(torch.from_numpy(_points(seed)), cfg)
    return f[None], c[None], v[None]


def _map(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _both(fn):
    """``fn()`` on the inference route (``inference_mode``) and as the
    layers are written (gradients on)."""
    with torch.inference_mode():
        fused = fn()
    with torch.enable_grad():
        written = fn()
    return fused, written


def _flat(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _assert_close(fused, written):
    worst = 0.0
    for a, b in zip(_flat(fused), _flat(written)):
        b = b.detach()
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = float(b.abs().max()) or 1.0
        err = float((a - b).abs().max())
        assert err <= RTOL * (scale + 1), (err, scale)
        worst = max(worst, err / scale)
    return worst


def _cases():
    """name -> (model, callable(model) running the shared layers)."""
    def pp():
        m = PointPillars(PP, device="cpu")
        inputs = _inputs(PP)
        return m, lambda: m(*inputs)

    def cp():
        m = CenterPoint(CP, device="cpu")
        inputs = _inputs(CP)
        return m, lambda: m(*inputs)

    def sst_neck():
        m = SST(SST_CFG, device="cpu")
        x = _map((2, m.neck.convs[0].in_channels, 32, 32), 1)
        return m, lambda: m.neck(x)

    def bevseg_block():
        m = BEVSeg(SEG, device="cpu")
        x = _map((2, 8, 32, 32), 2)
        return m, lambda: m.dec(m.blocks[1](x))

    def up_square():
        m = _Upsample(128, 128, 2, "float32")
        x = _map((2, 128, 6, 5), 3)
        return m, lambda: m(x)

    return dict(pointpillars=pp, centerpoint=cp, sst_neck=sst_neck,
                bevseg_block=bevseg_block, upsample_128=up_square)


@pytest.mark.parametrize("name", list(_cases()))
def test_inference_route_matches_the_written_layers(name):
    model, run = _cases()[name]()
    _randomize_bn(model.eval(), 7)
    fused, written = _both(run)
    _assert_close(fused, written)


def _flax_bn_relu(y, bn):
    """flax's BatchNorm at the running statistics, then the ReLU, as the
    training route writes the formula."""
    shape = [1, -1] + [1] * (y.ndim - 2)
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return F.relu((y - bn.running_mean.view(shape)) * mul.view(shape)
                  + bn.bias.view(shape))


@torch.no_grad()
def test_epilogue_is_flax_batchnorm_bit_for_bit():
    """Each layer of the route is its linear part on the same weights and
    flax's formula: equal bit for bit (a stride-2 block's asymmetric
    padding, a 128 -> 128 transposed convolution, the pillar net)."""
    block = _randomize_bn(_ConvBlock(8, 16, 2, 2, "float32"), 17)
    x = _map((2, 8, 10, 12), 9).permute(0, 1, 3, 2)       # not contiguous
    want = x.contiguous()
    for i, (conv, bn) in enumerate(zip(block.convs, block.bns)):
        want = _flax_bn_relu(_conv_same(want, conv.weight, 2 if i == 0
                                        else 1), bn)
    assert torch.equal(block(x), want)

    up = _randomize_bn(_Upsample(128, 128, 2, "float32"), 18)
    x = _map((1, 128, 3, 4), 10)
    assert torch.equal(up(x), _flax_bn_relu(
        F.conv_transpose2d(x, up.conv.weight, stride=2), up.bn))

    pfn = _randomize_bn(_PFN(9, 16, "float32"), 19)
    x = _map((1, 6, 5, 9), 11)
    pmask = x[..., 0] > -0.5
    y = _flax_bn_relu(F.linear(x, pfn.dense.weight).reshape(-1, 16),
                      pfn.bn).reshape(1, 6, 5, 16)
    y = torch.where(pmask[..., None], y, -1.0).amax(dim=-2)
    assert torch.equal(pfn(x, pmask), torch.where(y >= 0, y, 0.0))


def test_upsample_writes_its_slice():
    up = _randomize_bn(_Upsample(16, 8, 2, "float32"), 5)
    x = _map((2, 16, 4, 3), 6)
    feat = torch.full((2, 24, 8, 6), float("nan"))
    with torch.inference_mode():
        ret = up(x, out=feat[:, 8:16])
    with torch.enable_grad():
        want = up(x).detach()
    assert ret.data_ptr() == feat[:, 8:16].data_ptr()
    torch.testing.assert_close(feat[:, 8:16], want, rtol=RTOL, atol=RTOL)
    assert torch.isnan(feat[:, :8]).all() and torch.isnan(feat[:, 16:]).all()


def test_epilogue_plain_version():
    """Maps (in place and into a channel slice) and rows; the statistics
    in float32 for a bfloat16 map, float64 for a float64 one."""
    x = _map((2, 5, 4, 3), 8)
    stats = [torch.linspace(-1, 1, 5), torch.linspace(0.5, 2, 5),
             torch.linspace(0.3, -0.3, 5)]
    m, k, b = (t.view(1, -1, 1, 1) for t in stats)
    want = torch.relu((x - m) * k + b)
    out = torch.zeros(2, 9, 4, 3)
    assert bn_relu(x, *stats, out=out[:, 2:7]).data_ptr() == \
        out[:, 2:7].data_ptr()
    assert torch.equal(out[:, 2:7], want)
    assert not out[:, :2].any() and not out[:, 7:].any()
    assert bn_relu(x, *stats) is x and torch.equal(x, want)
    rows = _map((7, 5), 12)
    want = torch.relu((rows - stats[0]) * stats[1] + stats[2])
    assert torch.equal(bn_relu(rows, *stats), want)
    half = _map((2, 5, 4, 3), 13).bfloat16()
    want = torch.relu((half.float() - m) * k + b).bfloat16()
    assert torch.equal(bn_relu(half, *stats), want)
    with pytest.raises(ValueError):
        bn_relu(x, stats[0][:4], *stats[1:])
    with pytest.raises(ValueError):
        bn_relu(x, *(t.double() for t in stats))
    with pytest.raises(ValueError):
        bn_relu(x, *stats, out=out[:, :4])
    with pytest.raises(ValueError):
        bn_relu(x[0], *stats)


# -- the training route, bit for bit ---------------------------------------

def _pfn_train(pfn, x, pmask):
    x = F.linear(x, pfn.dense.weight)
    x = F.relu(_bn_train(x.reshape(-1, x.shape[-1]), pfn.bn).reshape(x.shape))
    x = torch.where(pmask[..., None], x, -1.0)
    x = x.gather(-2, x.detach().argmax(dim=-2, keepdim=True)).squeeze(-2)
    return torch.where(x >= 0, x, 0.0)


def _block_train(block, x):
    for i, (conv, bn) in enumerate(zip(block.convs, block.bns)):
        x = _conv_same(x, conv.weight, block.stride if i == 0 else 1)
        x = F.relu(_bn_train(x, bn))
    return x


def _up_train(up, x):
    x = (F.conv_transpose2d(x, up.conv.weight, stride=up.factor)
         if up.factor > 1 else F.conv2d(x, up.conv.weight))
    return F.relu(_bn_train(x, up.bn))


def _pointpillars_train(m, features, coords, valid):
    """PointPillars' training forward, composed of the layers' arithmetic
    as written: PFN, canvas, blocks, upsamplings, concatenation, heads."""
    pmask = (features != 0).any(dim=-1)
    pf = _pfn_train(m.pfn, features, pmask) * valid[..., None].float()
    x = scatter_to_bev(pf, coords, valid, m.cfg.grid).permute(0, 3, 1, 2)
    ups = []
    for block, up in zip(m.blocks, m.ups):
        x = _block_train(block, x)
        ups.append(_up_train(up, x))
    feat = torch.cat(ups, dim=1)
    return tuple(_head(feat, conv, c, torch.float32) for conv, c in (
        (m.head_cls, m.cfg.num_classes), (m.head_box, 7), (m.head_dir, 2)))


@pytest.mark.parametrize("grad", [True, False])
def test_training_route_is_the_written_arithmetic(grad):
    """``train=True`` with gradients on or off: outputs and the moved
    running statistics equal the layers' own arithmetic exactly, after an
    inference call has filled the fold cache."""
    model = _randomize_bn(PointPillars(PP, device="cpu"), 9)
    inputs = _inputs(PP, 1)
    with torch.inference_mode():
        model(*inputs)
    ref = copy.deepcopy(model)
    with torch.set_grad_enabled(grad):
        got = model(*inputs, train=True)
        want = _pointpillars_train(ref, *inputs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for (name, g), w in zip(model.state_dict().items(),
                            ref.state_dict().values()):
        assert torch.equal(g, w), name


# -- the fold cache --------------------------------------------------------

def _folds(fn):
    """(number of ``bev.fold`` spans, result) of ``fn()``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return sum(e.name == FOLD for e in prof.events()), out


def _layers(model):
    """The layers with a BatchNorm: the pillar net's, every convolution's,
    every upsampling's."""
    return 1 + sum(len(b.convs) for b in model.blocks) + len(model.ups)


def test_fold_cache_folds_once_and_refolds_on_change():
    model = _randomize_bn(PointPillars(PP, device="cpu"), 13)
    detect = make_pointpillars_detector(
        model, None, PP, make_anchors(PP, device="cpu"),
        [KittiObjectClass.Car], score_threshold=0.0, top_k=16, device="cpu")
    pts = _points(2)
    counts = [_folds(lambda: detect(pts))[0] for _ in range(5)]
    assert counts == [_layers(model), 0, 0, 0, 0]

    inputs = _inputs(PP, 3)

    def infer():
        with torch.inference_mode():
            return model(*inputs)

    def check(want_folds):
        n, fused = _folds(infer)
        assert n == want_folds
        with torch.enable_grad():
            _assert_close(fused, model(*inputs))
        assert _folds(infer)[0] == 0

    check(0)
    state = _randomize_bn(copy.deepcopy(model), 14).state_dict()
    model.load_state_dict(state)
    check(_layers(model))
    with torch.no_grad():                    # an optimizer's step
        model.blocks[1].bns[0].weight.mul_(1.25)
    check(1)
    model.ups[2].bn.running_var.mul_(1.5)
    check(1)
    with torch.no_grad():                    # the weights are not folded
        model.blocks[0].convs[1].weight.mul_(0.75)
    check(0)
    with torch.no_grad():
        model(*inputs, train=True)           # moves every statistic
    check(_layers(model))


def test_inference_tensor_parameters_refold_every_call():
    """Statistics made under ``inference_mode`` count no versions: their
    fold is made on every call and not kept."""
    with torch.inference_mode():
        up = _randomize_bn(_Upsample(8, 8, 2, "float32"), 15)
        x = _map((1, 8, 3, 3), 16)
        counts = [_folds(lambda: up(x))[0] for _ in range(2)]
        got = up(x)
    assert counts == [1, 1]
    with torch.no_grad():
        want = _flax_bn_relu(F.conv_transpose2d(x, up.conv.weight, stride=2),
                             up.bn)
    assert torch.equal(got, want)
