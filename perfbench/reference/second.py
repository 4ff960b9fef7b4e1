"""Plain SECOND (Yan, Mao and Li, "SECOND: Sparsely Embedded Convolutional
Detection", Sensors 18(10):3337, 2018) in OpenPCDet's KITTI structure
(``tools/cfgs/kitti_models/second.yaml``: MeanVFE, ``VoxelBackBone8x``,
``BaseBEVBackbone``, ``AnchorHeadSingle``) in PyTorch, one frame at a time,
from a state dict keyed as the program's module is.

The sparse layers are dense 3D convolutions over the whole canvas, masked
by the active set: a submanifold layer keeps its input's set, a strided
layer's is the max pool of its input's over its window, spconv's rule (a
site is active when its window holds an active input). The canvas is taken
in slabs along x where it is large. Coordinates are (x, y, z); OpenPCDet's
spconv orders them (z, y, x).

Departures, all of the configuration: each voxel's mean over all its
points (OpenPCDet keeps 5), in float64; the first ``max_voxels`` voxels in
key order; the height folded z-major into the BEV channels (a permutation
of the first BEV convolution's inputs); SAME padding in the BEV network
(OpenPCDet: ``ZeroPad2d(1)``); BatchNorm epsilon 1e-3 from the running
statistics.
"""

import math

import torch
import torch.nn.functional as F

from .pointpillars import _bn, _head, _same

__all__ = ["voxelize", "extents", "forward", "layers", "sparse_work",
           "dense_flops"]

# canvas elements of one slab of a sparse layer's convolution
_SLAB_ELEMS = 1 << 26


def voxelize(points, model):
    """(N, 4) float32 points -> (features (V, 4) float32, coords (V, 3)
    int64 [ix, iy, iz]): the occupied cells of ``model["grid"]`` in
    ascending key ``(ix * Y + iy) * Z + iz``, the first ``max_voxels``, each
    the float64 mean of its points' x, y, z and intensity."""
    dev = points.device
    b = torch.tensor(model["bounds"], dtype=torch.float32,
                     device=dev).reshape(3, 2)
    sh = torch.tensor(model["grid"], dtype=torch.int32, device=dev)
    vsize = (b[:, 1] - b[:, 0]) / sh
    idx = torch.trunc((points[:, :3] - b[:, 0]) / vsize).to(torch.int64)
    inside = ((idx >= 0) & (idx < sh)).all(dim=1)
    _, gy, gz = model["grid"]
    key = (idx[:, 0] * gy + idx[:, 1]) * gz + idx[:, 2]
    pts, key = points[inside].double(), key[inside]
    cells, which = torch.unique(key, sorted=True, return_inverse=True)
    nv = min(len(cells), model["max_voxels"])
    keep = which < nv
    sums = pts.new_zeros(nv, pts.shape[1]).index_add_(0, which[keep],
                                                      pts[keep])
    counts = torch.bincount(which[keep], minlength=nv).double()
    cells = cells[:nv]
    coords = torch.stack([cells // (gy * gz), cells // gz % gy, cells % gz],
                         1)
    return (sums / counts[:, None]).float(), coords


def layers(model):
    """The sparse layers in order: (state-dict name, in channels, out
    channels, kernel, stride, padding), each a 3-tuple (x, y, z)."""
    lay = model["layout"]
    chans = model["stage_channels"]
    out, c_in = [], 4
    for s, ch in enumerate(chans):
        for i in range(model["subm_per_stage"]):
            out.append((f"middle.subm{s}_{i}", c_in, ch, (3,) * 3, (1,) * 3,
                        (1,) * 3))
            c_in = ch
        if s + 1 < len(chans):
            out.append((f"middle.down{s}", c_in, chans[s + 1], (3,) * 3,
                        (2,) * 3, tuple(lay["down_padding"][s])))
            c_in = chans[s + 1]
    out.append((f"middle.down{len(chans) - 1}", c_in, lay["out_channels"],
                tuple(lay["out_kernel"]), tuple(lay["out_stride"]), (0,) * 3))
    return out


def extents(model):
    """The sparse extents (x, y, z): the middle's input, then after each
    strided layer; the last is the map the BEV network folds."""
    g = [(model["grid"][0], model["grid"][1], model["layout"]["z_extent"])]
    for _, _, _, k, s, p in layers(model):
        if s != (1, 1, 1):
            g.append(tuple((n + 2 * pp - kk) // ss + 1
                           for n, kk, ss, pp in zip(g[-1], k, s, p)))
    return g


def _masks(coords, model):
    """The active set (a bool canvas) after each sparse layer, with the
    input's first."""
    m = torch.zeros(extents(model)[0], dtype=torch.bool, device=coords.device)
    m[coords[:, 0], coords[:, 1], coords[:, 2]] = True
    out = [m]
    for _, _, _, k, s, p in layers(model):
        if s != (1, 1, 1):
            m = F.max_pool3d(m[None, None].float(), k, s, p)[0, 0] > 0
        out.append(m)
    return out


def _sparse_layer(st, name, x, mask, kernel, stride, pad, cast):
    """One sparse layer on the (1, C, X, Y, Z) canvas ``x``: the
    convolution, BatchNorm, ReLU, zero outside ``mask`` (the output's
    active set), in slabs of output rows along x."""
    w = st[name + ".weight"]                      # (K, C, Cout), raster
    kern = w.reshape(*kernel, *w.shape[1:]).permute(4, 3, 0, 1, 2)
    kern = cast(kern)
    _, c, nx, ny, nz = x.shape
    ox = mask.shape[0]
    out = x.new_zeros((1, kern.shape[0]) + tuple(mask.shape))
    rows = max(1, _SLAB_ELEMS // (max(c, kern.shape[0]) * ny * nz))
    for o0 in range(0, ox, rows):
        o1 = min(ox, o0 + rows)
        i0 = stride[0] * o0 - pad[0]
        i1 = stride[0] * (o1 - 1) - pad[0] + kernel[0]
        slab = F.pad(x[:, :, max(i0, 0):min(i1, nx)],
                     (0, 0, 0, 0, max(-i0, 0), max(i1 - nx, 0)))
        y = F.conv3d(cast(slab), kern, stride=stride,
                     padding=(0, pad[1], pad[2]))
        y = F.relu(_bn(y.float(), st, name + ".bn", None))
        out[:, :, o0:o1] = y * mask[o0:o1]
    return out


def forward(st, model, feats, coords, cast=lambda t: t):
    """Head outputs (cls (1, N, C), box (1, N, 7), dir (1, N, 2)) of one
    voxelized frame; ``cast`` sets the compute precision of every product
    (the control's)."""
    masks = _masks(coords, model)
    x = feats.new_zeros((1, feats.shape[1]) + tuple(masks[0].shape))
    x[0][:, coords[:, 0], coords[:, 1], coords[:, 2]] = feats.T
    for (name, _, _, k, s, p), m in zip(layers(model), masks[1:]):
        x = _sparse_layer(st, name, x, m, k, s, p, cast)
    # the height fold, z-major: channel z * C + c
    _, c, nx, ny, nz = x.shape
    x = x.permute(0, 4, 1, 2, 3).reshape(1, nz * c, nx, ny)
    lay = model["layout"]
    ups = []
    for i, nb in enumerate(lay["bev_convs"]):
        for j in range(nb):
            x = _same(cast(x), cast(st[f"blocks.{i}.convs.{j}.weight"]),
                      2 if (i > 0 and j == 0) else 1)
            x = F.relu(_bn(x, st, f"blocks.{i}.bns.{j}", None))
        wt = cast(st[f"ups.{i}.conv.weight"])
        u = (F.conv_transpose2d(cast(x), wt, stride=2 ** i) if i
             else F.conv2d(cast(x), wt))
        ups.append(F.relu(_bn(u, st, f"ups.{i}.bn", None)))
    feat = torch.cat(ups, 1)
    return tuple(_head(st, name, feat, c, cast)
                 for name, c in (("head_cls", model["num_classes"]),
                                 ("head_box", 7), ("head_dir", 2)))


def sparse_work(coords, model):
    """Each sparse layer's work on one frame by this module's rule: dicts
    of its active input and output sites, its neighbour pairs (an active
    output and an active input in its window), kernel offsets and
    channels."""
    masks = _masks(coords, model)
    out = []
    for (name, cin, cout, k, s, p), m_in, m_out in zip(layers(model), masks,
                                                       masks[1:]):
        ones = torch.ones((1, 1) + k, device=coords.device)
        reach = F.conv3d(m_in[None, None].float(), ones, stride=s,
                         padding=p)[0, 0]
        pairs = int(torch.round((reach * m_out).double().sum()))
        out.append(dict(name=name, sites_in=int(m_in.sum()),
                        sites_out=int(m_out.sum()), pairs=pairs,
                        k=math.prod(k),
                        cin=cin, cout=cout))
    return out


def dense_flops(model):
    """Multiply-adds x 2 of the BEV network and heads at the
    configuration's shapes: every 3x3 convolution over its whole map, the
    upsamplings (a 2x2 transposed convolution of stride 2 takes one tap an
    output cell), the three 1x1 heads."""
    nx, ny, nz = extents(model)[-1]
    lay = model["layout"]
    a = len(model["anchor_sizes"]) * len(model["anchor_rotations"])
    cin, cw, ch = nz * lay["out_channels"], nx, ny
    macs = 0
    for i, (c, nb, up) in enumerate(zip(lay["bev_channels"],
                                        lay["bev_convs"],
                                        lay["bev_up_channels"])):
        if i:
            cw, ch = -(-cw // 2), -(-ch // 2)
        macs += cw * ch * 9 * (cin * c + (nb - 1) * c * c)
        macs += cw * ch * 4 ** i * c * up
        cin = c
    feat = sum(lay["bev_up_channels"])
    macs += nx * ny * feat * a * (model["num_classes"] + 7 + 2)
    return 2 * macs
