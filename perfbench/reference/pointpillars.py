"""Plain PointPillars (Lang et al., CVPR 2019, arXiv:1812.05784) in
PyTorch: pillars, the pillar feature net, the three-block backbone with
its upsampling and the SSD head, one frame at a time, from a state dict
keyed as the program's module is. Departures from the paper, all the
program's configuration: BatchNorm epsilon 1e-3, "SAME" padding (a
stride-2 layer on an even map pads (0, 1)), the PFN's masked max writes
0 for an empty pillar, and the canvas keeps x along its first axis.

``train=True`` normalises by the batch's statistics (biased variance
``E[x^2] - E[x]^2``) and returns them, so the caller can move the running
ones; the masked max then sends its gradient to the first maximal point.
"""

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["pillarize", "forward", "dense_flops"]

EPS = 1e-3


def pillarize(points, model):
    """(N, 4) float32 points -> (features (P, K, 9), coords (P, 2) int64
    [ix, iy], valid (P,)): the first P occupied cells in x-major key
    order, the first K points of each in input order; a point carries x,
    y, z, intensity, its offset from the mean of its pillar's kept points
    and from the pillar's centre."""
    dev = points.device
    b = torch.tensor(model["bounds"], dtype=torch.float32, device=dev)
    w, h = model["grid"]
    p_max, k_max = model["max_pillars"], model["max_points_per_pillar"]
    sh = torch.tensor([w, h, 1], dtype=torch.int32, device=dev)
    lo = b.reshape(3, 2)[:, 0]
    vsize = (b.reshape(3, 2)[:, 1] - lo) / sh
    idx = torch.trunc((points[:, :3] - lo) / vsize).to(torch.int64)
    inside = ((idx >= 0) & (idx < sh)).all(dim=1)
    key = idx[:, 0] * h + idx[:, 1]
    pts, key = points[inside], key[inside]
    order = torch.sort(key, stable=True).indices
    pts, key = pts[order], key[order]
    cells, first, counts = torch.unique_consecutive(
        key, return_inverse=True, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(key), device=dev) - starts[first]
    keep = (first < p_max) & (slot < k_max)
    feats = torch.zeros(p_max, k_max, 4, device=dev)
    feats[first[keep], slot[keep]] = pts[keep]
    mask = torch.zeros(p_max, k_max, dtype=torch.bool, device=dev)
    mask[first[keep], slot[keep]] = True
    npill = min(len(cells), p_max)
    coords = torch.zeros(p_max, 2, dtype=torch.int64, device=dev)
    coords[:npill, 0] = cells[:npill] // h
    coords[:npill, 1] = cells[:npill] % h
    valid = torch.arange(p_max, device=dev) < npill
    n = mask.sum(dim=1).clamp_min(1).to(torch.float32)
    xyz = feats[..., :3]
    centroid = (xyz * mask[..., None]).sum(dim=1) / n[:, None]
    vs = torch.tensor(((np.array(model["bounds"][1::2])
                        - np.array(model["bounds"][0::2]))
                       / np.array([w, h, 1]))[:2], dtype=torch.float32,
                      device=dev)
    centre = (coords.to(torch.float32) + 0.5) * vs + lo[:2]
    out = torch.cat([feats, xyz - centroid[:, None], xyz[..., :2]
                     - centre[:, None]], -1) * mask[..., None]
    return out, coords, valid, mask


def _bn(x, st, name, stats):
    """BatchNorm over dim 1: the running statistics, or (``stats`` a
    dict) the batch's, recorded under ``name``."""
    shape = [1, -1] + [1] * (x.ndim - 2)
    if stats is None:
        mean, var = st[name + ".running_mean"], st[name + ".running_var"]
    else:
        dims = [d for d in range(x.ndim) if d != 1]
        mean = x.mean(dim=dims)
        var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
        stats[name] = (mean.detach(), var.detach())
    mul = torch.rsqrt(var + EPS) * st[name + ".weight"]
    return (x - mean.view(shape)) * mul.view(shape) + \
        st[name + ".bias"].view(shape)


def _same(x, wt, stride):
    pads = []
    for d in (3, 2):
        size, k = x.shape[d], wt.shape[d]
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), wt, stride=stride)


def _pfn(st, feats, mask, cast, stats):
    x = cast(feats) @ cast(st["pfn.dense.weight"]).T       # (B, P, K, F)
    shape = x.shape
    x = F.relu(_bn(x.reshape(-1, shape[-1]), st, "pfn.bn", stats)
               ).reshape(shape)
    x = torch.where(mask[..., None], x, -1.0)
    i = x.detach().argmax(dim=2, keepdim=True)
    x = x.gather(2, i).squeeze(2)
    return torch.where(x >= 0, x, 0.0)


def forward(st, model, feats, coords, valid, mask, cast=lambda t: t,
            stats=None):
    """Head outputs (cls (B, N, C), box (B, N, 7), dir (B, N, 2)) of a
    batch of pillarized frames; ``cast`` sets the compute precision of
    every product (the control's), ``stats`` (a dict) asks for batch
    statistics."""
    w, h = model["grid"]
    bsz = feats.shape[0]
    pf = _pfn(st, feats, mask, cast, stats) * valid[..., None]
    canvas = pf.new_zeros(bsz, w * h, pf.shape[-1])
    flat = coords[..., 0] * h + coords[..., 1]
    rows = torch.arange(bsz, device=pf.device)[:, None].expand_as(flat)
    canvas = canvas.index_put((rows[valid], flat[valid]), pf[valid])
    x = canvas.reshape(bsz, w, h, -1).permute(0, 3, 1, 2)
    ups = []
    for i, nb in enumerate(model["backbone_blocks"]):
        for j in range(nb):
            x = _same(cast(x), cast(st[f"blocks.{i}.convs.{j}.weight"]),
                      2 if (i > 0 and j == 0) else 1)
            x = F.relu(_bn(x, st, f"blocks.{i}.bns.{j}", stats))
        wt = cast(st[f"ups.{i}.conv.weight"])
        u = (F.conv_transpose2d(cast(x), wt, stride=2 ** i) if i
             else F.conv2d(cast(x), wt))
        ups.append(F.relu(_bn(u, st, f"ups.{i}.bn", stats)))
    feat = torch.cat(ups, 1)
    return tuple(_head(st, name, feat, c, cast)
                 for name, c in (("head_cls", model["num_classes"]),
                                 ("head_box", 7), ("head_dir", 2)))


def _head(st, name, feat, c, cast):
    out = F.conv2d(cast(feat), cast(st[name + ".weight"]),
                   cast(st[name + ".bias"]))
    return out.permute(0, 2, 3, 1).reshape(feat.shape[0], -1, c).float()


def dense_flops(model, point_features=4):
    """Multiply-adds x 2 of one frame's forward at the configuration's
    shapes: the PFN's linear layer over every pillar slot, every
    convolution and transposed convolution of the backbone over its whole
    map, the three 1x1 heads."""
    w, h = model["grid"]
    a = len(model["anchor_sizes"]) * len(model["anchor_rotations"])
    pfn = model["pfn_features"]
    macs = (model["max_pillars"] * model["max_points_per_pillar"]
            * (point_features + 5) * pfn)
    cin, cw, ch = pfn, w, h
    up = model["upsample_channels"]
    for i, (c, nb) in enumerate(zip(model["backbone_channels"],
                                    model["backbone_blocks"])):
        if i:
            cw, ch = -(-cw // 2), -(-ch // 2)
        macs += cw * ch * 9 * (cin * c + (nb - 1) * c * c)
        # the upsampling: a 1x1 conv, or an f x f transposed conv of
        # stride f, whose every output cell takes one tap
        macs += cw * ch * 4 ** i * c * up
        cin = c
    feat = up * len(model["backbone_channels"])
    macs += w * h * feat * a * (model["num_classes"] + 7 + 2)
    return 2 * macs
