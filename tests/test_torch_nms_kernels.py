"""The schedules of the port's K1 (``csrc/rbox_iou.cu``) and K4
(``csrc/soft_nms.cu``) on the CPU: K1's reject test (its plain version
``geometry_cuda._reject_plain``) never skips a pair whose IoU is not
exactly +0.0, in the port's plain version and in the Pallas kernel
(interpret mode), and K1's tiles write every entry once; a numpy emulation
of K4's two passes (overlap marks, then the cascade with each lane's cached
best and updates of marked boxes only) equals the plain cascade and the
Pallas kernel. The kernels themselves run only on the card
(``chip_smoke.py``)."""

import math
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from d3d_tpu.ops import geometry_pallas as P
from d3d_tpu.ops.nms_pallas import soft_nms_scan

from d3d_tpu_torch.ops import _build
from d3d_tpu_torch.ops import geometry_cuda as TC
from d3d_tpu_torch.ops import geometry_soa as TS
from d3d_tpu_torch.ops import nms_cuda as TK

_ADVERSARIAL = np.array([
    [[1.0, 2.0, 3.0, 1.5, 0.3], [1.0, 2.0, 3.0, 1.5, 0.3]],
    [[0.0, 0.0, 2.0, 2.0, 0.0], [2.0, 0.0, 2.0, 2.0, 0.0]],
    [[0.0, 0.0, 2.0, 2.0, 0.0], [2.0, 2.0, 2.0, 2.0, 0.0]],
    [[0.0, 0.0, 4.0, 4.0, 0.2], [0.1, 0.1, 1.0, 1.0, 0.7]],
    [[0.0, 0.0, 2.0, 2.0, 0.0], [1.0, 0.5, 2.0, 2.0, 0.0]],
    [[0.0, 0.0, 3.0, 1.0, 0.0], [0.0, 0.0, 3.0, 1.0, np.pi / 2]],
    [[0.0, 0.0, 2.0, 2.0, 0.0], [0.0, 0.0, 2.0, 2.0, np.pi / 2]],
    [[0.0, 0.0, 1.0, 1.0, 0.0], [10.0, 10.0, 1.0, 1.0, 0.0]],
    [[0.0, 0.0, 2.0, 2.0, np.pi / 4], [0.5, 0.5, 2.0, 2.0, np.pi / 4]],
])


def _c_constant(source, name):
    text = (_build.CSRC / source).read_text()
    return float(re.search(rf"constexpr \w+ {name} = ([0-9.e]+)f?;",
                           text).group(1))


def test_kernel_constants_match_the_wrappers():
    assert _c_constant("rbox_iou.cu", "kRejectRel") == TC._REJECT_REL
    assert (_c_constant("rbox_iou.cu", "kRejectMaxScale")
            == TC._REJECT_MAX_SCALE)
    assert _c_constant("soft_nms.cu", "kStagedMaxN") == TK._SOFT_STAGED_MAX_N
    assert _c_constant("soft_nms.cu", "kMaxN") == TK._SOFT_MAX_N
    assert _c_constant("soft_nms.cu", "kListLen") == TK._SOFT_LIST_LEN


# ---------------------------------------------------------------------------
# K1: the reject test
# ---------------------------------------------------------------------------

def _corner(box, k):
    """Corner k (CCW from (-w/2, -h/2)) of an xywhr box, in float64."""
    x, y, w, h, r = box
    lx = (-w / 2, w / 2, w / 2, -w / 2)[k]
    ly = (-h / 2, -h / 2, h / 2, h / 2)[k]
    return (x + math.cos(r) * lx - math.sin(r) * ly,
            y + math.sin(r) * lx + math.cos(r) * ly)


def _near_touching(rng, count, centre_scale):
    """Pairs that touch or nearly touch: a shared edge (the second box one
    width along the first's axis), a corner on a corner of a turned box, and
    nearly parallel neighbours, each moved by gaps of 0, +-1e-6 and +-1e-5
    times the boxes' coordinate scale."""
    a, b = [], []
    for _ in range(count):
        x, y = (rng.random(2) - 0.5) * 2 * centre_scale
        w, h = rng.random(2) * 4 + 0.5
        r = rng.random() * 2 * np.pi
        base = (x, y, w, h, r)
        scale = abs(x) + abs(y) + w + h
        ux, uy = math.cos(r), math.sin(r)
        for rel in (0.0, 1e-6, -1e-6, 1e-5, -1e-5):
            gap = rel * scale
            # shared edge, same size and heading
            d = w + gap
            a.append(base)
            b.append((x + d * ux, y + d * uy, w, h, r))
            # nearly parallel neighbour above (0.7 times as high)
            d = 0.85 * h + gap
            a.append(base)
            b.append((x - d * uy, y + d * ux, w, h * 0.7,
                      r + rng.choice([1e-5, -1e-5, 1e-3])))
            # corner on corner: a turned box whose corner 0 sits on the
            # first box's corner 2, pushed out along the diagonal
            turn = rng.random() * np.pi
            w2, h2 = rng.random(2) * 3 + 0.5
            px, py = _corner(base, 2)
            qx, qy = _corner((0.0, 0.0, w2, h2, r + turn), 0)
            dx, dy = px - x, py - y
            norm = math.hypot(dx, dy)
            a.append(base)
            b.append((px - qx + gap * dx / norm, py - qy + gap * dy / norm,
                      w2, h2, r + turn))
    return (np.asarray(a, np.float32), np.asarray(b, np.float32))


def _random_boxes(rng, n, spread):
    return np.stack([rng.random(n) * spread, rng.random(n) * spread,
                     rng.random(n) * 4 + 0.5, rng.random(n) * 4 + 0.5,
                     rng.random(n) * 2 * np.pi], 1).astype(np.float32)


def _assert_rejects_only_zeros(b1, b2, pairwise, pallas=True):
    """Where the reject test skips a pair, the plain IoU (and the Pallas
    kernel's) is exactly +0.0. ``pairwise``: test (b1[i], b2[i]) only."""
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    rej = TC._reject_plain(t1, t2).numpy()
    iou = TS._rbox_iou_matrix_plain(t1, t2).numpy()
    if pairwise:
        rej, iou = rej.diagonal(), iou.diagonal()
    bad = rej & ((iou != 0) | np.signbit(iou))
    assert not bad.any(), (np.argwhere(bad)[:5], iou[bad][:5])
    if pallas:
        ref = np.asarray(P.rbox_iou_matrix(jnp.asarray(b1), jnp.asarray(b2),
                                           interpret=True))
        if pairwise:
            ref = ref.diagonal()
        assert not (rej & (ref != 0)).any()
    return rej


@pytest.mark.parametrize("spread", [20.0, 70.0, 2000.0])
def test_reject_skips_only_zero_pairs_random(rng, spread):
    b1 = _random_boxes(rng, 40, spread)
    b2 = np.concatenate([b1[:5], _random_boxes(rng, 60, spread)])
    rej = _assert_rejects_only_zeros(b1, b2, pairwise=False)
    assert rej.any() and not rej[:5, :5].diagonal().any()


def test_reject_skips_only_zero_pairs_adversarial():
    b = _ADVERSARIAL.astype(np.float32)
    rej = _assert_rejects_only_zeros(b[:, 0], b[:, 1], pairwise=False)
    # touching pairs (diagonal 1, 2) run the chain; the disjoint one does not
    assert not rej.diagonal()[:7].any() and rej[7, 7]


@pytest.mark.parametrize("centre_scale", [1.0, 50.0, 1e4])
def test_reject_keeps_near_touching_pairs(rng, centre_scale):
    b1, b2 = _near_touching(rng, 8, centre_scale)
    rej = _assert_rejects_only_zeros(b1, b2, pairwise=True,
                                     pallas=centre_scale <= 50)
    assert not rej.any()


def test_reject_never_skips_nonfinite_or_degenerate_boxes(rng):
    far = _random_boxes(rng, 6, 10.0)
    odd = far.copy()
    odd[0, 0] = np.nan
    odd[1, 2] = np.inf
    odd[2, 4] = np.nan
    odd[3, 1] = -np.inf
    odd[4, 2] = 0.0              # zero width: a segment
    odd[5, 0] = 3e9              # corners beyond the reject test's range
    far[:, :2] += 1000.0         # far from every box of `odd`
    rej = TC._reject_plain(torch.from_numpy(odd), torch.from_numpy(far))
    assert not rej.any()
    rej = TC._reject_plain(torch.from_numpy(far), torch.from_numpy(odd))
    assert not rej.any()
    # the same finite boxes far apart are rejected
    sane = _random_boxes(rng, 6, 10.0)
    assert TC._reject_plain(torch.from_numpy(sane),
                            torch.from_numpy(far)).all()


def _k1_tile(n, m):
    """The tile csrc/rbox_iou.cu picks: the largest whose grid fills the
    132 SMs once, else 8."""
    for t in (64, 32, 16):
        if math.ceil(n / t) * math.ceil(m / t) >= 132:
            return t
    return 8


@pytest.mark.parametrize("n,m", [(100, 100), (37, 155), (512, 40), (3, 1)])
def test_k1_tiles_write_every_entry_once(rng, n, m):
    """An emulation of K1's blocks (phase 1 writes +0.0 for rejected pairs,
    phase 2 the chain's IoU for the queued ones) into a NaN-filled buffer:
    every entry is written exactly once and the result is the plain
    matrix."""
    b1 = torch.from_numpy(_random_boxes(rng, n, 30.0))
    b2 = torch.from_numpy(_random_boxes(rng, m, 30.0))
    rej = TC._reject_plain(b1, b2).numpy()
    iou = TS._rbox_iou_matrix_plain(b1, b2).numpy()
    t = _k1_tile(n, m)
    threads = min(t * t, 256)
    out = np.full((n, m), np.nan, np.float32)
    writes = np.zeros((n, m), np.int64)
    for by in range(math.ceil(n / t)):
        for bx in range(math.ceil(m / t)):
            queue = []
            for p0 in range(0, t * t, threads):
                for p in range(p0, p0 + threads):
                    r, c = by * t + p // t, bx * t + p % t
                    if r >= n or c >= m:
                        continue
                    if rej[r, c]:
                        out[r, c] = 0.0
                        writes[r, c] += 1
                    else:
                        queue.append((r, c))
            for r, c in queue:
                out[r, c] = iou[r, c]
                writes[r, c] += 1
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, iou)


# ---------------------------------------------------------------------------
# K4: the two-pass cascade
# ---------------------------------------------------------------------------

def _k4_layout(n):
    """Boxes a lane of K4's cascade, as csrc/soft_nms.cu `launch` picks
    them: one warp up to 1024 boxes (a power of two a lane), then 32 a
    lane."""
    if n > TK._SOFT_MAX_N:
        raise ValueError(n)
    if n > TK._SOFT_STAGED_MAX_N:
        return 32
    return 1 << (-(-n // 32) - 1).bit_length()


def _key(v):
    """csrc/soft_nms.cu score_key."""
    if np.isnan(v):
        return 0
    u = int(np.float32(0.0 if v == 0 else v).view(np.uint32))  # -0 -> +0
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def _emulate_k4(iou, scores0, pre, iou_t, score_t, param, method,
                c=None):
    """K4's schedule in numpy. Pass 1, per row: the marks (j != i,
    iou > t) as 32-bit words, the marks before each word (saturated at 255)
    and the decay factors of the first ``_SOFT_LIST_LEN`` marks. Pass 2:
    thread t owns boxes tc .. tc + c - 1 with availability and suppression
    bits and a cached best; per step a reduction per warp of 32 threads,
    then across warps; each thread with available boxes reads its word of
    the pick's marks and decays its marked boxes by the listed factor of
    their rank, or the row's own past the list; only changed threads
    recompute their best. The decay factors are the plain version's
    (``_soft_decay`` of a row)."""
    n = iou.shape[0]
    c = c or _k4_layout(n)
    threads = -(-n // (32 * c)) * 32
    ll = TK._SOFT_LIST_LEN
    t32, st = np.float32(iou_t), np.float32(score_t)
    p = torch.tensor(param, dtype=torch.float32)
    tiny = torch.tensor(1e-38, dtype=torch.float32)
    words = (n + 31) // 32
    marks = np.zeros((n, words), np.int64)
    before = np.zeros((n, words), np.int64)
    decs = np.zeros((n, ll), np.float32)
    dec_rows = [TK._soft_decay(torch.from_numpy(iou[i]), p, tiny,
                               method).numpy() for i in range(n)]
    for i in range(n):
        cnt = 0
        for w in range(words):
            before[i, w] = min(cnt, 255)
            for j in range(w * 32, min(n, w * 32 + 32)):
                if j != i and iou[i, j] > t32:
                    marks[i, w] |= 1 << (j % 32)
                    if cnt < ll:
                        decs[i, cnt] = dec_rows[i][j]
                    cnt += 1
    sc = scores0.astype(np.float32).copy()
    avail, supp = [0] * threads, [0] * threads
    for j in range(n):
        t, k = divmod(j, c)
        if pre[j]:
            supp[t] |= 1 << k
        else:
            avail[t] |= 1 << k

    def best(t):
        bk, bi = 0, None
        for k in range(c):
            if avail[t] >> k & 1:
                key = _key(sc[t * c + k])
                if key > bk:
                    bk, bi = key, t * c + k
        return bk, bi

    cached = [best(t) for t in range(threads)]
    for _ in range(n):
        warps = []
        for w in range(threads // 32):
            ks = cached[w * 32:(w + 1) * 32]
            key = max(k for k, _ in ks)
            idx = min((i for k, i in ks if k == key and i is not None),
                      default=None)
            warps.append((key, idx, any(avail[w * 32:(w + 1) * 32])))
        key = max(k for k, _, _ in warps)
        idx = min((i for k, i, _ in warps if k == key and i is not None),
                  default=None)
        if not any(a for _, _, a in warps):
            break
        pick = n - 1 if key == 0 else idx
        for t in range(threads):
            if not avail[t]:
                continue
            j0 = t * c
            word = int(marks[pick, j0 // 32])
            bit0 = j0 % 32
            hit = (word >> bit0) & ((1 << c) - 1) & avail[t]
            changed = bool(hit)
            for k in range(c):
                if hit >> k & 1:
                    rank = before[pick, j0 // 32] + bin(
                        word & ((1 << (bit0 + k)) - 1)).count("1")
                    dec = (decs[pick, rank] if rank < ll
                           else dec_rows[pick][j0 + k])
                    sc[j0 + k] = sc[j0 + k] * dec
                    if sc[j0 + k] < st:
                        avail[t] &= ~(1 << k)
                        supp[t] |= 1 << k
            if j0 <= pick < j0 + c:
                avail[t] &= ~(1 << (pick - j0))
                changed = True
            if changed:
                cached[t] = best(t)
    return np.array([bool(supp[j // c] >> (j % c) & 1) for j in range(n)])


def _soft_inputs(rng, n, spread, tied=False, score_t=0.1, sizes=(1.0, 4.0)):
    lo, hi = sizes
    boxes = np.stack([rng.random(n) * spread, rng.random(n) * spread,
                      rng.random(n) * (hi - lo) + lo,
                      rng.random(n) * (hi - lo) + lo,
                      rng.random(n) * np.pi], 1).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    if tied:
        scores = np.repeat(scores[:n // 4], 4)[:n]
    iou = TS._rbox_iou_matrix_plain(torch.from_numpy(boxes),
                                    torch.from_numpy(boxes)).numpy()
    pre = scores <= score_t
    pre[np.argsort(-scores, kind="stable")[0]] = False
    init = np.where(pre, -np.inf, scores).astype(np.float32)
    return iou, init, pre


def _check_k4(iou, init, pre, args, layouts=(None,), pallas=True):
    plain = TK._soft_nms_scan_plain(torch.from_numpy(iou),
                                    torch.from_numpy(init),
                                    torch.from_numpy(pre), *args).numpy()
    for c in layouts:
        got = _emulate_k4(iou, init, pre, *args, c=c)
        np.testing.assert_array_equal(got, plain, err_msg=f"c={c}")
    if pallas:
        ref = np.asarray(soft_nms_scan(jnp.asarray(iou), jnp.asarray(init),
                                       jnp.asarray(pre), *args,
                                       interpret=True))
        np.testing.assert_array_equal(plain, ref)
    return plain


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("method,param", [("linear", 0.5), ("linear", 0.0),
                                          ("gaussian", 0.4)])
def test_k4_schedule_matches_plain_and_pallas(rng, method, param, tied):
    """Both methods, p = 0 (linear decay 1 - 1 = 0) and tied scores (the
    lowest index first), in the kernel's layout for n = 72 (4 boxes a
    lane, one warp) and with 1 and 2 boxes a lane (3 warps, 2)."""
    iou, init, pre = _soft_inputs(rng, 72, 14.0, tied)
    sup = _check_k4(iou, init, pre, (0.2, 0.1, param, method),
                    layouts=(None, 1, 2))
    assert 0 < sup.sum() < 72


@pytest.mark.parametrize("method,param", [("linear", 1.0),
                                          ("gaussian", 0.5)])
def test_k4_schedule_edge_cases(rng, method, param):
    """Every box pre-suppressed (no step runs), iou_threshold 0 (every
    overlapping pair decays), and a dense cluster where every pair
    overlaps."""
    iou, init, pre = _soft_inputs(rng, 40, 10.0)
    all_pre = np.ones(40, bool)
    got = _emulate_k4(iou, np.full(40, -np.inf, np.float32), all_pre,
                      0.25, 0.3, param, method)
    assert got.all()
    _check_k4(iou, init, pre, (0.0, 0.3, param, method), layouts=(None, 1))
    # every row holds 47 marks: past the list the decay is computed
    iou, init, pre = _soft_inputs(rng, 48, 0.5, sizes=(3.0, 4.0))
    assert (iou > 0).all()
    sup = _check_k4(iou, init, pre, (0.0, 0.05, param, method),
                    layouts=(None, 1, 32))
    assert sup.any()


def test_k4_layouts_cover_every_n():
    for n in (1, 31, 32, 33, 100, 512, 1000, 1024, 1025, 2048, 4097, 8192):
        c = _k4_layout(n)
        lanes = -(-n // c)
        assert c <= 32 and lanes <= 256
        assert (lanes <= 32) == (n <= TK._SOFT_STAGED_MAX_N)
    with pytest.raises(ValueError):
        _k4_layout(TK._SOFT_MAX_N + 1)
