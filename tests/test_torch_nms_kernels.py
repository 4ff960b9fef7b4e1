"""The schedules of the port's K1 (``csrc/rbox_iou.cu``), K2/K3
(``csrc/nms_scan.cu``) and K4 (``csrc/soft_nms.cu``) on the CPU: K1's
reject test (its plain version ``geometry_cuda._reject_plain``) never skips
a pair whose IoU is not exactly +0.0, in the port's plain version and in
the Pallas kernel (interpret mode), and K1's tiles write every entry once,
in both output forms; K1's bit rows equal the JAX package's IoU matrix
thresholded; a numpy emulation of the scan's schedule (lane ownership, the
chunk chains, the broadcast, the ORs) equals the plain scan and both Pallas
scans; a numpy emulation of K4's two passes (overlap marks, then the
cascade with each lane's cached best and updates of marked boxes only)
equals the plain cascade and the Pallas kernel. The kernels themselves run
only on the card (``chip_smoke.py``)."""

import inspect
import math
import re

import numpy as np
import pytest

from _limits import time_limit

import jax.numpy as jnp
import torch

from d3d_tpu.ops import geometry_pallas as P
from d3d_tpu.ops import geometry_soa as S
from d3d_tpu.ops import nms as N
from d3d_tpu.ops.nms_pallas import nms_scan, nms_scan_blocked, soft_nms_scan

from d3d_tpu_torch.ops import _build
from d3d_tpu_torch.ops import nms as TN
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
    assert (_c_constant("soft_nms.cu", "kStagedMaxNF64")
            == TK._SOFT_STAGED_MAX_N_F64)
    assert _c_constant("soft_nms.cu", "kMaxN") == TK._SOFT_MAX_N
    assert _c_constant("soft_nms.cu", "kWordMaxN") == TK._SOFT_WORD_MAX_N
    assert (_c_constant("soft_nms.cu", "kSharedStateMaxN")
            == TK._SOFT_SHARED_STATE_MAX_N)
    assert _c_constant("soft_nms.cu", "kListLen") == TK._SOFT_LIST_LEN
    assert _c_constant("nms_scan.cu", "kWarpWords") * 64 == TK._WARP_MAX_N
    assert _c_constant("nms_scan.cu", "kMaxWords") == TK._MAX_N // 64


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
    lane up to 32 768 boxes, then 64, 128 or 256 (2, 4 or 8 words of
    bits a lane), the least that covers n with 1024 lanes."""
    if n > TK._SOFT_MAX_N:
        raise ValueError(n)
    if n > TK._SOFT_WORD_MAX_N:
        return next(c for c in (64, 128, 256) if n <= 1024 * c)
    if n > TK._SOFT_STAGED_MAX_N:
        return 32
    return 1 << (-(-n // 32) - 1).bit_length()


def _k4_warps(n):
    """Warps of K4's cascade, as csrc/soft_nms.cu `launch` picks them: the
    fewest power of two that covers the lanes up to 8 warps (scores in
    shared memory), then 16 up to 16 384 boxes and 32 up to 32 768 (scores
    in the scratch)."""
    lanes = -(-n // _k4_layout(n))
    if n <= TK._SOFT_SHARED_STATE_MAX_N:
        return 1 << (-(-lanes // 32) - 1).bit_length()
    return 16 if n <= 16384 else 32


_NAN_KEY = 0xFFFFFFFF  # csrc/soft_nms.cu kNanKey of a float32 score
_NAN_KEY64 = (1 << 64) - 1  # and of a float64 score


def _key(v):
    """csrc/soft_nms.cu score_key (float)."""
    if np.isnan(v):
        return _NAN_KEY
    u = int(np.float32(0.0 if v == 0 else v).view(np.uint32))  # -0 -> +0
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def _key64(v):
    """csrc/soft_nms.cu score_key (double)."""
    if np.isnan(v):
        return _NAN_KEY64
    u = int(np.float64(0.0 if v == 0 else v).view(np.uint64))
    return (~u & _NAN_KEY64) if u >> 63 else (u | 1 << 63)


def _warp_pick(lanes, wide):
    """csrc/soft_nms.cu warp_pick over a warp's (key, index) pairs (index
    None: no box): a 32-bit key is one max, then the least index holding
    it; a 64-bit key, which redux.sync has no form for, is the largest
    high word, the largest low word among the lanes holding it (0 from the
    rest), then the least index holding both."""
    if wide:
        top = max(k >> 32 for k, _ in lanes)
        lo = max((k & 0xFFFFFFFF) if k >> 32 == top else 0
                 for k, _ in lanes)
        key = top << 32 | lo
    else:
        key = max(k for k, _ in lanes)
    idx = min((i for k, i in lanes if k == key and i is not None),
              default=None)
    return key, idx


def _emulate_k4(iou, scores0, pre, iou_t, score_t, param, method,
                c=None, warps=None):
    """K4's schedule in numpy. Pass 1, per row: the marks (j != i,
    iou > t) as 32-bit words, the marks before each word (saturated at 255)
    and the decay factors of the first ``_SOFT_LIST_LEN`` marks. Pass 2:
    thread t owns boxes tc .. tc + c - 1 with availability and suppression
    bits and a cached best; per step a reduction per warp of 32 threads,
    then across warps; each thread with available boxes reads its word of
    the pick's marks and decays its marked boxes by the listed factor of
    their rank, or the row's own past the list; only changed threads
    recompute their best. A thread of more than 32 boxes reads a word of
    the pick's marks for each 32 of them. The decay factors are the plain
    version's (``_soft_decay`` of a row). The dtype is the matrix's:
    float64 keeps 64-bit keys and reduces them as :func:`_warp_pick`
    does. ``c`` and ``warps`` force a layout (default: the kernel's)."""
    n = iou.shape[0]
    c = c or _k4_layout(n)
    # the kernel's lanes: at least the boxes' (a layout of fewer boxes a
    # lane than the kernel's takes more), at most 32 warps
    threads = max(-(-n // (32 * c)) * 32, 32 * (warps or _k4_warps(n)))
    ll = TK._SOFT_LIST_LEN
    wide = iou.dtype == np.float64
    ft = iou.dtype.type
    tdt = torch.float64 if wide else torch.float32
    key_of = _key64 if wide else _key
    nan_key = _NAN_KEY64 if wide else _NAN_KEY
    t32, st = ft(iou_t), ft(score_t)
    p = torch.tensor(param, dtype=tdt)
    tiny = torch.tensor(1e-38, dtype=tdt)

    def decay(vals):  # the plain version's factors, element by element
        return TK._soft_decay(torch.from_numpy(np.ascontiguousarray(vals)),
                              p, tiny, method).numpy()

    words = (n + 31) // 32
    marks = np.zeros((n, words), np.int64)
    before = np.zeros((n, words), np.int64)
    decs = np.zeros((n, ll), iou.dtype)
    for r0 in range(0, n, 512):  # pass 1 in blocks of rows
        rows = np.arange(r0, min(n, r0 + 512))
        m = iou[rows] > t32
        m[np.arange(len(rows)), rows] = False
        mw = np.pad(m, ((0, 0), (0, words * 32 - n))).reshape(
            len(rows), words, 32)
        marks[rows] = (mw.astype(np.int64) << np.arange(32)).sum(-1)
        cnt = mw.sum(-1)
        before[rows] = np.minimum(np.cumsum(cnt, 1) - cnt, 255)
        rank = np.cumsum(m, 1) - 1
        ri, j = np.nonzero(m & (rank < ll))
        decs[rows[ri], rank[ri, j]] = decay(iou[rows[ri], j])
    sc = scores0.astype(iou.dtype).copy()
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
                key = key_of(sc[t * c + k])
                if key > bk:
                    bk, bi = key, t * c + k
        return bk, bi

    cached = [best(t) for t in range(threads)]
    for _ in range(n):
        warps = [_warp_pick(cached[w * 32:(w + 1) * 32], wide)
                 for w in range(threads // 32)]
        key, idx = _warp_pick(warps, wide)
        if not any(avail):
            break
        pick = n - 1 if key == nan_key else idx
        for t in range(threads):
            if not avail[t]:
                continue
            j0 = t * c
            bit0 = j0 % 32
            width = min(c, 32)
            changed = False
            for wd in range(-(-c // 32)):
                at = min(j0 // 32 + wd, words - 1)
                word = int(marks[pick, at])
                hit = ((word >> bit0) & ((1 << width) - 1)
                       & (avail[t] >> (32 * wd)))
                changed = changed or bool(hit)
                for kw in range(width):
                    if not hit >> kw & 1:
                        continue
                    k = 32 * wd + kw
                    rank = before[pick, at] + bin(
                        word & ((1 << (bit0 + kw)) - 1)).count("1")
                    dec = (decs[pick, rank] if rank < ll
                           else decay(iou[pick, j0 + k:j0 + k + 1])[0])
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


def test_k4_schedule_nan_pick_follows_the_pallas_kernel():
    """A NaN score among 6 boxes 0.3 m apart: a NaN
    maximum matches no key, so the step picks n - 1, as the Pallas kernel
    does; the emulated K4 and the plain cascade equal it (the JAX package's
    XLA loop, whose argmax picks the NaN, differs by design)."""
    boxes = np.array([[0.3 * i, 0.0, 1.0, 1.0, 0.0] for i in range(6)],
                     np.float32)
    scores = np.array([0.5, np.nan, 0.9, 0.2, 0.8, 0.1], np.float32)
    iou = TS._rbox_iou_matrix_plain(torch.from_numpy(boxes),
                                    torch.from_numpy(boxes)).numpy()
    pre = scores <= 0.3
    pre[np.argsort(-scores, kind="stable")[0]] = False
    init = np.where(pre, -np.inf, scores).astype(np.float32)
    sup = _check_k4(iou, init, pre, (0.3, 0.3, 0.0, "linear"),
                    layouts=(None, 1))
    np.testing.assert_array_equal(sup, [False] * 3 + [True] * 3)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("method,param", [("linear", 0.5), ("gaussian", 0.4)])
def test_k4_f64_schedule_matches_plain_and_pallas(rng, method, param, tied):
    """The float64 cascade (64-bit keys, three reductions a pick) on
    float32-representable float64 inputs: the emulation equals the plain
    cascade in float64, in the kernel's layout for n = 72 and with 1 and 2
    boxes a lane, and both equal the Pallas kernel's float32 mask."""
    iou, init, pre = _soft_inputs(rng, 72, 14.0, tied)
    args = (0.2, 0.1, param, method)
    ref = np.asarray(soft_nms_scan(jnp.asarray(iou), jnp.asarray(init),
                                   jnp.asarray(pre), *args, interpret=True))
    sup = _check_k4(iou.astype(np.float64), init.astype(np.float64), pre,
                    args, layouts=(None, 1, 2), pallas=False)
    np.testing.assert_array_equal(sup, ref)
    assert 0 < sup.sum() < 72


def test_k4_f64_schedule_nan_and_signed_zero():
    """Float64: a NaN score available makes every pick n - 1, as in the
    float32 kernel and the Pallas one; +0 and -0 keys tie, so the lower
    index is picked first."""
    boxes = np.array([[0.3 * i, 0.0, 1.0, 1.0, 0.0] for i in range(6)],
                     np.float32)
    scores = np.array([0.5, np.nan, 0.9, 0.2, 0.8, 0.1], np.float32)
    iou = TS._rbox_iou_matrix_plain(torch.from_numpy(boxes),
                                    torch.from_numpy(boxes)).numpy()
    pre = scores <= 0.3
    pre[np.argsort(-scores, kind="stable")[0]] = False
    init = np.where(pre, -np.inf, scores).astype(np.float32)
    args = (0.3, 0.3, 0.0, "linear")
    ref = np.asarray(soft_nms_scan(jnp.asarray(iou), jnp.asarray(init),
                                   jnp.asarray(pre), *args, interpret=True))
    sup = _check_k4(iou.astype(np.float64), init.astype(np.float64), pre,
                    args, layouts=(None, 1), pallas=False)
    np.testing.assert_array_equal(sup, [False] * 3 + [True] * 3)
    np.testing.assert_array_equal(sup, ref)
    assert _key64(-0.0) == _key64(0.0) == 1 << 63
    assert _key64(np.nan) == _NAN_KEY64 > _key64(np.inf) > _key64(1.0)
    assert _key64(-np.inf) > 0
    # a warp of +0 and -0 scores: the least index, whatever the sign
    lanes = [(_key64(v), i) for i, v in enumerate([-0.0, 0.0, -0.0])]
    assert _warp_pick(lanes, True) == (1 << 63, 0)
    # zeros and negatives: nothing can fall below a lower threshold, and
    # the cascade agrees with the plain version
    zeros = np.array([-0.0, 0.0, -0.0, 0.0, -0.5, 0.25], np.float64)
    _check_k4(iou.astype(np.float64), zeros, np.zeros(6, bool),
              (0.1, -1.0, 0.5, "linear"), layouts=(None, 1), pallas=False)


def test_k4_wide_key_reduction(rng):
    """The three-step reduction of 64-bit keys equals the largest key and
    its least index, on keys that share high words (the case the low-word
    step decides) and with lanes holding no box."""
    for _ in range(200):
        highs = rng.integers(0, 4, 32) + (1 << 31)
        lows = rng.integers(0, 1 << 32, 32, dtype=np.uint64)
        lows[rng.random(32) < 0.3] = lows[0]
        lanes = [(int(h) << 32 | int(lo), i)
                 for i, (h, lo) in enumerate(zip(highs, lows))]
        lanes = [(0, None) if rng.random() < 0.2 else kv for kv in lanes]
        key = max(k for k, _ in lanes)
        want = (key, min((i for k, i in lanes if k == key and i is not None),
                         default=None))
        assert _warp_pick(lanes, True) == want


def test_k4_layouts_cover_every_n():
    """Every n has a layout up to 262 144 boxes, whose float32 matrix
    (275 GB) no card holds: up to 8192 boxes at most 8 warps with the
    scores in shared memory, above them 16 warps up to 16 384 boxes and
    32 above (1024 threads) with the scores in the scratch, whose words
    the wrapper sizes for them; above 32 768 boxes a lane owns 64, 128 or
    256 of them. The wrapper has no size check of its own."""
    for n in (1, 31, 32, 33, 100, 512, 1000, 1024, 1025, 2048, 4097, 8192,
              8193, 16384, 16385, 32768, 32769, 65536, 65537, 131072,
              131073, TK._SOFT_MAX_N):
        c, warps = _k4_layout(n), _k4_warps(n)
        lanes = -(-n // c)
        assert c <= (32 if n <= TK._SOFT_WORD_MAX_N else 256)
        assert lanes <= 32 * warps <= 1024
        assert c == 32 or n <= TK._SOFT_STAGED_MAX_N or c == TK._soft_boxes(n)
        assert warps == TK._soft_warps(n)
        assert (lanes <= 32) == (n <= TK._SOFT_STAGED_MAX_N)
        assert (warps > 8) == (n > TK._SOFT_SHARED_STATE_MAX_N)
        for itemsize in (4, 8):
            marks = n * -(-n // 32)
            rows = (n * TK._SOFT_LIST_LEN * itemsize // 4 + marks
                    + -(-marks // 4))
            # above 8192 boxes: the scores and keys of every lane's boxes
            state = (-(-rows // 4) * 4 - rows
                     + warps * 32 * c * 2 * itemsize // 4) if warps > 8 else 0
            assert TK._soft_scratch_words(n, itemsize) == rows + state
    assert [_k4_layout(n) for n in (32769, 65536, 131072)] == [64, 64, 128]
    with pytest.raises(ValueError):
        _k4_layout(TK._SOFT_MAX_N + 1)
    src = inspect.getsource(TK._soft_launch)
    assert "_SOFT_MAX_N" not in src and "raise ValueError" not in src


def _sparse_k4_inputs(rng, n, dtype, available=160):
    """An (n, n) IoU matrix of clusters of 4 boxes that span lanes and
    warps (members i, i + 37, i + 1029 and i + n / 2), with ``available``
    boxes above the score threshold and the rest pre-suppressed, so that
    the cascade's steps stay few at n above 8192."""
    iou = np.zeros((n, n), dtype)
    np.fill_diagonal(iou, 1.0)
    heads = rng.choice(n, available // 4, replace=False)
    live = np.zeros(n, bool)
    for h in heads:
        members = (h + np.array([0, 37, 1029, n // 2])) % n
        live[members] = True
        vals = rng.uniform(0.05, 0.95, (4, 4))
        vals = (vals + vals.T) / 2
        np.fill_diagonal(vals, 1.0)
        iou[np.ix_(members, members)] = np.maximum(
            iou[np.ix_(members, members)], vals.astype(dtype))
    scores = np.where(live, rng.uniform(0.2, 1.0, n), 0.05).astype(dtype)
    pre = ~live
    init = np.where(pre, -np.inf, scores).astype(dtype)
    return iou, init, pre


@pytest.mark.parametrize("n,dtype,method,param,c,warps", [
    (8193, np.float64, "linear", 0.5, None, None),
    (16384, np.float32, "gaussian", 0.4, None, None),
    (4096, np.float32, "linear", 0.5, 64, 2),
    (4096, np.float64, "gaussian", 0.4, 128, 1),
    (8192, np.float32, "gaussian", 0.4, 128, 2),
    (8192, np.float64, "linear", 0.5, 256, 1)])
def test_k4_wide_layout_matches_plain(rng, n, dtype, method, param, c,
                                      warps):
    """Above 8192 boxes (16 warps of 32 boxes a lane, the scores in the
    scratch), the emulated schedule equals the plain cascade on sparse
    clusters whose picks decay boxes of other lanes and warps (float64
    linear at 8193 boxes, float32 gaussian at 16 384); and so does the
    layout above 32 768 boxes, lanes of 64, 128 or 256 boxes in 2 to 8
    words of bits, forced at n <= 8192 in one or two warps (its dense
    matrix at 32 769 boxes alone is 4.3 GB), float32 and float64, both
    methods, clusters spanning words of a lane, lanes and warps."""
    iou, init, pre = _sparse_k4_inputs(rng, n, dtype)
    if c is None:
        assert _k4_warps(n) == 16
    args = (0.3, 0.35, param, method)
    plain = TK._soft_nms_scan_plain(torch.from_numpy(iou),
                                    torch.from_numpy(init),
                                    torch.from_numpy(pre), *args).numpy()
    got = _emulate_k4(iou, init, pre, *args, c=c, warps=warps)
    np.testing.assert_array_equal(got, plain)
    assert pre.sum() < plain.sum() < n


# ---------------------------------------------------------------------------
# K1's bit-row form and the scan (K2/K3) that reads it
# ---------------------------------------------------------------------------

U64 = (1 << 64) - 1
THRESHOLDS = [-0.1, 0.0, 0.25, 1.0]


def _words(bits):
    """int64 bit rows -> a list of rows of Python ints in [0, 2^64)."""
    return [[int(v) & U64 for v in row] for row in bits.tolist()]


def _emulate_scan(bits, n, pre=None, neg=None, thr=0.0, order=None,
                  rng=None, stats=None):
    """csrc/nms_scan.cu in Python on the bit rows (a list of rows of ints):
    up to ``_WARP_MAX_N`` boxes one warp, lane l holding suppression word
    l; per chunk c the warp's fixed-point rounds on the diagonal words, or
    after 8 rounds the owner lane c's chain in two 32-bit halves (counted
    in ``stats``), give the alive rows; the later words take their ORs,
    computed by groups
    of 1, 2 or 4 lanes a word and shuffled to the word's lane. Above, one
    block: thread 0's chain on 64-bit words, then the same ORs. Rows past n
    read what a stale buffer holds (``rng``'s garbage), which only the
    padding bits may hide."""
    words = (n + 63) // 64
    garbage = rng or np.random.default_rng(0)
    stats = {"owner_chains": 0} if stats is None else stats

    def word(row, w):
        if row < n:
            return bits[row][w]
        return int(garbage.integers(0, 1 << 63)) << 1 | 1

    def presup(j):
        if j >= n:
            return True
        if pre is not None:
            return bool(pre[j])
        return j > 0 and bool(-np.float32(neg[j]) <= np.float32(thr))

    s = [sum(presup(64 * w + b) << b for b in range(64))
         for w in range(words)]
    warp = n <= TK._WARP_MAX_N
    for c in range(words):
        d = [word(64 * c + r, c) for r in range(64)]
        if warp:
            # the warp's rounds: alive = ~(entry | OR of the alive rows'
            # diagonal words; rows 32.. their high halves), to a fixed point
            alive = ~s[c] & U64
            for _ in range(8):
                ored = 0
                for r in range(64):
                    if alive >> r & 1:
                        ored |= d[r] if r < 32 else d[r] & ~0xFFFFFFFF & U64
                nxt = ~(s[c] | ored) & U64
                if nxt == alive:
                    break
                alive = nxt
            else:
                # not settled: the owner's two 32-bit chains
                stats["owner_chains"] += 1
                lo, hi = s[c] & 0xFFFFFFFF, s[c] >> 32
                for r in range(32):
                    if not lo >> r & 1:
                        lo |= d[r] & 0xFFFFFFFF
                for r in range(32):
                    if not lo >> r & 1:
                        hi |= d[r] >> 32
                for r in range(32, 64):
                    if not hi >> (r - 32) & 1:
                        hi |= d[r] >> 32
                alive = ~(hi << 32 | lo) & U64
            s[c] = ~alive & U64
            # g lanes a later word, 64 / g rows each, ORed in the group;
            # lane c + 1 + q takes word q's OR from lane q * g
            later = words - c - 1
            g = 4 if later <= 8 else 2 if later <= 16 else 1
            part = [0] * 32
            for lane in range(32):
                w = c + 1 + lane // g
                r0 = (lane % g) * (64 // g)
                if w < words:
                    for r in range(r0, r0 + 64 // g):
                        if alive >> r & 1:
                            part[lane] |= word(64 * c + r, w)
            group = [0] * 32
            for lane in range(32):
                for m in range(lane - lane % g, lane - lane % g + g):
                    group[lane] |= part[m]
            for lane in range(c + 1, min(words, 32)):
                s[lane] |= group[((lane - c - 1) * g) & 31]
        else:
            alive = 0
            for r in range(64):
                if not s[c] >> r & 1:
                    alive |= 1 << r
                    s[c] |= d[r]
            for w in range(c + 1, words):
                for r in range(64):
                    if alive >> r & 1:
                        s[w] |= word(64 * c + r, w)
    sup = np.array([bool(s[j // 64] >> (j % 64) & 1) for j in range(n)])
    if order is None:
        return sup
    out = np.zeros(n, bool)
    out[np.asarray(order)] = sup
    return out


def _scan_masks(rng, n, kind):
    """(overlap, pre): random (7% of pairs), every pair overlapping, none,
    random with 90% of the boxes pre-suppressed, and a chain (box i
    overlaps box i + 1 only: every chunk's rounds run out)."""
    if kind == "all":
        ov = np.ones((n, n), bool)
    elif kind == "chain":
        ov = np.eye(n, k=1, dtype=bool)
    elif kind == "none":
        ov = np.zeros((n, n), bool)
    else:
        ov = rng.random((n, n)) < 0.07
        ov = ov | ov.T
    pre = rng.random(n) < (0.9 if kind == "pre_heavy" else 0.1)
    return ov, pre


@pytest.mark.parametrize("n", [1, 63, 64, 65, 100, 512, 1024, 1025, 2048,
                               2049])
def test_scan_schedule_matches_plain_and_pallas(rng, n):
    """The emulated scan (the warp route up to 2048 boxes, the block route
    above) on the packed rows, with the words left of each row's own word
    left as garbage (never read), equals the plain scan, and the plain scan
    equals the Pallas kernels (K2 in interpret mode up to 1024 boxes, K3 at
    every n) on random, all-overlapping, none-overlapping and pre-suppressed
    heavy masks."""
    for kind in ("random", "all", "none", "pre_heavy", "chain"):
        ov, pre = _scan_masks(rng, n, kind)
        if kind == "chain":
            pre[:] = False
        # the pack kernel's rows: bits j > i only
        bits = _words(TK.pack_rows(torch.from_numpy(np.triu(ov, 1))))
        for i in range(n):  # the words left of row i's own word: garbage
            for w in range(i // 64):
                bits[i][w] = int(rng.integers(0, 1 << 63))
        plain = TK._nms_scan_plain(torch.from_numpy(np.triu(ov, 1)),
                                   torch.from_numpy(pre)).numpy()
        stats = {"owner_chains": 0}
        np.testing.assert_array_equal(
            _emulate_scan(bits, n, pre=pre, stats=stats), plain,
            err_msg=kind)
        if kind == "chain" and 64 < n <= TK._WARP_MAX_N:
            assert stats["owner_chains"] > 0
        blocked = np.asarray(nms_scan_blocked(jnp.asarray(ov),
                                              jnp.asarray(pre),
                                              interpret=True))
        np.testing.assert_array_equal(plain, blocked, err_msg=kind)
        if n <= 1024:
            k2 = np.asarray(nms_scan(jnp.asarray(ov), jnp.asarray(pre),
                                     interpret=True))
            np.testing.assert_array_equal(plain, k2, err_msg=kind)


def test_scan_takes_pre_from_sorted_scores_and_writes_through_order(rng):
    """nms2d's form of the scan: the pre-suppression from the negated
    sorted scores (rank 0 exempt, NaN never pre-suppressed, the threshold
    compared in float32) and the mask written to suppressed[order[i]], in
    the emulation and in the plain version, which equals the scan on the
    explicit mask scattered back."""
    n = 300
    ov, _ = _scan_masks(rng, n, "random")
    scores = rng.random(n).astype(np.float32)
    scores[[3, 77]] = np.nan
    scores[10] = np.float32(0.3)  # exactly at the threshold: pre-suppressed
    neg, order = torch.sort(-torch.from_numpy(scores), stable=True)
    bits = TK.pack_rows(torch.from_numpy(np.triu(ov, 1)))
    want_pre = TK._pre_suppression(-neg, 0.3)
    assert not want_pre[0] and not want_pre[-2:].any()  # NaN sorts last
    sup = TK._nms_scan_plain(torch.from_numpy(np.triu(ov, 1)), want_pre)
    want = torch.empty_like(sup)
    want[order] = sup
    plain = TK._nms_scan_sorted(bits, order, neg, 0.3)
    np.testing.assert_array_equal(plain.numpy(), want.numpy())
    got = _emulate_scan(_words(bits), n, neg=neg.numpy(), thr=0.3,
                        order=order.numpy())
    np.testing.assert_array_equal(got, want.numpy())


def test_pack_rows_round_trips(rng):
    for n in (1, 63, 64, 65, 130):
        ov = rng.random((n, n)) < 0.5
        bits = TK.pack_rows(torch.from_numpy(ov))
        assert bits.shape == (n, (n + 63) // 64) and bits.dtype == torch.int64
        np.testing.assert_array_equal(TK._unpack_rows(bits, n).numpy(), ov)


def _bit_tiles(n, rows):
    """csrc/rbox_iou.cu BitTiles and the block -> tile bisection: every
    block's (first row, word) of the tiles on or above the diagonal."""
    words, q = (n + 63) // 64, 64 // rows
    row_tiles = -(-n // rows)

    def start(b):
        return q * (b * words - b * (b - 1) // 2)
    last = (row_tiles - 1) // q
    total = start(last) + (row_tiles - last * q) * (words - last)
    tiles = []
    for blk in range(total):
        lo, hi = 0, last
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if start(mid) <= blk:
                lo = mid
            else:
                hi = mid - 1
        per = words - lo
        idx = blk - start(lo)
        tiles.append(((lo * q + idx // per) * rows, lo + idx % per))
    return tiles


def _k1_bit_rows(n):
    """The tile rows csrc/rbox_iou.cu d3d_rbox_overlap_bits picks."""
    for rows in (64, 32, 16):
        if len(_bit_tiles(n, rows)) >= 132:
            return rows
    return 8


def _emulate_k1_bits(rej, iou, thr, rows):
    """K1's bit-row blocks into a buffer of garbage: the own-word block
    zeroes its rows' words left of it; phase 1 sets a rejected pair's bit
    to 0.0 > thr and queues the pairs j > i that are not rejected; phase 2
    sets the chain's bits (the plain IoU of (row, column)); each block
    writes its rows' word. ``rej`` and ``iou``: the boxes' reject test and
    plain IoU matrix against themselves. Returns the rows and each word's
    write count."""
    n = rej.shape[0]
    words = (n + 63) // 64
    out = [[0xDEAD] * words for _ in range(n)]
    writes = np.zeros((n, words), np.int64)
    for row0, w in _bit_tiles(n, rows):
        rs = range(row0, min(n, row0 + rows))
        if w == row0 // 64:
            for i in rs:
                for ww in range(w):
                    out[i][ww] = 0
                    writes[i, ww] += 1
        for i in rs:
            word = 0
            for j in range(64 * w, min(n, 64 * w + 64)):
                if j <= i:
                    continue
                v = np.float32(0.0) if rej[i, j] else iou[i, j]
                if v > np.float32(thr):
                    word |= 1 << (j - 64 * w)
            out[i][w] = word
            writes[i, w] += 1
    return out, writes


def _boxes_with_odd_ones(rng, n, spread, apart=False):
    """Random boxes with a NaN coordinate, a NaN angle, a zero-width box
    and a zero-size box among them. ``apart`` moves the two degenerate
    boxes away from every other box: where a degenerate box overlaps one,
    its IoU is rounding noise (an area of collinear points over a union
    floored at 1e-12) in either package."""
    b = _random_boxes(rng, n, spread)
    for k, (col, v) in enumerate([(0, np.nan), (4, np.nan), (2, 0.0),
                                  (3, 0.0)]):
        if k < n:
            b[(k * 7) % n, col] = v
    b[(3 * 7) % n, 2] = 0.0 if n > 3 else b[0, 2]
    if apart:
        for k in (2, 3):
            if k < n:
                b[(k * 7) % n, :2] = (-500.0 * k, 900.0)
    return b


@pytest.mark.parametrize("n", [1, 63, 65, 100, 200])
@time_limit(120)
def test_k1_bit_tiles_write_every_word_once(rng, n):
    """K1's bit-row tiles cover every (row, word) once, at the tile rows it
    picks and at every other, and give the plain version's bits at each
    threshold, NaN and degenerate boxes among them."""
    b = torch.from_numpy(_boxes_with_odd_ones(rng, n, np.sqrt(n) * 2.0))
    rej = TC._reject_plain(b, b).numpy()
    iou = TS._rbox_iou_matrix_plain(b, b).numpy()
    for thr in THRESHOLDS:
        want = _words(TC._rbox_overlap_bits_plain(b, thr))
        for rows in sorted({_k1_bit_rows(n), 8, 64}):
            got, writes = _emulate_k1_bits(rej, iou, thr, rows)
            assert (writes == 1).all(), (rows, thr)
            assert got == want, (rows, thr)


@pytest.mark.parametrize("thr", THRESHOLDS)
def test_overlap_bits_plain_matches_jax_thresholded(rng, thr):
    """The plain bit rows equal the JAX package's IoU matrix (its SoA route,
    what its nms2d thresholds, and its Pallas kernel in interpret mode) >
    thr, upper triangle, packed; NaN and degenerate boxes among them."""
    n = 150
    b = _boxes_with_odd_ones(rng, n, 25.0, apart=True)
    got = TC._rbox_overlap_bits_plain(torch.from_numpy(b), thr)
    for ref in (S.rbox_iou_matrix(jnp.asarray(b), jnp.asarray(b)),
                P.rbox_iou_matrix(jnp.asarray(b), jnp.asarray(b),
                                  interpret=True)):
        want = TK.pack_rows(torch.from_numpy(
            np.triu(np.asarray(ref, np.float32) > np.float32(thr), 1)))
        assert torch.equal(got, want)
    if thr < 0:  # every pair but a NaN box's: 0.0 > thr for rejected ones
        assert TK._unpack_rows(got, n).sum() > 0.9 * n * (n - 1) / 2


def _clear_boxes(rng, n, thr, margin=1e-4):
    """Random boxes with no pairwise IoU within ``margin`` of ``thr``
    (other than an exact 0 at thr = 0), where one rounding could flip a
    keep bit."""
    boxes = _random_boxes(rng, n, np.sqrt(n) * 2.0)
    iou = np.asarray(S.rbox_iou(jnp.asarray(boxes, jnp.float64)[:, None],
                                jnp.asarray(boxes, jnp.float64)[None, :]))
    near = (np.abs(iou - thr) < margin) & (iou != thr)
    np.fill_diagonal(near, False)
    return np.delete(boxes, np.unique(np.nonzero(np.triu(near))[1]), axis=0)


@pytest.mark.parametrize("thr", THRESHOLDS)
def test_nms2d_bit_route_matches_jax(rng, thr):
    """nms2d (float32 boxes: the bit-row route, plain versions on the CPU)
    against the JAX package's nms2d at each threshold, with a score
    threshold and a NaN score; and the same chain of the CUDA route's
    pieces with the scan emulated."""
    boxes = _clear_boxes(rng, 260, thr)
    scores = rng.random(len(boxes)).astype(np.float32)
    scores[5] = np.nan
    want = np.asarray(N.nms2d(jnp.asarray(boxes), jnp.asarray(scores),
                              iou_threshold=thr, score_threshold=0.1))
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    got = TN.nms2d(tb, ts, iou_threshold=thr, score_threshold=0.1).numpy()
    np.testing.assert_array_equal(got, want)
    neg, order = torch.sort(-ts, stable=True)
    bits = TC._rbox_overlap_bits(tb[order], thr)
    emulated = _emulate_scan(_words(bits), len(boxes), neg=neg.numpy(),
                             thr=0.1, order=order.numpy())
    np.testing.assert_array_equal(emulated, want)
