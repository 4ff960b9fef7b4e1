"""The port's own spans in a serving trace: the card's idle time and the
host's launches inside the ``d3d.detect.*`` stages of the traced frames.

The program names its stages with ``torch.profiler.record_function``
ranges (``d3d_tpu_torch.profiler.span``); they are host rows of the
:class:`~perfbench.core.trace.Trace`, on the clock of its device
intervals. The traced window opens at the first request's ``d3d.detect``
(the profiler's start lies between ``t0_ns`` and it) and lasts
``wall_s``; the card is idle wherever no device interval runs in it.
Idle time is split by exact intersection with each stage's spans, so
the stages and ``unspanned`` (the client's loop between requests and
``detect``'s own code outside its stages) sum to the window's idle time.
A trace without ``d3d.detect`` spans (a program that records none) gives
None. The serving client runs on one thread, so every host row inside a
span is that request's.
"""

from .trace import union

__all__ = ["STAGES", "idle_ms", "is_launch", "launches", "overlap_ns",
           "window"]

ROOT = "d3d.detect"
# a stage of the metrics: the spans it reads
STAGES = {
    "voxelize": ("d3d.detect.upload", "d3d.detect.voxelize"),
    "network": ("d3d.detect.network",),
    "select": ("d3d.detect.select",),
    "readout": ("d3d.detect.readback", "d3d.detect.assemble"),
}
# host calls that put work on the card: kernel launches, copies, sets
_LAUNCH = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
           "cuLaunchCooperativeKernel", "cudaMemcpy", "cudaMemset",
           "cuMemcpy", "cuMemset", "cudaGraphLaunch", "cuGraphLaunch")


def is_launch(name):
    """Whether a host row is a ``cuda*`` or ``cu*`` API call that puts an
    operation on the card."""
    return name.startswith(_LAUNCH)


def _spans(tr, names):
    return union((s, e) for n, s, e in tr.host if n in names)


def window(tr):
    """(start, end) ns of the traced window, or None without root spans."""
    starts = [s for n, s, _ in tr.host if n == ROOT]
    if not starts:
        return None
    w0 = min(starts)
    return w0, w0 + round(tr.wall_s * 1e9)


def _complement(spans, w0, w1):
    """The parts of [w0, w1) that no interval of ``spans`` (merged,
    sorted) covers."""
    out, at = [], w0
    for s, e in spans:
        s, e = max(s, w0), min(e, w1)
        if s >= e:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < w1:
        out.append((at, w1))
    return out


def overlap_ns(a, b):
    """Total length of the intersection of two merged, sorted interval
    lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms(ctx, stage):
    """The card's idle milliseconds a traced frame inside ``stage``'s
    spans (a key of :data:`STAGES`), or outside every stage's for
    ``"unspanned"``; None without frames or spans."""
    tr, frames = ctx["trace"], len(ctx.get("traced_frames", ()))
    win = window(tr)
    if not frames or win is None:
        return None
    idle = _complement(tr.busy, *win)
    if stage == "unspanned":
        staged = _spans(tr, {n for names in STAGES.values() for n in names})
        where = _complement(staged, *win)
    else:
        where = _spans(tr, STAGES[stage])
    return overlap_ns(idle, where) / 1e6 / frames


def launches(ctx, stage):
    """Host calls that put work on the card, started inside ``stage``'s
    spans, a traced frame; None without frames, spans or device
    operations (a CPU run)."""
    tr, frames = ctx["trace"], len(ctx.get("traced_frames", ()))
    if not frames or not tr.device or window(tr) is None:
        return None
    spans = _spans(tr, STAGES[stage])
    starts = sorted(s for n, s, _ in tr.host if is_launch(n))
    count, i = 0, 0
    for s0, s1 in spans:
        while i < len(starts) and starts[i] < s0:
            i += 1
        while i < len(starts) and starts[i] <= s1:
            count += 1
            i += 1
    return count / frames
