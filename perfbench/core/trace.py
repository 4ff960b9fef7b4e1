"""Reading the profiler's trace in memory: device intervals, their union
(``busy_share`` of ``chip_smoke.py`` l. 3311, frozen here), launches,
the operations that took most device time and what the host was doing
while the device sat idle. Nothing is written to disk."""

import bisect
from collections import defaultdict

__all__ = ["Trace", "profile"]

# a templated kernel's name runs to thousands of characters; its head
# names it
NAME_CHARS = 160


def profile():
    """A ``torch.profiler.profile`` of the host's operators and the
    device's activity (CUPTI), shapes and stacks off."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof

    return prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def union(spans):
    """Merged (start, end) intervals of ``spans``, sorted."""
    out = []
    for s0, s1 in sorted(spans):
        if out and s0 <= out[-1][1]:
            if s1 > out[-1][1]:
                out[-1][1] = s1
        else:
            out.append([s0, s1])
    return out


class Trace:
    """The events of one profiled stretch of ``wall_s`` seconds, which
    began at ``t0_ns`` on the epoch clock the trace uses."""

    def __init__(self, prof, t0_ns, wall_s):
        from torch.autograd import DeviceType

        self.t0_ns, self.wall_s = t0_ns, wall_s
        device, self.host = [], []
        for e in prof.profiler.kineto_results.events():
            row = (e.name(), e.start_ns(), e.end_ns())
            if e.device_type() == DeviceType.CUDA:
                device.append(row)
            elif e.device_type() == DeviceType.CPU:
                self.host.append(row)
        # a record_function range on the host (the optimizer's step) is
        # mirrored on the device's timeline under its own name: it is no
        # work of the device's. Kernels and copies never share a name
        # with a host event.
        names = {name for name, _, _ in self.host}
        self.device = [r for r in device if r[0] not in names]
        self.busy = union((s, e) for _, s, e in self.device)

    def busy_s(self):
        """Seconds in which some operation ran on the device (overlap
        counted once)."""
        return sum(e - s for s, e in self.busy) / 1e9

    def launches(self):
        """Device operations (kernels, copies, sets) in the trace."""
        return len(self.device)

    def kernel_s(self, match):
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e9

    def exposed_s(self, match):
        """Seconds in which an operation that ``match`` accepts ran and no
        other operation did."""
        mine = union((s, e) for n, s, e in self.device if match(n))
        other = union((s, e) for n, s, e in self.device if not match(n))
        starts = [s for s, _ in other]
        total = 0
        for s0, s1 in mine:
            cover = 0
            i = max(bisect.bisect_right(starts, s0) - 1, 0)
            while i < len(other) and other[i][0] < s1:
                lo, hi = max(other[i][0], s0), min(other[i][1], s1)
                cover += max(hi - lo, 0)
                i += 1
            total += (s1 - s0) - cover
        return total / 1e9

    def top_ops(self, n=10):
        """The ``n`` device operations that took most time: [name, s]
        (names cut to their first ``NAME_CHARS`` characters)."""
        by = defaultdict(int)
        for name, s, e in self.device:
            by[name[:NAME_CHARS]] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n=10):
        """The device's idle gaps between its busy intervals, summed by
        the innermost host operation running at each gap's middle (none:
        "python"): the ``n`` largest, [name, s]."""
        gaps = [((a[1] + b[0]) // 2, b[0] - a[1])
                for a, b in zip(self.busy, self.busy[1:])]
        host = sorted(self.host, key=lambda r: r[1])
        by, active, i = defaultdict(int), [], 0
        for mid, length in sorted(gaps):
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] >= mid]
            name = max(active, key=lambda h: h[1])[0] if active else "python"
            by[name] += length
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]
