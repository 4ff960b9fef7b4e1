"""K5's share of its roofline over the traced window, in %: the
benchmark's least time for the traced frames' sparse layers
(``families/second.py`` ``k5_bound_s``: the larger of bytes over the
card's bandwidth and the neighbour pairs' FLOPs over its peak, a layer)
over the device time of ``subm_conv_kernel``. Nothing to read without K5
in the trace (a CPU run)."""

from perfbench.families import second


def read(ctx):
    frames = ctx.get("traced_frames")
    kernel_s = ctx["trace"].kernel_s(lambda n: second.K5_KERNEL in n)
    if not frames or not kernel_s:
        return None
    return 100.0 * second.k5_bound_s(ctx, frames) / kernel_s
