"""Model FLOPs of the frames served in the untraced window (the
benchmark's count at the configuration's shapes) over that window's
wall time x the card's peak at the configuration's precision x the
cards, in %."""

from perfbench.core import work


def read(ctx):
    if not ctx.get("plain_s"):
        return None
    done = work.flops(ctx, ctx["plain_frames"])
    return 100.0 * done / (ctx["plain_s"] * work.peak_ops(ctx)
                           * ctx["chips"])
