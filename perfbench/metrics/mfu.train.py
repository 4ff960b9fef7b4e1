"""Model FLOPs of the untraced window's training steps (three times the
forward's, by the benchmark's count at the configuration's shapes, over
every rank's frames) over the window's wall time x the card's peak at the
configuration's precision x the cards, in %."""

from perfbench.core import work


def read(ctx):
    if not ctx.get("plain_s") or not ctx.get("window_flops"):
        return None
    return 100.0 * ctx["window_flops"] / (
        ctx["plain_s"] * work.peak_ops(ctx) * ctx["chips"])
