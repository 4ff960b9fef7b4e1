"""Device operations (kernels, copies, sets) a training step in the traced
steps, the mean over the ranks."""


def read(ctx):
    ranks = [r for r in ctx.get("rank_traces") or () if r]
    if not ranks:
        return None
    return sum(r["launches"] for r in ranks) / len(ranks) / ctx["traced_steps"]
