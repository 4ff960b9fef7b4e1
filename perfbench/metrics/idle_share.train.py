"""The share of the traced steps' wall time in which no operation ran on a
card (1 - the union of its device intervals over the wall clock), the
mean over the ranks, in %."""


def read(ctx):
    ranks = [r for r in ctx.get("rank_traces") or () if r and r["wall"]]
    if not ranks:
        return None
    return 100.0 * sum(1.0 - r["busy"] / r["wall"] for r in ranks) / len(ranks)
