"""The share of the traced steps' wall time in which an NCCL kernel ran on
a card and no other kernel did, the mean over the ranks, in %. Nothing to
read without NCCL kernels (one card)."""


def read(ctx):
    ranks = [r for r in ctx.get("rank_traces") or () if r and r["wall"]]
    if not ranks or not any(r["nccl"] for r in ranks):
        return None
    return 100.0 * sum(r["exposed"] / r["wall"] for r in ranks) / len(ranks)
