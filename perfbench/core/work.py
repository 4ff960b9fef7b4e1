"""The work of the frames a window served, counted by the benchmark's
own plain model (never by the program): FLOPs for the utilisation."""

import torch

__all__ = ["frame_work", "flops"]


def frame_work(ctx):
    """The family's ``work`` of each frame of the pool, counted once a
    run and kept in ``ctx``."""
    if "frame_work" not in ctx:
        fam, model = ctx["cell"]["family"], ctx["cell"]["conf"]["model"]
        dev = ctx.get("device", torch.device("cpu"))
        with torch.no_grad():
            ctx["frame_work"] = [
                fam.work(fam.ref_inputs(torch.from_numpy(
                    p if not isinstance(p, tuple) else p[0]).to(dev),
                    model), model) for p in ctx["pool"]]
    return ctx["frame_work"]


def peak_ops(ctx):
    prec = ctx["cell"]["conf"]["precision"]
    return ctx["peaks"].OPS_PER_S["tf32" if prec.get("tf32") else
                                  prec["dtype"]]


def flops(ctx, frames):
    """Forward FLOPs of the pool frames ``frames`` (indices)."""
    work = frame_work(ctx)
    return sum(work[f]["flops"] for f in frames)
