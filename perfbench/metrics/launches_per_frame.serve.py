"""Device operations (kernels, copies, sets) in the traced window, over
the frames served in it."""


def read(ctx):
    frames = len(ctx.get("traced_frames", ()))
    return ctx["trace"].launches() / frames if frames else None
