"""The share of the traced window in which no operation ran on the card:
1 - the union of its device intervals over the wall clock, in %."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.wall_s) if tr.wall_s else None
