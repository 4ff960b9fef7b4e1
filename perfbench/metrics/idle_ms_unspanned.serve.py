"""The card's idle time in the traced window outside every stage's span:
the client's loop between requests and ``detect``'s own code between its
stages, in ms a traced frame (``core/spans.py``)."""

from perfbench.core import spans


def read(ctx):
    return spans.idle_ms(ctx, "unspanned")
