"""Row gathers through index tables whose backward is a gather too.

SST's window routing and the Switch-MoE's dispatch read rows through a
table in which every real row appears at most once and the rest of the
entries (a window's empty slots, a full expert's dropped tokens) read an
appended zero row. Autograd's backward of such a gather is a scatter-add
that piles the zero row's many entries onto one row, one after another on
CUDA (a request at ``presets.sst_kitti`` has ~420 000 of them a block);
:func:`table_gather`'s backward gathers each row's cotangent from its one
position instead, which gives the same values.
"""

import torch

__all__ = ["table_gather", "gather_rows", "inverse_table"]


def _flat_rows(table, rows_per_frame):
    """Flat row indices of a (B, L) per-frame table into (B * rows, C)."""
    return (table.to(torch.int64)
            + torch.arange(table.shape[0], device=table.device)[:, None]
            * rows_per_frame)


def gather_rows(x, table):
    """Rows of ``x`` (B, R, C) by ``table`` (B, L), entries ``>= R``
    reading an appended zero row: (B, L, C)."""
    b, r, c = x.shape
    x_pad = torch.cat([x, x.new_zeros((b, 1, c))], dim=1)
    table = torch.clamp(table.to(torch.int64), max=r)
    out = x_pad.reshape(b * (r + 1), c)[_flat_rows(table, r + 1).reshape(-1)]
    return out.reshape(b, table.shape[1], c)


def inverse_table(table, rows):
    """The inverse of a (B, L) table whose entries below ``rows`` are
    unique: (B, rows), each row's position in the table, L where it has
    none (entries at ``rows`` and above are dropped)."""
    b, length = table.shape
    inv = torch.full((b, rows + 1), length, dtype=torch.int64,
                     device=table.device)
    inv.scatter_(1, torch.clamp(table.to(torch.int64), max=rows),
                 torch.arange(length, device=table.device).expand(b, length))
    return inv[:, :rows]


class _TableGather(torch.autograd.Function):
    """:func:`gather_rows` with a gather for its backward."""

    @staticmethod
    def forward(ctx, x, table):
        ctx.save_for_backward(table)
        ctx.rows = x.shape[1]
        return gather_rows(x, table)

    @staticmethod
    def backward(ctx, g):
        (table,) = ctx.saved_tensors
        return gather_rows(g, inverse_table(table, ctx.rows)), None


def table_gather(x, table):
    """``gather_rows(x, table)`` for a table whose entries below R are
    unique, differentiable in ``x`` by a gather both ways."""
    return _TableGather.apply(x, table)
