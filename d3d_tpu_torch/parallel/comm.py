"""Collectives with autograd rules, the partition context of a sharded
step, and the spatial (``sp``) hook that the models take as ``constrain``.

The JAX package annotates shardings and lets XLA's SPMD partitioner insert
the collectives; here each rank runs eager code on its part and the
collectives are explicit. Two gradient conventions meet:

* a **sum** axis (``dp``, ``sp``): each rank back-propagates its share of
  the loss, and a parameter's gradient is the sum of the ranks'. Batch
  statistics and loss normalisers are sums over the axis
  (:func:`all_reduce_sum`, forward and backward), and a tensor that is
  whole again after a partitioned stretch (:func:`gather_slabs`) hands each
  rank the cotangent of its own rows only, so that the sum counts every
  row once;
* a **replicated** axis (``tp``, ``ep``, ``pp``): every rank computes the
  same value and holds the whole gradient. A rank that takes its own part
  of a replicated tensor (:func:`take_own`) gets the others' cotangents
  back by an all-gather.

:func:`sharded` sets the dp groups for the duration of a sharded step:
BatchNorm's statistics (``_bn_train``, SECOND's ``_MaskedBN``), the
detection loss's positive count and the MoE load-balance statistics sum
over them, as the JAX package's global arrays do.
"""

import contextlib
import contextvars

import torch
import torch.distributed as dist

__all__ = ["sharded", "batch_groups", "loss_share", "live", "all_reduce_sum",
           "batch_sum", "batch_mean", "gather_slabs", "take_own", "all_to_all",
           "SpatialHook"]

_PARTITION = contextvars.ContextVar("d3d_tpu_torch_partition",
                                    default=((), 1.0))


@contextlib.contextmanager
def sharded(groups=(), share=1.0):
    """Run the enclosed forward and backward as one rank's part of a step
    whose batch is split over ``groups`` (process groups, the dp axis).

    :param share: the factor a loss term that every rank computes whole
        (the MoE load-balance loss, from global statistics) takes on this
        rank, so that the ranks' shares sum to it once: 1 / (dp * sp)
    """
    token = _PARTITION.set((tuple(groups), float(share)))
    try:
        yield
    finally:
        _PARTITION.reset(token)


def batch_groups():
    """The process groups the batch is split over (empty outside
    :func:`sharded`)."""
    return _PARTITION.get()[0]


def loss_share():
    """This rank's share of a loss term computed whole on every rank (1.0
    outside :func:`sharded`)."""
    return _PARTITION.get()[1]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        y = x.clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


def live(groups):
    """The groups of more than one rank: a sum over one rank is the input,
    so a one-rank mesh computes what one process does."""
    return tuple(g for g in groups if dist.get_world_size(g) > 1)


def all_reduce_sum(x, groups):
    """The sum of ``x`` over every rank of ``live(groups)`` (applied in
    turn), on every rank; its backward sums the cotangents the same way
    (each rank consumed the sum for its own share of the loss). The
    identity for no live group."""
    groups = live(groups)
    return _AllReduceSum.apply(x, groups) if groups else x


def batch_sum(x):
    """:func:`all_reduce_sum` over :func:`batch_groups`."""
    return all_reduce_sum(x, batch_groups())


def batch_mean(x):
    """This rank's share of the whole batch's mean of ``x``: its sum over
    the count of every rank's elements, so that the shares sum to the mean
    once; ``x.mean()`` outside a sharded step (or on one rank)."""
    if not live(batch_groups()):
        return x.mean()
    return x.sum() / batch_sum(x.new_tensor(float(x.numel())))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n = dist.get_world_size(group)
        ctx.dim, ctx.rank, ctx.rows = dim, dist.get_rank(group), x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.rows, ctx.rows), None, None


def gather_slabs(x, dim, group):
    """The ranks' slabs of ``x`` joined along ``dim`` in rank order. The
    consumer computes the same loss on every rank, so the backward keeps
    this rank's rows of the (equal) cotangent: no sum over the ranks,
    which would count each row's gradient once per rank."""
    return _GatherRows.apply(x, dim, group)


class _TakeOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.group, ctx.n = dim, group, n
        rows = x.shape[dim] // n
        return x.narrow(dim, r * rows, rows).contiguous()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(ctx.n)]
        dist.all_gather(parts, g, group=ctx.group)
        return torch.cat(parts, dim=ctx.dim), None, None


def take_own(x, dim, group):
    """This rank's part of a tensor that every rank of ``group`` holds
    whole (part r of n along ``dim``). The backward all-gathers the parts'
    cotangents, so the whole tensor's gradient is whole on every rank."""
    if x.shape[dim] % dist.get_world_size(group):
        raise ValueError("dim %d of size %d does not split over %d ranks"
                         % (dim, x.shape[dim], dist.get_world_size(group)))
    return _TakeOwn.apply(x, dim, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        # contiguous first: empty_like keeps a dense view's strides, and
        # the collective writes its buffer in row-major order
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def all_to_all(x, group):
    """Equal chunks of dim 0: chunk k goes to rank k of ``group``, and
    the chunks received come in rank order. Its own transpose, so the
    backward is the same exchange of the cotangents."""
    if x.shape[0] % dist.get_world_size(group):
        raise ValueError("all_to_all: dim 0 of size %d does not split over "
                         "%d ranks" % (x.shape[0],
                                       dist.get_world_size(group)))
    return _AllToAll.apply(x, group)


def _exchange(sends, recvs, group):
    """Point-to-point: ``sends`` / ``recvs`` are lists of (group rank,
    tensor); all posted together, then waited for."""
    ops = [dist.P2POp(dist.isend, t.contiguous(),
                      dist.get_global_rank(group, r), group)
           for r, t in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, r), group)
            for r, t in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Halo(torch.autograd.Function):
    """Rows ``hb`` before and ``ha`` after a slab (dim 2), from its
    neighbours in ``group``, zeros past the canvas's edges. Backward: the
    halo rows' cotangents go back to their owners and add to theirs."""

    @staticmethod
    def forward(ctx, x, hb, ha, hook):
        ctx.hb, ctx.ha, ctx.hook = hb, ha, hook
        r, n = hook.rank, hook.size
        rows = x.shape[2]
        if max(hb, ha) > rows:
            raise ValueError("halo of %d rows over a slab of %d"
                             % (max(hb, ha), rows))
        shape = list(x.shape)
        before = x.new_zeros(shape[:2] + [hb] + shape[3:])
        after = x.new_zeros(shape[:2] + [ha] + shape[3:])
        sends, recvs = [], []
        if r > 0:
            if ha:
                sends.append((r - 1, x[:, :, :ha]))
            if hb:
                recvs.append((r - 1, before))
        if r < n - 1:
            if hb:
                sends.append((r + 1, x[:, :, rows - hb:]))
            if ha:
                recvs.append((r + 1, after))
        hook.count("halo", sum(t.shape[2] for _, t in sends))
        _exchange(sends, recvs, hook.group)
        return torch.cat([before, x, after], dim=2)

    @staticmethod
    def backward(ctx, g):
        hb, ha, hook = ctx.hb, ctx.ha, ctx.hook
        r, n = hook.rank, hook.size
        rows = g.shape[2] - hb - ha
        dx = g[:, :, hb:hb + rows].clone()
        shape = list(dx.shape)
        from_next = dx.new_zeros(shape[:2] + [hb] + shape[3:])
        from_prev = dx.new_zeros(shape[:2] + [ha] + shape[3:])
        sends, recvs = [], []
        if r > 0:
            if hb:
                sends.append((r - 1, g[:, :, :hb]))
            if ha:
                recvs.append((r - 1, from_prev))
        if r < n - 1:
            if ha:
                sends.append((r + 1, g[:, :, hb + rows:]))
            if hb:
                recvs.append((r + 1, from_next))
        _exchange(sends, recvs, hook.group)
        if r > 0 and ha:
            dx[:, :, :ha] += from_prev
        if r < n - 1 and hb:
            dx[:, :, rows - hb:] += from_next
        return dx, None, None, None


def _same_padding(size, k, stride):
    """flax/XLA "SAME" padding of one dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SpatialHook:
    """The ``constrain`` hook of :func:`~d3d_tpu_torch.parallel.mesh.
    spatial_constrain`: the BEV canvas (NCHW, x along dim 2) runs as one
    slab of rows per rank of ``group`` (the mesh's ``sp`` axis).

    ``hook(canvas, "bev")`` returns this rank's slab (plain slicing: the
    backward is its own rows' cotangent, the sum convention); the models
    then run their BEV convolutions through :meth:`conv2d` (halo rows from
    the neighbours, no gather of the canvas), normalise with statistics
    summed over ``group`` and join the head outputs with :meth:`gather`
    before their reshape. Other kinds and tensors of another rank pass
    through. ``counts`` tallies the halo rows sent and the gathers.
    """

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.counts = {"halo": 0, "halo_calls": 0, "gather": 0}

    def count(self, what, rows):
        self.counts[what] += rows
        if what == "halo":
            self.counts["halo_calls"] += 1

    def __call__(self, x, kind):
        if kind != "bev" or x.ndim != 4:
            return x
        rows = x.shape[2]
        if rows % self.size:
            raise ValueError("canvas of %d rows does not split over sp=%d"
                             % (rows, self.size))
        rows //= self.size
        return x[:, :, self.rank * rows:(self.rank + 1) * rows]

    def conv2d(self, x, weight, stride=1, bias=None):
        """The SAME convolution of the whole canvas, restricted to this
        slab's output rows: the global SAME padding along rows comes from
        the neighbours' halo (zeros at the canvas's edges), along columns
        it is the usual one. Needs a slab whose rows divide by
        ``stride``."""
        k, kw = weight.shape[2], weight.shape[3]
        rows = x.shape[2]
        if rows % stride:
            raise ValueError("slab of %d rows at stride %d" % (rows, stride))
        hb, ha = _same_padding(rows * self.size, k, stride)
        x = _Halo.apply(x, hb, ha, self) if hb or ha else x
        cl, cr = _same_padding(x.shape[3], kw, stride)
        if cl != cr:
            x = torch.nn.functional.pad(x, (cl, cr, 0, 0))
            cl = 0
        return torch.nn.functional.conv2d(x, weight, bias, stride=stride,
                                          padding=(0, cl))

    def gather(self, x):
        """The whole canvas (dim 2) of this rank's slab, on every rank
        (:func:`gather_slabs`)."""
        self.counts["gather"] += 1
        return gather_slabs(x, 2, self.group)

    def stat_groups(self):
        """The groups a BatchNorm over slabs sums its statistics over:
        the step's dp groups and this hook's."""
        return batch_groups() + (self.group,)
