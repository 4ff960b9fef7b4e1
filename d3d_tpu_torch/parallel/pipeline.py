"""GPipe pipeline parallelism over a ``pp`` mesh axis (port of
``d3d_tpu.parallel.pipeline``).

Stage ``i`` of a shape-homogeneous stack lives on pipeline rank
``i // k`` (``k`` stages a rank) and microbatches stream through the GPipe
schedule: microbatch ``j`` reaches rank ``r`` at tick ``j + r``, and each
activation hops one rank forward by point-to-point send and receive. The
JAX module runs every one of the ``M + S - 1`` ticks on every rank and
masks the bubbles; here each rank runs only its ``M`` real ticks, in
order, blocking on its predecessor's activations, so the bubbles are idle
time and the result is the same.

Gradients need no second schedule: each hop is an autograd function whose
backward sends the cotangent back to the rank it came from, so
``loss.backward()`` of a loss on :func:`pipeline_apply`'s output is
pipeline-parallel back-propagation, as ``jax.grad`` is in the JAX module.
Every rank receives the output; the loss on it is the same on every rank,
so the last rank keeps its own cotangent and the others none (the JAX
module's masked ``psum``, whose transpose reaches the last rank only).
"""

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .comm import gather_slabs, take_own

__all__ = ["make_pp_mesh", "microbatch", "unmicrobatch", "pipeline_apply"]


def make_pp_mesh(n_stages, dp=1, devices=None, device_type="cuda"):
    """A ``('dp', 'pp')`` mesh: ``pp`` the pipeline axis (consecutive
    stages on consecutive ranks), ``dp`` replicas of the whole pipeline.

    :param devices: the global ranks to lay out (default all, in order);
        ``n_stages * dp`` of them, the world
    """
    from .mesh import _mesh, _world

    n = _world()
    ranks = list(range(n)) if devices is None else list(devices)
    if len(ranks) != n_stages * dp or len(ranks) != n:
        raise ValueError("need n_stages * dp = %d ranks, the world has %d"
                         % (n_stages * dp, n))
    return _mesh(device_type, ranks, (dp, n_stages), ("dp", "pp"))


def microbatch(x, m):
    """Split the leading (batch) dim of every tensor into (m, b // m, ...)."""
    def split(a):
        if a.shape[0] % m:
            raise ValueError("batch %d not divisible into %d microbatches"
                             % (a.shape[0], m))
        return a.reshape(m, a.shape[0] // m, *a.shape[1:])
    return pytree.tree_map(split, x)


def unmicrobatch(x):
    """Inverse of :func:`microbatch`: merge the two leading dims."""
    return pytree.tree_map(
        lambda a: a.reshape(a.shape[0] * a.shape[1], *a.shape[2:]), x)


def _tag(j, i):
    return j * 64 + i


class _Send(torch.autograd.Function):
    """Send the activation's tensors to ``peer``; the output is a 0-d
    token that carries the backward, which receives their cotangents."""

    @staticmethod
    def forward(ctx, peer, group, j, *xs):
        ctx.peer, ctx.group, ctx.j = peer, group, j
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        for i, x in enumerate(xs):
            dist.send(x.contiguous(), peer, group=group, tag=_tag(j, i))
        return xs[0].new_zeros(())

    @staticmethod
    def backward(ctx, _):
        gs = []
        for i, (shape, dtype, dev) in enumerate(ctx.meta):
            g = torch.empty(shape, dtype=dtype, device=dev)
            dist.recv(g, ctx.peer, group=ctx.group, tag=_tag(ctx.j, i))
            gs.append(g)
        return (None, None, None, *gs)


class _Recv(torch.autograd.Function):
    """Receive an activation's tensors from ``peer`` (``like``: tensors of
    their shapes and dtypes); the backward sends their cotangents back.
    ``anchor`` ties the node into the graph."""

    @staticmethod
    def forward(ctx, peer, group, j, anchor, *like):
        ctx.peer, ctx.group, ctx.j = peer, group, j
        outs = []
        for i, t in enumerate(like):
            x = torch.empty(t.shape, dtype=t.dtype, device=t.device)
            dist.recv(x, peer, group=group, tag=_tag(j, i))
            outs.append(x)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        for i, g in enumerate(gs):
            dist.send(g.contiguous(), ctx.peer, group=ctx.group,
                      tag=_tag(ctx.j, i))
        # zeros for ``like`` (this rank's copy of the pipeline input), so
        # that its gradient's sum over the ranks runs here too
        return (None, None, None, None) + tuple(
            torch.zeros_like(g) if need else None
            for g, need in zip(gs, ctx.needs_input_grad[4:]))


class _FromLast(torch.autograd.Function):
    """The last rank's outputs on every rank (a broadcast). Backward: the
    last rank keeps its cotangent; the other ranks' tokens get zeros,
    which start their backward (their sends' receives)."""

    @staticmethod
    def forward(ctx, src, group, is_last, n_out, *args):
        ctx.is_last, ctx.n_out = is_last, n_out
        ctx.toks = [(t.dtype, t.device) for t in args[n_out:]]
        outs = [a.clone() for a in args[:n_out]]
        for o in outs:
            dist.broadcast(o, src, group=group)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.is_last:
            grads = tuple(gs)
        else:
            grads = (None,) * ctx.n_out
        toks = tuple(torch.zeros((), dtype=dt, device=dev)
                     for dt, dev in ctx.toks)
        return (None, None, None, None) + grads + toks


class _SumGrad(torch.autograd.Function):
    """Identity whose backward sums the cotangent over ``group``: the
    pipeline input, read by rank 0 only, and the weights a dp rank applies
    to its part of each microbatch get their whole gradient on every
    rank."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g in gs:
            g = g.clone()
            dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


def pipeline_apply(stage_fn, stage_state, xs, mesh, axis="pp",
                   batch_axis=None, state_specs=None):
    """Run ``S = mesh.shape[axis]`` pipeline ranks over ``M`` microbatches.

    :param stage_fn: ``(state_slice, x, mb_index) -> y`` with ``y`` shaped
        like ``x``; ``mb_index`` (an int) is the microbatch this call
        carries, for state that varies per microbatch
    :param stage_state: pytree whose tensors carry a leading stage dim of
        ``S * k`` stages; rank r applies stages ``[r*k, (r+1)*k)`` in turn
    :param xs: activation pytree with leading dims ``(M, mb, ...)``
        (:func:`microbatch`), the same on every rank
    :param batch_axis: optional mesh axis splitting the ``mb`` dim (dp x pp);
        state leaves carrying per-microbatch data split with it through
        ``state_specs``
    :param state_specs: optional pytree of tuples (one mesh axis name or
        None a dim, like ``stage_state``); dim 0 must be ``axis``
    :returns: outputs shaped like ``xs``, on every rank; differentiable
        with respect to ``stage_state`` and ``xs`` (their gradients whole
        on every rank)
    """
    S = mesh.shape[axis]
    leaves = pytree.tree_leaves(stage_state)
    nstages = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != nstages or nstages % S:
            raise ValueError(
                "stage_state leading axes must agree and divide into the "
                "%d pipeline ranks on axis %r (got %d/%d)"
                % (S, axis, leaf.shape[0], nstages))
    if state_specs is not None:
        for spec in pytree.tree_leaves(
                state_specs, is_leaf=lambda s: isinstance(s, tuple)):
            if not spec or spec[0] != axis:
                raise ValueError(
                    "state_specs must shard dim 0 over the pipeline axis")
    group = mesh.get_group(axis)
    r = dist.get_rank(group)
    bgroup = mesh.get_group(batch_axis) if batch_axis else None

    grad = torch.is_grad_enabled() and any(
        t.requires_grad
        for t in pytree.tree_leaves(xs) + pytree.tree_leaves(stage_state))
    # this rank's stages, and with a batch axis its part of the
    # per-microbatch state (the rest, the weights, sum their gradients
    # over the batch axis)
    state = pytree.tree_map(lambda a: take_own(a, 0, group), stage_state)
    if bgroup is not None:
        specs = (state_specs if state_specs is not None
                 else pytree.tree_map(lambda _: (axis,), stage_state))
        flat_s, tdef = pytree.tree_flatten(state)
        flat_spec = pytree.tree_leaves(
            specs, is_leaf=lambda s: isinstance(s, tuple))
        for i, (leaf, spec) in enumerate(zip(flat_s, flat_spec)):
            dims = [d for d, a in enumerate(spec) if a == batch_axis]
            for d in dims:
                leaf = take_own(leaf, d, bgroup)
            if not dims and grad and leaf.requires_grad:
                (leaf,) = _SumGrad.apply(bgroup, leaf)
            flat_s[i] = leaf
        state = pytree.tree_unflatten(flat_s, tdef)
        xs = pytree.tree_map(lambda a: take_own(a, 1, bgroup), xs)
    flat_x, xdef = pytree.tree_flatten(xs)
    m = flat_x[0].shape[0]
    spr = nstages // S
    if grad:
        flat_x = list(_SumGrad.apply(group, *flat_x))
    anchor = (flat_x[0].new_zeros((), requires_grad=True) if grad
              else flat_x[0].new_zeros(()))
    prev = dist.get_global_rank(group, r - 1) if r > 0 else None
    nxt = dist.get_global_rank(group, r + 1) if r < S - 1 else None

    outs, tokens = [], []
    for j in range(m):
        if prev is None:
            act = [a[j] for a in flat_x]
        else:
            act = list(_Recv.apply(prev, group, j, anchor,
                                   *[a[j] for a in flat_x]))
        y = pytree.tree_unflatten(act, xdef)
        for k in range(spr):
            y = stage_fn(pytree.tree_map(lambda a: a[k], state), y, j)
        ys = pytree.tree_leaves(y)
        if nxt is None:
            outs.append(ys)
        else:
            tokens.append(_Send.apply(nxt, group, j, *ys))
    if nxt is None:
        stacked = [torch.stack(list(t)) for t in zip(*outs)]
    else:
        stacked = [torch.empty(a.shape, dtype=a.dtype, device=a.device)
                   for a in flat_x]
    src = dist.get_global_rank(group, S - 1)
    result = list(_FromLast.apply(src, group, nxt is None, len(stacked),
                                  *stacked, *tokens))
    if bgroup is not None:
        result = [gather_slabs(t, 1, bgroup) for t in result]
    return pytree.tree_unflatten(result, xdef)
