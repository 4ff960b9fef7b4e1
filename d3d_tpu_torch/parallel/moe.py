"""A Switch-style mixture-of-experts MLP (port of ``d3d_tpu.parallel.moe``).

Top-1 (Switch) routing per group of ``group_size`` tokens with a capacity
of ``ceil(group / E * capacity_factor)`` tokens per expert and group:
tokens over capacity, and masked tokens, get zero output (the caller's
residual passes them through) and masked tokens take no capacity. The
auxiliary load-balance loss is the Switch ``E * sum_e f_e * P_e`` over the
valid tokens.

The JAX module dispatches with dense one-hot einsums, whose
``(G, group, E, cap)`` dispatch and combine tensors are 0.5 GB each at
``presets.sst_kitti(moe_experts=8)`` and batch 2. The port dispatches by
index instead: an inverse slot table (which token fills slot ``c`` of
expert ``e`` in group ``g``) gathers the tokens into ``(G, E, cap, C)``
blocks, the expert MLP runs on the blocks as batched products, and each
token gathers its expert's output row back, weighted by its gate; both
gathers' backward passes are gathers too
(:func:`~d3d_tpu_torch.ops.gather.table_gather`). Every
entry of the one-hot products is one product of one token, so the two
forms give the same numbers.

Expert parallelism (``mesh=`` or the :func:`~.mesh.expert_constrain`
hook): every rank of the ``ep`` group routes every token (the router is
replicated, the load-balance loss the dense one), takes its share of the
routing groups, dispatches their token blocks to the experts' owners by
one all-to-all, runs its E/ep experts on the blocks of every group, sends
the outputs back by a second all-to-all, combines its groups' tokens, and
all-gathers the tokens' outputs. The expert weights are either the whole
stack (each rank then uses its E/ep of them, and their gradients are
gathered whole) or a rank's E/ep experts already
(:func:`~.mesh.shard_train_step`, :func:`expert_sharding`).
"""

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor.placement_types import Replicate, Shard

from ..ops.gather import inverse_table, table_gather
from .comm import all_to_all, batch_sum, gather_slabs, take_own
from .mesh import ExpertHook, expert_constrain

__all__ = ["init_moe_params", "moe_mlp", "gelu_tanh", "expert_sharding"]


def init_moe_params(generator, n_experts, d_model, d_hidden,
                    dtype=torch.float32, device=None):
    """Router + stacked expert-MLP weights (leading expert axis), in the
    JAX module's layouts: router (C, E), w1 (E, C, H), b1 (E, H), w2 (E, H,
    C), b2 (E, C). Normal draws from the ``torch.Generator`` scaled by
    ``1/sqrt(fan_in)``, zero biases."""
    def normal(*shape, fan_in):
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                / math.sqrt(fan_in)).to(dtype=dtype, device=device)

    return {
        "router": normal(d_model, n_experts, fan_in=d_model),
        "w1": normal(n_experts, d_model, d_hidden, fan_in=d_model),
        "b1": torch.zeros((n_experts, d_hidden), dtype=dtype, device=device),
        "w2": normal(n_experts, d_hidden, d_model, fan_in=d_hidden),
        "b2": torch.zeros((n_experts, d_model), dtype=dtype, device=device),
    }


# gelu's constants rounded to each float dtype once, as JAX rounds them
# to the input's (a weak Python float, and sqrt(2/pi) cast by numpy)
_GELU_CONSTS = {dt: tuple(float(torch.tensor(v, dtype=dt))
                          for v in (math.sqrt(2 / math.pi), 0.044715))
                for dt in (torch.float64, torch.float32, torch.bfloat16,
                           torch.float16)}


def gelu_tanh(x):
    """``jax.nn.gelu`` (``approximate=True``, flax ``nn.gelu``'s default)
    in its operation order and x's dtype: ``x * (0.5 * (1 + tanh(sqrt(2/pi)
    * (x + 0.044715 x^3))))``, ``x^3`` as two products, the constants
    rounded to the dtype. ``F.gelu`` defaults to the erf form."""
    c, a = _GELU_CONSTS[x.dtype]
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


def expert_sharding(mesh, axis="ep"):
    """Placements (one per mesh axis) of each parameter: the expert axis
    (dim 0) of ``w1``/``b1``/``w2``/``b2`` over ``axis``, the router
    replicated."""
    ex = tuple(Shard(0) if a == axis else Replicate()
               for a in mesh.mesh_dim_names)
    rep = tuple(Replicate() for _ in mesh.mesh_dim_names)
    return {"router": rep, "w1": ex, "b1": ex, "w2": ex, "b2": ex}


def _experts(xe, w1, b1, w2, b2):
    """The expert MLPs on their (G, E, cap, C) token blocks."""
    h = torch.einsum("gecd,edh->gech", xe, w1) + b1[None, :, None, :]
    h = gelu_tanh(h)
    return torch.einsum("gech,ehd->gecd", h, w2) + b2[None, :, None, :]


def _ep_branch(hook, params, e, cap, xg, slot, gate):
    """The expert branch with the experts split over ``hook``'s group:
    (Gp * g, C) outputs of the (G, g) tokens, groups padded to a multiple
    of the group's size."""
    n, r, group = hook.size, hook.rank, hook.group
    ng, g, c = xg.shape
    pad = (-ng) % n
    if pad:
        xg = torch.cat([xg, xg.new_zeros((pad, g, c))])
        slot = torch.cat([slot, slot.new_full((pad, g), e * cap)])
        gate = torch.cat([gate, gate.new_zeros((pad, g))])
    gl = (ng + pad) // n
    own = slice(r * gl, (r + 1) * gl)
    # this rank's groups: their tokens into (E, cap) blocks, block k of
    # experts to rank k
    inv = inverse_table(slot[own], e * cap)
    xe = table_gather(take_own(xg, 0, group), inv).reshape(
        gl, n, e // n, cap, c).transpose(0, 1)
    xe = all_to_all(xe.reshape(n * gl, e // n, cap, c), group)
    local = []
    for k in ("w1", "b1", "w2", "b2"):
        w = params[k]
        local.append(take_own(w, 0, group) if w.shape[0] == e else w)
    ye = all_to_all(_experts(xe, *local), group)         # (n*gl, E/n, ...)
    ye = ye.reshape(n, gl, e // n, cap, c).transpose(0, 1).reshape(
        gl, e * cap, c)
    y = table_gather(ye, slot[own]) * take_own(gate, 0, group).to(
        ye.dtype)[..., None]
    return gather_slabs(y.reshape(gl * g, c), 0, group)


def moe_mlp(params, x, capacity_factor=1.25, mesh=None, axis="ep",
            mask=None, constrain=None, group_size=None):
    """Top-1 routed expert MLP over ``x`` of shape (..., N, C).

    :param params: :func:`init_moe_params`' dict (any float dtype; the
        expert weights are used in their own dtype, the router in x's)
    :param mask: optional (..., N) bool: False tokens are not routed (no
        capacity, zero output, left out of the load-balance statistics)
    :param group_size: tokens per routing group (default: one group of
        every token); a short last group is padded with masked tokens
    :param mesh: optional mesh with an ``axis`` dim: the experts run split
        over it (the module docstring); ``x`` is the same on every rank
    :param constrain: :func:`~.mesh.expert_constrain`'s hook instead of
        ``mesh``, or any ``t -> t`` applied to the (G, E, cap, ...) expert
        blocks as in the JAX module
    :returns: ``(y, aux)``: the expert branch (x's shape and dtype, zero
        for dropped tokens) and the float32 Switch load-balance loss. In a
        sharded step (:func:`~.comm.sharded`) the load-balance statistics
        are the whole batch's.
    """
    if mesh is not None and constrain is None:
        constrain = expert_constrain(mesh, axis)
    lead = x.shape[:-2]
    n, c = x.shape[-2], x.shape[-1]
    dev = x.device
    x2 = x.reshape(-1, c)
    ntok = x2.shape[0]
    m2 = (torch.ones(ntok, dtype=torch.bool, device=dev) if mask is None
          else mask.reshape(-1).to(torch.bool))
    g = int(min(group_size or ntok, ntok)) or 1
    padrows = (-ntok) % g
    if padrows:
        x2 = torch.cat([x2, x2.new_zeros((padrows, c))])
        m2 = torch.cat([m2, m2.new_zeros(padrows)])
    ng = x2.shape[0] // g
    e = params["router"].shape[1]
    cap = int(math.ceil(g / e * capacity_factor))

    xg = x2.reshape(ng, g, c)
    mg = m2.reshape(ng, g).to(torch.float32)
    logits = torch.matmul(xg, params["router"].to(xg.dtype))
    probs = torch.softmax(logits.to(torch.float32), dim=-1)   # (G, g, E)
    expert = probs.argmax(dim=-1)                             # (G, g)
    gate = probs.gather(-1, expert[..., None])[..., 0]

    # each token's place in its expert's queue of the group (masked tokens
    # take none): small integers, exact in any summation order
    onehot = F.one_hot(expert, e).to(torch.float32) * mg[..., None]
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos_tok = (pos * onehot).sum(dim=-1).to(torch.int64)      # (G, g)
    keep = (pos_tok < cap) & m2.reshape(ng, g)
    # slot of each kept token in the group's (E * cap) blocks; the rest
    # take the trash slot E * cap
    trash = e * cap
    slot = torch.where(keep, expert * cap + pos_tok, trash)   # (G, g)
    if isinstance(constrain, ExpertHook):
        y = _ep_branch(constrain, params, e, cap, xg, slot, gate)
    else:
        # the token that fills each slot (g: none), then the blocks
        inv = inverse_table(slot, trash)
        xe = table_gather(xg, inv).reshape(ng, e, cap, c)  # (G, E, cap, C)
        con = constrain or (lambda t: t)
        ye = con(_experts(con(xe), *(params[k]
                                     for k in ("w1", "b1", "w2", "b2"))))
        y = table_gather(ye.reshape(ng, trash, c), slot)
        # dropped tokens read the zero row
        y = (y * gate.to(ye.dtype)[..., None]).reshape(-1, c)
    y = y[:ntok]

    denom = torch.clamp_min(batch_sum(mg.sum()), 1.0)
    frac = batch_sum(onehot.sum(dim=(0, 1))) / denom
    pmean = batch_sum((probs * mg[..., None]).sum(dim=(0, 1))) / denom
    aux = e * (frac * pmean).sum()
    return y.reshape(*lead, n, c), aux
