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

Sharding the experts over a mesh axis (``mesh=``, ``expert_sharding``)
waits for the port of ``d3d_tpu.parallel``'s mesh helpers.
"""

import math

import torch
import torch.nn.functional as F

from ..ops.gather import inverse_table, table_gather

__all__ = ["init_moe_params", "moe_mlp", "gelu_tanh"]


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


def _not_ported(what):
    return NotImplementedError(
        f"moe_mlp({what}=...) shards the experts over a mesh axis, which "
        "waits for the port of d3d_tpu.parallel's mesh helpers "
        "(d3d_tpu_torch.parallel); call it without it")


def moe_mlp(params, x, capacity_factor=1.25, mesh=None, axis="ep",
            mask=None, constrain=None, group_size=None):
    """Top-1 routed expert MLP over ``x`` of shape (..., N, C).

    :param params: :func:`init_moe_params`' dict (any float dtype; the
        expert weights are used in their own dtype, the router in x's)
    :param mask: optional (..., N) bool: False tokens are not routed (no
        capacity, zero output, left out of the load-balance statistics)
    :param group_size: tokens per routing group (default: one group of
        every token); a short last group is padded with masked tokens
    :param mesh: / ``constrain``: the JAX module's expert-sharding hooks;
        anything but None raises ``NotImplementedError``
    :returns: ``(y, aux)``: the expert branch (x's shape and dtype, zero
        for dropped tokens) and the float32 Switch load-balance loss
    """
    if mesh is not None:
        raise _not_ported("mesh")
    if constrain is not None:
        raise _not_ported("constrain")
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
    e = params["w1"].shape[0]
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
    # the token that fills each slot (g: none), then the blocks
    inv = inverse_table(slot, trash)
    xe = table_gather(xg, inv).reshape(ng, e, cap, c)         # (G, E, cap, C)

    w1, b1, w2, b2 = (params[k] for k in ("w1", "b1", "w2", "b2"))
    h = torch.einsum("gecd,edh->gech", xe, w1) + b1[None, :, None, :]
    h = gelu_tanh(h)
    ye = torch.einsum("gech,ehd->gecd", h, w2) + b2[None, :, None, :]
    y = table_gather(ye.reshape(ng, trash, c), slot)
    y = y * gate.to(ye.dtype)[..., None]   # dropped tokens read the zero row
    y = y.reshape(-1, c)[:ntok]

    denom = torch.clamp_min(mg.sum(), 1.0)
    frac = onehot.sum(dim=(0, 1)) / denom
    pmean = (probs * mg[..., None]).sum(dim=(0, 1)) / denom
    aux = e * (frac * pmean).sum()
    return y.reshape(*lead, n, c), aux
