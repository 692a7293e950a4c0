"""Mixture-of-Experts FFN (llama4 style: top-1 routed + shared expert),
for the PyTorch port: the counterpart of ``repro/models/moe.py``.

Dispatch is the token-choice / capacity-drop scheme: each token's
position within its expert comes from a stable sort of the token ->
expert assignments (``torch.argsort(stable=True)``, as ``jnp.argsort``
is stable), so which tokens an expert keeps past its capacity is the
reference's; tokens are scattered into (E, cap, d) buffers, every
expert's FFN runs over its whole buffer (empty slots included, as the
reference's batched einsum does) and the outputs are gathered back,
masked by ``keep`` and scaled by the gate. The router runs in float32.

Aux losses: load-balance (Switch) + router z-loss, summed over the
layers by ``transformer.DecoderLM.forward``.

On a mesh (``runtime/sharding.use_mesh``) the routing's index
arithmetic has no DTensor sharding rule (``searchsorted``, the stable
sort, the scatter into the buffers), so it is placed explicitly: the
tokens and the router's logits are replicated, the routing and the
dispatch run on every rank's full local copy, the (E, cap, d) buffers
enter the experts' products as replicated DTensors (the expert weights
keep their expert-parallel placement) and the outputs are replicated
back before the gather.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers as L
from repro_torch.runtime import sharding as SH


def _experts_init(generator, e: int, d_in: int, d_out: int, dtype,
                  device=None):
    """(e, d_in, d_out) truncated-normal weights, fan-in scaled, drawn
    one expert at a time in float32 and cast into the ``dtype`` tensor,
    so the draw never holds the whole float32 tensor (21.5 GB for one
    of llama4-maverick's at full width)."""
    out = L._empty((e, d_in, d_out), generator, device, L.torch_dtype(dtype))
    if L._drawn(out):
        for i in range(e):
            out[i] = L.dense_init(generator, d_in, d_out, torch.float32,
                                  device=out.device)
    return out


def moe_init(generator, cfg: MoEConfig, d: int, f: int, act: str, dtype,
             device=None):
    e = cfg.num_experts
    p = {
        "router": L.dense_init(generator, d, e, torch.float32, device=device),
        "wi_gate": _experts_init(generator, e, d, f, dtype, device),
        "wi_up": _experts_init(generator, e, d, f, dtype, device),
        "wo": _experts_init(generator, e, f, d, dtype, device),
    }
    if cfg.num_shared:
        p["shared"] = L.mlp_init(generator, d, f * cfg.num_shared, act, dtype,
                                 device=device)
    return p


class MoEAux(NamedTuple):
    load_balance: torch.Tensor
    router_z: torch.Tensor


def top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: (values, indices), largest
    first, and of equal values the lower index first (``torch.topk``
    promises no order among ties; a stable descending sort keeps the
    index order)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def capacity(cfg: MoEConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens, in Python numbers as the
    reference computes it; the floor of ``min(t, 8)`` keeps small decode
    batches drop-free."""
    cap = int(cfg.capacity_factor * t * cfg.top_k / cfg.num_experts)
    return max(cap, min(t, 8))


def dispatch_positions(expert_k, e: int, cap: int):
    """(keep, slot) of each token for one of the top-k choices: a
    token's slot is its rank among the tokens routed to its expert, in
    token order (a stable sort; searchsorted on the left, as the
    reference's); tokens past ``cap`` are dropped (``keep`` False) and
    point at slot ``cap - 1``."""
    t = expert_k.shape[0]
    order = torch.argsort(expert_k, stable=True)
    e_sorted = expert_k[order]
    run_start = torch.searchsorted(
        e_sorted, torch.arange(e, device=expert_k.device,
                               dtype=e_sorted.dtype))
    pos_sorted = torch.arange(t, device=expert_k.device) - run_start[e_sorted]
    my_pos = torch.zeros(t, dtype=torch.int64, device=expert_k.device)
    my_pos[order] = pos_sorted
    keep = my_pos < cap
    return keep, torch.where(keep, my_pos, cap - 1)


def _dispatch_one(params, xf, expert_k, gate_k, e: int, cap: int, act: str):
    """One of the top-k choices: scatter, the experts' FFN over their
    (E, cap, d) buffers, gather back. Dropped tokens add zeros at slot
    ``cap - 1`` and read nothing back."""
    d = xf.shape[1]
    keep, safe_pos = dispatch_positions(expert_k, e, cap)
    buf = torch.zeros((e, cap, d), dtype=xf.dtype, device=xf.device)
    buf.index_put_((expert_k, safe_pos),
                   torch.where(keep[:, None], xf, 0), accumulate=True)
    mesh = SH.current_mesh()
    if mesh is not None:
        buf = SH.as_replicated(buf, mesh)
    if act in ("silu", "geglu"):
        hg = torch.bmm(buf, params["wi_gate"])
        hu = torch.bmm(buf, params["wi_up"])
        h = (L.silu(hg) if act == "silu" else L.gelu_tanh(hg)) * hu
    else:
        h = L.gelu_tanh(torch.bmm(buf, params["wi_gate"]))
    out_buf = SH.replicated(torch.bmm(h, params["wo"]))
    y = out_buf[expert_k, safe_pos]                          # (T, d)
    return torch.where(keep[:, None], y, 0) * gate_k[:, None].to(xf.dtype)


def moe_apply(params, cfg: MoEConfig, x, act: str):
    """x: (B, S, d) -> (y, MoEAux). Top-k routing over a float32 softmax
    (llama4 is top-1)."""
    b, s, d = x.shape
    t = b * s
    e = cfg.num_experts
    # on a mesh: rows over the data axes only, so the (B*S) rows split
    # back into (B, S)
    x = SH.constrain(x, SH.dp_axes_spec(), None, None)
    xf = x.reshape(t, d)
    mesh = SH.current_mesh()

    # on a mesh the tokens and logits are replicated and routed locally
    x_in = xf
    logits = SH.replicated(xf.float() @ params["router"])    # (T, E)
    xf = SH.replicated(xf)
    probs = torch.softmax(logits, dim=-1)
    gate, expert = top_k(probs, cfg.top_k)                   # (T, k)
    cap = capacity(cfg, t)

    y = torch.zeros_like(xf)
    for kk in range(cfg.top_k):
        y = y + _dispatch_one(params, xf, expert[:, kk], gate[:, kk], e, cap,
                              act)
    if mesh is not None:
        y = SH.as_replicated(y, mesh)
    if cfg.num_shared:
        y = y + L.mlp_apply(params["shared"], x_in, act)

    me = torch.nn.functional.one_hot(expert[:, 0], e).float().mean(dim=0)
    pe = probs.mean(dim=0)
    aux = MoEAux(
        load_balance=e * torch.sum(me * pe),
        router_z=torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
    )
    if mesh is not None:
        aux = MoEAux(*(SH.as_replicated(a, mesh) for a in aux))
    return SH.pin(y.reshape(b, s, d)), aux
