"""Mamba-2 (SSD, state-space duality) mixer, for the PyTorch port: the
counterpart of ``repro/models/ssm.py``.

Chunked SSD (arXiv:2405.21060 §6) for the full sequence: within-chunk
terms are matmuls, across chunks the state is carried by a scan over
(decay, state) pairs; decode is the O(1)-state recurrent step. The
reference's scan is ``jax.lax.associative_scan``; the port's is a loop
over the chunks in order (the same recurrence, float32 either way,
summed in another order). The reference's three-operand einsums are
written as two products each, so no (B, nc, Q, Q, H, P) intermediate
is ever formed.

Layout: x (B, T, H, P) heads x headdim; B/C (B, T, G, N) with G = 1
state group; dt (B, T, H); A (H,) negative reals via -exp(A_log).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models import layers as L
from repro_torch.runtime import sharding as SH


def ssd_init(generator, cfg: SSMConfig, d_model: int, dtype, device=None):
    inner = cfg.expand * d_model
    heads = inner // cfg.head_dim
    n = cfg.d_state
    conv_ch = inner + 2 * n                       # conv over (x, B, C)
    dt = L.torch_dtype(dtype)
    conv_w = L._empty((cfg.d_conv, conv_ch), generator, device)
    if L._drawn(conv_w):
        conv_w.normal_(generator=generator).mul_(0.1)
    dev = conv_w.device
    return {
        # fused in_proj -> [z, x, B, C, dt]
        "in_proj": L.dense_init(generator, d_model,
                                2 * inner + 2 * n + heads, dtype, device=dev),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "a_log": torch.log(torch.linspace(1.0, float(cfg.d_state) / 2 + 1,
                                          heads, dtype=torch.float32,
                                          device=dev)),
        "dt_bias": torch.zeros((heads,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((heads,), dtype=torch.float32, device=dev),
        "gate_norm": L.rmsnorm_init(inner, torch.float32, device=dev),
        "out_proj": L.dense_init(generator, inner, d_model, dtype,
                                 scale=inner ** -0.5, device=dev),
    }


def _dims(cfg: SSMConfig, d_model: int):
    """(inner, n, heads)."""
    inner = cfg.expand * d_model
    return inner, cfg.d_state, inner // cfg.head_dim


def _split_proj(cfg: SSMConfig, d_model: int, zxbcdt):
    """[z, x, B, C, dt] of the fused projection (``torch.split`` takes
    the sizes where ``jnp.split`` takes the indices)."""
    inner, n, heads = _dims(cfg, d_model)
    z, x, bmat, cmat, dt = torch.split(zxbcdt, [inner, inner, n, n, heads],
                                       dim=-1)
    return z, x, bmat, cmat, dt


def softplus(x):
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` switches to x past
    a threshold)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x, w, b):
    """(B, T, C) depthwise causal conv, width K: the K shifted products
    summed in order, then the bias, as the reference writes it."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return out + b


def ssd_apply(params, cfg: SSMConfig, d_model: int, x_in, *,
              return_state: bool = False):
    """Full-sequence SSD (prefill). x_in: (B, T, d_model); T must be a
    multiple of ``cfg.chunk`` (``ValueError`` otherwise, where the
    reference asserts). With ``return_state``, also (the final state
    (B, H, N, P) float32, the last d_conv - 1 pre-activation conv
    inputs). On a mesh the two projections are DTensor products and the
    rest (:func:`_ssd_core`: conv, scan, gate) runs on each rank's batch
    rows (``sharding.run_local``), its parameters replicated; there
    ``return_state`` is not offered."""
    bsz, t, _ = x_in.shape
    if t % cfg.chunk:
        raise ValueError(f"ssd_apply: sequence of {t} is not a multiple of "
                         f"the chunk {cfg.chunk}")
    x_in = SH.rows(x_in)             # on a mesh: batch-only sharding
    zxbcdt = x_in @ params["in_proj"]
    leaves = (params["conv_w"], params["conv_b"], params["a_log"],
              params["dt_bias"], params["d_skip"],
              params["gate_norm"]["scale"])
    mesh = SH.current_mesh()
    if mesh is None:
        y, state = _ssd_core(cfg, d_model, x_in.dtype, zxbcdt, *leaves)
    else:
        if return_state:
            raise NotImplementedError("ssd_apply(return_state=True) on a "
                                      "mesh")
        dp = SH.fit_spec((SH.dp_axes_spec(),), zxbcdt.shape, mesh)[0]
        y = SH.run_local(
            lambda *a: _ssd_core(cfg, d_model, x_in.dtype, *a)[0],
            (zxbcdt, *leaves),
            [(dp, None, None)] + [(None,) * x.ndim for x in leaves],
            (dp, None, None))
    out = SH.pin(y @ params["out_proj"])      # on a mesh: grad batch-only
    if return_state:
        return out, state
    return out


def _ssd_core(cfg: SSMConfig, d_model: int, dtype, zxbcdt, conv_w, conv_b,
              a_log, dt_bias, d_skip, gate_scale):
    """:func:`ssd_apply` between its projections: (the gated y (B, T,
    inner) in ``dtype``, (the final state, the conv tail))."""
    bsz, t, _ = zxbcdt.shape
    q = cfg.chunk
    nc = t // q
    p = cfg.head_dim
    inner, n, heads = _dims(cfg, d_model)
    z, xc, bmat, cmat, dt = _split_proj(cfg, d_model, zxbcdt)

    conv_in = torch.cat([xc, bmat, cmat], dim=-1)
    conv = L.silu(_causal_conv(conv_in, conv_w, conv_b))
    xc, bmat, cmat = torch.split(conv, [inner, n, n], dim=-1)

    x = xc.reshape(bsz, t, heads, p)
    dt = softplus(dt.float() + dt_bias)            # (B, T, H)
    a = -torch.exp(a_log)                          # (H,)
    dta = dt * a                                             # log-decay/step

    # --- chunked SSD --- (g = 1 state group, dropped from the layouts)
    xs = (x * dt[..., None].to(x.dtype)).reshape(bsz, nc, q, heads, p)
    xs = xs.float()
    bm_c = bmat.reshape(bsz, nc, q, n).float()
    cm_c = cmat.reshape(bsz, nc, q, n).float()
    lcum = torch.cumsum(dta.reshape(bsz, nc, q, heads), dim=2)  # (B,nc,Q,H)

    # intra-chunk: scores[t,s] = (C_t . B_s) exp(l_t - l_s), s <= t
    cb = cm_c @ bm_c.transpose(-1, -2)                       # (B,nc,Q,Q)
    ldiff = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    causal = torch.ones((q, q), dtype=torch.bool,
                        device=zxbcdt.device).tril()[None, None, :, :, None]
    # mask BEFORE exp: for s > t ldiff is positive and exp overflows
    decay = torch.exp(torch.where(causal, ldiff, -torch.inf))
    scores = (cb[..., None] * decay).permute(0, 1, 4, 2, 3)  # (B,nc,H,Q,S)
    y_intra = (scores @ xs.transpose(2, 3)).transpose(2, 3)  # (B,nc,Q,H,P)

    # per-chunk terminal state: S_c = sum_s exp(l_last - l_s) B_s (dt_s x_s)
    seg = torch.exp(lcum[:, :, -1:, :] - lcum)               # (B,nc,Q,H)
    u = (seg[..., None] * xs).reshape(bsz, nc, q, heads * p)
    s_chunk = (bm_c.transpose(-1, -2) @ u).reshape(
        bsz, nc, n, heads, p).permute(0, 1, 3, 2, 4)         # (B,nc,H,N,P)
    g_chunk = torch.exp(lcum[:, :, -1, :])                   # (B,nc,H)

    # inter-chunk scan over (decay, state): s_acc[c] = g_c s_acc[c-1] + s_c
    acc = [s_chunk[:, 0]]
    for c in range(1, nc):
        acc.append(g_chunk[:, c, :, None, None] * acc[-1] + s_chunk[:, c])
    s_acc = torch.stack(acc, dim=1)
    # state entering chunk c = s_acc[c-1]
    s_prev = torch.cat([torch.zeros_like(s_acc[:, :1]), s_acc[:, :-1]], dim=1)

    # y_inter[q,h,p] = exp(l_q,h) sum_n C_q,n s_prev[h,n,p]
    y_inter = (cm_c[:, :, None] @ s_prev).transpose(2, 3)    # (B,nc,Q,H,P)
    y_inter = torch.exp(lcum)[..., None] * y_inter

    y = (y_intra + y_inter).reshape(bsz, t, heads, p)
    y = y + d_skip[None, None, :, None] * x.float()
    y = y.reshape(bsz, t, inner).to(dtype)

    # gated RMSNorm + out projection (mamba2 block epilogue)
    y = L.rmsnorm({"scale": gate_scale}, y * L.silu(z))
    final_state = s_acc[:, -1]                               # (B, H, N, P)
    conv_tail = conv_in[:, -(cfg.d_conv - 1):, :]            # pre-activation
    return y, (final_state, conv_tail)


class SSMCache(NamedTuple):
    state: torch.Tensor      # (B, H, N, P) float32
    conv_buf: torch.Tensor   # (B, d_conv-1, conv_channels)


def ssm_cache_init(batch: int, cfg: SSMConfig, d_model: int, dtype,
                   device=None):
    inner, n, heads = _dims(cfg, d_model)
    return SSMCache(
        state=torch.zeros((batch, heads, n, cfg.head_dim),
                          dtype=torch.float32, device=device),
        conv_buf=torch.zeros((batch, cfg.d_conv - 1, inner + 2 * n),
                             dtype=L.torch_dtype(dtype), device=device),
    )


def ssd_decode(params, cfg: SSMConfig, d_model: int, x_in, cache: SSMCache):
    """Single-token recurrent step. x_in: (B, 1, d_model). Returns (out
    (B, 1, d_model), the new cache)."""
    bsz = x_in.shape[0]
    p = cfg.head_dim
    inner, n, heads = _dims(cfg, d_model)
    zxbcdt = x_in[:, 0] @ params["in_proj"]
    z, xc, bmat, cmat, dt = _split_proj(cfg, d_model, zxbcdt)
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)            # (B, C)
    window = torch.cat([cache.conv_buf, conv_in[:, None]], dim=1)
    # the reference's einsum over the window: exact products summed in
    # float32, rounded once to the model's dtype
    conv = L.silu((window.float() * params["conv_w"].float()).sum(dim=1)
                  .to(window.dtype) + params["conv_b"])
    xc, bmat, cmat = torch.split(conv, [inner, n, n], dim=-1)

    x = xc.reshape(bsz, heads, p).float()
    bm = bmat.float()                                        # (B, N)
    cm = cmat.float()
    dt = softplus(dt.float() + params["dt_bias"])            # (B, H)
    a = torch.exp(dt * -torch.exp(params["a_log"]))          # (B, H)

    state = (a[..., None, None] * cache.state
             + bm[:, None, :, None] * (dt[..., None] * x)[:, :, None, :])
    y = (cm[:, None, None, :] @ state)[:, :, 0]              # (B, H, P)
    y = y + params["d_skip"][None, :, None] * x
    y = y.reshape(bsz, inner).to(x_in.dtype)
    y = L.rmsnorm(params["gate_norm"], y * L.silu(z))
    out = (y @ params["out_proj"])[:, None, :]
    return out, SSMCache(state=state, conv_buf=window[:, 1:])
