"""GQA attention with RoPE, qk-norm, soft-capping, sliding windows and a
KV cache, for the PyTorch port: the counterpart of
``repro/models/attention.py`` for every stack of the zoo (qwen3,
granite, gemma2, llama4, internvl2, zamba2's shared block, and
whisper's encoder, decoder and cross attention).

Plain torch, written as the reference writes it: the direct softmax
(:func:`_sdpa`) and the online-softmax blockwise form
(:func:`_blockwise_attn`) with the reference's soft-cap, masks, GQA
grouping (query head ``h`` reads kv head ``h // group``) and order of
operations; not ``F.scaled_dot_product_attention``, which cannot
soft-cap and sums in another order. Attention logits are float32
whatever the model's dtype: q and k are upcast before the product, as
the reference's ``preferred_element_type=jnp.float32`` asks, and the
probabilities are cast to v's dtype before the second product.

On a mesh (``runtime/sharding.use_mesh``, the tensors DTensors) q, k
and v are constrained at the reference's sites (:func:`_constrain_heads`:
batch over the data axes, heads over ``'model'``), and
:func:`_blockwise_attn` expands the kv heads to the query heads when
those divide the ``'model'`` axis, so the grouped layout shards
(``attention.py:108-121`` of the reference). The softmax itself runs
on each rank's shards (:func:`_on_shards`: batch rows and heads are
independent), so a decode step gathers a cache whose sequence is
sharded over 'model' (the reference's comment speaks of a split-K
decode; XLA chooses). Decode writes the new key and value into the
local shard of such a cache (:func:`_write_slot`). Off a mesh all of
this is a no-op.

Decode consumes a cache laid out (B, S_cache, Hkv, hd): global layers
the full context written at ``pos``, sliding layers a rolling window of
the last W positions written at ``pos % W``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import AttnConfig
from repro_torch.models import layers as L
from repro_torch.runtime import sharding as SH

NEG_INF = -2.0e38

# query and key block lengths of _blockwise_attn, read at call time (a
# test may shrink them, as tests/test_models.py does the reference's)
BLOCK_Q = 1024
BLOCK_K = 1024


def attn_init(generator, cfg: AttnConfig, d_model: int, dtype, head_dim=None,
              device=None):
    hd = head_dim or (cfg.head_dim or d_model // cfg.num_heads)
    p = {
        "wq": L.dense_init(generator, d_model, (cfg.num_heads, hd), dtype,
                           device=device),
        "wk": L.dense_init(generator, d_model, (cfg.num_kv_heads, hd), dtype,
                           device=device),
        "wv": L.dense_init(generator, d_model, (cfg.num_kv_heads, hd), dtype,
                           device=device),
        "wo": L.dense_init(
            generator, d_model, (cfg.num_heads, hd), dtype,
            scale=(cfg.num_heads * hd) ** -0.5, device=device,
        ),  # stored (d, H, hd); applied transposed
    }
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(hd, torch.float32, device=device)
        p["k_norm"] = L.rmsnorm_init(hd, torch.float32, device=device)
    return p


def _qkv(params, cfg: AttnConfig, x, positions, *, rope: bool = True):
    q = L.heads_proj(x, params["wq"])
    k = L.heads_proj(x, params["wk"])
    v = L.heads_proj(x, params["wv"])
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q)
        k = L.rmsnorm(params["k_norm"], k)
    if rope:
        # q and k share the positions, so one set of angles serves both
        sin, cos = L.rope_angles(positions, q.shape[-1], cfg.rope_theta)
        q = L.rotate(q, sin, cos)
        k = L.rotate(k, sin, cos)
    return q, k, v


def _additive(ok):
    """0 where ``ok``, NEG_INF elsewhere, float32."""
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill_(~ok, NEG_INF)


def _mask(q_pos, k_pos, *, causal: bool, window: int):
    """(.., Sq, Sk) additive mask from position vectors."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        ok &= diff >= 0
    if window:
        ok &= diff < window
    return _additive(ok)


def _on_shards(fn, q, k, v, *rest, **kwargs):
    """``fn(q, k, v, *rest, **kwargs)`` on a mesh, run on each rank's
    shards (``sharding.run_local``): batch rows over the data axes, heads
    over 'model' when both q's and k's head counts divide it (each rank's
    query heads then read its own kv heads), else replicated; ``rest``
    (masks, positions) batch-leading. The result is placed as q."""
    mesh = SH.current_mesh()
    dp = SH.fit_spec((SH.dp_axes_spec(),), q.shape, mesh)[0]
    m = SH.mesh_axes(mesh).get("model", 1)
    heads = ("model" if "model" in SH.mesh_axes(mesh)
             and q.shape[2] % m == 0 and k.shape[2] % m == 0 else None)
    qkv = (dp, None, heads, None)
    specs = [qkv, qkv, qkv] + [(dp,) + (None,) * (x.ndim - 1) for x in rest]
    return SH.run_local(fn, (q, k, v, *rest), specs, qkv, **kwargs)


def _sdpa(q, k, v, mask, *, softcap_val: float):
    """Direct softmax attention: the decode path (Sq == 1) and sequences
    up to ``BLOCK_Q``. Materialises (B, H, Sq, Sk) float32 scores. On a
    mesh it runs on each rank's shards (:func:`_on_shards`)."""
    if SH.current_mesh() is not None:
        return _on_shards(_sdpa, q, k, v, mask, softcap_val=softcap_val)
    hd = q.shape[-1]
    hq, hkv = q.shape[-2], k.shape[-2]
    group = hq // hkv
    b, sq = q.shape[0], q.shape[1]
    q = q.reshape(b, sq, hkv, group, hd)
    logits = torch.einsum("bqhgk,bshk->bhgqs", q.float(), k.float())
    logits = logits / math.sqrt(hd)
    logits = L.softcap(logits, softcap_val)
    logits = logits + mask[:, None, None, :, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs, v)
    return out.reshape(b, sq, hq, hd)


def _blockwise_attn(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                    softcap_val: float):
    """Flash-style blockwise attention in plain torch (online softmax),
    the reference's order exactly: for each query block, the kv blocks in
    order, carrying (acc, running max, denom) in float32. A fully masked
    block contributes ``exp(NEG_INF - NEG_INF)`` until a later ``corr =
    0`` wipes it; the end divides by ``max(denom, 1e-30)``. Peak scores
    memory is one (B, H, Bq, Bk) block. q/k/v: (B, S, H(kv), hd).

    Raises ``ValueError`` unless ``min(BLOCK_Q, Sq)`` divides Sq and
    ``min(BLOCK_K, Sk)`` divides Sk (the reference asserts it)."""
    mesh = SH.current_mesh()
    if mesh is not None:
        # GQA head expansion on a mesh: with fewer kv heads than the
        # model axis the grouped (hkv, group) layout cannot shard over
        # 'model'; k and v expanded to hq heads shard whenever hq
        # divides it. Then the blocks run on each rank's shards.
        group = q.shape[2] // k.shape[2]
        if group > 1 and q.shape[2] % SH.mesh_axes(mesh).get("model", 1) == 0:
            k = _constrain_heads(torch.repeat_interleave(k, group, dim=2))
            v = _constrain_heads(torch.repeat_interleave(v, group, dim=2))
        return _on_shards(_blockwise_attn, q, k, v, q_pos, k_pos,
                          causal=causal, window=window,
                          softcap_val=softcap_val)
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    bq = min(BLOCK_Q, sq)
    bk = min(BLOCK_K, sk)
    if sq % bq or sk % bk:
        raise ValueError(
            f"_blockwise_attn: {sq} query and {sk} key positions are not "
            f"whole blocks of {bq} and {bk}")
    nq, nk = sq // bq, sk // bk
    scale = 1.0 / math.sqrt(hd)

    qb = q.reshape(b, nq, bq, hkv, group, hd)
    kb = k.reshape(b, nk, bk, hkv, hd)
    vb = v.reshape(b, nk, bk, hkv, hd)
    qp = q_pos.reshape(b, nq, bq)
    kp = k_pos.reshape(b, nk, bk)

    outs = []
    for i in range(nq):
        qq, qpos = qb[:, i].float(), qp[:, i]
        acc = torch.zeros((b, hkv, group, bq, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, hkv, group, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        denom = torch.zeros((b, hkv, group, bq), dtype=torch.float32,
                            device=q.device)
        for j in range(nk):
            kkb, vvb, kpb = kb[:, j], vb[:, j], kp[:, j]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qq, kkb.float()) * scale
            s = L.softcap(s, softcap_val)
            diff = qpos[:, :, None] - kpb[:, None, :]
            ok = torch.ones_like(diff, dtype=torch.bool)
            if causal:
                ok &= diff >= 0
            if window:
                ok &= diff < window
            s = torch.where(ok[:, None, None, :, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            denom = denom * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vvb.dtype), vvb).float()
            m = m_new
        out = acc / torch.clamp(denom[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, bq, hq, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def _constrain_heads(t):
    """Batch over the data axes, heads over 'model' (replicate-fallback;
    a no-op off a mesh)."""
    return SH.constrain(t, SH.dp_axes_spec(), None, "model", None)


def attn_apply(params, cfg: AttnConfig, x, positions, *,
               causal: bool = True, window: int = 0,
               rope: bool = True):
    """Full-sequence attention (prefill): blockwise online-softmax
    beyond ``BLOCK_Q`` positions, direct softmax up to it."""
    q, k, v = _qkv(params, cfg, x, positions, rope=rope)
    q, k, v = _constrain_heads(q), _constrain_heads(k), _constrain_heads(v)
    if x.shape[1] <= BLOCK_Q:
        mask = _mask(positions, positions, causal=causal, window=window)
        out = _sdpa(q, k, v, mask, softcap_val=cfg.logit_softcap)
    else:
        out = _blockwise_attn(q, k, v, positions, positions, causal=causal,
                              window=window, softcap_val=cfg.logit_softcap)
    return L.out_proj(out, params["wo"])


def cross_attn_apply(params, cfg: AttnConfig, x, ctx):
    """Encoder-decoder cross attention (whisper): queries from x (B, Sq,
    d), keys and values from ctx (B, Sk, d). No RoPE, no mask: the direct
    softmax up to ``BLOCK_Q`` queries and ``4 * BLOCK_K`` keys, else the
    blockwise form with every key at position 0."""
    q = _constrain_heads(L.heads_proj(x, params["wq"]))
    k = _constrain_heads(L.heads_proj(ctx, params["wk"]))
    v = _constrain_heads(L.heads_proj(ctx, params["wv"]))
    b, sq, sk = x.shape[0], x.shape[1], ctx.shape[1]
    if sq <= BLOCK_Q and sk <= 4 * BLOCK_K:
        zeros = torch.zeros((b, sq, sk), dtype=x.dtype, device=x.device)
        out = _sdpa(q, k, v, zeros, softcap_val=cfg.logit_softcap)
    else:
        qp = torch.arange(sq, dtype=torch.int32, device=x.device).expand(b, sq)
        kp = torch.zeros((b, sk), dtype=torch.int32, device=x.device)
        out = _blockwise_attn(q, k, v, qp, kp, causal=False, window=0,
                              softcap_val=cfg.logit_softcap)
    return L.out_proj(out, params["wo"])


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_cache, Hkv, hd)
    v: torch.Tensor       # (B, S_cache, Hkv, hd)


def cache_init(batch: int, s_cache: int, cfg: AttnConfig, hd: int, dtype,
               device=None):
    shape = (batch, s_cache, cfg.num_kv_heads, hd)
    dt = L.torch_dtype(dtype)
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


def _write_slot(cache_t, slot: int, new) -> None:
    """``cache_t[:, slot] = new[:, 0]`` in place. On a mesh the cache is a
    DTensor whose sequence dim may be sharded: ``new`` is brought to the
    cache's placements with the sequence replicated, and the rank whose
    shard holds ``slot`` writes it there (a slice of a sharded dim would
    write into a gathered copy)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(cache_t, DTensor):
        cache_t[:, slot:slot + 1].copy_(new)
        return
    mesh, places = cache_t.device_mesh, cache_t.placements
    local = cache_t.to_local()
    start, size = 0, cache_t.shape[1]
    for dim, p in enumerate(places):
        if p == Shard(1):
            n = mesh.size(dim)
            size //= n
            start += mesh.get_local_rank(dim) * size
    row = new.redistribute(
        mesh, [Replicate() if p == Shard(1) else p for p in places])
    if start <= slot < start + size:
        local[:, slot - start:slot - start + 1].copy_(row.to_local())


def attn_decode(params, cfg: AttnConfig, x, cache: KVCache, pos: int, *,
                window: int = 0, rope: bool = True):
    """One-token decode. ``pos`` is the new token's position, a host
    ``int`` (the serving loop's counter).

    For windowed layers the cache is a rolling buffer of size W written
    at ``pos % W``; for global layers it is the full context written at
    ``pos``. Key positions are reconstructed from ``pos``, so RoPE and
    masking stay exact in both layouts. The new key and value are
    written into ``cache`` in place, and the same ``KVCache`` is
    returned (the reference returns a new one).

    Raises ``ValueError`` for a ``pos`` past a global cache, where the
    reference's ``dynamic_update_slice`` would clamp the write to the
    last slot and overwrite it silently.
    """
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(params, cfg, x, positions, rope=rope)

    s_cache = cache.k.shape[1]
    if not window and not 0 <= pos < s_cache:
        raise ValueError(
            f"attn_decode: position {pos} is past the global cache of "
            f"{s_cache} slots (positions 0..{s_cache - 1})")
    slot = pos % s_cache if window else pos
    # detached: a graph behind k_new (trained parameters, grad on) must
    # not ride into the cache
    _write_slot(cache.k, slot, k_new.detach())
    _write_slot(cache.v, slot, v_new.detach())

    idx = torch.arange(s_cache, device=x.device)
    if window:
        # rolling buffer: entry i holds absolute position
        #   p = pos - ((pos - i) mod S_cache)
        k_pos = pos - torch.remainder(pos - idx, s_cache)
        # k_pos >= 0 excludes not-yet-written slots early in the stream
        valid = (k_pos >= 0) & (k_pos <= pos) & (k_pos > pos - window)
    else:
        valid = idx <= pos
    mask = _additive(valid)[None, None, :].expand(b, 1, s_cache)
    out = _sdpa(q, cache.k, cache.v, mask, softcap_val=cfg.logit_softcap)
    out = L.out_proj(out, params["wo"])
    return out, cache
