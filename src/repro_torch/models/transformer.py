"""Backbone stacks of the LM zoo, for the PyTorch port: the counterpart
of ``repro/models/transformer.py`` for serving: the decoder-only stack
(dense, MoE and VLM backbones: ``block_*``, ``_group_layout``,
``lm_*``), the Mamba2 stack (``mamba_*``), the Zamba2 hybrid
(``zamba_*``) and Whisper (``whisper_*``).

The reference scans over stacked layer groups (``params["groups"][slot]``
with a leading group axis); the port holds one module per layer in an
``nn.ModuleList``, in layer order. In :class:`DecoderLM` layer
``g * gsize + slot`` is slot ``slot`` of group ``g``: for gemma2 layer 0
is local (window ``sliding_window``), layer 1 global, and so on; for
llama4-maverick layer 0 is dense, layer 1 MoE. :class:`MambaLM` holds
``blocks``; :class:`ZambaLM` ``groups`` (G lists of ``ZAMBA_GROUP``
mamba blocks), ``tail`` and the one ``shared`` attention block that
every group reuses; :class:`WhisperLM` ``encoder`` and ``decoder``.
Parameter names and shapes are the reference's leaves (``attn.wq`` is
(d, H, hd), ``wo`` (d, H, hd) applied transposed, the norms' ``scale``
float32 in every model), so ``convert.lm_params_from_numpy`` is a copy.
The decode caches are one cache per layer, in layer order: a
``KVCache`` per attention layer (a local layer's holds ``min(window,
s_cache)`` slots), an ``ssm.SSMCache`` per mamba layer; zamba2 keeps a
``KVCache`` per group (the shared block's weights, each site's keys).

Remat (the reference's ``_maybe_remat``): with ``cfg.remat`` other
than ``"none"`` and grad enabled, each block, mamba block, zamba group
and whisper encoder or decoder layer runs under
``torch.utils.checkpoint`` (non-reentrant), so its activations are
recomputed in the backward; ``"block"`` and ``"full"`` are the same, as
in the reference.

On a mesh (``runtime/sharding.use_mesh``) the residual stream is
constrained at the reference's sites, sequence-parallel (:func:`_sp`:
batch over the data axes, sequence over ``'model'``, by
``sharding.activation_constraint``) after each layer
group of the decoder-only stack, each mamba block and each zamba group,
and the full-sequence logits vocab-parallel (:func:`_logit_sp`); off a
mesh both are no-ops.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import frontends as F
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.runtime import sharding as SH


def _sp(x):
    """Sequence-parallel residual-stream constraint: a stream of more
    than one position placed by ``sharding.activation_constraint``
    (no-op off a mesh)."""
    mesh = SH.current_mesh()
    if mesh is None or x.ndim != 3 or x.shape[1] == 1:
        return x
    return SH.activation_constraint(x, mesh)


def _logit_sp(x):
    """Logits shard over the vocab dim ('model'), matching the
    vocab-sharded embedding table (no-op off a mesh)."""
    if x.ndim != 3:
        return x
    return SH.constrain(x, SH.dp_axes_spec(), None, "model")


def remat(cfg: ModelConfig, fn, *args, **kw):
    """``fn(*args, **kw)``, under ``torch.utils.checkpoint`` when
    ``cfg.remat`` asks for it and grad is enabled (the reference's
    ``_maybe_remat``). The forward draws nothing, so no RNG state is
    kept; outputs may be any structure of tensors (a block's ``MoEAux``
    or None), which the non-reentrant form allows."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args, **kw)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


# ---------------------------------------------------------------------------
# Transformer block (attn + FFN), covers dense / gemma2 / llama4 variants
# ---------------------------------------------------------------------------

def block_init(generator, cfg: ModelConfig, *, moe_layer: bool = False,
               dtype, device=None):
    p = {
        "ln_attn": L.rmsnorm_init(cfg.d_model, device=device),
        "ln_mlp": L.rmsnorm_init(cfg.d_model, device=device),
        "attn": A.attn_init(generator, cfg.attn, cfg.d_model, dtype,
                            cfg.head_dim, device=device),
    }
    if moe_layer:
        p["moe"] = M.moe_init(generator, cfg.moe, cfg.d_model, cfg.d_ff,
                              cfg.act, dtype, device=device)
    else:
        p["mlp"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act,
                              dtype, device=device)
    if cfg.post_norms:
        p["ln_attn_post"] = L.rmsnorm_init(cfg.d_model, device=device)
        p["ln_mlp_post"] = L.rmsnorm_init(cfg.d_model, device=device)
    return p


def _ffn(p, cfg: ModelConfig, x, moe_layer: bool):
    """(the FFN's output, the MoE aux pair or None for a dense layer)."""
    if moe_layer:
        return M.moe_apply(p["moe"], cfg.moe, x, cfg.act)
    return L.mlp_apply(p["mlp"], x, cfg.act), None


def block_apply(p, cfg: ModelConfig, x, positions, *, window: int,
                moe_layer: bool = False, causal: bool = True):
    """Returns (x, aux): aux is the layer's ``moe.MoEAux``, None for a
    dense layer (the reference's zeros)."""
    h = A.attn_apply(p["attn"], cfg.attn, L.rmsnorm(p["ln_attn"], x),
                     positions, causal=causal, window=window)
    if cfg.post_norms:
        h = L.rmsnorm(p["ln_attn_post"], h)
    x = x + h
    h, aux = _ffn(p, cfg, L.rmsnorm(p["ln_mlp"], x), moe_layer)
    if cfg.post_norms:
        h = L.rmsnorm(p["ln_mlp_post"], h)
    return x + h, aux


def block_decode(p, cfg: ModelConfig, x, cache: A.KVCache, pos: int, *,
                 window: int, moe_layer: bool = False):
    h, cache = A.attn_decode(p["attn"], cfg.attn,
                             L.rmsnorm(p["ln_attn"], x), cache, pos,
                             window=window)
    if cfg.post_norms:
        h = L.rmsnorm(p["ln_attn_post"], h)
    x = x + h
    h, _ = _ffn(p, cfg, L.rmsnorm(p["ln_mlp"], x), moe_layer)
    if cfg.post_norms:
        h = L.rmsnorm(p["ln_mlp_post"], h)
    return x + h, cache


class Block(L.Params):
    """One layer (attention + FFN) with its window (0 for a global
    layer); ``moe_layer`` holds ``moe`` (``moe.moe_init``) in place of
    ``mlp``."""

    def __init__(self, cfg: ModelConfig, window: int = 0,
                 moe_layer: bool = False, *, generator=None, device=None):
        super().__init__(block_init(generator, cfg, moe_layer=moe_layer,
                                    dtype=L.torch_dtype(cfg.dtype),
                                    device=device))
        self.cfg, self.window, self.moe_layer = cfg, window, moe_layer

    def forward(self, x, positions, causal: bool = True):
        return block_apply(self, self.cfg, x, positions, window=self.window,
                           moe_layer=self.moe_layer, causal=causal)

    def decode(self, x, cache: A.KVCache, pos: int):
        return block_decode(self, self.cfg, x, cache, pos,
                            window=self.window, moe_layer=self.moe_layer)


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _no_aux(device):
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return zero, zero


# ---------------------------------------------------------------------------
# Decoder-only stack
# ---------------------------------------------------------------------------

def _group_layout(cfg: ModelConfig):
    """(group_size, n_groups, per-slot (window, moe_layer)) of the
    reference's scan; the port's layer l is slot l % group_size."""
    if cfg.attn.local_global_pattern:           # gemma2: (local, global)
        slots = [(cfg.attn.sliding_window, False), (0, False)]
    elif cfg.moe and cfg.moe.num_experts and cfg.moe.every == 2:
        slots = [(0, False), (0, True)]         # llama4-maverick
    elif cfg.moe and cfg.moe.num_experts:
        slots = [(0, True)]                     # llama4-scout
    else:
        slots = [(0, False)]                    # homogeneous dense
    gsize = len(slots)
    if cfg.num_layers % gsize:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                         f"whole groups of {gsize}")
    return gsize, cfg.num_layers // gsize, slots


def embed_scale(cfg: ModelConfig, dtype) -> float:
    """Gemma scales the embedding by ``sqrt(d_model)`` rounded to the
    model's dtype first (59.75 in bfloat16 for d = 3584), as the
    reference's ``jnp.asarray(d_model ** 0.5, x.dtype)``; 1 otherwise.
    The test is on the config's name, as the reference's."""
    if not cfg.name.startswith("gemma"):
        return 1.0
    return float(torch.tensor(cfg.d_model ** 0.5, dtype=dtype))


def lm_cache_init(cfg: ModelConfig, batch: int, s_cache: int,
                  device=None) -> list[A.KVCache]:
    """One zeroed ``KVCache`` per layer, in layer order: ``s_cache``
    slots for a global layer, ``min(window, s_cache)`` for a local one."""
    gsize, _, slots = _group_layout(cfg)
    caches = []
    for layer in range(cfg.num_layers):
        window = slots[layer % gsize][0]
        size = min(window, s_cache) if window else s_cache
        caches.append(A.cache_init(batch, size, cfg.attn, cfg.head_dim,
                                   cfg.dtype, device=device))
    return caches


class DecoderLM(nn.Module):
    """The decoder-only LM (dense, MoE, VLM): ``embed``, ``layers``
    (``cfg.num_layers`` :class:`Block`\\ s in layer order) and
    ``final_norm``; a VLM also carries ``adapter``
    (``models/model.py``)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        dtype = L.torch_dtype(cfg.dtype)
        gsize, _, slots = _group_layout(cfg)
        self.cfg = cfg
        self.embed = L.Params(L.embed_init(generator, cfg.vocab_size,
                                           cfg.d_model, dtype, device=device))
        self.layers = nn.ModuleList(
            Block(cfg, *slots[layer % gsize], generator=generator,
                  device=device)
            for layer in range(cfg.num_layers))
        self.final_norm = L.Params(L.rmsnorm_init(cfg.d_model,
                                                  device=device))

    def _embed(self, tokens):
        x = L.embed_lookup(self.embed, tokens)
        scale = embed_scale(self.cfg, x.dtype)
        return x * scale if scale != 1.0 else x

    def head(self, x):
        """The tied read-out, soft-capped: (B, S, d) -> (B, S, V)."""
        logits = L.embed_logits(self.embed, x)
        return L.softcap(logits, self.cfg.final_logit_softcap)

    def forward(self, tokens, *, prefix_embeds: Optional[torch.Tensor] = None,
                with_logits: bool = True):
        """Train/prefill forward. Returns (logits, aux, final_hidden);
        ``aux`` is the MoE loss pair (load balance, router z) summed over
        the MoE layers, zeros for a dense model."""
        x = self._embed(tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        b, s, _ = x.shape
        positions = _positions(b, s, x.device)
        aux = _no_aux(x.device)
        gsize = _group_layout(self.cfg)[0]
        for i, block in enumerate(self.layers):
            x, layer_aux = remat(self.cfg, block, x, positions)
            if layer_aux is not None:
                aux = (aux[0] + layer_aux.load_balance,
                       aux[1] + layer_aux.router_z)
            if (i + 1) % gsize == 0:
                x = _sp(x)
        x = L.rmsnorm(self.final_norm, x)
        if not with_logits:
            return None, aux, x
        return _logit_sp(self.head(x)), aux, x

    def decode_step(self, caches: list[A.KVCache], token, pos: int):
        """token: (B, 1) integer; pos: host int. Returns (logits, caches),
        the caches written in place."""
        x = self._embed(token)
        new = []
        for block, cache in zip(self.layers, caches):
            x, cache = block.decode(x, cache, pos)
            new.append(cache)
        x = L.rmsnorm(self.final_norm, x)
        return self.head(x), new


# ---------------------------------------------------------------------------
# Mamba2 stack (ssm family)
# ---------------------------------------------------------------------------

class MambaBlock(L.Params):
    """One mamba layer: ``ln`` and the SSD ``mixer`` (``ssm.ssd_init``),
    residual around both."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__({
            "ln": L.rmsnorm_init(cfg.d_model, device=device),
            "mixer": S.ssd_init(generator, cfg.ssm, cfg.d_model,
                                L.torch_dtype(cfg.dtype), device=device)})
        self.cfg = cfg

    def forward(self, x):
        return x + S.ssd_apply(self.mixer, self.cfg.ssm, self.cfg.d_model,
                               L.rmsnorm(self.ln, x))

    def decode(self, x, cache: S.SSMCache):
        h, cache = S.ssd_decode(self.mixer, self.cfg.ssm, self.cfg.d_model,
                                L.rmsnorm(self.ln, x), cache)
        return x + h, cache


def ssm_caches(cfg: ModelConfig, batch: int, n: int, device=None):
    """``n`` zeroed ``SSMCache``\\ s, one per mamba layer."""
    return [S.ssm_cache_init(batch, cfg.ssm, cfg.d_model, cfg.dtype,
                             device=device) for _ in range(n)]


class _Stack(nn.Module):
    """What the recurrent and encoder-decoder stacks share: ``embed``,
    ``final_norm``, and the tied read-out without a soft-cap (none of
    their configs has one; the reference applies none)."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.cfg = cfg
        self.embed = L.Params(L.embed_init(generator, cfg.vocab_size,
                                           cfg.d_model,
                                           L.torch_dtype(cfg.dtype),
                                           device=device))

    def head(self, x):
        """The tied read-out: (B, S, d) -> (B, S, V)."""
        return L.embed_logits(self.embed, x)

    def _out(self, x, with_logits: bool):
        x = L.rmsnorm(self.final_norm, x)
        aux = _no_aux(x.device)
        return (_logit_sp(self.head(x)) if with_logits else None), aux, x


class MambaLM(_Stack):
    """The Mamba2 LM: ``embed``, ``blocks`` (``cfg.num_layers``
    :class:`MambaBlock`\\ s) and ``final_norm``. The caches are one
    ``SSMCache`` per layer (:func:`mamba_cache_init`)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__(cfg, generator, device)
        self.blocks = nn.ModuleList(
            MambaBlock(cfg, generator=generator, device=device)
            for _ in range(cfg.num_layers))
        self.final_norm = L.Params(L.rmsnorm_init(cfg.d_model,
                                                  device=device))

    def forward(self, tokens, *, with_logits: bool = True):
        """Returns (logits, aux zeros, final_hidden); the length must be
        a multiple of ``cfg.ssm.chunk``."""
        x = L.embed_lookup(self.embed, tokens)
        for block in self.blocks:
            x = _sp(remat(self.cfg, block, x))
        return self._out(x, with_logits)

    def decode_step(self, caches: list[S.SSMCache], token, pos: int):
        """token: (B, 1); ``pos`` is unused (the state is the context).
        Returns (logits, the new caches)."""
        x = L.embed_lookup(self.embed, token)
        new = []
        for block, cache in zip(self.blocks, caches):
            x, cache = block.decode(x, cache)
            new.append(cache)
        return self.head(L.rmsnorm(self.final_norm, x)), new


def mamba_cache_init(cfg: ModelConfig, batch: int, device=None):
    return ssm_caches(cfg, batch, cfg.num_layers, device)


# ---------------------------------------------------------------------------
# Zamba2 hybrid: mamba backbone + ONE shared attention block every 6
# ---------------------------------------------------------------------------

ZAMBA_GROUP = 6


def zamba_layout(cfg: ModelConfig):
    """(groups of ZAMBA_GROUP mamba layers, mamba layers in the tail)."""
    ngroups = cfg.num_layers // ZAMBA_GROUP
    return ngroups, cfg.num_layers - ngroups * ZAMBA_GROUP


class ZambaLM(_Stack):
    """The Zamba2 hybrid: ``embed``, ``groups`` (G lists of
    ``ZAMBA_GROUP`` :class:`MambaBlock`\\ s, each group followed by the
    shared block), ``tail`` (the remaining mamba layers), ``shared`` (one
    global attention :class:`Block`, its weights reused at every site)
    and ``final_norm``. The caches (:func:`zamba_cache_init`):
    ``{"groups_ssm": G lists of 6 SSMCache, "groups_kv": a KVCache per
    group, "tail_ssm": a list of SSMCache}``."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__(cfg, generator, device)
        ngroups, tail = zamba_layout(cfg)

        def mambas(n):
            return nn.ModuleList(MambaBlock(cfg, generator=generator,
                                            device=device) for _ in range(n))
        self.groups = nn.ModuleList(mambas(ZAMBA_GROUP)
                                    for _ in range(ngroups))
        self.tail = mambas(tail)
        self.shared = Block(cfg, generator=generator, device=device)
        self.final_norm = L.Params(L.rmsnorm_init(cfg.d_model,
                                                  device=device))

    def forward(self, tokens, *, with_logits: bool = True):
        x = L.embed_lookup(self.embed, tokens)
        positions = _positions(*tokens.shape, x.device)
        for group in self.groups:
            x = remat(self.cfg, self._group, group, x, positions)
        for block in self.tail:
            x = block(x)
        return self._out(x, with_logits)

    def _group(self, group, x, positions):
        """One remat unit: the group's mamba blocks, then the shared
        block (the reference's ``group_body``; its tail is not remat'd)."""
        for block in group:
            x = block(x)
        return _sp(self.shared(x, positions)[0])

    def decode_step(self, caches: dict, token, pos: int):
        x = L.embed_lookup(self.embed, token)
        new_ssm, new_kv = [], []
        for group, gssm, kv in zip(self.groups, caches["groups_ssm"],
                                   caches["groups_kv"]):
            row = []
            for block, cache in zip(group, gssm):
                x, cache = block.decode(x, cache)
                row.append(cache)
            x, kv = self.shared.decode(x, kv, pos)
            new_ssm.append(row)
            new_kv.append(kv)
        new_tail = []
        for block, cache in zip(self.tail, caches["tail_ssm"]):
            x, cache = block.decode(x, cache)
            new_tail.append(cache)
        logits = self.head(L.rmsnorm(self.final_norm, x))
        return logits, {"groups_ssm": new_ssm, "groups_kv": new_kv,
                        "tail_ssm": new_tail}


def zamba_cache_init(cfg: ModelConfig, batch: int, s_cache: int,
                     device=None):
    ngroups, tail = zamba_layout(cfg)
    return {
        "groups_ssm": [ssm_caches(cfg, batch, ZAMBA_GROUP, device)
                       for _ in range(ngroups)],
        "groups_kv": [A.cache_init(batch, s_cache, cfg.attn, cfg.head_dim,
                                   cfg.dtype, device=device)
                      for _ in range(ngroups)],
        "tail_ssm": ssm_caches(cfg, batch, tail, device),
    }


# ---------------------------------------------------------------------------
# Whisper (enc-dec)
# ---------------------------------------------------------------------------

class WhisperLM(_Stack):
    """Whisper: ``embed``, ``adapter`` (the audio-frame stub,
    ``frontends.adapter_init``), ``encoder`` (``cfg.num_layers``
    non-causal :class:`Block`\\ s, RoPE as the reference has it),
    ``decoder`` (``cfg.num_decoder_layers`` layers: a block's leaves plus
    ``ln_cross`` and ``cross``), ``enc_norm`` and ``final_norm``. The
    caches: ``{"self": a KVCache per decoder layer, "cross": a KVCache
    per decoder layer over the encoder's frames}``."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__(cfg, generator, device)
        dtype = L.torch_dtype(cfg.dtype)
        self.adapter = L.Params(F.adapter_init(generator, cfg.d_model,
                                               cfg.d_model, dtype,
                                               device=device))
        self.encoder = nn.ModuleList(
            Block(cfg, generator=generator, device=device)
            for _ in range(cfg.num_layers))

        def dec_one():
            p = block_init(generator, cfg, dtype=dtype, device=device)
            p["ln_cross"] = L.rmsnorm_init(cfg.d_model, device=device)
            p["cross"] = A.attn_init(generator, cfg.attn, cfg.d_model, dtype,
                                     cfg.head_dim, device=device)
            return L.Params(p)
        self.decoder = nn.ModuleList(dec_one()
                                     for _ in range(cfg.num_decoder_layers))
        self.enc_norm = L.Params(L.rmsnorm_init(cfg.d_model, device=device))
        self.final_norm = L.Params(L.rmsnorm_init(cfg.d_model,
                                                  device=device))

    def encode(self, frames):
        """frames (B, T, d) -> the encoder's output (B, T, d)."""
        x = F.audio_frames_apply(self.adapter, frames)
        positions = _positions(x.shape[0], x.shape[1], x.device)
        for block in self.encoder:
            x, _ = remat(self.cfg, block, x, positions, causal=False)
        return L.rmsnorm(self.enc_norm, x)

    def forward(self, frames, tokens, *, with_logits: bool = True):
        cfg = self.cfg
        ctx = self.encode(frames)
        x = L.embed_lookup(self.embed, tokens)
        positions = _positions(*tokens.shape, x.device)
        for p in self.decoder:
            x = remat(cfg, _whisper_decoder_layer, p, cfg, x, positions, ctx)
        return self._out(x, with_logits)

    def prime_cross(self, ctx) -> list[A.KVCache]:
        """Each decoder layer's cross K/V over the encoder's output."""
        return [A.KVCache(L.heads_proj(ctx, p["cross"]["wk"]),
                          L.heads_proj(ctx, p["cross"]["wv"]))
                for p in self.decoder]

    def primed_caches(self, frames, s_cache: int) -> dict:
        """The decode caches for ``frames`` (B, T, d): zeroed self caches
        of ``s_cache`` slots and the cross caches primed from the
        encoder (the reference's ``whisper_cache_init`` then
        ``whisper_prime_cross``)."""
        return {"self": whisper_self_caches(self.cfg, frames.shape[0],
                                            s_cache, frames.device),
                "cross": self.prime_cross(self.encode(frames))}

    def decode_step(self, caches: dict, token, pos: int):
        cfg = self.cfg
        x = L.embed_lookup(self.embed, token)
        b = token.shape[0]
        new_self = []
        for p, self_c, cross_c in zip(self.decoder, caches["self"],
                                      caches["cross"]):
            h, self_c = A.attn_decode(p["attn"], cfg.attn,
                                      L.rmsnorm(p["ln_attn"], x), self_c, pos)
            x = x + h
            # cross attention against the primed encoder K/V
            q = L.heads_proj(L.rmsnorm(p["ln_cross"], x), p["cross"]["wq"])
            zeros = torch.zeros((b, 1, cross_c.k.shape[1]), dtype=x.dtype,
                                device=x.device)
            o = A._sdpa(q, cross_c.k, cross_c.v, zeros,
                        softcap_val=cfg.attn.logit_softcap)
            x = x + L.out_proj(o, p["cross"]["wo"])
            x = x + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln_mlp"], x), cfg.act)
            new_self.append(self_c)
        logits = self.head(L.rmsnorm(self.final_norm, x))
        return logits, {"self": new_self, "cross": caches["cross"]}


def _whisper_decoder_layer(p, cfg: ModelConfig, x, positions, ctx):
    x = x + A.attn_apply(p["attn"], cfg.attn, L.rmsnorm(p["ln_attn"], x),
                         positions, causal=True)
    x = x + A.cross_attn_apply(p["cross"], cfg.attn,
                               L.rmsnorm(p["ln_cross"], x), ctx)
    return x + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln_mlp"], x), cfg.act)


def whisper_self_caches(cfg: ModelConfig, batch: int, s_cache: int,
                        device=None) -> list[A.KVCache]:
    return [A.cache_init(batch, s_cache, cfg.attn, cfg.head_dim, cfg.dtype,
                         device=device)
            for _ in range(cfg.num_decoder_layers)]


def whisper_cache_init(cfg: ModelConfig, batch: int, s_cache: int,
                       enc_len: int, device=None):
    """Zeroed self caches of ``s_cache`` slots and cross caches of
    ``enc_len``."""
    return {"self": whisper_self_caches(cfg, batch, s_cache, device),
            "cross": [A.cache_init(batch, enc_len, cfg.attn, cfg.head_dim,
                                   cfg.dtype, device=device)
                      for _ in range(cfg.num_decoder_layers)]}
