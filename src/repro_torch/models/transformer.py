"""The decoder-only stack of the LM zoo (dense and VLM backbones), for
the PyTorch port: the counterpart of ``repro/models/transformer.py:61-225``
(``block_init``, ``block_apply``, ``block_decode``, ``_group_layout``,
``lm_init``, ``lm_forward``, ``lm_cache_init``, ``lm_decode_step``).

The reference scans over stacked layer groups (``params["groups"][slot]``
with a leading group axis); the port holds one :class:`Block` per layer
in an ``nn.ModuleList``, in layer order: layer ``g * gsize + slot`` is
slot ``slot`` of group ``g``. For gemma2, layer 0 is local (window
``sliding_window``), layer 1 global, and so on. Parameter names and
shapes are the reference's leaves (``attn.wq`` is (d, H, hd), ``wo``
(d, H, hd) applied transposed, the norms' ``scale`` float32 in every
model), so ``convert.lm_params_from_numpy`` is a copy. The decode cache
is one ``KVCache`` per layer, in layer order; a local layer's holds
``min(window, s_cache)`` slots.

Left out: the sequence- and vocab-parallel ``SH.constrain`` calls
(no-ops off a mesh; the port has no LM mesh yet, ROADMAP queue 1 item
8e), remat (training, item 8d), the MoE block (item 8b) and the Mamba2,
Zamba2 and Whisper stacks (item 8c).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# Transformer block (attn + FFN)
# ---------------------------------------------------------------------------

def block_init(generator, cfg: ModelConfig, *, dtype, device=None):
    p = {
        "ln_attn": L.rmsnorm_init(cfg.d_model, device=device),
        "ln_mlp": L.rmsnorm_init(cfg.d_model, device=device),
        "attn": A.attn_init(generator, cfg.attn, cfg.d_model, dtype,
                            cfg.head_dim, device=device),
        "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                          device=device),
    }
    if cfg.post_norms:
        p["ln_attn_post"] = L.rmsnorm_init(cfg.d_model, device=device)
        p["ln_mlp_post"] = L.rmsnorm_init(cfg.d_model, device=device)
    return p


def block_apply(p, cfg: ModelConfig, x, positions, *, window: int,
                causal: bool = True):
    h = A.attn_apply(p["attn"], cfg.attn, L.rmsnorm(p["ln_attn"], x),
                     positions, causal=causal, window=window)
    if cfg.post_norms:
        h = L.rmsnorm(p["ln_attn_post"], h)
    x = x + h
    h = L.mlp_apply(p["mlp"], L.rmsnorm(p["ln_mlp"], x), cfg.act)
    if cfg.post_norms:
        h = L.rmsnorm(p["ln_mlp_post"], h)
    return x + h


def block_decode(p, cfg: ModelConfig, x, cache: A.KVCache, pos: int, *,
                 window: int):
    h, cache = A.attn_decode(p["attn"], cfg.attn,
                             L.rmsnorm(p["ln_attn"], x), cache, pos,
                             window=window)
    if cfg.post_norms:
        h = L.rmsnorm(p["ln_attn_post"], h)
    x = x + h
    h = L.mlp_apply(p["mlp"], L.rmsnorm(p["ln_mlp"], x), cfg.act)
    if cfg.post_norms:
        h = L.rmsnorm(p["ln_mlp_post"], h)
    return x + h, cache


class Block(L.Params):
    """One layer (attention + FFN) with its window (0 for a global
    layer). ``moe_layer=True`` is refused: MoE serving is ROADMAP queue
    1 item 8b."""

    def __init__(self, cfg: ModelConfig, window: int = 0,
                 moe_layer: bool = False, *, generator=None, device=None):
        if moe_layer:
            raise ValueError(
                f"{cfg.name}: MoE layers are not ported yet (ROADMAP queue "
                "1 item 8b, MoE serving)")
        super().__init__(block_init(generator, cfg,
                                    dtype=L.torch_dtype(cfg.dtype),
                                    device=device))
        self.cfg, self.window = cfg, window

    def forward(self, x, positions, causal: bool = True):
        return block_apply(self, self.cfg, x, positions, window=self.window,
                           causal=causal)

    def decode(self, x, cache: A.KVCache, pos: int):
        return block_decode(self, self.cfg, x, cache, pos,
                            window=self.window)


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
    """The decoder-only LM: ``embed``, ``layers`` (``cfg.num_layers``
    :class:`Block`\\ s in layer order) and ``final_norm``; a VLM also
    carries ``adapter`` (``models/model.py``)."""

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
        ``aux`` is the MoE loss pair, zeros for dense layers."""
        x = self._embed(tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        for block in self.layers:
            x = block(x, positions)
        x = L.rmsnorm(self.final_norm, x)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = (zero, zero)
        if not with_logits:
            return None, aux, x
        return self.head(x), aux, x

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
