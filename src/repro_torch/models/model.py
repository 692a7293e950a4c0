"""Unified model API over the LM zoo, for the PyTorch port: the
counterpart of ``repro/models/model.py`` for serving, every family:
``dense`` and ``moe`` (qwen3, granite, gemma2, llama4), ``vlm``
(internvl2), ``ssm`` (mamba2), ``hybrid`` (zamba2) and ``audio``
(whisper).

``build_model(cfg, device=...)`` returns a :class:`Model` with:

* ``init(generator=None) -> params`` (the family's stack of
  ``transformer.py``: ``DecoderLM``, with the patch ``adapter`` for a
  VLM, ``MambaLM``, ``ZambaLM`` or ``WhisperLM``)
* ``forward(params, batch) -> (logits, aux, hidden)`` (``batch`` holds
  ``tokens``, and ``patches`` for a VLM, ``frames`` for whisper)
* ``train_loss(params, batch) -> (loss, metrics)`` (``batch`` also
  holds ``labels``): :func:`chunked_xent_head` over the last
  ``labels.shape[1]`` positions, plus the MoE aux losses
* ``prefill_logits(params, batch)`` (last-position logits, soft-capped)
* ``cache_init(batch, s_cache) -> caches`` (whisper's cross caches at
  ``WHISPER_ENC_FRAMES`` zeroed slots, as the reference's)
* ``decode(params, caches, token, pos) -> (logits, caches)``

and the two loops that serving and its checks run over ``decode``:
:func:`decode_all` (every position teacher-forced) and :func:`greedy`
(the loop of ``examples/serve_decode.py``; whisper's primed caches,
``WhisperLM.primed_caches``, go through it too).

The params are the functions' first argument, as the reference's
pytrees are. Serving (``prefill_logits``, the loops) runs under
``torch.no_grad()``, so trained parameters (``requires_grad`` on,
``launch/train.py``) build no graph there.

For the dry run (``launch/dryrun.py``), ``input_specs(shape)`` and
``cache_specs(shape)`` give meta-device tensors of the reference's
shapes and dtypes (its ``ShapeDtypeStruct`` objects; the caches in its
stacked layout). On a mesh the chunked head's logits are constrained
vocab-parallel, as the reference's.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.network import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import frontends as F
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.runtime import sharding as SH

WHISPER_ENC_FRAMES = 3000      # whisper-medium 30 s window (stub frontend)
VLM_PATCHES = 256              # internvl2 tile -> 256 patch embeddings


def cross_entropy(logits, labels, mask=None):
    """logsumexp-form token cross-entropy (mean over tokens, or over the
    ``mask``ed ones), reductions in float32."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ll = picked.float() - lse
    if mask is None:
        return -ll.mean()
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1)


def _chunk_len(s: int, target: int = 512) -> int:
    for c in (target, 256, 128, 64, 32):
        if s % c == 0:
            return c
    return s


def _chunk_nll(table, xc, lc, softcap_val: float):
    """Summed token NLL of one (B, c) chunk under the tied head."""
    logits = torch.einsum("bsd,vd->bsv", xc, table)
    logits = L.softcap(SH.constrain(logits, SH.dp_axes_spec(), None, "model"),
                       softcap_val)
    lse = SH.logsumexp(logits.float(), dim=-1)
    picked = SH.settle(torch.gather(logits, -1, lc[..., None].long()))[..., 0]
    return (lse - picked.float()).sum()


def chunked_xent_head(table, hidden, labels, *, softcap_val: float,
                      chunk: int = 512):
    """Cross-entropy over the vocab head without the (B, S, V) logits: a
    loop over sequence chunks of :func:`_chunk_len`, each under
    ``torch.utils.checkpoint``, so one (B, c, V) chunk of logits is live
    at a time, in the forward and in the backward (which recomputes the
    chunk's logits); the table's gradient accumulates over the chunks.
    The per-chunk sums are stacked and summed, as the reference's
    ``lax.map`` then ``sum``, and divided by B * S."""
    b, s, _ = hidden.shape
    c = _chunk_len(s, chunk)
    nll = [torch.utils.checkpoint.checkpoint(
        _chunk_nll, table, hidden[:, i:i + c], labels[:, i:i + c],
        softcap_val, use_reentrant=False, preserve_rng_state=False)
        for i in range(0, s, c)]
    return torch.stack(nll).sum() / (b * s)


STACKS = {"dense": T.DecoderLM, "moe": T.DecoderLM, "vlm": T.DecoderLM,
          "ssm": T.MambaLM, "hybrid": T.ZambaLM, "audio": T.WhisperLM}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    def init(self, generator: torch.Generator | None = None) -> nn.Module:
        """Parameters drawn on the model's device from ``generator``,
        else from a generator seeded with 0 (none on the ``meta`` device,
        which makes an empty skeleton)."""
        cfg, dev = self.cfg, self.device
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        params = STACKS[cfg.family](cfg, generator=generator, device=dev)
        if cfg.family == "vlm":
            params.adapter = L.Params(F.adapter_init(
                generator, cfg.d_model, cfg.d_model, L.torch_dtype(cfg.dtype),
                device=dev))
        return params

    def forward(self, params: nn.Module, batch: dict, with_logits=True):
        fam = self.cfg.family
        if fam == "audio":
            return params(batch["frames"], batch["tokens"],
                          with_logits=with_logits)
        if fam == "vlm":
            prefix = F.vision_patches_apply(params.adapter, batch["patches"])
            return params(batch["tokens"], prefix_embeds=prefix,
                          with_logits=with_logits)
        return params(batch["tokens"], with_logits=with_logits)

    def train_loss(self, params: nn.Module, batch: dict):
        """Chunked-vocab-head loss (:func:`chunked_xent_head`) over the
        last ``labels.shape[1]`` positions (a VLM's patch prefix and
        nothing else is dropped), plus ``aux_loss_coef * load_balance +
        router_z_coef * router_z`` for an MoE config. Returns (loss,
        {"xent", "load_balance", "router_z"}); ``xent`` is the loss, as
        the reference reports it."""
        cfg = self.cfg
        _, (lb, rz), hidden = self.forward(params, batch, with_logits=False)
        labels = batch["labels"]
        hidden = SH.rows(hidden)[:, -labels.shape[1]:]
        loss = chunked_xent_head(params.embed["table"], hidden, labels,
                                 softcap_val=cfg.final_logit_softcap)
        if cfg.moe is not None and cfg.moe.num_experts:
            loss = loss + (cfg.moe.aux_loss_coef * lb
                           + cfg.moe.router_z_coef * rz)
        return loss, {"xent": loss, "load_balance": lb, "router_z": rz}

    @torch.no_grad()
    def prefill_logits(self, params: nn.Module, batch: dict):
        """Last-position logits only (what serving needs): skips the
        full (B, S, V) head."""
        _, _, hidden = self.forward(params, batch, with_logits=False)
        return params.head(SH.rows(hidden)[:, -1:])

    def cache_init(self, batch: int, s_cache: int):
        cfg, dev, fam = self.cfg, self.device, self.cfg.family
        if fam == "ssm":
            return T.mamba_cache_init(cfg, batch, device=dev)
        if fam == "hybrid":
            return T.zamba_cache_init(cfg, batch, s_cache, device=dev)
        if fam == "audio":
            return T.whisper_cache_init(cfg, batch, s_cache,
                                        WHISPER_ENC_FRAMES, device=dev)
        return T.lm_cache_init(cfg, batch, s_cache, device=dev)

    def decode(self, params: nn.Module, caches, token, pos: int):
        return params.decode_step(caches, token, pos)

    def input_specs(self, shape: ShapeConfig) -> dict:
        """Meta tensors of every input of a ``shape`` cell, the
        reference's shapes and dtypes: train and prefill ``tokens`` and
        ``labels`` (B, S) int32 (whisper ``frames`` (B, S, d) and
        max(S // 4, 128) tokens; a VLM ``patches`` (B, VLM_PATCHES, d)
        and S - VLM_PATCHES tokens); decode ``token`` (B, 1) and a
        scalar ``pos``."""
        b, s = shape.global_batch, shape.seq_len
        meta = dict(device="meta")
        i32, f = torch.int32, L.torch_dtype(self.cfg.dtype)
        d, fam = self.cfg.d_model, self.cfg.family

        def ints(*sh):
            return torch.empty(sh, dtype=i32, **meta)
        if shape.kind in ("train", "prefill"):
            if fam == "audio":
                s_txt = max(s // 4, 128)
                return {"frames": torch.empty((b, s, d), dtype=f, **meta),
                        "tokens": ints(b, s_txt), "labels": ints(b, s_txt)}
            if fam == "vlm":
                s_txt = s - VLM_PATCHES
                return {"patches": torch.empty((b, VLM_PATCHES, d), dtype=f,
                                               **meta),
                        "tokens": ints(b, s_txt), "labels": ints(b, s_txt)}
            return {"tokens": ints(b, s), "labels": ints(b, s)}
        return {"token": ints(b, 1), "pos": ints()}

    def cache_specs(self, shape: ShapeConfig):
        """Meta tensors of the decode caches of a ``shape`` cell in the
        reference's stacked layout: dense, moe and vlm a list of one
        ``KVCache`` per group slot, each (n_groups, B, S, Hkv, hd) (a
        local slot min(window, S)); ssm one ``SSMCache`` (L, B, ...);
        hybrid ``{"groups_ssm": (G, 6, B, ...), "groups_kv": (G, B, S,
        ...), "tail_ssm": (tail, B, ...) or None}``; audio ``{"self",
        "cross"}`` (L_dec, B, ...), the cross caches over
        ``WHISPER_ENC_FRAMES``."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def kv(lead, size):
            sh = lead + (b, size, cfg.attn.num_kv_heads, cfg.head_dim)
            return A.KVCache(*(torch.empty(sh, dtype=L.torch_dtype(cfg.dtype),
                                           device="meta") for _ in "kv"))

        def ssm(lead):
            one = S.ssm_cache_init(b, cfg.ssm, cfg.d_model, cfg.dtype,
                                   device="meta")
            return S.SSMCache(*(torch.empty(lead + tuple(x.shape),
                                            dtype=x.dtype, device="meta")
                                for x in one))
        fam = cfg.family
        if fam == "ssm":
            return ssm((cfg.num_layers,))
        if fam == "hybrid":
            ngroups, tail = T.zamba_layout(cfg)
            return {"groups_ssm": ssm((ngroups, T.ZAMBA_GROUP)),
                    "groups_kv": kv((ngroups,), s),
                    "tail_ssm": ssm((tail,)) if tail else None}
        if fam == "audio":
            nd = (cfg.num_decoder_layers,)
            return {"self": kv(nd, s), "cross": kv(nd, WHISPER_ENC_FRAMES)}
        _, ngroups, slots = T._group_layout(cfg)
        return [kv((ngroups,), min(w, s) if w else s) for w, _ in slots]


def build_model(cfg: ModelConfig, *, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (``cuda`` without a card
    raises, never falling back to the CPU)."""
    if cfg.family not in STACKS:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    return Model(cfg, resolve_device(device))


@torch.no_grad()
def decode_all(model: Model, params: nn.Module, toks, caches=None):
    """Every position of ``toks`` (B, S) teacher-forced through
    ``decode`` from ``caches`` (default an empty cache of S slots):
    (logits (B, S, V), the final caches)."""
    b, s = toks.shape
    if caches is None:
        caches = model.cache_init(b, s)
    steps = []
    for t in range(s):
        logits, caches = model.decode(params, caches, toks[:, t:t + 1], t)
        steps.append(logits)
    return torch.cat(steps, dim=1), caches


@torch.no_grad()
def greedy(model: Model, params: nn.Module, prompts, n_gen: int,
           on_step=None, caches=None):
    """The loop of ``examples/serve_decode.py``: ``prompts`` (B, P)
    teacher-forced through ``decode``, then ``n_gen`` greedy tokens, on
    ``caches`` (default ``model.cache_init(B, P + n_gen)``; whisper's
    primed caches, for example). Returns (tokens (B, n_gen) int32, the
    last step's logits). ``on_step()``, if given, is called once when
    the cache is ready and once after each step (a timer's marks: step
    i lies between calls i and i + 1)."""
    prompt = prompts.shape[1]
    if caches is None:
        caches = model.cache_init(prompts.shape[0], prompt + n_gen)
    tok, generated = prompts[:, :1], []
    if on_step is not None:
        on_step()
    for pos in range(prompt + n_gen - 1):
        logits, caches = model.decode(params, caches, tok, pos)
        nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        if on_step is not None:
            on_step()
        if pos + 1 < prompt:
            tok = prompts[:, pos + 1:pos + 2]          # teacher-forced
        else:
            tok = nxt
            generated.append(nxt)
    return torch.cat(generated, dim=1), logits
