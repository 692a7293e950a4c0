"""Modality frontend stubs of the LM zoo, for the PyTorch port: the
counterpart of ``repro/models/frontends.py``.

``[audio]`` / ``[vlm]`` architectures specify the transformer backbone
only; the caller provides precomputed frame/patch embeddings. The stubs
here are a single linear adapter (+ positional info) so the backbone
consumes a well-typed embedding stream. A product of two dtypes runs in
their promoted dtype, as JAX promotes it.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L


def adapter_init(generator, d_in: int, d_model: int, dtype, device=None):
    return {"proj": L.dense_init(generator, d_in, d_model, dtype,
                                 device=device)}


def _project(params, x):
    dt = torch.promote_types(x.dtype, params["proj"].dtype)
    return x.to(dt) @ params["proj"].to(dt)


def audio_frames_apply(params, frames):
    """frames: (B, T, d_in) precomputed log-mel conv features (stub)."""
    x = _project(params, frames)
    pos = L.sinusoidal_positions(frames.shape[1], x.shape[-1], x.dtype,
                                 device=x.device)
    return x + pos[None]


def vision_patches_apply(params, patches):
    """patches: (B, P, d_in) precomputed InternViT patch embeddings (stub)."""
    return _project(params, patches)
