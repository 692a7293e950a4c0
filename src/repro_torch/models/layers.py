"""Shared layer primitives of the LM zoo, for the PyTorch port.

The counterpart of ``repro/models/layers.py``: every layer is an
``*_init(generator, ...) -> dict of tensors`` plus an ``apply(params, x,
...)`` function over plain tensors. ``params`` is anything that hands
out its leaves by name (``params["scale"]``): a dict of tensors, as the
tests pass, or a :class:`Params` module, which holds them as the
model's ``nn.Parameter``\\ s under the reference's leaf names.

Draws come from an explicit ``torch.Generator`` on the device the
tensors are made on (none on the ``meta`` device, where the converter
builds an empty skeleton). They are not the reference's bits: the tests
carry the reference's parameters in (``convert.lm_params_from_numpy``).
Where the reference computes in float32 (norms, rotary angles,
attention logits), so does the port, whatever the model's dtype.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.runtime import sharding as SH


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16``; a torch.dtype as it is."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


class Params(nn.Module):
    """A group of leaves from a nested dict of tensors: each tensor a
    frozen ``nn.Parameter`` (serving needs no gradients), each dict a
    sub-group, all reachable by name with ``[]`` as in the reference's
    pytrees (``p["attn"]["q_norm"]["scale"]``); ``named_parameters``
    gives the reference's leaf paths with dots. On a mesh
    (``runtime/sharding.use_mesh``) a leaf handed out by name is pinned
    (``sharding.pin``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, Params(leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def __getitem__(self, name):
        # on a mesh each use of a parameter is pinned, so that its
        # gradient comes back in the parameter's own placements (a tied
        # table's or a shared block's uses then add alike)
        x = getattr(self, name)
        return x if SH.current_mesh() is None else SH.pin(x)


def _empty(shape, generator, device, dtype=torch.float32):
    device = torch.device(device if device is not None
                          else generator.device if generator is not None
                          else "cpu")
    return torch.empty(shape, dtype=dtype, device=device)


def _drawn(t: torch.Tensor) -> bool:
    """Whether an initialiser draws ``t``: not on the ``meta`` device, nor
    a fake tensor (``FakeTensorMode``, as ``launch/cost.py`` traces a
    step from shapes alone), which holds no values to draw."""
    from torch._subclasses.fake_tensor import FakeTensor
    return t.device.type != "meta" and not isinstance(t, FakeTensor)


def dense_init(generator, d_in: int, d_out, dtype, scale: float | None = None,
               device=None):
    """(d_in, *d_out) truncated-normal weight, fan-in scaled: drawn in
    float32 within [-3, 3], scaled, then cast to ``dtype``."""
    shape = (d_in,) + (tuple(d_out) if isinstance(d_out, tuple)
                       else (d_out,))
    std = scale if scale is not None else d_in ** -0.5
    w = _empty(shape, generator, device)
    if _drawn(w):
        nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
        w.mul_(std)
    return w.to(torch_dtype(dtype))


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.zeros((d,), dtype=torch_dtype(dtype),
                                 device=device)}   # gemma-style (1+scale)


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].float())).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    dt = torch_dtype(dtype)
    return {"scale": torch.ones((d,), dtype=dt, device=device),
            "bias": torch.zeros((d,), dtype=dt, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


def softcap(x, cap: float):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    """``theta ** (-arange(0, hd, 2) / hd)`` in float32. The exponent is
    float32, as the reference's; the power is taken in float64 and
    rounded once, which gives XLA's float32 power to the bit (torch's
    float32 ``pow`` is an ulp off at a few exponents, and an ulp of a
    frequency is 2e-3 rad of angle at position 32,767)."""
    exponent = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return torch.pow(theta, exponent.double()).float()


def rope_angles(positions, head_dim: int, theta: float):
    """(sin, cos) of the rotary angles, each (..., S, 1, hd/2) float32,
    for positions (..., S)."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., :, None, None].float() * freqs
    return torch.sin(angles), torch.cos(angles)


def rotate(x, sin, cos):
    """Rotate the split halves of x (..., S, H, hd) by angles from
    :func:`rope_angles`, in float32, cast back to x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). The
    halves of the head are rotated as pairs (i, i + hd/2), not
    interleaved pairs."""
    return rotate(x, *rope_angles(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# MLP (dense FFN)
# ---------------------------------------------------------------------------

def mlp_init(generator, d: int, f: int, act: str, dtype, device=None):
    if act in ("silu", "geglu"):          # gated: wi_gate, wi_up, wo
        return {
            "wi_gate": dense_init(generator, d, f, dtype, device=device),
            "wi_up": dense_init(generator, d, f, dtype, device=device),
            "wo": dense_init(generator, f, d, dtype, scale=f ** -0.5,
                             device=device),
        }
    return {
        "wi": dense_init(generator, d, f, dtype, device=device),
        "wo": dense_init(generator, f, d, dtype, scale=f ** -0.5,
                         device=device),
    }


@functools.lru_cache(maxsize=None)
def in_dtype(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as the reference's constants are
    (``np.asarray(c, x.dtype)``, or a weakly typed Python scalar): a
    tensor times it then rounds the exact product once, as the
    reference's op does, where torch would use the unrounded scalar."""
    return float(torch.tensor(value, dtype=dtype))


def silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)``, the sigmoid as XLA expands it,
    ``1 / (1 + exp(-x))``, every step rounded to x's dtype (``F.silu``
    rounds once, and differs from the reference in bfloat16)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)`` as the reference writes it, its
    constants rounded to x's dtype and every step rounded to it
    (``F.gelu(approximate="tanh")`` rounds once)."""
    c = in_dtype(math.sqrt(2 / math.pi), x.dtype)
    cube = in_dtype(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + cube * (x * x * x)))))


def mlp_apply(params, x, act: str):
    """silu and GeGLU are gated; GELU is the tanh form, as the
    reference's ``jax.nn.gelu(approximate=True)``. The activations round
    each step to x's dtype, as the reference's ops do (:func:`silu`,
    :func:`gelu_tanh`). On a mesh the rows are gathered to batch-only
    sharding first (``sharding.rows``) and the output is pinned
    (``sharding.pin``): its gradient comes back batch-only, as the
    product's backward needs to fold (batch, sequence)."""
    x = SH.rows(x)
    if act == "silu":
        h = silu(x @ params["wi_gate"]) * (x @ params["wi_up"])
    elif act == "geglu":
        h = gelu_tanh(x @ params["wi_gate"]) * (x @ params["wi_up"])
    else:
        h = gelu_tanh(x @ params["wi"])
    return SH.pin(h @ params["wo"])


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def heads_proj(x, w):
    """``einsum("bsd,dhk->bshk", x, w)``, written out as einsum's own
    batched product of (1, B*S, d) by (1, d, H*k) (the same ``bmm`` on
    the same strides, so the same bits), so that on a mesh DTensor can
    split the heads: there the rows are gathered to batch-only sharding
    (``sharding.rows``), the H*k dim is brought to whole heads before the
    split (``sharding.whole_chunks``), the dims each fold merges are
    sharded only on the leading one (``sharding.foldable``), the merged
    operands are pinned (``sharding.pin``) so that the backward splits
    gradients laid out as the forward's operands, and the split's
    gradient is made contiguous (``sharding.contiguous_grad``). Off a
    mesh every one of those returns its input."""
    x = SH.rows(x)
    b, s, d = x.shape
    _, h, k = w.shape
    y = torch.bmm(SH.pin(x.reshape(1, b * s, d)),
                  SH.pin(SH.foldable(w, 1, 2).reshape(1, d, h * k)))
    return SH.contiguous_grad(SH.whole_chunks(y, 2, h).reshape(b, s, h, k))


def out_proj(o, w):
    """``einsum("bshk,dhk->bsd", o, w)`` (the attention output projection;
    w stored (d, H, k)), written out as einsum's batched product of
    (1, B*S, H*k) by (1, H*k, d), as :func:`heads_proj`."""
    b, s, h, k = o.shape
    d = w.shape[0]
    o = SH.foldable(SH.foldable(SH.whole_chunks(o, 2, h), 0, 1), 2, 3)
    w = SH.foldable(w.permute(1, 2, 0), 0, 1)
    y = torch.bmm(SH.pin(o.reshape(1, b * s, h * k)),
                  SH.pin(w.reshape(1, h * k, d)))
    return SH.pin(y.reshape(b, s, d))


def embed_init(generator, vocab: int, d: int, dtype, device=None):
    table = _empty((vocab, d), generator, device)
    if _drawn(table):
        table.normal_(generator=generator)
    return {"table": table.to(torch_dtype(dtype))}


def embed_lookup(params, tokens):
    """The rows of the table. On a mesh the lookup is placed explicitly:
    the tokens replicated (a vocab-sharded table gives a pending masked
    sum, whose mask DTensor keeps only for the tokens it saw and for one
    reduction), the sum settled, and the rows placed over the data
    axes."""
    if SH.current_mesh() is None:
        return F.embedding(tokens, params["table"])
    mesh = SH.current_mesh()
    tokens = SH.as_replicated(SH.replicated(tokens), mesh)
    x = SH.settle(F.embedding(tokens, params["table"]))
    return SH.constrain(x, SH.dp_axes_spec(), None, None)


def embed_logits(params, x):
    """Tied read-out: (B, S, d) @ (v, d)^T (on a mesh, the rows gathered
    to batch-only sharding first, ``sharding.rows``)."""
    return torch.einsum("bsd,vd->bsv", SH.rows(x), params["table"])


def sinusoidal_positions(seq: int, d: int, dtype=torch.float32,
                         device=None):
    pos = torch.arange(seq, device=device)[:, None].float()
    dim = torch.arange(0, d, 2, device=device)[None, :].float()
    # XLA's float32 power, to the bit (see rope_frequencies)
    angle = pos / torch.pow(10000.0, (dim / d).double()).float()
    return torch.cat([torch.sin(angle), torch.cos(angle)],
                     dim=-1).to(torch_dtype(dtype))
