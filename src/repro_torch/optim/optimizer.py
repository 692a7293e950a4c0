"""Optimizers of the PyTorch port: the counterpart of
``repro/optim/optimizer.py`` (hand-rolled, as there; not
``torch.optim``, whose arithmetic differs).

Three variants selected by ``TrainConfig.optimizer``:

* ``adamw``     float32 moments;
* ``adamw8bit`` block-quantized int8 moments with per-block float32
  scales (:class:`Q8`);
* ``adafactor`` factored second moment, no first moment.

Every function works on the reference's leaves: a dict of tensors keyed
by the reference's leaf path (``"groups.0.attn.wq"``), each holding the
stacked layers as the reference's pytree does
(``launch/train.py::Leaves`` stacks a port model's parameters that
way). The stacking matters: the 8-bit blocks, adafactor's factored
statistics and its update clipping span a whole stacked leaf.
``init(params) -> state`` and ``update(grads, state, params, step) ->
(new_params, new_state, metrics)``; the updates return new tensors and
change nothing in place. The arithmetic follows the reference's order:
the schedule, ``b1 ** t``, ``b2 ** t`` and adafactor's decay are float32
tensors (the reference's int32 step against weakly typed Python floats),
and :func:`global_norm` sums the leaves in the reference's flatten order
(:func:`leaf_order`).

The reference's ``_serialize`` / ``_token_of`` are XLA barriers that
stop XLA from running every leaf's update at once; eager PyTorch
already updates one leaf at a time, so they have no counterpart.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import TrainConfig

# adafactor's low-memory branch: bfloat16 leaves of more elements than
# this keep the param-shaped intermediates in bfloat16 (module constant,
# so a test can lower it)
LOWMEM_ELEMENTS = 2 * 10 ** 8
# rows of a 2-D low-memory leaf squared in float32 at a time
LOWMEM_ROWS = 4096


def leaf_order(path: str):
    """Sort key of a leaf path in JAX's flatten order: dict keys sorted,
    list entries by index."""
    return tuple((0, int(k), "") if k.isdigit() else (1, 0, k)
                 for k in path.split("."))


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _device(tree: dict):
    return next(iter(tree.values())).device


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf, the leaves
    summed in :func:`leaf_order`."""
    total = None
    for path in sorted(tree, key=leaf_order):
        sq = torch.sum(torch.square(tree[path].float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree: dict, max_norm: float):
    """(every leaf scaled by ``min(1, max_norm / max(norm, 1e-9))`` in
    float32 and cast back, the norm)."""
    n = global_norm(tree)
    # a tensor numerator: torch computes ``float / tensor`` as a
    # reciprocal times the float, rounded twice
    scale = torch.clamp(_f32(max_norm, n.device) / torch.clamp_min(n, 1e-9),
                        max=1.0)
    return {k: (x.float() * scale).to(x.dtype) for k, x in tree.items()}, n


def lr_schedule(cfg: TrainConfig, step, total_steps: int = 10000):
    """Linear warmup then cosine decay to 10 %, in float32 (``step`` a
    host int or a float32 tensor)."""
    if not torch.is_tensor(step):
        step = _f32(step, None)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


# ---------------------------------------------------------------------------
# int8 block quantization (for 8-bit moments)
# ---------------------------------------------------------------------------

_QBLOCK = 256


@dataclasses.dataclass
class Q8:
    """An int8 block-quantized tensor: ``q`` (nblocks, 256) int8,
    ``scale`` (nblocks,) float32, ``shape`` the original shape."""
    q: torch.Tensor
    scale: torch.Tensor
    shape: tuple


def q8_encode(x: torch.Tensor) -> Q8:
    flat = x.float().reshape(-1)
    pad = (-flat.shape[0]) % _QBLOCK
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _QBLOCK)
    scale = flat.abs().amax(dim=1) / 127.0
    q = torch.round(flat / torch.clamp_min(scale[:, None], 1e-12)
                    ).to(torch.int8)
    return Q8(q, scale, tuple(x.shape))


def q8_decode(z: Q8) -> torch.Tensor:
    flat = (z.q.float() * z.scale[:, None]).reshape(-1)
    return flat[:math.prod(z.shape)].reshape(z.shape)


# ---------------------------------------------------------------------------
# AdamW (float32 / int8 moments)
# ---------------------------------------------------------------------------

def adamw_init(params: dict, *, bits8: bool = False) -> dict:
    def zeros(x):
        z = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return q8_encode(z) if bits8 else z
    return {"m": {k: zeros(x) for k, x in params.items()},
            "v": {k: zeros(x) for k, x in params.items()}}


@torch.no_grad()
def adamw_update(cfg: TrainConfig, grads: dict, state: dict, params: dict,
                 step, lr, *, bits8: bool = False):
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
    dev = _device(params)
    t = _f32(int(step) + 1, dev)
    c1 = 1 - _f32(b1, dev) ** t
    c2 = 1 - _f32(b2, dev) ** t
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m_f = q8_decode(state["m"][k]) if bits8 else state["m"][k]
        v_f = q8_decode(state["v"][k]) if bits8 else state["v"][k]
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * g * g
        mhat = m_f / c1
        vhat = v_f / c2
        upd = mhat / (torch.sqrt(vhat) + eps) + wd * p.float()
        new_p[k] = (p.float() - lr * upd).to(p.dtype)
        new_m[k] = q8_encode(m_f) if bits8 else m_f
        new_v[k] = q8_encode(v_f) if bits8 else v_f
    return new_p, {"m": new_m, "v": new_v}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)
# ---------------------------------------------------------------------------

def adafactor_init(params: dict) -> dict:
    def one(x):
        if x.ndim >= 2:
            return {"vr": torch.zeros(x.shape[:-1], dtype=torch.float32,
                                      device=x.device),
                    "vc": torch.zeros(x.shape[:-2] + x.shape[-1:],
                                      dtype=torch.float32, device=x.device)}
        return {"v": torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device)}
    return {"v": {k: one(x) for k, x in params.items()}}


def _sq_stats(g):
    """(mean over the last axis, mean over the second-to-last) of g*g,
    accumulated in float32."""
    g2 = torch.square(g.float())
    return g2.sum(dim=-1) / g.shape[-1], g2.sum(dim=-2) / g.shape[-2]


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _adafactor_leaf(cfg: TrainConfig, g, v, p, b2, lr, eps: float):
    lowmem = g.numel() > LOWMEM_ELEMENTS and p.dtype == torch.bfloat16
    # a DTensor leaf (on a mesh) is not walked slice by slice: DTensor
    # cannot split a sharded dim; its statistics take the whole leaf,
    # in the low-memory branch's dtypes
    sliced = lowmem and not _is_dtensor(g)
    gf = g if lowmem else g.float()
    if g.ndim >= 2:
        if lowmem and not sliced:
            g2r, g2c = _sq_stats(g)
        elif lowmem and g.ndim >= 3:
            # one leading slice's float32 copy at a time
            stats = [_sq_stats(gs) for gs in g]
            g2r = torch.stack([r for r, _ in stats])
            g2c = torch.stack([c for _, c in stats])
        elif lowmem:
            # one block of rows' float32 copy at a time
            rows, cols = [], 0
            for gs in g.split(LOWMEM_ROWS):
                g2 = torch.square(gs.float())
                rows.append(g2.sum(dim=-1))
                cols = cols + g2.sum(dim=-2)
            g2r = torch.cat(rows) / g.shape[-1]
            g2c = cols / g.shape[-2]
        else:
            g2r, g2c = _sq_stats(g)
        vr = b2 * v["vr"] + (1 - b2) * g2r
        vc = b2 * v["vc"] + (1 - b2) * g2c
        denom = (vr[..., :, None] * vc[..., None, :]
                 / torch.clamp_min(vr.mean(dim=-1)[..., None, None], eps))
        scale = torch.rsqrt(denom + eps)
        u = gf * scale.to(gf.dtype)
        nv = {"vr": vr, "vc": vc}
    else:
        nvv = b2 * v["v"] + (1 - b2) * torch.square(g.float())
        u = gf * torch.rsqrt(nvv + eps).to(gf.dtype)
        nv = {"v": nvv}
    # update clipping (Shazeer-Stern d = 1.0)
    if sliced and u.ndim >= 3:
        u2 = torch.stack([torch.square(us.float()).sum() for us in u])
        rms_u = torch.sqrt(u2.sum() / float(u.numel()) + eps)
    else:
        rms_u = torch.sqrt(torch.mean(torch.square(u.float())) + eps)
    clip = torch.reciprocal(torch.clamp_min(rms_u, 1.0)).to(u.dtype)
    u = u * clip
    if lowmem:
        lr_p = lr.to(p.dtype)
        wd_p = (lr * cfg.weight_decay).to(p.dtype)
        new_p = p - lr_p * u - wd_p * p
    else:
        new_p = (p.float() - lr * u
                 - lr * cfg.weight_decay * p.float()).to(p.dtype)
    return new_p, nv


@torch.no_grad()
def adafactor_update(cfg: TrainConfig, grads: dict, state: dict,
                     params: dict, step, lr):
    dev = _device(params)
    b2 = 1.0 - (_f32(int(step), dev) + 1.0) ** -0.8
    new_p, new_v = {}, {}
    for k, p in params.items():
        new_p[k], new_v[k] = _adafactor_leaf(cfg, grads[k], state["v"][k],
                                             p, b2, lr, 1e-30)
    return new_p, {"v": new_v}


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------

def make_optimizer(cfg: TrainConfig):
    """(init, update): ``update(grads, state, params, step)`` clips the
    gradients to ``cfg.grad_clip``, takes the step's learning rate and
    returns (new params, new state, {"grad_norm", "lr"})."""
    kind = cfg.optimizer
    if kind not in ("adamw", "adamw8bit", "adafactor"):
        raise ValueError(f"unknown optimizer {kind!r}")

    def init(params: dict) -> dict:
        if kind == "adafactor":
            return adafactor_init(params)
        return adamw_init(params, bits8=(kind == "adamw8bit"))

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict, step):
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        lr = lr_schedule(cfg, _f32(int(step), _device(params)))
        if kind == "adafactor":
            p, s = adafactor_update(cfg, grads, state, params, step, lr)
        else:
            p, s = adamw_update(cfg, grads, state, params, step, lr,
                                bits8=(kind == "adamw8bit"))
        return p, s, {"grad_norm": gnorm, "lr": lr}

    return init, update
