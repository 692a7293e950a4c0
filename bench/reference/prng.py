"""JAX's threefry2x32 draws as plain tensor ops, for the reference.

A frozen copy of the arithmetic that the simulator's network, initial
state and Poisson drive are defined by (``jax.random`` with
``jax_threefry_partitionable=True``): keys are two uint32 words held in
int64 tensors of shape ``(..., 2)``, masked after every add and shift.
It imports nothing of the program under test. Every function runs on the
device of the key it is given; on the card each operation is the same
per element whatever the shape, so batching keys changes no bit.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` in float32 rounded once, as ``__fmaf_rn`` rounds it:
    the float64 product of two float32 values is exact, and its float64
    sum with ``c`` is rounded to odd (TwoSum gives the sum's error), so the
    one rounding to float32 that follows is the correct one."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor)
                      else float(b))
    c = c.double() if isinstance(c, torch.Tensor) else float(c)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.to(a.dtype)


def _rotl(x, r):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Random123's threefry2x32, 20 rounds, on int64-held uint32 words
    that broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK
    return x[0], x[1]


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``PRNGKey(seed)``: the key ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``fold_in``: the counter ``(0, data)`` hashed under each key."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``split``: ``num`` keys from each key, as ``(*batch, num, 2)``."""
    ctr = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          torch.zeros_like(ctr), ctr)
    return torch.stack((y1, y2), dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 bits per element: flat index i hashed as ``(0, i)``, the two
    output words xor-ed; ``(*batch, *shape)``."""
    shape = tuple(shape)
    ctr = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device)
    y1, y2 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          torch.zeros_like(ctr), ctr)
    return (y1 ^ y2).reshape(*key.shape[:-1], *shape)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1): the top 23 bits as the mantissa of [1, 2), - 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, minval=0.0, maxval=1.0):
    f = bits_to_unit(random_bits(key, shape))
    lo = torch.as_tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, fma(f, hi - lo, lo))


def bernoulli(key, p: float, shape):
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32,
                                              device=key.device)


def randint(key, shape, minval: int, maxval: int):
    """``randint`` as int32: two bit draws of a split key, combined
    modulo the span as uint32."""
    span = maxval - minval
    keys = split(key)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    mult = ((2 ** 16 % span) ** 2 & MASK) % span
    offset = (((hi % span) * mult) & MASK) + lo % span
    return ((offset & MASK) % span + minval).to(torch.int32)


_ERFINV_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x):
    """Giles' single-precision erfinv with fused Horner steps."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(
            small, torch.tensor(_ERFINV_LT_5[i], dtype=x.dtype,
                                device=x.device),
            torch.tensor(_ERFINV_GE_5[i], dtype=x.dtype, device=x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT_5)):
        p = fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, p * x)


def truncated_normal(key, lower: float, upper: float, shape):
    f32, dev = torch.float32, key.device
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=f32, device=dev)
    lo = torch.tensor(lower, dtype=f32, device=dev)
    hi = torch.tensor(upper, dtype=f32, device=dev)
    a, b = torch.erf(lo / sqrt2), torch.erf(hi / sqrt2)
    out = sqrt2 * erf_inv(uniform(key, shape, a, b))
    inf = torch.tensor(math.inf, dtype=f32, device=dev)
    return torch.clamp(out, torch.nextafter(lo, inf),
                       torch.nextafter(hi, -inf))
