"""JAX's threefry2x32 PRNG as tensor ops (the counterpart of the
``jax.random`` functions the reference calls).

The reference draws every random number from ``jax.random`` keys: the
network per global column id, the initial potentials per column, the
Poisson drive per (step, column). The port draws the same numbers from
the same keys, as jax 0.9.0 gives them with
``jax_threefry_partitionable=True`` (its default):

* a key is two uint32 words, held here as an int64 tensor of shape
  ``(..., 2)``: uint32 words in int64, masked with ``0xFFFFFFFF`` after
  every add and shift (torch's ``uint32`` lacks shifts on the CPU);
  leading dimensions are a batch of keys, as ``jax.vmap`` over keys;
* ``threefry2x32`` is the Random123 hash: 20 rounds of add, rotate and
  xor with the ``0x1BD11BDA`` key schedule (``jax/_src/prng.py``,
  ``_threefry2x32_lowering``);
* ``prng_key(seed)`` is ``(0, seed mod 2**32)`` (``threefry_seed`` of a
  32-bit seed); ``fold_in(key, d)`` hashes the counter ``(0, d)``;
  ``split(key, n)`` hashes the counters ``(0, j)``, j < n, and keeps
  both output words; ``random_bits(key, shape)`` hashes ``(0, i)`` for
  the flat index i and returns the xor of the two output words;
* ``uniform``, ``bernoulli``, ``randint``, ``truncated_normal`` and
  ``poisson`` follow ``jax/_src/random.py``. The integer draws are
  bitwise; ``uniform`` and ``bernoulli`` too (the mantissa trick, and
  ``floats * (max - min) + min`` as one fused multiply-add, as XLA
  fuses it on the CPU). ``truncated_normal`` goes through ``erf`` and
  XLA's own ``erf_inv`` polynomial, but ``log1p`` inside it rounds as the
  device's does, a few ulp from XLA's (``tests/test_torch_prng.py``
  states the bound). ``poisson`` is
  Knuth's loop, the reference's branch for ``lam < 10``; its ``log``
  rounds as the device's ``log`` does.

Every function runs on the device of the key it is given.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import _fma

MASK = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of counters ``(x1, x2)`` under the key
    ``(k1, k2)``: uint32 words in int64 tensors that broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK
    return x[0], x[1]


def _words(key: torch.Tensor):
    """A key batch's two words, with one trailing dimension to broadcast
    against a draw's flat counters."""
    return key[..., 0:1], key[..., 1:2]


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` (an int, or an integer tensor that
    broadcasts against the key batch) hashed as the counter ``(0, data)``
    under each key. Returns keys of the broadcast batch shape."""
    if isinstance(data, int) and not 0 <= data <= MASK:
        raise ValueError(f"fold_in: {data} is not a uint32")
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` keys from each key of the batch, as
    ``(*batch, num, 2)``."""
    ctr = torch.arange(num, dtype=torch.int64, device=key.device)
    k1, k2 = _words(key)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(ctr), ctr)
    return torch.stack((y1, y2), dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element, ``(*batch, *shape)``: the flat index i
    hashed as the counter ``(0, i)``, the two output words xor-ed."""
    shape = tuple(shape)
    size = math.prod(shape)
    if size >= 1 << 32:
        raise ValueError(f"random_bits: {size} draws need a 64-bit counter")
    ctr = torch.arange(size, dtype=torch.int64, device=key.device)
    k1, k2 = _words(key)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(ctr), ctr)
    return (y1 ^ y2).reshape(*key.shape[:-1], *shape)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32 random bits: the top 23 as the mantissa
    of a number in [1, 2), minus 1."""
    one = 0x3F800000
    return ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0
            ) -> torch.Tensor:
    """``jax.random.uniform`` in float32: ``max(minval, f * (maxval -
    minval) + minval)`` for the unit draw ``f``, the multiply-add fused as
    XLA fuses it."""
    f = bits_to_unit(random_bits(key, shape))
    lo = torch.as_tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, _fma(f, hi - lo, lo))


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform < p`` in float32."""
    p = torch.tensor(p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < p


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` as int32: two bit draws from a split of the
    key, combined modulo the span as uint32 (``_randint``)."""
    span = maxval - minval
    if not 0 < span <= MASK:
        raise ValueError(f"randint: empty or too wide range [{minval}, "
                         f"{maxval})")
    keys = split(key)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    # the reference squares 2**16 mod span in uint32, so past a span of
    # 2**16 the square wraps to 0
    mult = ((2 ** 16 % span) ** 2 & MASK) % span
    offset = (((hi % span) * mult) & MASK) + lo % span
    return ((offset & MASK) % span + minval).to(torch.int32)


# Giles' single-precision erfinv, as XLA evaluates it: coefficients for
# w = -log1p(-x*x) below 5 and at or above it, highest degree first
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` in float32: Giles' polynomial in ``w =
    -log1p(-x*x)`` (shifted by 2.5 below 5, else ``sqrt(w) - 3``), its
    Horner steps fused multiply-adds as XLA fuses them; ``x * FLT_MAX``
    at |x| = 1. ``log1p`` rounds as the device's does, so the result can
    differ from XLA's by a few ulp (``tests/test_torch_prng.py`` states
    the bound)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(
            small, torch.tensor(_ERFINV_W_LT_5[i], dtype=x.dtype,
                                device=x.device),
            torch.tensor(_ERFINV_W_GE_5[i], dtype=x.dtype, device=x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = _fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, p * x)


def truncated_normal(key: torch.Tensor, lower: float, upper: float, shape
                     ) -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32: ``sqrt(2) *
    erfinv(u)`` for ``u`` uniform between ``erf(lower / sqrt 2)`` and
    ``erf(upper / sqrt 2)``, clamped to the open interval."""
    f32 = torch.float32
    dev = key.device
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=f32, device=dev)
    lo = torch.tensor(lower, dtype=f32, device=dev)
    hi = torch.tensor(upper, dtype=f32, device=dev)
    a, b = torch.erf(lo / sqrt2), torch.erf(hi / sqrt2)
    out = sqrt2 * erf_inv(uniform(key, shape, a, b))
    inf = torch.tensor(math.inf, dtype=f32, device=dev)
    return torch.clamp(out, torch.nextafter(lo, inf),
                       torch.nextafter(hi, -inf))


def poisson(key: torch.Tensor, lam: float, shape) -> torch.Tensor:
    """``jax.random.poisson`` for ``0 <= lam < 10`` (Knuth's loop), as
    float32 counts ``(*batch, *shape)``.

    Iteration j draws ``u`` from the j-th subkey of each key's split chain
    (``rng, subkey = split(rng)``) and adds ``log u`` to a float32 running
    sum; the count is J - 1, where J is the number of draws after which
    the sum is first ``-lam`` or below. The loop runs until every element
    is done, as the reference's does, so no count is ever clipped."""
    if not 0.0 <= lam < 10.0:
        raise NotImplementedError(
            f"poisson: lam = {lam}; only Knuth's branch (0 <= lam < 10) "
            f"is ported")
    batch = key.shape[:-1]
    f32 = torch.float32
    count = torch.zeros((*batch, *shape), dtype=f32, device=key.device)
    if lam == 0.0:
        return count
    neg_lam = torch.tensor(-lam, dtype=f32, device=key.device)
    log_prod = torch.zeros_like(count)
    rng = key
    while True:
        live = log_prod > neg_lam
        if not bool(live.any()):
            break
        keys = split(rng)
        rng, sub = keys[..., 0, :], keys[..., 1, :]
        count += live.to(f32)
        log_prod = log_prod + torch.log(bits_to_unit(random_bits(sub,
                                                                 shape)))
    return count - 1.0
