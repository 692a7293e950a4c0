"""In-band integrity guard, single shard (the port of
``repro/runtime/integrity.py``).

:class:`GuardState` holds five scalar tensors on the state's device and
rides ``NetworkState.guard``. Each step :func:`step_verdict` checks the
freshly computed state (non-finite membrane voltage or STDP trace,
voltage outside ``[v_floor, v_ceil]``, a per-step spike-count ceiling)
and :func:`guard_update` folds the verdict in, latching the first trip.
Everything stays on the device: no step waits for the host. The
batched service's B tenants carry one GuardState of (B,) leaves, with a
verdict and an update per tenant. Under
``impl='cuda_fused'`` the NaN and bounds checks of ``v`` come as
per-column flags from ``fused_step``'s epilogue.

On a mesh (``core/exchange.py``) the leaves are (S,), one verdict per
local shard, and :class:`HaloGuard` frames every halo message of a step
with a position-weighted checksum word (:func:`frame_checksum`),
verified on receive: one frame per shard's message, so a corrupt word
trips the shard that received it. Its chaos bit flip corrupts one
received word at a fixed send ordinal and step, as the reference's
does.

Trip codes are a bitmask, so one int32 reports compound failures.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import GuardConfig

# trip-code bitmask (int32)
TRIP_NAN = 1          # non-finite membrane voltage or STDP trace
TRIP_BOUNDS = 2       # membrane voltage outside [v_floor, v_ceil]
TRIP_SPIKES = 4       # per-step spike count above the ceiling
TRIP_AER_SAT = 8      # AER saturation for >= aer_sat_trip_steps steps
TRIP_CHECKSUM = 16    # halo-frame checksum mismatch on receive

_TRIP_NAMES = (
    (TRIP_NAN, "nan"),
    (TRIP_BOUNDS, "v-bounds"),
    (TRIP_SPIKES, "spike-ceiling"),
    (TRIP_AER_SAT, "aer-saturation"),
    (TRIP_CHECKSUM, "halo-checksum"),
)

#: process exit code of a worker whose guard tripped, so that a
#: supervisor tells "corrupt, rolled back" from a crash
GUARD_EXIT_CODE = 13


def describe_code(code: int) -> str:
    """Human-readable rendering of a trip-code bitmask."""
    names = [name for bit, name in _TRIP_NAMES if int(code) & bit]
    return "+".join(names) if names else "clean"


class GuardState(NamedTuple):
    """Scalar guard verdict carried in the simulation state.

    ``trip_code`` / ``trip_step`` latch the first trip (the step ``t``
    that produced the corrupt value); ``sat_run`` counts consecutive
    AER-saturated steps; ``checksum_fails`` counts corrupt halo frames.
    """
    tripped: torch.Tensor         # bool scalar
    trip_code: torch.Tensor       # int32 bitmask, 0 until the first trip
    trip_step: torch.Tensor       # int32, -1 until the first trip
    sat_run: torch.Tensor         # int32 consecutive AER-saturated steps
    checksum_fails: torch.Tensor  # int32 corrupt halo frames observed


def init_guard(device="cpu", shape: tuple = ()) -> GuardState:
    """A clean guard; ``shape`` (S,) gives one per shard of a mesh."""
    def scalar(value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=device)
    return GuardState(tripped=scalar(False, torch.bool), trip_code=scalar(0),
                      trip_step=scalar(-1), sat_run=scalar(0),
                      checksum_fails=scalar(0))


_MASK = 0xFFFFFFFF
_POSITIONS: dict = {}       # (n, device) -> the int64 weights 1..n


def _positions(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _POSITIONS:
        _POSITIONS[key] = torch.arange(1, n + 1, dtype=torch.int64,
                                       device=device)
    return _POSITIONS[key]


def _checksum64(words: torch.Tensor) -> torch.Tensor:
    """``sum((i+1) * word_i) mod 2**32`` over the last axis, int64. An
    int32 word and its unsigned reading agree mod 2**32, so the signed
    product (below 2**62) needs no mask first; each product is cut to 32
    bits, so the sum of fewer than 2**31 of them stays in int64."""
    idx = _positions(words.shape[-1], words.device)
    return ((words.to(torch.int64) * idx) & _MASK).sum(-1) & _MASK


def frame_checksum(words: torch.Tensor) -> torch.Tensor:
    """Position-weighted modular checksum ``sum((i+1) * word_i) mod 2**32``
    of the 32-bit words along the last axis of ``words`` (int32, read as
    unsigned), as int32 holding the reference's uint32 bits: one checksum
    per leading index."""
    s = _checksum64(words)
    return ((s ^ 0x80000000) - 0x80000000).to(torch.int32)


class HaloGuard:
    """One step's checksum accumulator for the halo exchange of ``shards``
    local shards at host step ``t``.

    :meth:`wrap` turns a transport's ``move(x, axis, direction)`` (a
    stack of messages, one per index of the (rows, cols) stack axes in
    front of ``x``) into a framed one: each message's 32-bit words gain a
    checksum word, the frames move, the chaos flip lands on the received
    frames (send ordinal ``chaos_flip_ring`` at step ``chaos_flip_step``:
    bit 0 of word ``chaos_flip_word % n_words`` of every received frame,
    the zero frame at the sheet's edge too), and each is verified.
    :meth:`verdict` gives the step's (shards,) failures and counts. A
    message that is not 32-bit words cannot be framed and raises."""

    def __init__(self, gcfg: GuardConfig, t: int, shards: int, device):
        self.gcfg = gcfg
        self.t = t
        self._none = torch.zeros(shards, dtype=torch.int32, device=device)
        self._groups = []     # per wrapped move: its verdicts, to_shards
        self._send_ordinal = 0

    def wrap(self, move, to_shards=None):
        """``move`` framed; ``to_shards`` maps a (rows, cols) count of
        corrupt frames to the (shards,) one (default: flattened, one
        message per shard)."""
        if not self.gcfg.halo_checksum:
            return move
        gcfg = self.gcfg
        bads = []
        self._groups.append((bads, to_shards))

        def framed(x: torch.Tensor, axis: int, direction: int):
            if x.element_size() != 4:
                raise ValueError(
                    f"HaloGuard frames 32-bit words; a {x.dtype} halo "
                    f"message cannot be framed")
            ordinal = self._send_ordinal
            self._send_ordinal += 1
            words = x.view(torch.int32).reshape(*x.shape[:2], -1)
            n = words.shape[-1]
            msg = torch.cat([words, frame_checksum(words)[..., None]], -1)
            recv = move(msg, axis, direction)
            if ordinal == gcfg.chaos_flip_ring and self.t == \
                    gcfg.chaos_flip_step:
                recv = recv.clone()
                recv[..., gcfg.chaos_flip_word % n] ^= 1
            payload = recv[..., :n]
            bads.append(_checksum64(payload)
                        != recv[..., n].to(torch.int64) & _MASK)
            return payload.view(x.dtype).reshape(x.shape)

        return framed

    def verdict(self):
        """``(fail, count)``: (shards,) bool and int32, whether and how
        many corrupt frames each shard received this step."""
        count = self._none
        for bads, to_shards in self._groups:
            if bads:
                n = torch.stack(bads).sum(0, dtype=torch.int32)
                count = count + (n.reshape(-1) if to_shards is None
                                 else to_shards(n))
        return count > 0, count


def inject_nan(gcfg: GuardConfig, t, v: torch.Tensor,
               chaos_step=None, shards: int = 1) -> torch.Tensor:
    """Poison the first membrane voltage with NaN at step ``chaos_step``
    (``gcfg.chaos_nan_at_step`` when None). ``t`` is the host step counter
    (with ``shards`` S, ``v`` holds S shards' rows and each shard's first
    voltage is poisoned, as the reference poisons every shard's), or the
    (B,) step counters of B tenants on the device with ``v`` of (B, ...)
    and ``chaos_step`` (B,): then each tenant's first voltage is poisoned
    at its own step, on the device."""
    step = gcfg.chaos_nan_at_step if chaos_step is None else chaos_step
    if not isinstance(t, torch.Tensor):
        if t != step:
            return v
        v = v.clone()
        v.view(shards, -1)[:, 0] = float("nan")
        return v
    flat = v.reshape(t.shape[0], -1)
    first = torch.where(t == step, float("nan"), flat[:, 0])
    out = flat.clone()
    out[:, 0] = first
    return out.reshape(v.shape)


def step_verdict(gcfg: GuardConfig, *, v: torch.Tensor, spikes: torch.Tensor,
                 x_pre: torch.Tensor | None = None,
                 x_post: torch.Tensor | None = None,
                 kernel_flags: torch.Tensor | None = None,
                 tenants: int | None = None) -> torch.Tensor:
    """int32 trip-code bitmask of this step's freshly computed state.

    ``kernel_flags`` (int32 per column, bit 0 non-finite, bit 1 out of
    bounds, from ``fused_step``'s epilogue) stand in for a second pass
    over ``v``.

    ``tenants`` = B gives B verdicts, (B,) int32, of B tenants whose
    arrays have a leading (B, ...) axis (or B times the rows): the
    reference's ``vmap`` of the one-tenant verdict.
    """
    single = tenants is None
    tenants = tenants or 1

    def per(x):
        return x.reshape(tenants, -1)

    if kernel_flags is not None:
        nan_bad = ((per(kernel_flags) & 1) != 0).any(1)
        rng_bad = ((per(kernel_flags) & 2) != 0).any(1)
    else:
        nan_bad = ~torch.isfinite(per(v)).all(1)
        rng_bad = ((per(v) < gcfg.v_floor) | (per(v) > gcfg.v_ceil)).any(1)
    for tr in (x_pre, x_post):
        if tr is not None:
            nan_bad = nan_bad | ~torch.isfinite(per(tr)).all(1)
    # a tenant's spikes add up to an integer below 2**24, exact in any order
    ceiling = gcfg.max_spike_fraction * (spikes.numel() // tenants)
    spike_bad = per(spikes).sum(1, dtype=torch.float32) > ceiling
    if single:
        nan_bad, rng_bad, spike_bad = nan_bad[0], rng_bad[0], spike_bad[0]
    i32 = torch.int32
    return ((nan_bad.to(i32) * TRIP_NAN) | (rng_bad.to(i32) * TRIP_BOUNDS)
            | (spike_bad.to(i32) * TRIP_SPIKES))


def guard_update(gcfg: GuardConfig, gs: GuardState, *,
                 step_code: torch.Tensor, t,
                 aer_sat: torch.Tensor | None = None,
                 chk_fail: torch.Tensor | None = None,
                 chk_count: torch.Tensor | None = None) -> GuardState:
    """Fold one step's verdict into the carried :class:`GuardState`.
    ``aer_sat`` (bool) escalates to ``TRIP_AER_SAT`` after
    ``gcfg.aer_sat_trip_steps`` consecutive saturated steps; ``chk_fail``
    and ``chk_count`` (a :class:`HaloGuard`'s :meth:`~HaloGuard.verdict`)
    trip ``TRIP_CHECKSUM`` and add to ``checksum_fails``. ``t`` is the host
    step counter; B tenants' guards (or S shards') are one GuardState of
    (B,) leaves, updated with their (B,) verdicts (and, for tenants, (B,)
    step counters)."""
    code = step_code.to(torch.int32)
    sat_run = gs.sat_run
    if aer_sat is not None:
        sat_run = torch.where(aer_sat, gs.sat_run + 1, 0).to(torch.int32)
        code = code | torch.where(sat_run >= gcfg.aer_sat_trip_steps,
                                  TRIP_AER_SAT, 0).to(torch.int32)
    if chk_fail is not None:
        code = code | torch.where(chk_fail, TRIP_CHECKSUM, 0).to(torch.int32)
    fails = gs.checksum_fails
    if chk_count is not None:
        fails = fails + chk_count
    tripped_now = code != 0
    first = tripped_now & ~gs.tripped
    return GuardState(
        tripped=gs.tripped | tripped_now,
        trip_code=torch.where(first, code, gs.trip_code),
        trip_step=torch.where(
            first, t if isinstance(t, torch.Tensor) else int(t),
            gs.trip_step),
        sat_run=sat_run,
        checksum_fails=fails,
    )


def tenant_guard(gs: GuardState, b: int) -> GuardState:
    """Tenant ``b``'s guard of B tenants' (B,) leaves."""
    return GuardState(*(leaf[b] for leaf in gs))


def guard_report(gs: GuardState) -> dict:
    """Host-side summary of a GuardState (reads the device), of a mesh's
    (S,) leaves, or of their numpy copies; of one tenant's,
    :func:`tenant_guard`."""
    code = int(gs.trip_code.max())
    return {
        "guard_tripped": bool(gs.tripped.any()),
        "guard_trip_code": code,
        "guard_trip_what": describe_code(code),
        "guard_trip_step": int(gs.trip_step.max()),
        "guard_checksum_fails": int(gs.checksum_fails.max()),
    }
