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

Trip codes are a bitmask, so one int32 reports compound failures. The
halo-frame checksums (``frame_checksum``, ``HaloGuard``) belong to the
halo exchange and come with the multi-rank slice of the port.
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


def init_guard(device="cpu") -> GuardState:
    def scalar(value, dtype=torch.int32):
        return torch.full((), value, dtype=dtype, device=device)
    return GuardState(tripped=scalar(False, torch.bool), trip_code=scalar(0),
                      trip_step=scalar(-1), sat_run=scalar(0),
                      checksum_fails=scalar(0))


def inject_nan(gcfg: GuardConfig, t, v: torch.Tensor,
               chaos_step=None) -> torch.Tensor:
    """Poison the first membrane voltage with NaN at step ``chaos_step``
    (``gcfg.chaos_nan_at_step`` when None). ``t`` is the host step counter,
    or the (B,) step counters of B tenants on the device with ``v`` of
    (B, ...) and ``chaos_step`` (B,): then each tenant's first voltage is
    poisoned at its own step, on the device."""
    step = gcfg.chaos_nan_at_step if chaos_step is None else chaos_step
    if not isinstance(t, torch.Tensor):
        if t != step:
            return v
        v = v.clone()
        v.view(-1)[0] = float("nan")
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
                 aer_sat: torch.Tensor | None = None) -> GuardState:
    """Fold one step's verdict into the carried :class:`GuardState`.
    ``aer_sat`` (bool scalar) escalates to ``TRIP_AER_SAT`` after
    ``gcfg.aer_sat_trip_steps`` consecutive saturated steps. ``t`` is the
    host step counter; B tenants' guards are one GuardState of (B,)
    leaves, updated with their (B,) verdicts and (B,) step counters."""
    code = step_code.to(torch.int32)
    sat_run = gs.sat_run
    if aer_sat is not None:
        sat_run = torch.where(aer_sat, gs.sat_run + 1, 0).to(torch.int32)
        code = code | torch.where(sat_run >= gcfg.aer_sat_trip_steps,
                                  TRIP_AER_SAT, 0).to(torch.int32)
    tripped_now = code != 0
    first = tripped_now & ~gs.tripped
    return GuardState(
        tripped=gs.tripped | tripped_now,
        trip_code=torch.where(first, code, gs.trip_code),
        trip_step=torch.where(
            first, t if isinstance(t, torch.Tensor) else int(t),
            gs.trip_step),
        sat_run=sat_run,
        checksum_fails=gs.checksum_fails,
    )


def tenant_guard(gs: GuardState, b: int) -> GuardState:
    """Tenant ``b``'s guard of B tenants' (B,) leaves."""
    return GuardState(*(leaf[b] for leaf in gs))


def guard_report(gs: GuardState) -> dict:
    """Host-side summary of a GuardState (reads the device); of one
    tenant's, :func:`tenant_guard`."""
    code = int(gs.trip_code.max())
    return {
        "guard_tripped": bool(gs.tripped.any()),
        "guard_trip_code": code,
        "guard_trip_what": describe_code(code),
        "guard_trip_step": int(gs.trip_step.max()),
        "guard_checksum_fails": int(gs.checksum_fails.max()),
    }
