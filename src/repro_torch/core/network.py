"""Network containers and the single-shard step (the port of
``repro/core/network.py``).

Per shard the network holds

* ``w_local``  (C, N, N) dense intra-column weights  [src, tgt]
* ``rem_flat`` (C, N, K) int32 gather indices into the flattened
  (O*N,) per-column neighbour-spike table
* ``rem_w``    (C, N, K) remote weights
* a spike **history ring buffer** (D, C, N) for the axonal delays.

``impl`` selects the delivery and neuron update: ``"ref"`` (plain
PyTorch on whatever device holds the tensors), ``"cuda"`` (the three
kernels ``synapse_matmul``, ``ell_gather`` and ``lif_step``) or
``"cuda_fused"`` (one ``fused_step`` kernel per step, with its STDP-trace
epilogue under ``cfg.stdp`` and its guard-flag epilogue under
``cfg.guard.enabled``). On CPU tensors the kernel wrappers run their
plain versions. Every impl draws the Poisson drive keyed per (seed,
step, global column id) as the reference does: the ``keyed_drive``
kernel on the card, its plain version on the CPU. With ``cfg.stdp`` the
state carries the STDP traces
(the weights are updated in ``core/simulation.py``); with
``cfg.guard.enabled`` it carries the integrity guard's verdict
(``runtime/integrity.py``).

The functions are pure, as in the reference: a step returns a new
state and leaves its input as it was, so two runs can start from one
state. The step counter ``t`` is a host (CPU) int32 scalar: the Python
loop indexes the ring buffer with it, and a device counter would make
the host wait for the card every step.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import DPSNNConfig
from repro_torch.core import connectivity as conn
from repro_torch.core import prng
from repro_torch.core.connectivity import StencilSpec, build_stencil
from repro_torch.core.neuron import LIFState, lif_init, lif_sfa_step
from repro_torch.kernels import ops
from repro_torch.kernels.ref import per_tenant, silent_block_count, tenants_of
from repro_torch.runtime import integrity
from repro_torch.runtime.spans import span

IMPLS = ("ref", "cuda", "cuda_fused")


class NetworkParams(NamedTuple):
    w_local: torch.Tensor       # (C, N, N)
    rem_flat: torch.Tensor      # (C, N, K) gather idx into (O*N,) table
    rem_w: torch.Tensor         # (C, N, K)
    local_outdeg: torch.Tensor  # (C, N) for synaptic-event accounting


class NetworkState(NamedTuple):
    lif: LIFState               # leaves (C, N)
    hist: torch.Tensor          # (D, C, N) spike history ring buffer
    t: torch.Tensor             # host int32 scalar step counter
    spike_count: torch.Tensor   # f32 scalar, total spikes emitted
    event_count: torch.Tensor   # f32 scalar, total synaptic events
    stdp: Any = None            # STDPState traces under cfg.stdp
    guard: Any = None           # GuardState under cfg.guard.enabled


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it is CUDA and there is
    no card (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain PyTorch versions")
    return dev


def check_supported(cfg: DPSNNConfig, impl: str, *,
                    mesh: bool = False) -> None:
    """Raise for what the port does not run yet, rather than running
    without it: on a single shard, or with ``mesh`` on the multi-rank
    step (``core/exchange.py``)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS})")
    if cfg.exchange.pipelined and not mesh:
        raise NotImplementedError(
            "pipelined: the cross-step pipelined halo exchange belongs to "
            "the multi-rank step (core/exchange.py); a single shard has no "
            "halo to pipeline")
    if cfg.dtype != "float32" or cfg.weight_dtype != "float32":
        raise NotImplementedError(
            f"dtype {cfg.dtype} / weight_dtype {cfg.weight_dtype}: this "
            "slice runs float32 only; bf16 weights wait for a later slice")


def build_params(cfg: DPSNNConfig, col_ids, device="cpu") -> NetworkParams:
    stencil = build_stencil(cfg)
    w_local, rem_idx, rem_w = conn.generate_columns(cfg, col_ids, device)
    rem_flat = conn.flat_gather_index(stencil, rem_idx,
                                      cfg.neurons_per_column)
    return NetworkParams(
        w_local=w_local,
        rem_flat=rem_flat,
        rem_w=rem_w,
        local_outdeg=conn.local_out_degree(w_local).to(torch.float32),
    )


# added to the seed for the initial potentials' keys
INIT_STREAM = 0x51F


def column_ids(cfg: DPSNNConfig, device="cpu") -> torch.Tensor:
    """The (C,) int32 global ids of a single shard's columns."""
    return torch.arange(cfg.n_columns, dtype=torch.int32, device=device)


def init_state(cfg: DPSNNConfig, col_ids, stencil: StencilSpec | None = None,
               device="cpu", *, seed: int | None = None) -> NetworkState:
    """Initial state, deterministic per global column id: the potentials
    of column c from ``fold_in(PRNGKey(seed + 0x51F), c)``. ``seed``
    overrides ``cfg.seed`` (a tenant of the batched service); ``None`` is
    the single-tenant state."""
    stencil = stencil or build_stencil(cfg)
    n = cfg.neurons_per_column
    ids = torch.as_tensor(col_ids, dtype=torch.int64).reshape(-1)
    dtype = getattr(torch, cfg.dtype)
    base = cfg.seed if seed is None else int(seed)
    keys = prng.fold_in(prng.prng_key(base + INIT_STREAM, device),
                        ids.to(device))
    lif = lif_init(cfg.neuron, (n,), dtype, keys)
    stdp = guard = None
    if cfg.stdp:
        from repro_torch.core.plasticity import init_stdp  # imports network
        stdp = init_stdp(len(ids), n, dtype, device)
    if cfg.guard.enabled:
        guard = integrity.init_guard(device)
    return NetworkState(
        lif=lif,
        hist=torch.zeros((stencil.max_delay + 1, len(ids), n), dtype=dtype,
                         device=device),
        t=torch.tensor(0, dtype=torch.int32),
        spike_count=torch.zeros((), dtype=torch.float32, device=device),
        event_count=torch.zeros((), dtype=torch.float32, device=device),
        stdp=stdp,
        guard=guard,
    )


# ---------------------------------------------------------------------------
# Delivery
# ---------------------------------------------------------------------------

def deliver_local_ref(spikes: torch.Tensor,
                      w_local: torch.Tensor) -> torch.Tensor:
    """(C,N) x (C,N,N) -> (C,N): batched product over columns, float32
    accumulation. B tenants' (B*C, N) spikes over shared weights: each
    tenant's product on its own (``kernels/ref.py::per_tenant``)."""
    b = tenants_of(spikes.shape[0], w_local.shape[0], "deliver_local")
    if b > 1:
        return per_tenant(deliver_local_ref, b, spikes.shape[0], spikes,
                          w_local)
    return torch.einsum("cs,cst->ct", spikes.float(),
                        w_local.float()).to(spikes.dtype)


def deliver_remote_ref(s_flat: torch.Tensor, rem_flat: torch.Tensor,
                       rem_w: torch.Tensor) -> torch.Tensor:
    """Gather-and-reduce ELL delivery, summed in the state dtype.

    s_flat:   (C, O*N) neighbour spike table (offset-major)
    rem_flat: (C, N, K) indices into the O*N axis
    rem_w:    (C, N, K)
    returns   (C, N) currents

    B tenants' (B*C, O*N) tables gather through the shared ``rem_flat``
    (and ``rem_w`` of C or B*C rows), each tenant on its own.
    """
    b = tenants_of(s_flat.shape[0], rem_flat.shape[0], "deliver_remote")
    if b > 1:
        return per_tenant(deliver_remote_ref, b, s_flat.shape[0], s_flat,
                          rem_flat, rem_w)
    c, n, k = rem_flat.shape
    gathered = torch.gather(
        s_flat, 1, rem_flat.reshape(c, n * k).long()
    ).reshape(c, n, k)
    return (gathered * rem_w).sum(dim=-1).to(s_flat.dtype)


def _stage_fns(impl: str):
    if impl == "ref":
        def deliver_local(spikes, w_local, silent_blocks=None):
            if silent_blocks is not None:
                silent_blocks += silent_block_count(spikes)
            return deliver_local_ref(spikes, w_local)
        return deliver_local, deliver_remote_ref, lif_sfa_step
    if impl == "cuda":
        def lif_kernel(ncfg, lif0, currents):
            v, c, refrac, spikes = ops.lif_step(ncfg, lif0.v, lif0.c,
                                                lif0.refrac, currents)
            return LIFState(v=v, c=c, refrac=refrac), spikes
        return ops.synapse_matmul, ops.ell_gather, lif_kernel
    raise ValueError(f"unknown staged impl {impl!r} ('cuda_fused' runs the "
                     f"whole step as one kernel, in step_single)")


def offset_slice(g_ext: torch.Tensor, dy: int, dx: int, r: int,
                 h: int, w: int, n: int) -> torch.Tensor:
    """(..., h+2r, w+2r, N) halo-extended frames -> the (..., h, w, N)
    blocks seen from the neighbour at stencil offset (dy, dx): THE shift
    convention of the reference, shared by every neighbour table (a
    leading shard axis passes through)."""
    return g_ext[..., r + dy:r + dy + h, r + dx:r + dx + w, :n]


def neighbour_table_single(hist: torch.Tensor, t: int, stencil: StencilSpec,
                           grid_hw: tuple[int, int]) -> torch.Tensor:
    """The (C, O*N) delayed neighbour-spike table of a full (unsharded)
    grid: per active offset, the delayed history slice shifted by
    (dy, dx) with a zero boundary (the cortical sheet's edge)."""
    gh, gw = grid_hw
    d_slots, c_cols, n = hist.shape
    r = stencil.radius
    padded = {}                       # one zero-padded frame per delay
    per_offset = []
    for (dy, dx, _k, delay, _p) in stencil.offsets:
        if delay not in padded:
            g = hist.new_zeros((gh + 2 * r, gw + 2 * r, n))
            g[r:r + gh, r:r + gw] = hist[(t - delay) % d_slots].reshape(
                gh, gw, n)
            padded[delay] = g
        per_offset.append(offset_slice(padded[delay], dy, dx, r, gh, gw, n))
    if not per_offset:
        return hist.new_zeros((c_cols, 0))
    s_ext = torch.stack(per_offset, dim=2)                # (gh, gw, O, N)
    return s_ext.reshape(c_cols, stencil.n_offsets * n)


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

def drive_rate(cfg: DPSNNConfig, nu_scale=None):
    """The Poisson rate per neuron and step, C_ext * nu_ext * dt; with a
    tenant's ``nu_scale`` (a float, or a float32 tensor of them) the
    reference's ``float32(lam) * nu_scale`` in float32."""
    lam = cfg.c_ext * cfg.nu_ext_hz * cfg.neuron.dt_ms * 1e-3
    if nu_scale is None:
        return lam
    f32 = torch.float32
    lam32 = float(torch.tensor(lam, dtype=f32))    # exact in any float
    if isinstance(nu_scale, torch.Tensor):
        return nu_scale.to(f32) * lam32
    return float(torch.tensor(nu_scale, dtype=f32) * lam32)


def external_drive(cfg: DPSNNConfig, t: int, col_ids: torch.Tensor, *,
                   seed: int | None = None, nu_scale: float | None = None):
    """Poisson thalamo-cortical input: C_ext synapses at nu_ext each.

    Keyed per (seed, step, global column id) as the reference keys it, so
    the counts do not depend on what ran before or on which columns are
    drawn together. ``col_ids`` is a (C,) int32 tensor on the device to
    draw on: the ``keyed_drive`` kernel on the card, its plain version on
    the CPU. ``seed`` overrides ``cfg.seed`` and ``nu_scale`` scales the
    rate (a tenant of the batched service); both ``None`` is the
    single-tenant drive. Returns ``(currents, counts)``, both (C, N)
    float32.
    """
    return ops.keyed_drive(cfg.seed if seed is None else int(seed), t,
                           col_ids, cfg.neurons_per_column,
                           drive_rate(cfg, nu_scale), cfg.conn.j_ext)


def step_single(cfg: DPSNNConfig, params: NetworkParams, state: NetworkState,
                *, stencil: StencilSpec, grid_hw: tuple[int, int],
                col_ids: torch.Tensor, impl: str = "ref",
                ext_counts: torch.Tensor | None = None,
                silent_blocks: torch.Tensor | None = None,
                seed: int | None = None, nu_scale: float | None = None,
                chaos_nan: int | None = None) -> NetworkState:
    """One time step of the full (single-shard) network.

    ``col_ids`` are the state's (C,) int32 global column ids, on its
    device. ``ext_counts`` (C, N) are this step's Poisson counts, drawn
    by :func:`external_drive` when None (with ``seed`` and ``nu_scale``,
    a tenant's drive). ``silent_blocks`` (one int64 on the
    state's device), when given, gains the number of silent 128-source
    blocks the local delivery skipped (``impl`` 'cuda' and 'cuda_fused'
    count them in the kernel, 'ref' in plain PyTorch). ``chaos_nan`` (a
    step) overrides ``cfg.guard.chaos_nan_at_step``, as a tenant's poison.
    """
    d_slots = state.hist.shape[0]
    t = int(state.t)
    dtype = state.hist.dtype

    # 1. recurrent delivery from delayed history
    with span("step.table"):
        s_loc = state.hist[(t - cfg.conn.min_delay_steps) % d_slots]
        s_flat = neighbour_table_single(state.hist, t, stencil, grid_hw)

    # 2. external Poisson drive
    with span("step.drive"):
        if ext_counts is None:
            ext, ext_counts = external_drive(cfg, t, col_ids, seed=seed,
                                             nu_scale=nu_scale)
        else:
            ext = ext_counts.to(dtype) * cfg.conn.j_ext

    # 3. delivery + neuron update (one fused kernel, or three stages)
    new_stdp = state.stdp
    gflags = None
    with span("step.kernel"):
        if impl == "cuda_fused":
            lif, spikes, new_stdp, gflags = fused_stage(
                cfg, params, state.lif, state.stdp, s_loc, s_flat, ext,
                silent_blocks=silent_blocks)
        else:
            deliver_local, deliver_remote, lif_update = _stage_fns(impl)
            currents = deliver_local(s_loc, params.w_local,
                                     silent_blocks=silent_blocks)
            currents = currents + deliver_remote(s_flat, params.rem_flat,
                                                 params.rem_w)
            currents = currents + ext
            lif, spikes = lif_update(cfg.neuron, state.lif, currents)

    with span("step.post"):
        # 3b. integrity guard: the chaos NaN lands on the fresh membrane
        # state, so the verdict below sees it within the step; the
        # kernel's flags pre-date it and are dropped whenever chaos is
        # configured
        new_guard = state.guard
        if cfg.guard.enabled:
            gcfg = cfg.guard
            if gcfg.chaos_nan_at_step >= 0 or chaos_nan is not None:
                lif = lif._replace(v=integrity.inject_nan(
                    gcfg, t, lif.v, chaos_step=chaos_nan))
                gflags = None
            tr = new_stdp if cfg.stdp else None
            code = integrity.step_verdict(
                gcfg, v=lif.v, spikes=spikes,
                x_pre=None if tr is None else tr.x_pre,
                x_post=None if tr is None else tr.x_post,
                kernel_flags=gflags)
            new_guard = integrity.guard_update(gcfg, state.guard,
                                               step_code=code, t=t)

        # 4. write new spikes into (a copy of) the ring buffer
        hist = state.hist.clone()
        hist[t % d_slots] = spikes

        # 5. synaptic-event accounting (the paper's normalisation unit)
        k_tot = params.rem_w.shape[-1]
        events = ((spikes * (params.local_outdeg + k_tot)).sum()
                  + ext_counts.sum().to(torch.float32))

        return NetworkState(
            lif=lif,
            hist=hist,
            t=torch.tensor(t + 1, dtype=torch.int32),
            spike_count=state.spike_count + spikes.sum(),
            event_count=state.event_count + events,
            # unfused: the traces advance in the caller (simulation.run);
            # fused: the kernel advanced them, and the caller takes them
            stdp=new_stdp,
            guard=new_guard,
        )


def fused_stage(cfg: DPSNNConfig, params: NetworkParams, lif0: LIFState,
                stdp0, s_loc: torch.Tensor, s_flat: torch.Tensor,
                ext: torch.Tensor, *,
                silent_blocks: torch.Tensor | None = None):
    """The column step as one ``fused_step`` kernel (``stdp0`` the
    STDPState traces, or None with plasticity off). Returns ``(lif',
    spikes, stdp', gflags)``: ``stdp'`` the traces the kernel advanced
    under ``cfg.stdp`` (else ``stdp0``), ``gflags`` the kernel's
    per-column guard flags under ``cfg.guard.enabled`` (else None)."""
    scfg = cfg.stdp_cfg if cfg.stdp else None
    gcfg = cfg.guard if cfg.guard.enabled else None
    traces = (stdp0.x_pre, stdp0.x_post) if cfg.stdp else ()
    out = ops.fused_step(
        cfg.neuron, lif0.v, lif0.c, lif0.refrac, s_loc,
        params.w_local, s_flat, params.rem_flat, params.rem_w, ext, *traces,
        scfg=scfg, gcfg=gcfg, silent_blocks=silent_blocks)
    v, c, refrac, spikes = out[:4]
    stdp1 = stdp0
    if cfg.stdp:
        stdp1 = stdp0._replace(x_pre=out[4], x_post=out[5])
    gflags = out[-1] if gcfg is not None else None
    return LIFState(v=v, c=c, refrac=refrac), spikes, stdp1, gflags


def make_step_fn(cfg: DPSNNConfig, *, impl: str = "ref"):
    """Step function with the stencil and grid closed over."""
    check_supported(cfg, impl)
    stencil = build_stencil(cfg)
    grid_hw = (cfg.grid_h, cfg.grid_w)

    def step(params: NetworkParams, state: NetworkState,
             ext_counts: torch.Tensor | None = None) -> NetworkState:
        return step_single(cfg, params, state, stencil=stencil,
                           grid_hw=grid_hw,
                           col_ids=column_ids(cfg, state.hist.device),
                           impl=impl, ext_counts=ext_counts)

    return step
