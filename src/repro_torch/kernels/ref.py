"""Plain PyTorch versions of every kernel in this package.

``synapse_matmul_ref``, ``ell_gather_ref``, ``lif_step_ref`` and
``stdp_dense_update_ref`` are the counterparts of the oracles of the
same names in ``repro/kernels/ref.py``; ``fused_step_ref`` composes them
as the reference step does, with the STDP-trace and guard-flag
epilogues of ``repro/kernels/fused_step.py``. ``keyed_poisson_ref`` and
``stdp_remote_update_ref`` are plain jnp in the reference (the drive of
``core/network.py``, the remote rule of ``core/plasticity.py``). Each is
the version a kernel wrapper takes for a tensor on the CPU. On the card
``chip_smoke.py`` holds each CUDA kernel against it, and
``synapse_matmul`` also against ``synapse_matmul_chain_ref``, the same
product summed in the CUDA kernel's order and rounding. Products that the
reference accumulates in float32 (``preferred_element_type=jnp.float32``)
accumulate in float32 here.

Each takes the kernels' tenant axis too (the batched service): the
per-tenant inputs then have B * C rows, tenant after tenant, and a leaf
that the tenants share keeps its C rows. A version whose arithmetic
reduces (a product, a gather's sum) or gathers through a shared index
runs once per tenant (:func:`per_tenant`), so each tenant's result is the
single-tenant version's to the bit; the elementwise ones run on all rows
at once, which gives the same bits.
"""
from __future__ import annotations

import torch

BLK = 128   # source-block width of the block-event skip (csrc/kernels.cuh)
DRIVE_STREAM = 0xE57   # the drive's key: PRNGKey(seed + DRIVE_STREAM)


def tenants_of(rows: int, shared_rows: int, what: str) -> int:
    """B of a tenant-axis call: ``rows`` per-tenant rows (B * C) over the
    ``shared_rows`` (C) of a leaf the tenants share."""
    if shared_rows <= 0 or rows % shared_rows:
        raise ValueError(f"{what}: {rows} rows are not a whole number of "
                         f"tenants of {shared_rows} columns")
    return rows // shared_rows


def per_tenant(fn, tenants: int, rows: int, *xs):
    """``fn`` once per tenant, the results joined along the rows: each
    tensor of ``rows`` (B * C) rows is cut into the tenants' C rows, any
    other (a shared leaf of C rows, None) passes whole. A tuple result is
    joined leaf by leaf."""
    if tenants == 1:
        return fn(*xs)
    c = rows // tenants
    outs = [fn(*(x[i * c:(i + 1) * c]
                 if isinstance(x, torch.Tensor) and x.shape[0] == rows
                 else x for x in xs)) for i in range(tenants)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(leaf) for leaf in zip(*outs))
    return torch.cat(outs)


def synapse_matmul_ref(spikes: torch.Tensor, w_local: torch.Tensor
                       ) -> torch.Tensor:
    """Local synaptic delivery: (C,N) x (C,N,N)[src,tgt] -> (C,N); with
    (B*C, N) spikes, each tenant's over the shared weights."""
    b = tenants_of(spikes.shape[0], w_local.shape[0], "synapse_matmul")
    if b > 1:
        return per_tenant(synapse_matmul_ref, b, spikes.shape[0], spikes,
                          w_local)
    out = torch.einsum("cs,cst->ct", spikes.float(), w_local.float())
    return out.to(spikes.dtype)


def synapse_matmul_chain_ref(spikes: torch.Tensor, w_local: torch.Tensor
                             ) -> torch.Tensor:
    """``synapse_matmul_ref`` summed as the CUDA kernel sums it: for each
    target, one chain ``acc = fma(spikes[c, s], w[c, s, t], acc)`` from 0
    over the column's spiking sources in ascending order, each step
    rounded once to float32 (``__fmaf_rn``). The kernel's result, to the
    bit; float32 only."""
    b = tenants_of(spikes.shape[0], w_local.shape[0], "synapse_matmul")
    if b > 1:
        return per_tenant(synapse_matmul_chain_ref, b, spikes.shape[0],
                          spikes, w_local)
    c, n = spikes.shape
    active = spikes != 0
    counts = active.sum(dim=1)
    acc = torch.zeros(c, w_local.shape[-1], dtype=torch.float32,
                      device=spikes.device)
    if c == 0 or int(counts.max()) == 0:
        return acc
    # each column's spiking sources first, in ascending order
    order = torch.sort((~active).to(torch.int8), dim=1, stable=True).indices
    for k in range(int(counts.max())):
        live = (counts > k).nonzero().squeeze(1)
        src = order[live, k]
        acc[live] = _fma(spikes[live, src].unsqueeze(1), w_local[live, src],
                         acc[live])
    return acc


def ell_gather_ref(s_flat: torch.Tensor, idx: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Remote ELL delivery: gather+reduce.

    s_flat (C, T) neighbour-spike table, idx/w (C, N, K) -> (C, N); with
    (B*C, T) tables, each tenant's through the shared idx (and the shared
    weights, or its own of B*C rows).
    """
    b = tenants_of(s_flat.shape[0], idx.shape[0], "ell_gather")
    if b > 1:
        return per_tenant(ell_gather_ref, b, s_flat.shape[0], s_flat, idx, w)
    c, n, k = idx.shape
    g = torch.gather(s_flat, 1, idx.reshape(c, n * k).long())
    out = (g.reshape(c, n, k).float() * w.float()).sum(dim=-1)
    return out.to(s_flat.dtype)


def lif_constants(ncfg, dtype=torch.float32) -> dict:
    """The LIF+SFA constants as ``lif_step_ref`` and the kernels take them.

    The decays are ``exp`` evaluated in the state dtype, as
    ``core/neuron.py`` of the reference does (not a double-precision
    ``math.exp``). The exp-Euler gain ``(1 - decay_v) * (tau_m/dt)`` is
    folded once, in the state dtype, as XLA folds it in the reference;
    eager left-to-right evaluation of ``drive * (1 - decay_v) * (tau_m/dt)``
    would be a different product.
    """
    def f(x):
        return torch.tensor(x, dtype=dtype)

    dt = ncfg.dt_ms
    decay_v = torch.exp(f(-dt / ncfg.tau_m_ms))
    decay_c = torch.exp(f(-dt / ncfg.tau_c_ms))
    gain = (f(1.0) - decay_v) * f(ncfg.tau_m_ms / dt)
    return dict(decay_v=float(decay_v), decay_c=float(decay_c),
                gain=float(gain), g_c=float(f(ncfg.g_c)),
                alpha_c=float(f(ncfg.alpha_c)), v_rest=float(f(ncfg.v_rest)),
                v_reset=float(f(ncfg.v_reset)),
                v_threshold=float(f(ncfg.v_threshold)),
                arp_steps=round(ncfg.tau_arp_ms / dt))


def _f64(x):
    """A tensor as float64; a Python number stays a scalar (made a tensor
    on the card, it would be a copy the host waits for)."""
    return x.double() if isinstance(x, torch.Tensor) else float(x)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` for float32 ``a``, ``b``, ``c``, rounded once to
    float32 like a fused multiply-add (CUDA's ``__fmaf_rn``).

    The float64 product of two float32 values is exact. Its float64 sum
    with ``c`` is rounded to odd (TwoSum gives the sum's rounding error
    exactly; an inexact sum keeps the neighbour whose last bit is 1), so
    the one rounding to float32 that follows is the correct one: a plain
    float64 sum would round twice and miss now and then.
    """
    p = a.double() * _f64(b)
    c = _f64(c)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.to(a.dtype)


def _fma_sparse(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """:func:`_fma` for spike-gated terms, where most of ``a``, ``b`` or
    ``c`` are zero. Where one of the three is zero, ``a * b + c`` in
    float32 rounds at most once and so already is the fused result; the
    fused multiply-add is emulated only where all three are nonzero."""
    out = a * b + c
    a, b, c = torch.broadcast_tensors(
        a, torch.as_tensor(b, dtype=a.dtype, device=a.device), c)
    need = (a != 0) & (b != 0) & (c != 0)
    if bool(need.any()):
        out[need] = _fma(a[need], b[need], c[need])
    return out


def _fma_lr(y: torch.Tensor, lr: float, w: torch.Tensor) -> torch.Tensor:
    """``fma(lr, y, w)``: ``w + y`` when ``lr`` is 1, which rounds once
    as the fused multiply-add does."""
    return w + y if lr == 1.0 else _fma(y, lr, w)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's weak-typed Python
    constants are."""
    return float(torch.tensor(x, dtype=torch.float32))


def lif_step_ref(v, c, refrac, current, *, decay_v, decay_c, gain,
                 g_c, alpha_c, v_rest, v_reset, v_threshold, arp_steps):
    """Fused LIF+SFA update (mirrors core/neuron.py lif_sfa_step).

    The multiply-adds are grouped as XLA groups the reference's jitted
    step on the CPU: ``drive = fma(-g_c, c, cur)``,
    ``v1 = v_rest + fma(v - v_rest, decay_v, drive * gain)`` and
    ``c' = fma(c, decay_c, alpha_c * spikes)``; the CUDA kernels write the
    same grouping with ``__fmaf_rn``.
    """
    dtype = v.dtype
    drive = _fma(c, -g_c, current)
    v1 = v_rest + _fma(v - v_rest, decay_v, drive * gain)
    refractory = refrac > 0
    v1 = torch.where(refractory, torch.tensor(v_reset, dtype=dtype), v1)
    spikes_b = (v1 >= v_threshold) & (~refractory)
    spikes = spikes_b.to(dtype)
    v2 = torch.where(spikes_b, torch.tensor(v_reset, dtype=dtype), v1)
    c2 = _fma(c, decay_c, alpha_c * spikes)
    r2 = torch.where(spikes_b, torch.tensor(arp_steps, dtype=refrac.dtype),
                     torch.clamp(refrac - 1, min=0))
    return v2, c2, r2, spikes


def stdp_constants(scfg, dt_ms: float, dtype=torch.float32) -> dict:
    """The trace decays ``dp = exp(-dt/tau_plus)``, ``dm =
    exp(-dt/tau_minus)``, as ``exp`` in the state dtype (the reference's
    ``jnp.exp(...).astype(dtype)``; see :func:`lif_constants`)."""
    def decay(tau):
        return float(torch.exp(torch.tensor(-dt_ms / tau, dtype=dtype)))
    return dict(dp=decay(scfg.tau_plus_ms), dm=decay(scfg.tau_minus_ms))


def stdp_trace_ref(x: torch.Tensor, decay: float,
                   spikes: torch.Tensor) -> torch.Tensor:
    """Exponential trace decay and spike bump ``x * decay + spikes``,
    grouped as XLA groups it in the reference's jitted step: one fused
    multiply-add (the CUDA epilogue writes ``__fmaf_rn``)."""
    return _fma(x, decay, spikes)


# (C, N, N) elements per chunk of stdp_dense_update_ref: bounds its
# temporaries to a few GB at any grid size
_STDP_CHUNK = 1 << 26


def stdp_dense_update_ref(w_local, x_pre_exc, spk_exc, spikes, x_post, *,
                          a_plus, a_minus, lr, w_max, active=None):
    """Dense local STDP update (mirrors core/plasticity.py local branch):
    ``w' = where(w > 0, clip(w + lr*(a_plus*pot - a_minus*dep), 0, w_max),
    w)`` with ``pot[c,s,t] = x_pre_exc[c,s]*spikes[c,t]`` and
    ``dep[c,s,t] = spk_exc[c,s]*x_post[c,t]``.

    Grouped as XLA groups the reference (jitted ``ref`` and the Pallas
    kernel alike): ``w' = fma(lr, fma(a_plus, pot, -(a_minus*dep)), w)``
    before the clip, for any ``lr``. Out of place, a chunk of columns at
    a time. ``active`` ((B,) bool or int over tenants of C = rows / B
    columns), when given: an inactive tenant's weights come back as they
    were (:func:`tenant_rows`)."""
    a_plus, a_minus, lr, w_max = map(_f32, (a_plus, a_minus, lr, w_max))
    out = torch.empty_like(w_local)
    n_cols, n = spikes.shape
    keep = tenant_rows(active, n_cols)
    step = max(1, _STDP_CHUNK // max(1, n * n))
    for c0 in range(0, n_cols, step):
        cs = slice(c0, c0 + step)
        w = w_local[cs]
        pot = x_pre_exc[cs, :, None] * spikes[cs, None, :]
        dep = spk_exc[cs, :, None] * x_post[cs, None, :]
        new = _fma_lr(_fma_sparse(pot, a_plus, -(a_minus * dep)), lr, w)
        new = torch.where(w > 0, torch.clamp(new, 0.0, w_max), w)
        if keep is not None:
            new = torch.where(keep[cs, None, None], new, w)
        out[cs] = new
    return out


def tenant_rows(active, rows: int):
    """The (rows,) bool mask of the rows of the active tenants, ``active``
    a (B,) mask over tenants of rows / B rows each; None for None."""
    if active is None:
        return None
    b = active.shape[0]
    return (active != 0).repeat_interleave(tenants_of(rows, b, "active"))


def stdp_remote_update_ref(table, rem_flat, rem_w, spikes, x_post, *,
                          a_plus, a_minus, lr, w_max, active=None):
    """The remote ELL rule of the reference (``core/plasticity.py:115-133``),
    its ``* 0.5`` on the depression term kept as written:
    ``dw = lr * (a_plus*pre*spk - a_minus*pre*x_post*0.5)`` with ``pre``
    the (C, O*N) pre-trace ``table`` gathered through ``rem_flat`` (C, N, K)
    int32, ``spk`` and ``x_post`` each neuron's (C, N), then the clip on
    positive weights. Grouped as XLA rewrites and fuses it:
    ``fma(lr, fma(pre, spk*a_plus, -(pre*(x_post*a_minus))*0.5), rem_w)``.
    Out of place. Finding the rows of the neurons that spiked makes the
    host wait for the device once per call (once per tenant).

    Tenant axis: ``table``, ``spikes`` and ``x_post`` of B*C rows through
    the shared ``rem_flat`` (C rows), ``rem_w`` of C or B*C rows, the
    result of B*C rows; ``active`` as in :func:`stdp_dense_update_ref`."""
    kw = dict(a_plus=a_plus, a_minus=a_minus, lr=lr, w_max=w_max)
    rows = table.shape[0]
    b = tenants_of(rows, rem_flat.shape[0], "stdp_remote_update")
    if b > 1 or active is not None:
        out = per_tenant(
            lambda *xs: stdp_remote_update_ref(*xs, **kw), b, rows, table,
            rem_flat, rem_w, spikes, x_post)
        keep = tenant_rows(active, rows)
        if keep is None:
            return out
        if rem_w.shape[0] != rows:
            rem_w = rem_w.repeat(b, 1, 1)
        return torch.where(keep[:, None, None], out, rem_w)
    a_plus, a_minus, lr, w_max = map(_f32, (a_plus, a_minus, lr, w_max))
    c, n, k = rem_flat.shape
    pre = torch.gather(table, 1, rem_flat.reshape(c, n * k).long()
                       ).reshape(c * n, k)
    dep = pre * (x_post * a_minus).reshape(c * n, 1) * 0.5
    # a neuron that did not spike has spk*a_plus = 0, and there the FMA is
    # -dep exactly; it is emulated on the rows of the neurons that spiked
    y = -dep
    spk = spikes.reshape(c * n)
    rows = spk.nonzero().squeeze(1)
    y[rows] = _fma(pre[rows], (spk[rows] * a_plus)[:, None], -dep[rows])
    new = _fma_lr(y.reshape(c, n, k), lr, rem_w)
    return torch.where(rem_w > 0, torch.clamp(new, 0.0, w_max), rem_w)


def guard_flags_ref(v: torch.Tensor, v_floor: float,
                    v_ceil: float) -> torch.Tensor:
    """Per-column int32 guard flags of the fused step's epilogue: bit 0
    where a column's ``v`` holds a non-finite value, bit 1 where one lies
    outside ``[v_floor, v_ceil]``."""
    nan = (~torch.isfinite(v)).any(dim=-1)
    out = ((v < v_floor) | (v > v_ceil)).any(dim=-1)
    return nan.to(torch.int32) | (out.to(torch.int32) << 1)


def fused_step_ref(ncfg, v, c, refrac, s_loc, w_local, s_flat, rem_flat,
                   rem_w, ext, x_pre=None, x_post=None, *, scfg=None,
                   gcfg=None):
    """The column step: local product, + ELL gather, + external drive,
    then LIF+SFA. Returns ``(v', c', refrac', spikes)``; with ``scfg``
    the advanced traces ``(x_pre', x_post')`` follow, and with ``gcfg``
    the (C,) guard flags of ``v'`` (:func:`guard_flags_ref`)."""
    cur = synapse_matmul_ref(s_loc, w_local)
    cur = cur + ell_gather_ref(s_flat, rem_flat, rem_w)
    cur = cur + ext
    out = lif_step_ref(v, c, refrac, cur, **lif_constants(ncfg, v.dtype))
    spikes = out[3]
    if scfg is not None:
        k = stdp_constants(scfg, ncfg.dt_ms, v.dtype)
        out += (stdp_trace_ref(x_pre, k["dp"], spikes),
                stdp_trace_ref(x_post, k["dm"], spikes))
    if gcfg is not None:
        out += (guard_flags_ref(out[0], gcfg.v_floor, gcfg.v_ceil),)
    return out


def keyed_poisson_ref(seed: int, t: int, col_ids: torch.Tensor, n: int,
                      lam: float) -> torch.Tensor:
    """The reference's Poisson drive counts, (C, N) float32: for each
    global column id ``col_ids[c]``, ``jax.random.poisson`` of ``lam``
    over N neurons under the key ``fold_in(fold_in(PRNGKey(seed +
    DRIVE_STREAM), t), col_ids[c])``, as ``jax.vmap`` of the reference's
    ``external_drive`` gives them; on ``col_ids``' device."""
    # core.prng takes this module's _fma, so it is imported here
    from repro_torch.core import prng
    base = prng.fold_in(prng.prng_key(seed + DRIVE_STREAM, col_ids.device),
                        t)
    return prng.poisson(prng.fold_in(base, col_ids.long()), lam, (n,))


def keyed_poisson_tenants_ref(seeds, t, col_ids: torch.Tensor, n: int,
                              lam) -> torch.Tensor:
    """:func:`keyed_poisson_ref` of B tenants, (B*C, N): tenant b's under
    seed ``seeds[b]`` at step ``t[b]`` and rate ``lam[b]`` ((B,) tensors
    on the CPU, or sequences)."""
    return torch.cat([keyed_poisson_ref(int(s), int(tt), col_ids, n,
                                        float(lm))
                      for s, tt, lm in zip(seeds, t, lam)])


def silent_block_count(spikes: torch.Tensor) -> torch.Tensor:
    """Number of (column, 128-source block) pairs whose spike slice is all
    zero: the blocks whose weight rows the kernels never read."""
    c, n = spikes.shape
    pad = (-n) % BLK
    s = torch.nn.functional.pad(spikes, (0, pad)).reshape(c, -1, BLK)
    return (~(s != 0).any(dim=-1)).sum()
