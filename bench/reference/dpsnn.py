"""The plain reference of the DPSNN simulator: network, drive, step, STDP.

Plain PyTorch, written from the model's definition (arXiv:1511.09325
Sec. 2; DPSNN-STDP's pair rule) and the key schedule of its random
numbers, with no kernel, no import of the program under test and nothing
taken from the program's state. It rebuilds the network from the seed,
draws the Poisson drive, and steps LIF neurons with spike-frequency
adaptation over the local (dense, per column) and remote (ELL, lateral
stencil) synapses with axonal delays.

Summation order. The network is chaotic: a sum taken in another order
changes a spike within some tens of steps and the raster thereafter. So
the reference sums as the program states its sums, and is compared with
it to the bit:

* ``order="kernel"`` (the card): the local product of a target is one
  float32 chain over the column's spiking sources in ascending order;
  the remote sum of a target is, for each of 32 lanes, a float32 chain
  over its slots (lane l takes the 4-slot groups l, l + 32, ... when K
  is a multiple of 4, else the slots l, l + 32, ...), then a butterfly
  of the 32 lane sums (strides 16, 8, 4, 2, 1); the step's current is
  ``(local + remote) + drive``.
* ``order="plain"`` (the CPU): the products as ``einsum`` and
  ``(gathered * w).sum(-1)``, the sums the program's CPU path takes.

Every multiply-add that the model writes as one is rounded once
(:func:`prng.fma`). Spikes are exactly 0 or 1, so a chain of
``fma(spike, w, acc)`` is a chain of float32 adds of the weights of the
sources that spiked.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass

import torch

from bench.reference import prng
from bench.reference.prng import fma

REMOTE_STREAM = 0x9E3779B9   # added to both words of the network's key
INIT_STREAM = 0x51F          # added to the seed for the initial state
DRIVE_STREAM = 0xE57         # added to the seed for the Poisson drive
BUILD_CHUNK = 1 << 24        # elements per chunk of columns at build
LANES = 32


@dataclass
class Stencil:
    offsets: list        # [(dy, dx, K, delay)]
    k_total: int
    slot_offset: torch.Tensor   # (K_tot,) int32
    max_delay: int
    radius: int


def stencil(cfg: dict) -> Stencil:
    """The active lateral offsets after the probability cutoff, each with
    its fixed fan-in ``K = max(1, round(p * N))`` and axonal delay."""
    conn, n = cfg["conn"], cfg["neurons_per_column"]
    prof, r = conn["lateral_profile"], conn["radius"]
    entries = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            p = 0.0
            if prof in ("gaussian", "gauss_exp"):
                p += conn["amp_lateral"] * math.exp(
                    -(dy * dy + dx * dx) / (2.0 * conn["alpha_steps"] ** 2))
            if prof in ("exponential", "gauss_exp"):
                p += conn["amp_exp"] * math.exp(-math.hypot(dy, dx)
                                                / conn["lambda_steps"])
            if p >= conn["cutoff"]:
                k = max(1, round(p * n))
                delay = conn["min_delay_steps"] + int(round(
                    conn["delay_per_step"] * math.hypot(dy, dx)))
                entries.append((dy, dx, k, delay))
    slot = torch.cat([torch.full((k,), i, dtype=torch.int32)
                      for i, (_, _, k, _) in enumerate(entries)])
    return Stencil(
        offsets=entries, k_total=int(slot.shape[0]), slot_offset=slot,
        max_delay=max([conn["min_delay_steps"]]
                      + [d for (_, _, _, d) in entries]),
        radius=max(max(abs(dy), abs(dx)) for dy, dx, _, _ in entries))


def n_columns(cfg: dict) -> int:
    return cfg["grid_h"] * cfg["grid_w"]


def inhibitory(cfg: dict, device) -> torch.Tensor:
    n = cfg["neurons_per_column"]
    n_exc = round(cfg["conn"]["exc_fraction"] * n)
    return torch.arange(n, device=device) >= n_exc


def _efficacy(cfg, key, shape, inh_src):
    conn = cfg["conn"]
    jitter = 1.0 + conn["weight_cv"] * prng.truncated_normal(key, -2.0, 2.0,
                                                             shape)
    mag = torch.where(inh_src, -conn["g_balance"] * conn["j_exc"],
                      conn["j_exc"])
    return (mag * jitter).to(torch.float32)


@dataclass
class Network:
    w_local: torch.Tensor   # (C, N, N) [src, tgt]
    rem_src: torch.Tensor   # (C, N, K) int32: index into the (O*N,) table
    rem_w: torch.Tensor     # (C, N, K)
    outdeg: torch.Tensor    # (C, N) float32 local out-degree at build


def build(cfg: dict, seed: int, device) -> Network:
    """The network of ``seed``: per global column c, the local synapses
    (Bernoulli(p_local), no autapses) from ``fold_in(key(seed), c)`` and
    the remote ones (uniform sources per stencil slot) from
    ``fold_in(key(seed) + REMOTE_STREAM, c)``; efficacies by source type
    with a truncated-normal jitter."""
    st = stencil(cfg)
    n, kt, c = cfg["neurons_per_column"], st.k_total, n_columns(cfg)
    ids = torch.arange(c, dtype=torch.int64, device=device)
    key = prng.prng_key(seed, device)
    rkey = (key + REMOTE_STREAM) & prng.MASK
    inh = inhibitory(cfg, device)
    eye = torch.eye(n, dtype=torch.bool, device=device)
    w_local = torch.empty((c, n, n), dtype=torch.float32, device=device)
    rem_idx = torch.empty((c, n, kt), dtype=torch.int32, device=device)
    rem_w = torch.empty((c, n, kt), dtype=torch.float32, device=device)
    step = max(1, BUILD_CHUNK // (n * max(n, kt)))
    for c0 in range(0, c, step):
        chunk = ids[c0:c0 + step]
        cs = slice(c0, c0 + chunk.shape[0])
        keys = prng.split(prng.fold_in(key, chunk))
        mask = prng.bernoulli(keys[..., 0, :], cfg["conn"]["p_local"], (n, n))
        mask &= ~eye
        w = _efficacy(cfg, keys[..., 1, :], (n, n), inh[:, None])
        w_local[cs] = torch.where(mask, w, torch.zeros((), device=device))
        keys = prng.split(prng.fold_in(rkey, chunk))
        idx = prng.randint(keys[..., 0, :], (n, kt), 0, n)
        rem_idx[cs] = idx
        rem_w[cs] = _efficacy(cfg, keys[..., 1, :], (n, kt), inh[idx.long()])
    off = st.slot_offset.to(device)
    rem_src = off[None, None, :] * n + rem_idx
    return Network(w_local=w_local, rem_src=rem_src, rem_w=rem_w,
                   outdeg=(w_local != 0).sum(dim=-1).to(torch.float32))


@dataclass
class State:
    v: torch.Tensor
    c: torch.Tensor
    refrac: torch.Tensor
    hist: torch.Tensor          # (D, C, N) spike ring, slot t % D
    t: int
    spike_count: torch.Tensor   # float32 scalar
    event_count: torch.Tensor   # float32 scalar
    x_pre: torch.Tensor | None = None
    x_post: torch.Tensor | None = None

    LEAVES = ("v", "c", "refrac", "hist", "spike_count", "event_count",
              "x_pre", "x_post")

    def leaves(self) -> dict:
        return {k: getattr(self, k) for k in self.LEAVES
                if getattr(self, k) is not None}


def init_state(cfg: dict, seed: int, device, stdp: bool) -> State:
    """Potentials uniform in [v_rest, 0.95 v_threshold) from
    ``fold_in(key(seed + INIT_STREAM), c)``; everything else zero."""
    st = stencil(cfg)
    n, c = cfg["neurons_per_column"], n_columns(cfg)
    nc = cfg["neuron"]
    ids = torch.arange(c, dtype=torch.int64, device=device)
    keys = prng.fold_in(prng.prng_key(seed + INIT_STREAM, device), ids)
    v = prng.uniform(keys, (n,), nc["v_rest"], nc["v_threshold"] * 0.95)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    tr = (torch.zeros_like(v), torch.zeros_like(v)) if stdp else (None, None)
    return State(v=v, c=torch.zeros_like(v),
                 refrac=torch.zeros(v.shape, dtype=torch.int32, device=device),
                 hist=torch.zeros((st.max_delay + 1, c, n), device=device),
                 t=0, spike_count=zero.clone(), event_count=zero.clone(),
                 x_pre=tr[0], x_post=tr[1])


def drive_rate(cfg: dict, nu_scale: float | None = None) -> float:
    """Poisson events per neuron and step, ``C_ext * nu_ext * dt``; a
    tenant's ``nu_scale`` multiplies it in float32."""
    lam = cfg["c_ext"] * cfg["nu_ext_hz"] * cfg["neuron"]["dt_ms"] * 1e-3
    if nu_scale is None:
        return lam
    f32 = torch.float32
    return float(torch.tensor(nu_scale, dtype=f32)
                 * float(torch.tensor(lam, dtype=f32)))


def poisson_counts(seed: int, steps, c: int, n: int, lam: float, device,
                   compact: bool) -> torch.Tensor:
    """(len(steps), C, N) float32 Poisson counts of rate ``lam``: for
    step t and column c, Knuth's loop over the split chain of the key
    ``fold_in(fold_in(key(seed + DRIVE_STREAM), t), c)``, draw j from
    the j-th subkey at counter n, until the float32 sum of the logs of
    the draws is at or below ``-lam``; the count is the draws less one.

    ``compact`` draws only for the elements still going, a batch of
    steps at once (the card, where each operation is the same per
    element whatever the shape); else every element is carried through
    every round of one step at a time (the CPU, whose vector ``log``
    can round a tail element apart)."""
    if lam == 0.0:
        return torch.zeros((len(steps), c, n), device=device)
    neg = torch.tensor(-lam, dtype=torch.float32, device=device)
    base = prng.prng_key(seed + DRIVE_STREAM, device)
    ids = torch.arange(c, dtype=torch.int64, device=device)
    if not compact:
        out = []
        for t in steps:
            rng = prng.fold_in(prng.fold_in(base, int(t)), ids)
            count = torch.zeros((c, n), device=device)
            logp = torch.zeros_like(count)
            while True:
                live = logp > neg
                if not bool(live.any()):
                    break
                ks = prng.split(rng)
                rng, sub = ks[..., 0, :], ks[..., 1, :]
                count += live.to(torch.float32)
                logp = logp + torch.log(prng.bits_to_unit(
                    prng.random_bits(sub, (n,))))
            out.append(count - 1.0)
        return torch.stack(out)
    tk = prng.fold_in(base, torch.as_tensor(list(steps), dtype=torch.int64,
                                            device=device))
    rng = prng.fold_in(tk[:, None, :], ids[None, :]).reshape(-1, 2)
    total = rng.shape[0] * n
    count = torch.zeros(total, device=device)
    logp = torch.zeros(total, device=device)
    live = torch.arange(total, dtype=torch.int64, device=device)
    while live.numel():
        ks = prng.split(rng)
        rng, sub = ks[..., 0, :], ks[..., 1, :]
        count[live] += 1.0
        row = live // n
        y1, y2 = prng.threefry2x32(sub[row, 0], sub[row, 1],
                                   torch.zeros_like(live), live - row * n)
        lp = logp[live] + torch.log(prng.bits_to_unit(y1 ^ y2))
        logp[live] = lp
        live = live[lp > neg]
    return (count - 1.0).reshape(len(steps), c, n)


def lif_constants(nc: dict) -> dict:
    """The LIF+SFA constants in float32: decays as float32 ``exp``, the
    exponential-Euler gain ``(1 - decay_v) * (tau_m / dt)`` folded in
    float32."""
    def f(x):
        return torch.tensor(x, dtype=torch.float32)
    dt = nc["dt_ms"]
    decay_v = torch.exp(f(-dt / nc["tau_m_ms"]))
    return dict(decay_v=float(decay_v),
                decay_c=float(torch.exp(f(-dt / nc["tau_c_ms"]))),
                gain=float((f(1.0) - decay_v) * f(nc["tau_m_ms"] / dt)),
                g_c=float(f(nc["g_c"])), alpha_c=float(f(nc["alpha_c"])),
                v_rest=float(f(nc["v_rest"])),
                v_reset=float(f(nc["v_reset"])),
                v_thr=float(f(nc["v_threshold"])),
                arp=round(nc["tau_arp_ms"] / dt))


def lif(k: dict, v, c, refrac, cur):
    """One dt of LIF with spike-frequency adaptation:
    ``drive = fma(-g_c, c, cur)``,
    ``v1 = v_rest + fma(v - v_rest, decay_v, drive * gain)``, held at
    v_reset while refractory, a spike at ``v1 >= v_thr``,
    ``c' = fma(c, decay_c, alpha_c * spike)``."""
    drive = fma(c, -k["g_c"], cur)
    v1 = k["v_rest"] + fma(v - k["v_rest"], k["decay_v"], drive * k["gain"])
    refr = refrac > 0
    reset = torch.tensor(k["v_reset"], dtype=v.dtype, device=v.device)
    v1 = torch.where(refr, reset, v1)
    fired = (v1 >= k["v_thr"]) & ~refr
    spikes = fired.to(v.dtype)
    return (torch.where(fired, reset, v1),
            fma(c, k["decay_c"], k["alpha_c"] * spikes),
            torch.where(fired, torch.tensor(k["arp"], dtype=refrac.dtype,
                                            device=v.device),
                        torch.clamp(refrac - 1, min=0)),
            spikes)


def neighbour_table(cfg: dict, st: Stencil, frames) -> torch.Tensor:
    """(C, O*N): per active offset (dy, dx), the frame ``frames(delay)``
    ((C, N), the spikes of that delay, or a trace) of the column at
    (y + dy, x + dx), zero beyond the sheet's edge."""
    gh, gw, n = cfg["grid_h"], cfg["grid_w"], cfg["neurons_per_column"]
    r = st.radius
    padded, cols = {}, []
    for (dy, dx, _k, delay) in st.offsets:
        if delay not in padded:
            f = frames(delay)
            g = f.new_zeros((gh + 2 * r, gw + 2 * r, n))
            g[r:r + gh, r:r + gw] = f.reshape(gh, gw, n)
            padded[delay] = g
        cols.append(padded[delay][r + dy:r + dy + gh, r + dx:r + dx + gw])
    return torch.stack(cols, dim=2).reshape(gh * gw, len(st.offsets) * n)


def local_sum(s_loc, w_local, order: str) -> torch.Tensor:
    """(C, N): each target's sum of the weights from the column's spiking
    sources. In kernel order the chains of all columns advance together:
    the columns sorted by their spike count, round j adds the j-th
    spiking source's row of each column that has one."""
    if order == "plain":
        return torch.einsum("cs,cst->ct", s_loc.float(), w_local.float())
    c, n = s_loc.shape
    dev = s_loc.device
    active = s_loc != 0
    cnt = active.sum(dim=1)
    by = torch.sort(cnt, descending=True, stable=True)
    counts = by.values.cpu().tolist()
    acc = torch.zeros((c, w_local.shape[-1]), device=dev)
    kmax = counts[0] if c else 0
    if kmax == 0:
        return acc
    cols = by.indices
    src = torch.sort((~active[cols]).to(torch.int8), dim=1,
                     stable=True).indices[:, :kmax]          # (C, kmax)
    rows = cols[:, None] * n + src
    live = torch.arange(kmax, device=dev)[None, :] < by.values[:, None]
    order_rows = rows.t()[live.t()]          # round after round
    g = w_local.reshape(c * n, -1).index_select(0, order_rows)
    asc = counts[::-1]
    m = [c - bisect.bisect_right(asc, j) for j in range(kmax)]  # round j
    off = 0
    for j in range(kmax):
        acc[:m[j]].add_(g[off:off + m[j]])
        off += m[j]
    out = torch.empty_like(acc)
    out[cols] = acc
    return out


def flat_index(rem_src: torch.Tensor, table_len: int) -> torch.Tensor:
    """(C*N*K,) int32 indices of the remote synapses' sources into the
    flattened (C * O*N,) table."""
    c = rem_src.shape[0]
    base = torch.arange(c, dtype=torch.int32,
                        device=rem_src.device)[:, None, None] * table_len
    return (base + rem_src).reshape(-1)


def remote_sum(table, gidx, rem_w, order: str) -> torch.Tensor:
    """(C, N): each target's sum over its K remote synapses of the table
    entry its source reads (``gidx``, :func:`flat_index`) times the
    weight."""
    c, n, k = rem_w.shape
    x = table.reshape(-1).index_select(0, gidx).reshape(c * n, k)
    x = x * rem_w.reshape(c * n, k)
    if order == "plain":
        return x.sum(dim=-1).reshape(c, n)
    if k % 4 == 0:      # lane l: 4-slot groups l, l + 32, ...
        groups, width = k // 4, 4
    else:               # lane l: slots l, l + 32, ...
        groups, width = k, 1
    x = x.reshape(c * n, groups, width)
    acc = torch.zeros((c * n, LANES), device=table.device)
    for g0 in range(0, groups, LANES):
        lanes = min(LANES, groups - g0)
        for e in range(width):
            acc[:, :lanes].add_(x[:, g0:g0 + lanes, e])
    h = LANES
    while h > 1:
        h //= 2
        acc = acc[:, :h] + acc[:, h:2 * h]
    return acc[:, 0].reshape(c, n)


def stdp_constants(cfg: dict) -> dict:
    s, dt = cfg["stdp_cfg"], cfg["neuron"]["dt_ms"]

    def f32(x):
        return float(torch.tensor(x, dtype=torch.float32))
    return dict(
        dp=float(torch.exp(torch.tensor(-dt / s["tau_plus_ms"]))),
        dm=float(torch.exp(torch.tensor(-dt / s["tau_minus_ms"]))),
        a_plus=f32(s["a_plus"]), a_minus=f32(s["a_minus"]), lr=f32(s["lr"]),
        w_max=f32(s["w_max_factor"] * cfg["conn"]["j_exc"]))


def _stdp_rule(w, pot, dep, k):
    """``where(w > 0, clip(w + lr * (a_plus * pot - a_minus * dep), 0,
    w_max), w)`` with ``fma(a_plus, pot, -(a_minus * dep))`` and the
    learning rate as one more multiply-add (an add at lr = 1)."""
    y = fma(pot, k["a_plus"], -(k["a_minus"] * dep))
    new = w + y if k["lr"] == 1.0 else fma(y, k["lr"], w)
    return torch.where(w > 0, torch.clamp(new, 0.0, k["w_max"]), w)


def stdp_local_(w, x_pre_exc, spk_exc, spikes, x_post, k):
    """The dense local rule in place on ``w`` (C, N, N): potentiation
    ``x_pre_exc[s] * spikes[t]`` and depression ``spk_exc[s] *
    x_post[t]`` are both zero outside the rows and the columns of the
    neurons that spiked, where the rule leaves a weight as it is; so the
    rule is applied to those rows and columns alone, each (column,
    neuron) that spiked giving one row and one column."""
    c, n = spikes.shape
    pairs = (spikes != 0).nonzero()
    if pairs.shape[0] == 0:
        return w
    cl, sl = pairs[:, 0], pairs[:, 1]
    flat = w.view(c * n, n)
    rows = cl * n + sl
    new_r = _stdp_rule(flat.index_select(0, rows),
                       x_pre_exc[cl, sl][:, None] * spikes[cl],
                       spk_exc[cl, sl][:, None] * x_post[cl], k)
    new_c = _stdp_rule(w[cl, :, sl], x_pre_exc[cl] * spikes[cl, sl][:, None],
                       spk_exc[cl] * x_post[cl, sl][:, None], k)
    flat[rows] = new_r
    w[cl, :, sl] = new_c
    return w


def stdp_remote(table, gidx, rem_w, spikes, x_post, k):
    """The remote rule: ``dw = lr * (a_plus * pre * spike - a_minus *
    pre * x_post * 0.5)`` with ``pre`` the previous step's pre-trace
    gathered through the ELL index (``gidx``, :func:`flat_index`), as
    ``fma(pre, spike * a_plus, -((pre * (x_post * a_minus)) * 0.5))``,
    then the clip on positive weights. Returns new weights."""
    c, n, kk = rem_w.shape
    pre = table.reshape(-1).index_select(0, gidx).reshape(c * n, kk)
    dep = pre * (x_post * k["a_minus"]).reshape(c * n, 1) * 0.5
    y = -dep
    spk = spikes.reshape(c * n)
    rows = spk.nonzero().squeeze(1)
    y[rows] = fma(pre[rows], (spk[rows] * k["a_plus"])[:, None], -dep[rows])
    w = rem_w.reshape(c * n, kk)
    new = w + y if k["lr"] == 1.0 else fma(y, k["lr"], w)
    return torch.where(w > 0, torch.clamp(new, 0.0, k["w_max"]),
                       w).reshape(c, n, kk)


class Sim:
    """The reference simulation of one network: ``advance(state, steps)``
    steps a state in place, with its own drive and, under ``stdp``, the
    weights as dynamical state (``net`` is updated in place)."""

    DRIVE_BATCH = 64

    def __init__(self, cfg: dict, net: Network, *, stdp: bool, order: str,
                 seed: int, nu_scale: float | None = None):
        self.cfg, self.net, self.stdp, self.order = cfg, net, stdp, order
        self.seed = seed
        self.st = stencil(cfg)
        self.lam = drive_rate(cfg, nu_scale)
        self.k = lif_constants(cfg["neuron"])
        self.sk = stdp_constants(cfg) if stdp else None
        dev = net.w_local.device
        self.exc = (~inhibitory(cfg, dev)).to(torch.float32)
        self.compact = dev.type == "cuda"
        self.gidx = flat_index(net.rem_src,
                               len(self.st.offsets) * cfg["neurons_per_column"])

    def advance(self, s: State, steps: int, on_step=None) -> State:
        """``steps`` steps of ``s``, in place; ``on_step(spikes)`` after
        each."""
        cfg, st, net = self.cfg, self.st, self.net
        c, n = s.v.shape
        d = s.hist.shape[0]
        j_ext = cfg["conn"]["j_ext"]
        min_delay = cfg["conn"]["min_delay_steps"]
        done = 0
        while done < steps:
            b = min(self.DRIVE_BATCH, steps - done)
            counts = poisson_counts(self.seed, range(s.t, s.t + b), c, n,
                                    self.lam, s.v.device, self.compact)
            for i in range(b):
                t = s.t
                table = neighbour_table(cfg, st,
                                        lambda dl: s.hist[(t - dl) % d])
                cur = (local_sum(s.hist[(t - min_delay) % d], net.w_local,
                                 self.order)
                       + remote_sum(table, self.gidx, net.rem_w,
                                    self.order))
                cur = cur + counts[i] * j_ext
                v, cc, r, spikes = lif(self.k, s.v, s.c, s.refrac, cur)
                if self.stdp:
                    self._plasticity(s, spikes)
                s.v, s.c, s.refrac = v, cc, r
                s.hist[t % d] = spikes
                events = ((spikes * (net.outdeg + st.k_total)).sum()
                          + counts[i].sum().to(torch.float32))
                s.spike_count = s.spike_count + spikes.sum()
                s.event_count = s.event_count + events
                s.t = t + 1
                if on_step is not None:
                    on_step(spikes)
            done += b
        return s

    def _plasticity(self, s: State, spikes):
        k, net = self.sk, self.net
        table = neighbour_table(self.cfg, self.st, lambda _dl: s.x_pre)
        x_pre = fma(s.x_pre, k["dp"], spikes)
        x_post = fma(s.x_post, k["dm"], spikes)
        stdp_local_(net.w_local, x_pre * self.exc[None, :],
                    spikes * self.exc[None, :], spikes, x_post, k)
        net.rem_w = stdp_remote(table, self.gidx, net.rem_w, spikes,
                                x_post, k)
        s.x_pre, s.x_post = x_pre, x_post
