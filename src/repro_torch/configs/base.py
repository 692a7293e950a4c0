"""Config dataclasses of the PyTorch port.

A copy (fields, defaults and derived properties verbatim) of
``repro/configs/base.py``: the DPSNN half (``NeuronConfig`` ..
``DPSNNConfig`` with its derived Table-1 bookkeeping) and the LM-zoo
half (``MoEConfig``, ``SSMConfig``, ``AttnConfig``, ``ModelConfig`` with
``head_dim``, ``param_count`` and ``active_param_count``,
``ShapeConfig``, ``SHAPES`` and ``TrainConfig``). The port keeps its own
copy so that it imports nothing of the JAX package;
``tests/test_torch_connectivity.py`` holds the DPSNN classes equal to
the reference's field by field and property by property, and
``tests/test_torch_lm_configs.py`` the LM classes and every arch config.

Everything is a frozen dataclass so configs hash and compare by value.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# DPSNN (the paper)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NeuronConfig:
    """LIF neuron with spike-frequency adaptation (SFA).

    The AHP (after-hyper-polarizing) adaptation current follows Gigante,
    Mattia, Del Giudice (PRL 2007): ``dc/dt = -c/tau_c + alpha_c * spikes``,
    subtracted from the input current with gain ``g_c``.
    """
    tau_m_ms: float = 20.0        # membrane time constant
    tau_c_ms: float = 300.0       # adaptation (Ca) time constant
    alpha_c: float = 1.0          # adaptation increment per spike
    g_c: float = 0.35             # adaptation current gain
    v_threshold: float = 20.0     # spike threshold
    v_reset: float = 10.0         # post-spike reset
    v_rest: float = 0.0
    tau_arp_ms: float = 2.0       # absolute refractory period
    dt_ms: float = 1.0            # simulation step


@dataclass(frozen=True)
class ConnectivityConfig:
    """Paper Sec. 2 connectivity, plus the lineage papers' lateral families.

    * local (intra-column) probability ``p_local`` = 0.8
    * lateral probability is a sum of up to two decay profiles selected by
      ``lateral_profile`` (the follow-up papers arXiv:1512.05264 /
      arXiv:1803.08833 study exactly these families):

      - ``"gaussian"``     : ``A_g * exp(-r^2 / (2 alpha^2))`` (2015 paper)
      - ``"exponential"``  : ``A_e * exp(-r / lambda)`` (long-range decay)
      - ``"gauss_exp"``    : the sum of both (short-range Gaussian +
        long-range exponential tail — the 30G-synapse scenario class)

      with ``r`` in grid steps; cut off below ``cutoff`` (paper: 1/1000),
      bounded by a ``(2*radius+1)^2`` stencil (2015 paper: 7x7, radius 3).
      The *realized* halo radius is derived from the active offsets after
      the cutoff (``StencilSpec.radius``) — the Gaussian default activates
      only a 5x5 interior, while an exponential tail genuinely reaches
      ``radius`` (multi-ring halo exchange, DESIGN.md §2).

    ``alpha_steps`` defaults to 0.9 grid steps: the paper states "~100 um"
    (1.0 step) but its realized fan-in (~250 remote synapses/neuron, 1239-1245
    total) is matched by 0.9 — see DESIGN.md §2 for the calibration.
    """
    p_local: float = 0.8
    lateral_profile: str = "gaussian"  # gaussian | exponential | gauss_exp
    amp_lateral: float = 0.05     # A_g (Gaussian amplitude)
    alpha_steps: float = 0.9      # Gaussian width in units of grid steps
    amp_exp: float = 0.0          # A_e (exponential amplitude)
    lambda_steps: float = 2.0     # exponential decay length (grid steps)
    cutoff: float = 1e-3          # min connection probability
    radius: int = 3               # stencil bound (7x7 for the 2015 paper)
    exc_fraction: float = 0.8     # 80% RS excitatory / 20% FS inhibitory
    # synaptic efficacies (source-type based). Inhibitory weights are
    # ``-g_balance * j_exc``.
    j_exc: float = 0.42
    g_balance: float = 4.5
    j_ext: float = 0.60           # external (thalamo-cortical) efficacy
    min_delay_steps: int = 1      # intra-column synaptic delay
    delay_per_step: float = 1.0   # extra axonal delay per grid-step distance
    weight_cv: float = 0.25       # lognormal-ish weight jitter (coeff of var.)
    # ---- spike-halo wire format (DESIGN.md §AER) ----
    # "dense_packed": activity-independent bit-packed frames (32 neurons
    # per uint32 word — the original behaviour). "aer_sparse": the source
    # paper's event-driven exchange — fixed-capacity
    # (count:int32, addresses:int32[cap]) event lists whose payload scales
    # with the firing-rate *bound*, not the neuron count. Both modes are
    # bitwise-equal while no send saturates its capacity.
    exchange_mode: str = "dense_packed"   # dense_packed | aer_sparse
    # static AER capacity per send: ceil(aer_capacity_factor * expected
    # events at aer_rate_bound_hz) int32 address slots (DESIGN.md §AER
    # capacity math). Sends whose true event count exceeds the capacity
    # truncate AND raise the per-step saturation flag in DistResult —
    # silent drops are forbidden.
    aer_rate_bound_hz: float = 12.0
    aer_capacity_factor: float = 2.0


@dataclass(frozen=True)
class ExchangeConfig:
    """Halo-exchange *scheduling* knobs (DESIGN.md §Fusion).

    The wire format lives on :class:`ConnectivityConfig`
    (``exchange_mode`` / ``aer_*``); this config owns when the
    exchange runs relative to compute. With ``pipelined=True`` the
    distributed step defers consumption of the exchanged spike table by
    one full step: the ring-``ppermute`` halo exchange for the spikes of
    step ``t`` is launched concurrently with the compute of step ``t+1``
    and only written into the (double-buffered) halo-extended history
    ring at ``t+1`` — legal because the axonal-delay ring serves every
    remote read at delay >= 2, so the deferred slot is never read
    earlier. Bitwise-equal to the unpipelined schedule (identical values
    arrive at identical reads; only the collective's completion deadline
    moves a full step of compute later). Rejected at trace time when the
    stencil carries no delay at all (``stencil.max_delay == 0``).

    ``exchange_mode`` here is the *selection policy* layered over the
    wire formats: ``"inherit"`` uses ``conn.exchange_mode`` uniformly
    for every ring (the original behaviour); ``"auto"`` picks the wire
    format **per halo ring** as the argmin of the exact byte accounting
    in runtime/compression.py (``ring_mode_table``) at the configured
    ``conn.aer_rate_bound_hz`` — each (phase, ring) send independently
    ships whichever of dense-packed / AER is fewer bytes. Under
    ``"auto"`` (and under the hierarchical exchange) the STDP trace
    side payload always rides as a dense f32 strip regardless of the
    spike wire format, so per-ring selection never changes plastic
    values (DESIGN.md §Hierarchy).
    """
    pipelined: bool = False       # cross-step pipelined halo exchange
    exchange_mode: str = "inherit"   # inherit | auto (per-ring selection)


@dataclass(frozen=True)
class STDPConfig:
    """Pair-based STDP with exponential traces (DESIGN.md §Plasticity).

    DPSNN-STDP makes plasticity a first-class engine feature; the 2015
    scaling paper disables it for the reported measurements, so the
    switch (``DPSNNConfig.stdp``) defaults to off while the machinery
    stays wired through both the single-shard and distributed paths.
    """
    tau_plus_ms: float = 20.0
    tau_minus_ms: float = 20.0
    a_plus: float = 0.01
    a_minus: float = 0.012      # slight depression bias (stability)
    lr: float = 1.0
    w_max_factor: float = 2.0   # clip at w_max_factor * j_exc


@dataclass(frozen=True)
class GuardConfig:
    """In-band integrity guard (DESIGN.md §Integrity).

    With ``enabled=False`` (the default) the simulator is byte-for-byte
    the pre-guard engine: no guard state is allocated, no checks are
    traced, and checkpoints/benchmark rows are unchanged. With
    ``enabled=True`` every jitted step accumulates invariant checks in
    the scan carry — NaN/Inf in the membrane state and STDP traces,
    membrane-voltage bounds, a per-step spike-count ceiling, AER
    saturation escalated from "flagged" to "tripped" after
    ``aer_sat_trip_steps`` consecutive saturated steps — and every halo
    frame ships a position-weighted checksum word verified on receive.

    The ``chaos_*`` fields are deterministic corruption injectors for
    CI (mirroring the supervisor's ``--chaos-kill-rank``): they flip one
    bit of one received halo word or poison one membrane voltage with
    NaN at a fixed step, so the detection path is exercised end-to-end.
    They are static config — a restarted worker simply omits them.
    """
    enabled: bool = False
    # --- invariant monitors ---
    v_floor: float = -500.0       # generous bounds: a healthy run never
    v_ceil: float = 500.0         # leaves [v_floor, v_ceil] (threshold=20)
    max_spike_fraction: float = 0.5   # per-step ceiling on fraction firing
    aer_sat_trip_steps: int = 3   # consecutive saturated steps before trip
    # --- halo-frame checksums ---
    halo_checksum: bool = True
    # --- deterministic corruption injection (CI chaos) ---
    chaos_flip_ring: int = -1     # send ordinal within the step (-1 = off)
    chaos_flip_step: int = -1     # simulation step at which to flip
    chaos_flip_word: int = 0      # payload word index to corrupt
    chaos_nan_at_step: int = -1   # poison one membrane voltage (-1 = off)


@dataclass(frozen=True)
class DPSNNConfig:
    """A full simulator problem instance (one of the paper's grids)."""
    name: str = "dpsnn"
    grid_h: int = 24
    grid_w: int = 24
    neurons_per_column: int = 1240
    c_ext: int = 540              # external synapses per neuron
    nu_ext_hz: float = 3.0        # rate per external synapse
    neuron: NeuronConfig = field(default_factory=NeuronConfig)
    conn: ConnectivityConfig = field(default_factory=ConnectivityConfig)
    exchange: ExchangeConfig = field(default_factory=ExchangeConfig)
    stdp: bool = False            # plasticity off for the paper's measurements
    stdp_cfg: STDPConfig = field(default_factory=STDPConfig)
    guard: GuardConfig = field(default_factory=GuardConfig)
    seed: int = 42
    dtype: str = "float32"        # state dtype
    weight_dtype: str = "float32"

    # ---- derived quantities (paper Table 1 bookkeeping) ----
    @property
    def n_columns(self) -> int:
        return self.grid_h * self.grid_w

    @property
    def n_neurons(self) -> int:
        return self.n_columns * self.neurons_per_column

    def stencil_offsets(self) -> list[tuple[int, int, float]]:
        """Active (dy, dx, probability) stencil entries (cutoff applied).

        Probability follows ``conn.lateral_profile``: Gaussian short-range
        decay, exponential long-range decay, or their sum (the families of
        arXiv:1512.05264 / arXiv:1803.08833). Offsets whose summed
        probability falls below ``cutoff`` are inactive — the realized halo
        radius (max |dy|, |dx| over active offsets) can therefore be
        smaller than the ``conn.radius`` stencil bound.
        """
        profile = self.conn.lateral_profile
        if profile not in ("gaussian", "exponential", "gauss_exp"):
            raise ValueError(f"unknown lateral_profile {profile!r}")
        out = []
        r = self.conn.radius
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dy == 0 and dx == 0:
                    continue
                p = 0.0
                if profile in ("gaussian", "gauss_exp"):
                    rr = (dy * dy + dx * dx) / (
                        2.0 * self.conn.alpha_steps ** 2)
                    p += self.conn.amp_lateral * math.exp(-rr)
                if profile in ("exponential", "gauss_exp"):
                    p += self.conn.amp_exp * math.exp(
                        -math.hypot(dy, dx) / self.conn.lambda_steps)
                if p >= self.conn.cutoff:
                    out.append((dy, dx, p))
        return out

    @property
    def stencil_radius(self) -> int:
        """Realized halo radius: max |dy|, |dx| over *active* offsets."""
        offs = self.stencil_offsets()
        if not offs:
            return 0
        return max(max(abs(dy), abs(dx)) for dy, dx, _ in offs)

    def remote_fanin_per_offset(self) -> list[tuple[int, int, int]]:
        """(dy, dx, K) fixed fan-in per stencil offset (ELL layout)."""
        return [
            (dy, dx, max(1, round(p * self.neurons_per_column)))
            for dy, dx, p in self.stencil_offsets()
        ]

    @property
    def local_fanin(self) -> int:
        # expected intra-column synapses per neuron (no self-connection)
        return round(self.conn.p_local * (self.neurons_per_column - 1))

    @property
    def remote_fanin(self) -> int:
        return sum(k for _, _, k in self.remote_fanin_per_offset())

    @property
    def recurrent_synapses(self) -> int:
        return self.n_neurons * (self.local_fanin + self.remote_fanin)

    @property
    def total_equivalent_synapses(self) -> int:
        return self.recurrent_synapses + self.n_neurons * self.c_ext

    @property
    def max_delay_steps(self) -> int:
        r = self.stencil_radius
        return self.conn.min_delay_steps + int(
            math.ceil(self.conn.delay_per_step * math.hypot(r, r))
        )


# ---------------------------------------------------------------------------
# LM architecture zoo
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts (0 = dense FFN)
    top_k: int = 1
    num_shared: int = 0           # always-on shared experts (llama4 style)
    every: int = 1                # MoE layer stride (2 = alternate dense/MoE)
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128            # mamba2 N
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256              # SSD chunk length


@dataclass(frozen=True)
class AttnConfig:
    num_heads: int = 16
    num_kv_heads: int = 16
    head_dim: int = 0             # 0 -> d_model // num_heads
    rope_theta: float = 10000.0
    qk_norm: bool = False         # qwen3
    logit_softcap: float = 0.0    # gemma2: 50. on attn logits
    sliding_window: int = 0       # gemma2 local layers
    local_global_pattern: int = 0 # gemma2: 2 => alternate local/global


@dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture. ``family`` picks the stack of blocks."""
    name: str = "model"
    family: str = "dense"         # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int = 12
    d_model: int = 1024
    d_ff: int = 4096
    vocab_size: int = 32000
    attn: AttnConfig = field(default_factory=AttnConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # gemma2 extras
    final_logit_softcap: float = 0.0
    post_norms: bool = False      # gemma2 sandwich norms
    act: str = "silu"             # silu | gelu | geglu
    tie_embeddings: bool = True
    # enc-dec (whisper)
    num_decoder_layers: int = 0   # >0 => encoder-decoder
    # hybrid (zamba2): one shared attention block every `shared_every` blocks
    shared_every: int = 0
    # frontend stubs
    frontend: str = "none"        # none | audio_frames | vision_patches
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "block"          # none | block | full
    # which shapes this arch skips (see DESIGN.md §6)
    skip_shapes: Tuple[str, ...] = ()

    @property
    def head_dim(self) -> int:
        return self.attn.head_dim or self.d_model // self.attn.num_heads

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        n_q = self.attn.num_heads * self.head_dim
        n_kv = self.attn.num_kv_heads * self.head_dim
        attn = d * n_q + 2 * d * n_kv + n_q * d
        if self.act == "geglu" or self.act == "silu":
            ffn_dense = 3 * d * f
        else:
            ffn_dense = 2 * d * f
        total = emb
        if self.family == "ssm":
            inner = self.ssm.expand * d
            heads = inner // self.ssm.head_dim
            blk = d * (2 * inner + 2 * heads * self.ssm.d_state  # x,z,B,C
                       ) + inner * d + heads + inner  # out, A, dt, D-ish
            total += self.num_layers * blk
            return total
        for layer in range(self.num_layers):
            is_moe = (
                self.moe is not None
                and self.moe.num_experts > 0
                and layer % self.moe.every == (self.moe.every - 1)
            )
            if is_moe:
                total += attn + ffn_dense * (self.moe.num_experts + self.moe.num_shared)
                total += d * self.moe.num_experts  # router
            else:
                total += attn + ffn_dense
        if self.num_decoder_layers:
            total += self.num_decoder_layers * (2 * attn + ffn_dense)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None or self.moe.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        d, f = self.d_model, self.d_ff
        ffn = 3 * d * f if self.act in ("silu", "geglu") else 2 * d * f
        n_moe_layers = sum(
            1 for layer in range(self.num_layers)
            if layer % self.moe.every == (self.moe.every - 1)
        )
        inactive = n_moe_layers * ffn * (
            self.moe.num_experts - self.moe.top_k
        )
        return full - inactive


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set) and meshes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str = "train_4k"
    seq_len: int = 4096
    global_batch: int = 256
    kind: str = "train"           # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"      # adamw | adafactor | adamw8bit
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    microbatch: int = 0           # 0 = no gradient accumulation
    accum_dtype: str = "float32"  # bfloat16 for the very largest models
    grad_compression: str = "none"  # none | int8_ef
