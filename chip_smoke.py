#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``src/repro_torch/csrc`` from the checkout,
then, on the card:

1. holds every kernel against its plain PyTorch version at the main
   path's shapes (inputs from a real 24x24-grid state after 20 steps,
   static and plastic, and random ones), at ragged shapes, on all-silent
   spikes and on a table wider than the shared-memory budget of the
   staged path (``ell_gather`` and all four ``fused_step`` instances on
   their wide path), and times each (kernel, plain version, one library
   call where there is one, and the bound); ``stdp_dense_update`` and
   the fused step's STDP-trace and guard-flag epilogues are held to the
   bit, and so is ``synapse_matmul``, against the float32 fused
   multiply-add chain over each column's spiking sources in ascending
   order (real, random and ragged inputs, and the real state with one
   column in which every source spikes); ``keyed_drive``, the port's
   kernel with no Pallas counterpart (the reference's Poisson drive,
   keyed per step and global column id), is held to the bit against its
   plain version at the main shapes (steps 0, 1, 20 and 2**31 - 1, and
   rates 9.9 and 0), at ragged shapes, on one column of 1, 33, 1240 and
   of the most and one more neurons than one CTA takes, and on a 2-D
   tile of the grid, and to known answers: the Random123 threefry2x32
   vector and the JAX reference's own drive counts and ELL indices
   (``THREEFRY_KAT``, ``DRIVE_KAT``, ``RANDINT_KAT``); its time is
   printed beside the timing floor and its lane work beside the useful
   draws; ``lif_step`` is held to the bit on the real state and on
   ragged (n = 1, 3, 4097) and unaligned inputs (views one element
   off, which take its scalar path); ``stdp_remote_update``, the remote
   STDP rule (plain jnp in the reference), is held to the bit on the
   plastic state after 20 steps (lr 1 and 0.7, all-silent and
   all-spiking frames, weights at 0, below 0 and near w_max with the
   clip biting on both sides), on small grids with K = 7 and 248, on
   unaligned weights, and on a table of T = 180,000 (its wide path);
2. runs a 4x4-column, 64-neuron network for 60 steps, and a plastic
   guarded 4x4x48 one for 100, under the three impls from one state and
   one drive: equal spikes and events; the network the card builds from
   the seed equals the one the CPU builds (mask and indices to the bit),
   and a run that draws its own drive equals the one fed the same counts;
3. drives the main path, the paper's 24x24 grid of 1240-neuron columns
   built from the seed as the reference builds it (``impl="cuda_fused"``,
   one ``fused_step`` and one ``keyed_drive`` launch per step), and the
   staged path (``impl="cuda"``) over the same steps, with the launch
   counts set to 0 just before each and read just after (every
   ``fused_step`` and ``ell_gather`` launch on the staged path, none on
   the wide one), and checks the rate against the plain path, which
   draws its drive with ``keyed_drive`` too;
4. drives the plastic guarded path on the same grid (STDP and the
   integrity guard on) in the same way under ``cuda_fused``, ``cuda``
   and ``ref``, checks rates, weights and the guard, and shows that the
   guard leaves 50 plastic steps bitwise as they were without it;
5. drives the multi-rank static step (``core/exchange.py``) on the same
   grid and steps: (a) in-process shard grids of 1x1, 2x2, 4x4, 12x12
   (one halo ring) and 24x24 (two chained rings) under ``cuda_fused``,
   2x2 under ``cuda`` and pipelined, and 24x24 with float32 strips, each
   with one ``fused_step`` (or one of each staged kernel) and one
   ``keyed_drive`` launch per step for all its shards, timed and
   profiled (device time outside the kernels, its largest item); (b) 2
   and 4 ranks as OS processes on gloo through
   ``repro_torch.launch.launch_distributed``, every rank on this card
   (time-sliced: their ms/step is no scaling figure). Every run is held
   to phase 3's single-shard run, or to ``single_process_reference``:
   spikes, per-step spike counts and v to the bit, events to the bit
   while float32 holds them exactly and within 1e-6 past 2**24 (how a
   total is split over shards then sets its rounding), and the ISI
   totals the same way across runs; (c) the paper's AER event-list
   wire, the per-ring ``auto`` wire and the hierarchical two-level
   exchange on in-process meshes (2x2 and 24x24, the latter also in
   nodes of 1x4): AER at a bound that cannot overflow and the
   hierarchical runs equal phase 3 to the bit, AER and ``auto`` at the
   default bound print their saturated steps and equal phase 3 before
   the first, ``auto``'s ring table is the accounting's; then 4 ranks
   in nodes of 2 against phase 3, and 2 ranks on AER at a 1 Hz bound
   (which overflows) against an in-process 1x2 mesh, saturation flags
   included.

Every phase raises on failure and the script exits non-zero. Without a
card, or without the rest of the repository beside it, it exits
non-zero and prints no result. The last line of its output is
``{"ok": true, "device": {...}}``; the line before it the per-kernel
JSON (for ``synapse_matmul``, ``fused_step`` and ``ell_gather`` also the
path they took at the main shapes, their grid and shared memory per CTA,
and each instance's registers and spills from the build log); a fuller
report goes to ``build/chip_smoke_report.json``.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks: memory rate and
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# H100 SXM int32 rate outside the tensor cores: 64 INT32 lanes per SM and
# clock, half the 128 FP32 lanes whose FMAs (counted twice) make the
# float32 peak, so a quarter of it
PEAK_INT32_OPS = PEAK_F32_FLOPS / 4
# integer operations of one threefry2x32 (2 + 20 rounds of add, rotate,
# xor + 5 key injections of 3 adds + the key schedule) and its draw
OPS_PER_THREEFRY = 80

TPU_KERNELS = {
    "lif_step": "src/repro/kernels/lif_step.py:45",
    "synapse_matmul": "src/repro/kernels/synapse_matmul.py:55",
    "ell_gather": "src/repro/kernels/ell_gather.py:72",
    "fused_step": "src/repro/kernels/fused_step.py:185",
    "stdp_dense_update": "src/repro/kernels/stdp_update.py:76",
}
# the port's kernels with no Pallas counterpart: the plain-jnp function
# of the reference each replaces
PORT_KERNELS = {"keyed_drive": "src/repro/core/network.py:181",
                "stdp_remote_update": "src/repro/core/plasticity.py:115"}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu"
           for name in (*TPU_KERNELS, *PORT_KERNELS)}
SOURCES["stdp_dense_update"] = "src/repro_torch/csrc/stdp_update.cu"
SOURCES["stdp_remote_update"] = "src/repro_torch/csrc/stdp_remote.cu"
# the device-side names of the port's kernels, in a profile
PORT_KERNEL_RE = re.compile(
    "(" + "|".join((*TPU_KERNELS, *PORT_KERNELS)) + ")_kernel")
# rtol = atol = 1e-5; the relative part of a sum's error is taken against
# the sum of its absolute terms (Smoke.close)
TOL = dict(rtol=1e-5, atol=1e-5)
MAX_FLIP_SHARE = 1e-5     # 0.001 % of neurons: threshold flips
# known answers the card is held to: the Random123 threefry2x32 vector
# (key, counter, output), and the JAX reference's own draws at GRID_24
# (seed 42), pinned to jax.random by tests/test_torch_prng.py: the drive
# counts of neurons 0..23 of column 100 at step 3, and the ELL indices
# idx[0, 0..15] of column 7's remote synapses
THREEFRY_KAT = ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE))
DRIVE_KAT = dict(seed=42, t=3, col=100, counts=[
    3, 3, 2, 0, 2, 5, 0, 2, 1, 1, 0, 1, 3, 1, 1, 2, 4, 2, 2, 1, 1, 5, 2, 0])
RANDINT_KAT = dict(seed=42, col=7, row=0, idx=[
    496, 1001, 483, 697, 832, 232, 430, 674, 890, 62, 928, 243, 686, 1136,
    245, 820])
MAIN_STEPS = 200
WARMUP_STEPS = 20
# phase 5: the in-process meshes (rows x cols of shards) under cuda_fused,
# and the rank counts launched as processes
MESHES = ((1, 1), (2, 2), (4, 4), (12, 12), (24, 24))
RANKS = (2, 4)
RANK_TIMEOUT_S = 300
# phase 5c: an AER rate bound whose capacity, at factor 2, reaches every
# strip's units (no list can overflow), and the ranks' overflowing bound
AER_FREE_HZ = 500.0
RANK_AER_HZ = 1.0
NEUTRAL_STEPS = 50        # guard on against off, plastic, bitwise
PLASTIC_TOL = dict(rtol=1e-6, atol=1e-6)   # weights across impls


def log(*args):
    print(*args, flush=True)


def kernel_constant(name, constant):
    """The value of ``constexpr int constant`` in kernel ``name``'s
    source."""
    src = (ROOT / SOURCES[name]).read_text()
    return int(re.search(rf"constexpr int {constant} = (\d+);", src)[1])


def drive_lane_slots(counts, draws):
    """Lane slots that ``keyed_drive`` issues for draws, modelled from
    the (C, N) counts for columns of one CTA each: round r draws
    ``draws`` times for each neuron still undone, 32 to a warp. Beside
    them, those of a layout of one thread per neuron in CTAs of 256,
    each warp running to its largest count."""
    import torch
    need = counts.long() + 1
    slots = 0
    for r in range(-(-int(need.max()) // draws)):
        undone = (need > draws * r).sum(1)
        slots += draws * 32 * int(((undone + 31) // 32).sum())
    pad = torch.nn.functional.pad(counts.long(),
                                  (0, -counts.shape[1] % 256), value=-1)
    parent = 32 * int((pad.reshape(-1, 32).max(1).values + 1).sum())
    return slots, parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "smoke test needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import ops  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    return Smoke(torch).run()


class Smoke:
    def __init__(self, torch, device="cuda:0"):
        from repro_torch.configs import base, dpsnn
        from repro_torch.core import (connectivity, metrics, network,
                                      plasticity, prng, simulation)
        from repro_torch.kernels import _build, ops, plan, ref
        self.torch, self.dpsnn, self.M = torch, dpsnn, metrics
        self.build, self.plan = _build, plan
        self.net, self.sim, self.conn, self.prng = (network, simulation,
                                                    connectivity, prng)
        self.plast = plasticity
        self.ops, self.ref = ops, ref
        self.STDPConfig, self.GuardConfig = base.STDPConfig, base.GuardConfig
        self.neuron_types = connectivity.neuron_types
        from repro_torch.core import exchange, partition
        from repro_torch.launch import launch_distributed
        from repro_torch.runtime import compression, multiprocess, transport
        self.ex, self.part, self.ld, self.mp = (exchange, partition,
                                                launch_distributed,
                                                multiprocess)
        self.LocalMesh = transport.LocalMesh
        self.ExchangeConfig = base.ExchangeConfig
        self.payload_bytes = compression.halo_payload_bytes
        self.comp = compression
        self.dev = torch.device(device)
        self.report = {"kernels": {}, "checks": []}
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        # writing 128 MB evicts the 50 MB L2 before each timed launch
        self.flush = torch.empty(32 << 20, dtype=torch.float32,
                                 device=self.dev)

    # ------------------------------------------------------------ helpers
    def sync(self):
        self.torch.cuda.synchronize(self.dev)

    def time_ms(self, fn, iters=10):
        """Median device time of ``fn`` over ``iters`` launches, each after
        an L2 flush (CUDA events around the call alone, recorded while the
        card is still busy with a spin kernel)."""
        torch = self.torch
        fn()
        self.sync()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for s, e in zip(starts, ends):
            self.flush.zero_()
            # keep the card busy while the host enqueues the timed call, so
            # that host-side launch overhead is not timed as device time
            torch.cuda._sleep(2_000_000)
            s.record()
            fn()
            e.record()
        self.sync()
        return statistics.median(s.elapsed_time(e)
                                 for s, e in zip(starts, ends))

    def close(self, name, got, want, scale=None, **tol):
        """|got - want| <= atol + rtol * max(|want|, scale) elementwise;
        returns the max abs error. ``scale`` is the sum of the absolute
        terms of a float32 sum (|spikes| @ |w|, sum_k |tbl[idx] * w|):
        summed in another order, a sum's error grows with its terms, not
        with its value, which cancels when excitation meets inhibition.
        Equal values (NaN against NaN too) agree; a NaN against a number
        does not."""
        torch = self.torch
        tol = tol or TOL
        got, want = got.float(), want.float()
        same = (got == want) | (got.isnan() & want.isnan())
        diff = torch.where(same, 0.0, (got - want).abs())
        err = float(diff.max()) if got.numel() else 0.0
        mag = want.abs() if scale is None else torch.maximum(want.abs(),
                                                             scale)
        bad = (diff > tol["atol"] + tol["rtol"] * mag) | diff.isnan()
        if bool(bad.any()):
            raise AssertionError(
                f"{name}: {int(bad.sum())} values beyond rtol={tol['rtol']} "
                f"atol={tol['atol']} (max abs err {err:.3e})")
        return err

    def close_step(self, name, got, want, scale=None):
        """(v', c', refrac', spikes) against the plain version: spikes may
        differ in at most MAX_FLIP_SHARE of neurons (a float32 sum taken in
        another order can move v across the threshold); every other value
        of the agreeing neurons is close at 1e-5, v relative to ``scale``
        (the currents' absolute terms; the gain is below 1)."""
        agree = got[3] == want[3]
        flips = int((~agree).sum())
        if flips > MAX_FLIP_SHARE * agree.numel():
            raise AssertionError(f"{name}: {flips} spike flips in "
                                 f"{agree.numel()} neurons")
        err = max(self.close(f"{name}[{i}]", g[agree], w[agree],
                             scale=None if i or scale is None
                             else scale[agree])
                  for i, (g, w) in enumerate(zip(got, want)))
        return err, flips

    def equal(self, name, got, want):
        """Raise unless ``got`` equals ``want`` to the bit."""
        if not self.torch.equal(got, want):
            n_bad = int((got != want).sum())
            raise AssertionError(f"{name}: {n_bad} of {want.numel()} values "
                                 f"differ from the plain version")

    def scale_local(self, s, w):
        return self.ref.synapse_matmul_ref(s.abs(), w.abs())

    def scale_remote(self, tbl, idx, w):
        return self.ref.ell_gather_ref(tbl.abs(), idx, w.abs())

    def scale_step(self, s_loc, w, tbl, idx, rw, ext):
        return (self.scale_local(s_loc, w) + self.scale_remote(tbl, idx, rw)
                + ext.abs())

    def note(self, text):
        log(text)
        self.report["checks"].append(text)

    # ------------------------------------------------------------- phases
    def run(self) -> int:
        torch = self.torch
        t_start = time.perf_counter()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        log(smi)
        self.report["nvidia_smi"] = smi
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"device {torch.cuda.get_device_name(0)}")

        # 0. build the kernels from the checkout's sources
        lib = self.ops.library()
        log(f"phase 0: kernel library built in {lib.build_seconds:.1f} s "
            f"({lib.path.name})")
        self.report["instances"] = self.instances(lib.log)
        for kernel, insts in self.report["instances"].items():
            log(f"  ptxas {kernel}: " + ", ".join(
                f"{label} {i['registers']} registers, {i['spill_bytes']} B "
                f"spilled" for label, i in insts.items()))

        # 1. kernels against their plain versions
        cfg = self.dpsnn.GRID_24
        t0 = time.perf_counter()
        params, state0 = self.sim.build(cfg, device=self.dev)
        self.sync()
        self.report["build_seconds"] = time.perf_counter() - t0
        log(f"phase 1: built {cfg.name} ({cfg.n_columns} columns x "
            f"{cfg.neurons_per_column} neurons, "
            f"{cfg.total_equivalent_synapses/1e9:.3f}G equivalent synapses) "
            f"from seed {cfg.seed} with the reference's keys, on the card "
            f"in {self.report['build_seconds']:.4f} s")
        warm = self.sim.run(cfg, params, state0, WARMUP_STEPS,
                            impl="cuda_fused")
        state, self.warm_trace = warm.state, warm.rate_trace
        self.check_keyed_drive(cfg, int(state.t))
        real = self.step_inputs(cfg, params, state)
        self.check_kernels_real(cfg, params, real)
        # the plastic guarded path's inputs: 20 plastic steps on the same
        # network, STDPConfig() defaults and the guard on
        pcfg = self.plastic_cfg(cfg)
        pstate0 = self.net.init_state(pcfg, range(cfg.n_columns),
                                      device=self.dev)
        pwarm = self.sim.run(pcfg, params, pstate0, WARMUP_STEPS,
                             impl="cuda_fused")
        self.check_plastic_real(pcfg, pwarm)
        self.check_stdp_remote_real(pcfg, pwarm)
        self.check_kernels_random(cfg, params, real)
        self.check_ragged()
        self.check_wide_table()
        self.check_stdp_remote_shapes()

        # 2. small runs: three impls, one state, one drive
        self.check_small_run()
        self.check_small_plastic_run()

        # 3. the main path at full width, then the staged path
        fused = self.main_path(cfg, params, state)
        del state, real

        # 4. the plastic guarded path at full width, and the guard's
        # neutrality on it
        self.plastic_path(pcfg, params, pwarm)
        self.guard_neutrality(pcfg, pwarm)
        del pwarm, pstate0
        torch.cuda.empty_cache()

        # 5. the multi-rank static step: in-process meshes, then ranks as
        # processes, each held against phase 3's single-shard run
        isi_runs = self.mesh_path(cfg, params, fused)
        # 5c. the AER and per-ring auto wires and the hierarchical exchange
        self.wire_path(cfg, params, fused)
        del params
        torch.cuda.empty_cache()
        self.rank_path(cfg, fused, isi_runs)
        self.wire_rank_path(cfg, fused)

        kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                        replaces={**TPU_KERNELS, **PORT_KERNELS}[name],
                        tpu_kernel=TPU_KERNELS.get(name),
                        **self.report["kernels"][name])
                   for name in (*TPU_KERNELS, *PORT_KERNELS)]
        log(f"total {time.perf_counter()-t_start:.1f} s")
        out = ROOT / "build"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_report.json").write_text(
            json.dumps(dict(self.report, kernels=kernels), indent=1))
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    def instances(self, log):
        """Registers and spill bytes of every instance of the kernels that
        ``kernels/plan.py`` plans, labelled by path and epilogues, from the
        build log."""
        out = {name: {} for name in self.plan.KERNELS}
        for mangled, info in self.build.ptxas_report(log).items():
            if re.search(r"synapse_matmul_kernel", mangled):
                out["synapse_matmul"]["staged"] = info
                continue
            m = re.search(r"(ell_gather|fused_step|stdp_remote_update)"
                          r"_kernelI((?:Lb[01]E)+)E", mangled)
            if m is None:
                continue
            flags = [f == "1" for f in re.findall(r"Lb([01])E", m[2])]
            label = ("staged" if flags[0] else "wide") + "".join(
                f"+{e}" for e, on in zip(("stdp", "guard"), flags[1:]) if on)
            out[m[1]][label] = info
        return out

    def plan_entry(self, name, c, n, t):
        """The path, grid and shared memory ``name`` takes at these shapes,
        and its instances' registers and spills."""
        p = self.plan.plan(name, c, n, t, self.plan.sm_count(self.dev))
        insts = self.report["instances"][name]
        return dict(path=p.path, schedule=p.schedule, ctas=p.ctas,
                    smem_bytes=p.smem_bytes,
                    registers={k: i["registers"] for k, i in insts.items()},
                    spill_bytes=sum(i["spill_bytes"] for i in insts.values()))

    def expected_launches(self, **counts):
        """Every kernel's launch count: ``counts``, and 0 for the rest."""
        return {name: counts.get(name, 0) for name in self.ops.LAUNCHES}

    def plastic_cfg(self, cfg):
        """``cfg`` with STDP (``STDPConfig()`` defaults) and the guard on."""
        return dataclasses.replace(cfg, stdp=True,
                                   guard=self.GuardConfig(enabled=True))

    def stdp_args(self, cfg, params, state):
        """The dense update's inputs as ``core/simulation.py`` hands them
        over after the state's last step: weights, x_pre_exc, spk_exc,
        spikes, x_post; and its constants."""
        d = state.hist.shape[0]
        spikes = state.hist[(int(state.t) - 1) % d]
        exc = (~self.neuron_types(cfg, self.dev)).float()
        scfg = cfg.stdp_cfg
        kw = dict(a_plus=scfg.a_plus, a_minus=scfg.a_minus, lr=scfg.lr,
                  w_max=scfg.w_max_factor * cfg.conn.j_exc)
        return (params.w_local, state.stdp.x_pre * exc, spikes * exc, spikes,
                state.stdp.x_post), kw

    def check_stdp(self, name, args, kw):
        """stdp_dense_update against its plain version, to the bit; and
        the same inputs with silent spikes and the weights tripled (most
        above w_max): the clip alone."""
        ops, ref, torch = self.ops, self.ref, self.torch
        self.equal(f"stdp_dense_update {name}",
                   ops.stdp_dense_update(*args, **kw),
                   ref.stdp_dense_update_ref(*args, **kw))
        w3, z = args[0] * 3.0, torch.zeros_like(args[3])
        silent = (w3, args[1], z, z, args[4])
        got = ops.stdp_dense_update(*silent, **kw)
        self.equal(f"stdp_dense_update {name} all-silent", got,
                   ref.stdp_dense_update_ref(*silent, **kw))
        self.equal(f"stdp_dense_update {name} clip only", got,
                   torch.where(w3 > 0, w3.clamp(0.0, kw["w_max"]), w3))
        entry = self.report["kernels"].setdefault(
            "stdp_dense_update", {"max_abs_err": 0.0})
        return entry

    def check_epilogues(self, name, ncfg, args, x_pre, x_post, scfg, gcfg,
                        scale=None):
        """fused_step's STDP, guard and STDP+guard variants against
        fused_step_ref: (v', c', refrac', spikes) as ``close_step`` holds
        them, the traces to the bit on the neurons whose spikes agree, the
        flags to the bit. Returns the flags and the spike flips."""
        ops, ref = self.ops, self.ref
        flips = 0
        for sc, gc in ((scfg, None), (None, gcfg), (scfg, gcfg)):
            tag = "+".join(k for k, on in (("stdp", sc), ("guard", gc)) if on)
            tr = (x_pre, x_post) if sc is not None else ()
            got = ops.fused_step(ncfg, *args, *tr, scfg=sc, gcfg=gc)
            want = ref.fused_step_ref(ncfg, *args, *tr, scfg=sc, gcfg=gc)
            _err, f = self.close_step(f"fused_step {tag} {name}", got[:4],
                                      want[:4], scale=scale)
            flips = max(flips, f)
            agree = got[3] == want[3]
            if sc is not None:
                for i, leaf in ((4, "x_pre"), (5, "x_post")):
                    self.equal(f"fused_step {tag} {name} {leaf}",
                               got[i][agree], want[i][agree])
            if gc is not None:
                self.equal(f"fused_step {tag} {name} flags", got[-1],
                           want[-1])
                flags = got[-1].tolist()
        return flags, flips

    def silent_tile_share(self, spk_exc, spikes):
        """Share of (column, 128-source block, 128-target block) tiles of
        the dense update whose source and target spike slices are both
        silent: the tiles that skip the products."""
        torch, blk = self.torch, self.ref.BLK
        c, n = spikes.shape

        def active(x):
            x = torch.nn.functional.pad(x, (0, (-n) % blk))
            return (x.reshape(c, -1, blk) != 0).any(dim=-1)
        s_act, t_act = active(spk_exc), active(spikes)
        return float((~s_act[:, :, None] & ~t_act[:, None, :]).float().mean())

    def check_plastic_real(self, pcfg, pwarm):
        """The plastic path's kernels on its real inputs after 20 plastic
        steps: stdp_dense_update to the bit, fused_step's epilogues, and
        the times of both."""
        torch, ops, ref, ncfg = self.torch, self.ops, self.ref, pcfg.neuron
        params, state = pwarm.params, pwarm.state
        args, kw = self.stdp_args(pcfg, params, state)
        entry = self.check_stdp("real", args, kw)
        share = self.silent_tile_share(args[2], args[3])
        x = self.step_inputs(pcfg, params, state)
        fargs = (x["v"], x["c"], x["refrac"], x["s_loc"], params.w_local,
                 x["s_flat"], params.rem_flat, params.rem_w, x["ext"])
        tr = (state.stdp.x_pre, state.stdp.x_post)
        scale = self.scale_step(x["s_loc"], params.w_local, x["s_flat"],
                                params.rem_flat, params.rem_w, x["ext"])
        flags, flips = self.check_epilogues("real", ncfg, fargs, *tr,
                                            pcfg.stdp_cfg, pcfg.guard,
                                            scale=scale)
        if any(flags):
            raise AssertionError(f"guard flags {flags} on a healthy state")
        c, n = args[3].shape
        nbytes = 2 * c * n * n * 4 + 4 * c * n * 4
        flops = 7 * c * n * n
        ms = self.time_ms(lambda: ops.stdp_dense_update(*args, **kw))
        plain_ms = self.time_ms(
            lambda: ref.stdp_dense_update_ref(*args, **kw), iters=3)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        entry.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     bytes=nbytes, flops=flops, silent_tile_share=share)
        # the fused step's variants on the same plastic inputs, in turns
        scfg, gcfg = pcfg.stdp_cfg, pcfg.guard
        variants = {"static": {}, "stdp": dict(scfg=scfg),
                    "guard": dict(gcfg=gcfg),
                    "stdp_guard": dict(scfg=scfg, gcfg=gcfg)}
        fused = self.report["kernels"]["fused_step"]
        fused["ms_variants"] = {
            tag: self.time_ms(lambda v=v: ops.fused_step(
                ncfg, *fargs, *(tr if "scfg" in v else ()), **v))
            for tag, v in variants.items()}
        fused["plain_ms_stdp_guard"] = self.time_ms(
            lambda: ref.fused_step_ref(ncfg, *fargs, *tr, scfg=scfg,
                                       gcfg=gcfg))
        fused["bound_ms_stdp_guard"] = (
            fused["bound_ms"] + (4 * c * n * 4 + c * 4) / PEAK_BYTES_PER_S
            * 1e3)
        log(f"phase 1 plastic real state (step {WARMUP_STEPS}): "
            f"stdp_dense_update equal to its plain version (and all-silent "
            f"clip only), silent tile share {share:.4f}; fused_step stdp/"
            f"guard variants: traces and flags equal, spike flips {flips}")
        log(f"  stdp_dense_update: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"library -, bound {entry['bound_ms']:.4f} ms by "
            f"{entry['bound_by']}, {nbytes/1e9:.4f} GB)")
        log("  fused_step variants on the plastic inputs: "
            + ", ".join(f"{k} {v:.4f} ms"
                        for k, v in fused["ms_variants"].items())
            + f" (with both epilogues: plain "
            f"{fused['plain_ms_stdp_guard']:.4f} ms, bound "
            f"{fused['bound_ms_stdp_guard']:.4f} ms)")

    def lif_equal(self, name, ncfg, v, c, refrac, cur):
        """lif_step against its plain version, all four outputs to the
        bit; returns the spikes."""
        got = self.ops.lif_step(ncfg, v, c, refrac, cur)
        want = self.ref.lif_step_ref(v, c, refrac, cur,
                                     **self.ref.lif_constants(ncfg))
        for leaf, g, w in zip(("v", "c", "refrac", "spikes"), got, want):
            self.equal(f"lif_step {name} {leaf}", g, w)
        return got[3]

    def check_lif_shapes(self, ncfg, real=None):
        """lif_step to the bit: on ``real`` (v, c, refrac, cur) at the main
        path's shapes (the vector path), on n = 1, 3 and 4097 (the scalar
        path), and on views one element off of n = 4096 and of the main
        path's 714,240 neurons (every input, or refrac alone): unaligned,
        so the scalar path too."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(6)
        n_main = self.dpsnn.GRID_24.n_neurons

        def inputs(n, off=0):
            def rnd():
                return torch.rand(n + off, generator=g, device=self.dev)
            cur = torch.randn(n + off, generator=g, device=self.dev) * 4 + 1
            return [x[off:] for x in (rnd() * 22, rnd() * 3,
                                      (rnd() * 3).int(), cur)]
        spikes = 0
        if real is not None:
            spikes += int(self.lif_equal("real", ncfg, *real).sum())
        for n in (1, 3, 4097):
            spikes += int(self.lif_equal(f"n={n}", ncfg, *inputs(n)).sum())
        for n in (4096, n_main):
            spikes += int(self.lif_equal(f"n={n} one element off", ncfg,
                                         *inputs(n, 1)).sum())
            x = inputs(n)
            x[2] = inputs(n, 1)[2]
            self.lif_equal(f"n={n} refrac one element off", ncfg, *x)
        if spikes == 0:
            raise AssertionError("lif_step checks: no neuron spiked")
        self.report["kernels"].setdefault("lif_step", {"max_abs_err": 0.0})
        self.note(f"phase 1 lif_step equal to its plain version"
                  f"{' on the real state, ' if real is not None else ' '}on "
                  f"n = 1, 3, 4097 and on views one element off of n = 4096 "
                  f"and {n_main} ({spikes} spikes)")

    def remote_equal(self, name, args, kw):
        """stdp_remote_update against its plain version, to the bit."""
        got = self.ops.stdp_remote_update(*args, **kw)
        self.equal(f"stdp_remote_update {name}", got,
                   self.ref.stdp_remote_update_ref(*args, **kw))
        return got

    def check_stdp_remote_real(self, pcfg, pwarm):
        """stdp_remote_update on the plastic state after 20 steps, as
        ``core/simulation.py`` hands it over (the pre-trace table of the
        state's x_pre, its last spikes and x_post, the real indices and
        weights), to the bit: at lr 1 and 0.7; all-silent and all-spiking
        frames; and weights at 0, below 0, near w_max and just above 0,
        with a_plus 0.5 on the all-spiking frame and a_minus 0.5 on the
        silent one, and the traces raised by 1 (every pre-trace positive),
        so that the clip bites at w_max and at 0. Then its times."""
        torch, ops, ref = self.torch, self.ops, self.ref
        params, state = pwarm.params, pwarm.state
        stencil = self.net.build_stencil(pcfg)
        table = self.plast.pre_trace_table(state.stdp.x_pre, stencil,
                                           (pcfg.grid_h, pcfg.grid_w))
        spikes = state.hist[(int(state.t) - 1) % state.hist.shape[0]]
        x_post = state.stdp.x_post
        idx, w = params.rem_flat, params.rem_w
        scfg = pcfg.stdp_cfg
        w_max = scfg.w_max_factor * pcfg.conn.j_exc
        kw = dict(a_plus=scfg.a_plus, a_minus=scfg.a_minus, lr=scfg.lr,
                  w_max=w_max)
        args = (table, idx, w, spikes, x_post)
        for lr in (1.0, 0.7):
            self.remote_equal(f"real lr={lr}", args, dict(kw, lr=lr))
        silent, spiking = torch.zeros_like(spikes), torch.ones_like(spikes)
        for name, frame in (("all-silent", silent), ("all-spiking", spiking)):
            self.remote_equal(f"real {name}", (table, idx, w, frame, x_post),
                              kw)
        g = torch.Generator(device=self.dev).manual_seed(5)
        u = torch.rand(w.shape, generator=g, device=self.dev)
        edge = torch.where(u < 0.25, 0.0, torch.where(
            u < 0.5, -w.abs() - 0.1, torch.where(
                u < 0.75, w_max - 1e-3 * u, 1e-3 * u)))
        del u
        raised = (table + 1.0, idx, edge)
        top = self.remote_equal("real near w_max, all spiking",
                                (*raised, spiking, x_post + 1.0),
                                dict(kw, a_plus=0.5))
        bottom = self.remote_equal("real near 0, all silent, lr 0.7",
                                   (*raised, silent, x_post + 1.0),
                                   dict(kw, a_minus=0.5, lr=0.7))
        pos = edge > 0
        n_top = int(((top == ref._f32(w_max)) & pos).sum())
        n_bottom = int(((bottom == 0) & pos).sum())
        if n_top == 0 or n_bottom == 0:
            raise AssertionError(f"stdp_remote_update: the clip did not bite "
                                 f"({n_top} at w_max, {n_bottom} at 0)")
        if not torch.equal(top[~pos], edge[~pos]):
            raise AssertionError("stdp_remote_update: a weight <= 0 moved")
        del raised, edge, top, bottom, pos
        # times; the bound reads idx and weights and writes the new weights
        # once (12 B a synapse), the table and the two (C, N) vectors once
        c, n, k = idx.shape
        t = table.shape[1]
        nbytes = 12 * c * n * k + 4 * c * t + 8 * c * n
        flops = 7 * c * n * k
        ms = self.time_ms(lambda: ops.stdp_remote_update(*args, **kw))
        plain_ms = self.time_ms(
            lambda: ref.stdp_remote_update_ref(*args, **kw), iters=3)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        entry = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                     library_ms=None, bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     bytes=nbytes, flops=flops,
                     **self.plan_entry("stdp_remote_update", c, n, t))
        self.report["kernels"]["stdp_remote_update"] = entry
        self.note(f"phase 1 stdp_remote_update on the plastic real state "
                  f"(step {WARMUP_STEPS}): equal to its plain version at lr 1 "
                  f"and 0.7, on all-silent and all-spiking frames, and on "
                  f"weights at 0, below 0 and near w_max ({n_top} clipped at "
                  f"w_max, {n_bottom} at 0, none <= 0 moved)")
        log(f"  stdp_remote_update: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"library -, bound {entry['bound_ms']:.4f} ms by "
            f"{entry['bound_by']}, {nbytes/1e9:.4f} GB; {entry['path']} path, "
            f"{entry['ctas']} CTAs ({entry['schedule']} schedule), "
            f"{entry['smem_bytes']} B of shared memory each, registers "
            f"{entry['registers']}, {entry['spill_bytes']} B spilled)")

    def check_stdp_remote_shapes(self):
        """stdp_remote_update to the bit on random inputs (a pre-trace
        table, weights a tenth absent, 10 % spiking) at lr 1 and 0.7: K = 7
        (4-byte accesses) and K = 248 on ragged grids, K = 248 with weights
        one element off (4-byte accesses), all staged; and a table of T =
        180,000 at K = 248 and 7 (the wide path). Staged and wide launches
        are counted apart."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(7)

        def rnd(*shape):
            return torch.rand(shape, generator=g, device=self.dev)
        cases = [(5, 130, 7, 20 * 130, "staged"),
                 (7, 257, 248, 20 * 257, "staged"),
                 (3, 1240, 248, 20 * 1240, "unaligned"),
                 (4, 1240, 248, 180_000, "wide"),
                 (4, 1240, 7, 180_000, "wide")]
        self.ops.reset_launches()
        for c, n, k, t, kind in cases:
            w = torch.randn((c, n, k), generator=g, device=self.dev) * 0.3
            w = torch.where(rnd(c, n, k) < 0.1, 0.0, w + 0.2)
            if kind == "unaligned":
                off = torch.empty(c * n * k + 1, device=self.dev)
                w = off[1:].view(c, n, k).copy_(w)
            args = (rnd(c, t) * 3,
                    torch.randint(0, t, (c, n, k), generator=g,
                                  device=self.dev, dtype=torch.int32),
                    w, (rnd(c, n) < 0.1).float(), rnd(c, n) * 3)
            for lr in (1.0, 0.7):
                self.remote_equal(f"{c}x{n}x{k} T={t} {kind} lr={lr}", args,
                                  dict(a_plus=0.05, a_minus=0.055, lr=lr,
                                       w_max=0.84))
        want = self.expected_launches(**{"stdp_remote_update": 6,
                                         "stdp_remote_update.wide": 4})
        launches = dict(self.ops.LAUNCHES)
        if launches != want:
            raise AssertionError(f"stdp_remote_update launches {launches}, "
                                 f"expected {want}")
        self.note("phase 1 stdp_remote_update equal to its plain version at "
                  "lr 1 and 0.7 on 5x130 K=7, 7x257 K=248, 3x1240 K=248 with "
                  "unaligned weights (staged) and on T = 180,000 at K = 248 "
                  "and 7 (every launch on the wide path)")

    def col_ids(self, cfg):
        return self.net.column_ids(cfg, self.dev)

    def drive_rate(self, cfg):
        """The drive's Poisson rate per neuron and step."""
        return cfg.c_ext * cfg.nu_ext_hz * cfg.neuron.dt_ms * 1e-3

    def check_keyed_drive(self, cfg, t_now):
        """keyed_drive against its plain version, counts and currents to
        the bit: the whole grid at steps 0, 1, 20, 2**31 - 1 and
        ``t_now``, and at rates 9.9 (long chains, many rounds) and 0;
        ragged shapes, one column of 1, 33, 1240 neurons and of the most
        one CTA takes (the kernel's ``SHARE_MAX``) and one more, and a 6x6
        tile of the grid (a shard's non-contiguous ids, whose counts equal
        the whole grid's rows); the known answers; then its times at
        ``t_now``, beside the timing floor, and its lane work."""
        torch, ops, ref = self.torch, self.ops, self.ref
        lam, j_ext = self.drive_rate(cfg), cfg.conn.j_ext

        def pair(name, seed, t, ids, n, rate=lam):
            cur, got = ops.keyed_drive(seed, t, ids, n, rate, j_ext)
            want = ref.keyed_poisson_ref(seed, t, ids, n, rate)
            self.equal(f"keyed_drive {name} counts", got, want)
            self.equal(f"keyed_drive {name} currents", cur, want * j_ext)
            return got
        ids, n = self.col_ids(cfg), cfg.neurons_per_column
        for t in (0, 1, 20, 2**31 - 1):
            pair(f"{cfg.name} t={t}", cfg.seed, t, ids, n)
        long_counts = pair(f"{cfg.name} lam=9.9", cfg.seed, t_now, ids, n,
                           rate=9.9)
        if not bool((pair(f"{cfg.name} lam=0", cfg.seed, t_now, ids, n,
                          rate=0.0) == 0).all()):
            raise AssertionError("keyed_drive: lam = 0 drew a spike")
        for c, nr in ((3, 70), (5, 130), (7, 257)):
            pair(f"{c}x{nr}", cfg.seed, 5,
                 torch.arange(11, 11 + c, dtype=torch.int32,
                              device=self.dev), nr)
        one = torch.tensor([100], dtype=torch.int32, device=self.dev)
        share_max = kernel_constant("keyed_drive", "SHARE_MAX")
        for nr in (1, 33, n, share_max, share_max + 1):
            pair(f"1x{nr}", cfg.seed, t_now, one, nr)
        rows = torch.arange(6, 12, device=self.dev)
        cols = torch.arange(12, 18, device=self.dev)
        tile = (rows[:, None] * cfg.grid_w + cols[None, :]).reshape(-1).int()
        counts = pair(f"{cfg.name} t={t_now}", cfg.seed, t_now, ids, n)
        self.equal("keyed_drive tile rows",
                   pair("tile", cfg.seed, t_now, tile, n),
                   counts[tile.long()])
        # known answers: the Random123 vector, the reference's own draws
        (k1, k2), (x1, x2), want = THREEFRY_KAT
        z = torch.zeros((), dtype=torch.int64, device=self.dev)
        got = tuple(int(w) for w in self.prng.threefry2x32(z + k1, z + k2,
                                                          z + x1, z + x2))
        if got != want:
            raise AssertionError(f"threefry2x32 {got} != Random123 {want}")
        kat = DRIVE_KAT
        one = torch.tensor([kat["col"]], dtype=torch.int32, device=self.dev)
        got = ops.keyed_drive(kat["seed"], kat["t"], one, n, lam, j_ext)[1]
        if got[0, :len(kat["counts"])].tolist() != kat["counts"]:
            raise AssertionError("keyed_drive differs from the reference's "
                                 "drive counts (DRIVE_KAT)")
        kat = RANDINT_KAT
        idx, _ = self.conn.generate_remote_column(
            dataclasses.replace(cfg, seed=kat["seed"]),
            self.conn.build_stencil(cfg), kat["col"], self.dev)
        if idx[kat["row"], :len(kat["idx"])].tolist() != kat["idx"]:
            raise AssertionError("remote randint indices differ from the "
                                 "reference's (RANDINT_KAT)")
        # times at the main path's shapes and this state's step; the bound
        # counts the draws this step needs (count + 1 per neuron) and each
        # column's key and split chain as far as its slowest neuron
        c = ids.shape[0]
        draws = float((counts + 1).sum())
        chain = float((2 + 2 * (counts.max(dim=1).values + 1)).sum())
        n_ops = OPS_PER_THREEFRY * (draws + chain)
        nbytes = 2 * c * n * 4 + c * 4
        ms = self.time_ms(lambda: ops.keyed_drive(cfg.seed, t_now, ids, n,
                                                  lam, j_ext))
        plain_ms = self.time_ms(lambda: ref.keyed_poisson_ref(
            cfg.seed, t_now, ids, n, lam), iters=3)
        floor_ms = self.time_ms(torch.zeros(1, device=self.dev).zero_)
        ms_long = self.time_ms(lambda: ops.keyed_drive(
            cfg.seed, t_now, ids, n, 9.9, j_ext))
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_INT32_OPS * 1e3
        slots, slots_parent = drive_lane_slots(
            counts, kernel_constant("keyed_drive", "DRAWS"))
        entry = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                     library_ms=None, bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     bytes=nbytes, int_ops=n_ops, draws=draws,
                     max_count=float(counts.max()),
                     mean_count=float(counts.mean()), ms_floor=floor_ms,
                     ms_lam_9_9=ms_long,
                     draws_lam_9_9=float((long_counts + 1).sum()),
                     max_count_lam_9_9=float(long_counts.max()))
        self.report["kernels"]["keyed_drive"] = entry
        self.note(f"phase 1 keyed_drive: counts and currents equal to the "
                  f"plain version at {cfg.name} (t = 0, 1, 20, 2**31 - 1, "
                  f"{t_now}; lam 9.9 at t = {t_now}, max count "
                  f"{entry['max_count_lam_9_9']:.0f}; lam 0 all zero), ragged "
                  f"3x70/5x130/7x257, one column of 1, 33, {n}, {share_max} "
                  f"and {share_max + 1} neurons, and a 6x6 tile equal to the "
                  f"grid's rows; threefry2x32 equal to the Random123 vector; "
                  f"the reference's drive counts (DRIVE_KAT) and remote "
                  f"indices (RANDINT_KAT) equal")
        log(f"  keyed_drive: {ms:.4f} ms (plain {plain_ms:.4f} ms, library "
            f"-, bound {entry['bound_ms']:.4f} ms by {entry['bound_by']}, "
            f"{n_ops/1e6:.1f} M integer operations, {nbytes/1e6:.3f} MB; "
            f"{draws:.0f} draws, mean count {entry['mean_count']:.4f}, max "
            f"{entry['max_count']:.0f}); timing floor (a one-float fill) "
            f"{floor_ms:.4f} ms; at lam 9.9 {ms_long:.4f} ms for "
            f"{entry['draws_lam_9_9']:.0f} draws")
        log(f"  keyed_drive lane work, modelled from the counts: "
            f"{slots} lane slots for draws, {slots / draws:.3f}x the "
            f"useful draws (a thread per neuron, 32 lanes to a warp's "
            f"largest count: {slots_parent}, {slots_parent / draws:.3f}x)")

    def step_inputs(self, cfg, params, state):
        """The inputs the main path's kernels see at the state's step."""
        net = self.net
        stencil = net.build_stencil(cfg)
        t = int(state.t)
        d = state.hist.shape[0]
        ext, _ = net.external_drive(cfg, t, self.col_ids(cfg))
        s_loc = state.hist[(t - cfg.conn.min_delay_steps) % d]
        s_flat = net.neighbour_table_single(state.hist, t, stencil,
                                            (cfg.grid_h, cfg.grid_w))
        return dict(v=state.lif.v, c=state.lif.c, refrac=state.lif.refrac,
                    s_loc=s_loc, s_flat=s_flat, ext=ext)

    def check_kernels_real(self, cfg, params, x):
        torch, ops, ref, ncfg = self.torch, self.ops, self.ref, cfg.neuron
        kinds = {}
        # synapse_matmul, with its silent-block counter
        counter = torch.zeros(1, dtype=torch.int64, device=self.dev)
        got = ops.synapse_matmul(x["s_loc"], params.w_local,
                                 silent_blocks=counter)
        want = ref.synapse_matmul_ref(x["s_loc"], params.w_local)
        kinds["synapse_matmul"] = self.close(
            "synapse_matmul real", got, want,
            scale=self.scale_local(x["s_loc"], params.w_local))
        self.equal("synapse_matmul real chain", got,
                   ref.synapse_matmul_chain_ref(x["s_loc"], params.w_local))
        w64 = torch.einsum("cs,cst->ct", x["s_loc"].double(),
                           params.w_local.double())
        self.note(f"  synapse_matmul against float64: kernel "
                  f"{float((got - w64).abs().max()):.2e}, plain "
                  f"{float((want - w64).abs().max()):.2e}")
        del w64
        want_silent = int(ref.silent_block_count(x["s_loc"]))
        if int(counter) != want_silent:
            raise AssertionError(f"silent-block count {int(counter)} != "
                                 f"plain count {want_silent}")
        local = want
        # ell_gather
        got = ops.ell_gather(x["s_flat"], params.rem_flat, params.rem_w)
        want = ref.ell_gather_ref(x["s_flat"], params.rem_flat, params.rem_w)
        kinds["ell_gather"] = self.close(
            "ell_gather real", got, want,
            scale=self.scale_remote(x["s_flat"], params.rem_flat,
                                    params.rem_w))
        cur = local + want + x["ext"]
        # lif_step on the real currents
        got = ops.lif_step(ncfg, x["v"], x["c"], x["refrac"], cur)
        want = ref.lif_step_ref(x["v"], x["c"], x["refrac"], cur,
                                **ref.lif_constants(ncfg))
        kinds["lif_step"], flips_lif = self.close_step("lif_step real",
                                                       got, want)
        self.check_lif_shapes(ncfg, (x["v"], x["c"], x["refrac"], cur))
        # fused_step
        args = (x["v"], x["c"], x["refrac"], x["s_loc"], params.w_local,
                x["s_flat"], params.rem_flat, params.rem_w, x["ext"])
        counter.zero_()
        got = ops.fused_step(ncfg, *args, silent_blocks=counter)
        want = ref.fused_step_ref(ncfg, *args)
        kinds["fused_step"], flips = self.close_step(
            "fused_step real", got, want,
            scale=self.scale_step(x["s_loc"], params.w_local, x["s_flat"],
                                  params.rem_flat, params.rem_w, x["ext"]))
        if int(counter) != want_silent:
            raise AssertionError("fused_step silent-block count differs")
        # all-silent spikes: exact zeros
        zeros = ops.synapse_matmul(torch.zeros_like(x["s_loc"]),
                                   params.w_local)
        if float(zeros.abs().max()) != 0.0:
            raise AssertionError("synapse_matmul: all-silent input is not 0")
        n_blocks = cfg.n_columns * -(-cfg.neurons_per_column // 128)
        nnz = int((x["s_loc"] != 0).sum())
        self.note(f"phase 1 real state (step {WARMUP_STEPS}): max abs err "
                  + ", ".join(f"{k} {v:.2e}" for k, v in kinds.items())
                  + f"; synapse_matmul equal to the fused multiply-add "
                  f"chain; spike flips lif {flips_lif} fused {flips}; "
                  f"{nnz} spiking sources, silent 128-blocks "
                  f"{want_silent}/{n_blocks}; all-silent exact zeros")
        for name, err in kinds.items():
            self.report["kernels"][name] = {"max_abs_err": err}
        self.check_worst_column(x["s_loc"], params.w_local)
        self.local_balance(x["s_loc"], x["s_flat"].shape[1])
        self.time_kernels(cfg, params, x, cur, nnz)

    def check_worst_column(self, s_loc, w):
        """synapse_matmul on the real spikes with every source of the last
        column spiking (a chain as long as the column): to the bit against
        the fused multiply-add chain, the silent-block count against the
        plain count, and its time; then its times on parts of the real
        spikes (none, the light columns, the heavy ones, all), beside the
        timing floor."""
        torch, ops, ref = self.torch, self.ops, self.ref
        s = s_loc.clone()
        s[-1] = 1.0
        counter = torch.zeros(1, dtype=torch.int64, device=self.dev)
        self.equal("synapse_matmul worst column chain",
                   ops.synapse_matmul(s, w, silent_blocks=counter),
                   ref.synapse_matmul_chain_ref(s, w))
        if int(counter) != int(ref.silent_block_count(s)):
            raise AssertionError("synapse_matmul worst column: silent-block "
                                 "count differs")
        entry = self.report["kernels"]["synapse_matmul"]
        entry["ms_worst_column"] = self.time_ms(
            lambda: ops.synapse_matmul(s, w))
        self.note(f"  synapse_matmul with every source of column "
                  f"{s.shape[0] - 1} spiking: equal to the fused "
                  f"multiply-add chain, silent-block count equal")
        # where its time goes: the same kernel on parts of the real input,
        # beside the timing's own floor (one launch that writes one float)
        per_col = (s_loc != 0).sum(1)
        parts = {"all-silent": torch.zeros_like(s_loc),
                 "columns of <= 32 spiking sources": torch.where(
                     (per_col <= 32)[:, None], s_loc, 0.0),
                 "columns of > 32": torch.where(
                     (per_col > 32)[:, None], s_loc, 0.0),
                 "every source spiking": torch.ones_like(s_loc)}
        tiny = torch.zeros(1, device=self.dev)
        entry["ms_floor"] = self.time_ms(tiny.zero_)
        entry["ms_parts"] = {k: self.time_ms(lambda v=v: ops.synapse_matmul(
            v, w)) for k, v in parts.items()}
        self.note("  synapse_matmul on parts of the real input: "
                  + ", ".join(f"{k} {v:.4f} ms"
                              for k, v in entry["ms_parts"].items())
                  + f"; timing floor (a one-float fill) "
                  f"{entry['ms_floor']:.4f} ms")

    def local_balance(self, s_loc, t_len):
        """How unevenly the local product's work falls on fused_step's
        items: spiking sources per column, and the weight rows (of one
        item's targets) each CTA would read if every CTA took an equal,
        contiguous share of the items instead of claiming them."""
        c, n = s_loc.shape
        per_col = (s_loc != 0).sum(1).double()
        p = self.plan.plan("fused_step", c, n, t_len,
                           self.plan.sm_count(self.dev))
        per_item = per_col.repeat_interleave(p.items // c).cpu()
        shares = self.torch.tensor([float(per_item[p.item_range(b)].sum())
                                    for b in range(p.ctas)])
        out = dict(spiking_per_column_mean=float(per_col.mean()),
                   spiking_per_column_max=float(per_col.max()),
                   equal_share_rows_mean=float(shares.mean()),
                   equal_share_rows_max=float(shares.max()))
        self.report["kernels"]["fused_step"].update(out)
        # synapse_matmul: one CTA per item, each item reads every listed
        # row of its column (of its own targets)
        q = self.plan.plan("synapse_matmul", c, n, t_len,
                           self.plan.sm_count(self.dev))
        rows = per_col.repeat_interleave(q.items // c)
        sm = dict(items=q.items, ctas=q.ctas,
                  rows_per_item_mean=float(rows.mean()),
                  rows_per_item_max=float(rows.max()))
        self.report["kernels"]["synapse_matmul"].update(sm)
        self.note(f"  local product balance: spiking sources per column "
                  f"mean {out['spiking_per_column_mean']:.2f}, max "
                  f"{out['spiking_per_column_max']:.0f}; rows per CTA under "
                  f"equal shares of {p.ctas}: mean "
                  f"{out['equal_share_rows_mean']:.1f}, max "
                  f"{out['equal_share_rows_max']:.0f} (fused_step claims "
                  f"its items instead); synapse_matmul: {q.items} items on "
                  f"{q.ctas} CTAs, rows per item and per CTA mean "
                  f"{sm['rows_per_item_mean']:.2f}, max "
                  f"{sm['rows_per_item_max']:.0f}")

    def time_kernels(self, cfg, params, x, cur, nnz):
        """Kernel, plain version, one library call where there is one, and
        the bound, at the main path's shapes and this state's data."""
        torch, ops, ref, ncfg = self.torch, self.ops, self.ref, cfg.neuron
        c, n = x["v"].shape
        k = params.rem_flat.shape[-1]
        t = x["s_flat"].shape[1]
        f4 = 4
        # the weight rows of the sources that spiked are all the product
        # needs; the ELL idx+weights and the table are read once each
        rows = nnz * n * f4
        b_sm = 2 * c * n * f4 + rows
        b_ell = c * t * f4 + 2 * c * n * k * f4 + c * n * f4
        b_lif = 8 * c * n * f4
        b_fused = (2 * c * n * f4 + rows + c * t * f4 + 2 * c * n * k * f4
                   + 7 * c * n * f4)
        flops = {"synapse_matmul": 2 * nnz * n, "ell_gather": 2 * c * n * k,
                 "lif_step": 12 * c * n,
                 "fused_step": 2 * nnz * n + 2 * c * n * k + 14 * c * n}
        nbytes = {"synapse_matmul": b_sm, "ell_gather": b_ell,
                  "lif_step": b_lif, "fused_step": b_fused}
        args = (x["v"], x["c"], x["refrac"], x["s_loc"], params.w_local,
                x["s_flat"], params.rem_flat, params.rem_w, x["ext"])
        consts = ref.lif_constants(ncfg)
        fns = {
            "synapse_matmul": (
                lambda: ops.synapse_matmul(x["s_loc"], params.w_local),
                lambda: ref.synapse_matmul_ref(x["s_loc"], params.w_local)),
            "ell_gather": (
                lambda: ops.ell_gather(x["s_flat"], params.rem_flat,
                                       params.rem_w),
                lambda: ref.ell_gather_ref(x["s_flat"], params.rem_flat,
                                           params.rem_w)),
            "lif_step": (
                lambda: ops.lif_step(ncfg, x["v"], x["c"], x["refrac"], cur),
                lambda: ref.lif_step_ref(x["v"], x["c"], x["refrac"], cur,
                                         **consts)),
            "fused_step": (
                lambda: ops.fused_step(ncfg, *args),
                lambda: ref.fused_step_ref(ncfg, *args)),
        }
        library = {"synapse_matmul": self.library_bmm(x, params),
                   "ell_gather": self.library_spmv(x, params),
                   "lif_step": None, "fused_step": None}
        for name, (kernel, plain) in fns.items():
            ms = self.time_ms(kernel)
            plain_ms = self.time_ms(plain)
            lib_ms = (self.time_ms(library[name]) if library[name] else None)
            t_bytes = nbytes[name] / PEAK_BYTES_PER_S * 1e3
            t_ops = flops[name] / PEAK_F32_FLOPS * 1e3
            entry = self.report["kernels"][name]
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else
                         "operations", bytes=nbytes[name], flops=flops[name])
            if name in self.report["instances"]:
                entry.update(self.plan_entry(name, c, n, t))
            if name == "fused_step":
                # the same step with silent local spikes: the ELL + LIF part
                silent = torch.zeros_like(x["s_loc"])
                entry["ms_local_silent"] = self.time_ms(
                    lambda: ops.fused_step(ncfg, *args[:3], silent,
                                           *args[4:]))
            log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library "
                f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
                f"{entry['bound_ms']:.4f} ms by {entry['bound_by']}, "
                f"{nbytes[name]/1e9:.4f} GB"
                + (f"; with silent local spikes {entry['ms_local_silent']:.4f}"
                   " ms" if "ms_local_silent" in entry else "")
                + (f"; {entry['path']} path, {entry['ctas']} CTAs "
                   f"({entry['schedule']} schedule), {entry['smem_bytes']} B "
                   f"of shared memory each, registers {entry['registers']}, "
                   f"{entry['spill_bytes']} B spilled" if "path" in entry
                   else "")
                + (f"; a column with every source spiking "
                   f"{entry['ms_worst_column']:.4f} ms"
                   if "ms_worst_column" in entry else "") + ")")

    def library_bmm(self, x, params):
        """One cuBLAS batched product computing synapse_matmul."""
        torch = self.torch
        s = x["s_loc"].unsqueeze(1)
        want = self.ref.synapse_matmul_ref(x["s_loc"], params.w_local)
        self.close("library bmm", torch.bmm(s, params.w_local).squeeze(1),
                   want, scale=self.scale_local(x["s_loc"], params.w_local))
        return lambda: torch.bmm(s, params.w_local)

    def library_spmv(self, x, params):
        """One cuSPARSE CSR product computing ell_gather: row (c, n) holds
        the entries at columns c*T + idx[c, n, k] (duplicates summed when
        the matrix is built)."""
        torch = self.torch
        c, n, k = params.rem_flat.shape
        t = x["s_flat"].shape[1]
        rows = torch.arange(c * n, device=self.dev).repeat_interleave(k)
        cols = (params.rem_flat.long()
                + (torch.arange(c, device=self.dev) * t)[:, None, None])
        a = torch.sparse_coo_tensor(
            torch.stack([rows, cols.reshape(-1)]), params.rem_w.reshape(-1),
            size=(c * n, c * t), check_invariants=True
        ).coalesce().to_sparse_csr()
        del rows, cols
        tbl = x["s_flat"].reshape(-1)
        want = self.ref.ell_gather_ref(x["s_flat"], params.rem_flat,
                                       params.rem_w)
        self.close("library spmv", (a @ tbl).reshape(c, n), want,
                   scale=self.scale_remote(x["s_flat"], params.rem_flat,
                                           params.rem_w))
        return lambda: a @ tbl

    def check_four(self, name, ncfg, v, cc, refrac, s_loc, w, s_flat, idx,
                   rw, ext):
        """All four kernels against their plain versions on one set of
        inputs; returns the max abs errors and the fused spike flips."""
        ops, ref = self.ops, self.ref
        errs = {
            "synapse_matmul": self.close(
                f"synapse_matmul {name}", ops.synapse_matmul(s_loc, w),
                ref.synapse_matmul_ref(s_loc, w),
                scale=self.scale_local(s_loc, w)),
            "ell_gather": self.close(
                f"ell_gather {name}", ops.ell_gather(s_flat, idx, rw),
                ref.ell_gather_ref(s_flat, idx, rw),
                scale=self.scale_remote(s_flat, idx, rw)),
            "lif_step": self.close_step(
                f"lif_step {name}", ops.lif_step(ncfg, v, cc, refrac, ext),
                ref.lif_step_ref(v, cc, refrac, ext,
                                 **ref.lif_constants(ncfg)))[0]}
        self.equal(f"synapse_matmul {name} chain",
                   ops.synapse_matmul(s_loc, w),
                   ref.synapse_matmul_chain_ref(s_loc, w))
        args = (v, cc, refrac, s_loc, w, s_flat, idx, rw, ext)
        errs["fused_step"], flips = self.close_step(
            f"fused_step {name}", ops.fused_step(ncfg, *args),
            ref.fused_step_ref(ncfg, *args),
            scale=self.scale_step(s_loc, w, s_flat, idx, rw, ext))
        zero = ops.synapse_matmul(self.torch.zeros_like(s_loc), w)
        if float(zero.abs().max()) != 0.0:
            raise AssertionError(f"all-silent {name} is not 0")
        for kname, e in errs.items():
            entry = self.report["kernels"].setdefault(
                kname, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], e)
        return errs, flips

    def check_kernels_random(self, cfg, params, real):
        """Random spikes, table and state with the real weights."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(1)
        c, n = real["v"].shape

        def rnd(shape):
            return torch.rand(shape, generator=g, device=self.dev)

        s_loc = (rnd((c, n)) < 0.05).float()
        s_flat = (rnd(real["s_flat"].shape) < 0.05).float()
        v, cc = rnd((c, n)) * 21, rnd((c, n)) * 3
        refrac = (rnd((c, n)) * 3).int()
        ext = torch.poisson(torch.full((c, n), 1.62, device=self.dev),
                            generator=g) * 0.6
        errs, flips = self.check_four(
            "random", cfg.neuron, v, cc, refrac, s_loc, params.w_local,
            s_flat, params.rem_flat, params.rem_w, ext)
        exc = (~self.neuron_types(cfg, self.dev)).float()
        spikes = (rnd((c, n)) < 0.05).float()
        for lr in (1.0, 0.7):
            self.check_stdp(f"random lr={lr}", (
                params.w_local, rnd((c, n)) * 3 * exc, spikes * exc, spikes,
                rnd((c, n)) * 3), dict(a_plus=0.01, a_minus=0.012, lr=lr,
                                       w_max=0.84))
        self.note(f"phase 1 random at the main shapes: max abs err "
                  f"{max(errs.values()):.2e}, fused spike flips {flips}; "
                  f"synapse_matmul equal to the fused multiply-add chain; "
                  f"all-silent exact zeros; stdp_dense_update equal to its "
                  f"plain version at lr 1 and 0.7, and all-silent")

    def check_ragged(self):
        """Ragged shapes: N = 70, 130, 257 with odd column counts. The four
        kernels of the static step; stdp_dense_update at lr 1 and 0.7 and
        all-silent; fused_step's epilogues on a state with one NaN v and
        one v at -1e4, in non-refractory neurons of the first and last
        column."""
        torch = self.torch
        ncfg = self.dpsnn.GRID_24.neuron
        g = torch.Generator(device=self.dev).manual_seed(2)
        worst = 0.0
        for c, n, k, o in [(3, 70, 17, 20), (5, 130, 248, 20),
                           (7, 257, 31, 9)]:
            def rnd(*shape):
                return torch.rand(shape, generator=g, device=self.dev)
            t = o * n
            v, refrac = rnd(c, n) * 21, (rnd(c, n) * 3).int()
            args = (v, rnd(c, n) * 3, refrac, (rnd(c, n) < 0.1).float(),
                    (rnd(c, n, n) - 0.5) * 2, (rnd(c, t) < 0.1).float(),
                    (rnd(c, n, k) * t).int().clamp_(max=t - 1),
                    (rnd(c, n, k) - 0.5) * 2, rnd(c, n) * 3)
            errs, _ = self.check_four(f"{c}x{n}", ncfg, *args)
            worst = max(worst, *errs.values())

            w = (rnd(c, n, n) - 0.3) * 2
            w[w.abs() < 0.1] = 0.0                # absent synapses
            exc = (torch.arange(n, device=self.dev) < 0.8 * n).float()
            spikes = (rnd(c, n) < 0.1).float()
            x_pre, x_post = rnd(c, n) * 3, rnd(c, n) * 3
            for lr in (1.0, 0.7):
                self.check_stdp(f"{c}x{n} lr={lr}", (
                    w, x_pre * exc, spikes * exc, spikes, x_post),
                    dict(a_plus=0.05, a_minus=0.055, lr=lr, w_max=0.84))

            self.check_poisoned(f"{c}x{n}", ncfg, args, x_pre, x_post)
        self.note(f"phase 1 ragged (3x70, 5x130, 7x257): max abs err "
                  f"{worst:.2e}; synapse_matmul equal to the fused "
                  f"multiply-add chain; all-silent exact zeros; "
                  f"stdp_dense_update equal to its plain version; fused_step "
                  f"traces and flags "
                  f"equal, flags [1, 0.., 2] on the NaN/-1e4 state")

    def check_poisoned(self, name, ncfg, args, x_pre, x_post):
        """fused_step's epilogues (check_epilogues) on ``args`` with one
        NaN v and one v at -1e4, in non-refractory neurons of the first and
        last column: flags [1, 0.., 2]."""
        v, refrac = args[0].clone(), args[2].clone()
        c = v.shape[0]
        v[0, 5], refrac[0, 5] = float("nan"), 0
        v[c - 1, 7], refrac[c - 1, 7] = -1e4, 0
        flags, _ = self.check_epilogues(
            name, ncfg, (v, args[1], refrac, *args[3:]), x_pre, x_post,
            self.STDPConfig(), self.GuardConfig(enabled=True))
        if flags != [1] + [0] * (c - 2) + [2]:
            raise AssertionError(f"fused_step flags {flags} on the poisoned "
                                 f"{name} state")

    def check_wide_table(self):
        """ell_gather and the four fused_step instances on a table wider
        than 131,072 lanes and than the staged path's shared memory (T =
        180,000, K = 497), against their plain versions: both kernels take
        their wide path, and only it."""
        torch, ops, ref = self.torch, self.ops, self.ref
        g = torch.Generator(device=self.dev).manual_seed(3)
        c, n, k, t = 4, 1240, 497, 180_000

        def rnd(*shape):
            return torch.rand(shape, generator=g, device=self.dev)
        s_flat = (rnd(c, t) < 0.05).float()
        idx = torch.randint(0, t, (c, n, k), generator=g, device=self.dev,
                            dtype=torch.int32)
        w = torch.randn((c, n, k), generator=g, device=self.dev)
        ops.reset_launches()
        err = self.close("ell_gather wide", ops.ell_gather(s_flat, idx, w),
                         ref.ell_gather_ref(s_flat, idx, w),
                         scale=self.scale_remote(s_flat, idx, w))
        ncfg = self.dpsnn.GRID_24.neuron
        args = (rnd(c, n) * 21, rnd(c, n) * 3, (rnd(c, n) * 3).int(),
                (rnd(c, n) < 0.1).float(), (rnd(c, n, n) - 0.5) * 2, s_flat,
                idx, w, rnd(c, n) * 3)
        err_f, flips = self.close_step(
            "fused_step wide", ops.fused_step(ncfg, *args),
            ref.fused_step_ref(ncfg, *args), scale=self.scale_step(
                args[3], args[4], s_flat, idx, w, args[8]))
        self.check_poisoned("wide", ncfg, args, rnd(c, n) * 3, rnd(c, n) * 3)
        launches = dict(ops.LAUNCHES)
        want = self.expected_launches(**{"ell_gather.wide": 1,
                                         "fused_step.wide": 4})
        if launches != want:
            raise AssertionError(f"wide table launches {launches}, expected "
                                 f"{want}")
        for name, e in (("ell_gather", err), ("fused_step", err_f)):
            entry = self.report["kernels"].setdefault(name,
                                                      {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], e)
        self.note(f"phase 1 wide table (T = {t}, K = {k}): max abs err "
                  f"ell_gather {err:.2e}, fused_step {err_f:.2e} (spike flips "
                  f"{flips}); fused_step traces and flags equal, flags "
                  f"[1, 0.., 2] on the NaN/-1e4 state; launches on the wide "
                  f"path only ({launches['ell_gather.wide']} ell_gather, "
                  f"{launches['fused_step.wide']} fused_step)")

    def check_small_run(self):
        """4x4x64, 60 steps, three impls from one state and one drive:
        equal spikes and events, v at 2e-4. The network the card builds
        against the CPU's (mask, indices, state to the bit, weights at
        1e-6: erf_inv's log1p rounds per device), and the fused run that
        draws its own drive against the one fed the same counts."""
        torch = self.torch
        cfg = self.dpsnn.reduced(grid_h=4, grid_w=4, neurons=64, seed=0)
        params, state = self.sim.build(cfg, device=self.dev)
        cpu_params, cpu_state = self.sim.build(cfg, device="cpu")
        for leaf in ("rem_flat", "local_outdeg"):
            self.equal(f"card build {leaf}", getattr(params, leaf).cpu(),
                       getattr(cpu_params, leaf))
        self.equal("card build mask", params.w_local.cpu() != 0,
                   cpu_params.w_local != 0)
        self.equal("card build v", state.lif.v.cpu(), cpu_state.lif.v)
        for leaf in ("w_local", "rem_w"):
            self.close(f"card build {leaf}", getattr(params, leaf).cpu(),
                       getattr(cpu_params, leaf), rtol=1e-6, atol=0.0)
        ids = self.col_ids(cfg)
        counts = torch.stack([self.net.external_drive(cfg, t, ids)[1]
                              for t in range(60)])
        res = {impl: self.sim.run(cfg, params, state, 60, impl=impl,
                                  ext_counts=counts)
               for impl in ("ref", "cuda", "cuda_fused")}
        own = self.sim.run(cfg, params, state, 60, impl="cuda_fused")
        self.equal("own drive hist", own.state.hist,
                   res["cuda_fused"].state.hist)
        self.equal("own drive events", own.events, res["cuda_fused"].events)
        ref = res["ref"]
        for impl in ("cuda", "cuda_fused"):
            r = res[impl]
            if float(r.spikes) != float(ref.spikes):
                raise AssertionError(f"small run {impl}: {float(r.spikes)} "
                                     f"spikes, ref {float(ref.spikes)}")
            if float(r.events) != float(ref.events):
                raise AssertionError(f"small run {impl}: events differ")
            self.close(f"small run {impl} v", r.state.lif.v, ref.state.lif.v,
                       rtol=2e-4, atol=2e-4)
        self.note(f"phase 2 small run 4x4x64, 60 steps: {float(ref.spikes):.0f}"
                  f" spikes, {float(ref.events):.0f} events, rate "
                  f"{float(ref.rate_hz):.3f} Hz, equal under ref/cuda/"
                  f"cuda_fused, v allclose 2e-4; the card's build equal to "
                  f"the CPU's (weights at 1e-6); its own drive equal to the "
                  f"injected one")

    def check_small_plastic_run(self, steps=100):
        """4x4x48 with STDP and the guard on, three impls from one state
        and one drive: equal spikes and events, weights at 1e-6, equal
        masks of zero and negative weights, no trip."""
        torch = self.torch
        cfg = self.dpsnn.reduced(
            4, 4, 48, seed=3, stdp=True,
            stdp_cfg=self.STDPConfig(a_plus=0.05, a_minus=0.055),
            guard=self.GuardConfig(enabled=True))
        params, state = self.sim.build(cfg, device=self.dev)
        ids = self.col_ids(cfg)
        counts = torch.stack([self.net.external_drive(cfg, t, ids)[1]
                              for t in range(steps)])
        res = {impl: self.sim.run(cfg, params, state, steps, impl=impl,
                                  ext_counts=counts)
               for impl in ("ref", "cuda", "cuda_fused")}
        ref = res["ref"]
        for impl, r in res.items():
            self.check_weights(f"small plastic run {impl}", cfg, params,
                               r.params)
            if bool(r.state.guard.tripped):
                raise AssertionError(f"small plastic run {impl}: guard "
                                     f"tripped {r.state.guard}")
            if impl == "ref":
                continue
            if (float(r.spikes), float(r.events)) != (float(ref.spikes),
                                                      float(ref.events)):
                raise AssertionError(f"small plastic run {impl}: spikes or "
                                     f"events differ from ref")
            for leaf in ("w_local", "rem_w"):
                got, want = getattr(r.params, leaf), getattr(ref.params, leaf)
                self.close(f"small plastic run {impl} {leaf}", got, want,
                           **PLASTIC_TOL)
                for mask in (lambda x: x == 0, lambda x: x < 0):
                    self.equal(f"small plastic run {impl} {leaf} mask",
                               mask(got), mask(want))
        self.note(f"phase 2 small plastic guarded run 4x4x48, {steps} steps: "
                  f"{float(ref.spikes):.0f} spikes, {float(ref.events):.0f} "
                  f"events, equal under ref/cuda/cuda_fused, weights within "
                  f"1e-6, zero/negative masks equal, no trip")

    def check_weights(self, name, cfg, params0, params):
        """Plastic weights keep STDP's invariants against the weights the
        network was built with: at most w_max, absent synapses (zeros)
        still absent, inhibitory (negative) weights unchanged."""
        w_max = cfg.stdp_cfg.w_max_factor * cfg.conn.j_exc
        for leaf in ("w_local", "rem_w"):
            w0, w = getattr(params0, leaf), getattr(params, leaf)
            if float(w.max()) > self.ref._f32(w_max):
                raise AssertionError(f"{name} {leaf}: a weight above w_max")
            if bool((w[w0 == 0] != 0).any()):
                raise AssertionError(f"{name} {leaf}: an absent synapse grew")
            neg = w0 < 0
            if not self.torch.equal(w[neg], w0[neg]):
                raise AssertionError(f"{name} {leaf}: a negative weight moved")

    def timed_run(self, cfg, params, state, impl, counter=None):
        """``MAIN_STEPS`` steps with the launch counts set to 0 just before
        and read just after; device time by CUDA events, host time by the
        wall clock, both ending in a synchronize."""
        torch = self.torch
        self.sync()
        self.ops.reset_launches()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        w0 = time.perf_counter()
        e0.record()
        res = self.sim.run(cfg, params, state, MAIN_STEPS, impl=impl,
                           silent_blocks=counter)
        e1.record()
        self.sync()
        wall = time.perf_counter() - w0
        launches = dict(self.ops.LAUNCHES)
        return res, e0.elapsed_time(e1) / MAIN_STEPS, wall, launches

    def run_rate(self, cfg, res, state):
        """Mean rate (Hz) over the ``MAIN_STEPS`` steps from ``state`` to
        ``res.state``: the spikes of earlier steps are not counted."""
        spikes = float(res.spikes - state.spike_count)
        return spikes / (cfg.n_neurons * MAIN_STEPS * cfg.neuron.dt_ms * 1e-3)

    def profile(self, label, run, ms_per_step, steps=20):
        """Device time by kernel over ``steps`` steps of ``run(k)`` (which
        runs k steps; torch.profiler), the device's busy share (of the
        profiled wall time, and of ``ms_per_step``, the same path's step
        time with the profiler off), and the device time outside the
        port's kernels with its largest item."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        run(2)
        self.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            run(steps)
            self.sync()
            wall_us = (time.perf_counter() - w0) * 1e6
        by_name = {}     # device-side events only: the kernels themselves
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                by_name[ev.key] = (by_name.get(ev.key, 0.0)
                                   + ev.self_device_time_total)
        # the PyTorch op behind each launch (the port's kernels launch
        # through ctypes, outside any op)
        by_op = {ev.key: ev.self_device_time_total
                 for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CPU
                 and ev.self_device_time_total > 0}
        op = max(by_op.items(), key=lambda kv: kv[1], default=("none", 0.0))
        device_us = sum(by_name.values())
        outside = {k: us for k, us in by_name.items()
                   if not PORT_KERNEL_RE.search(k)}
        largest = max(outside.items(), key=lambda kv: kv[1],
                      default=("none", 0.0))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out = dict(impl=label, steps=steps,
                   wall_ms_per_step=wall_us / steps / 1e3,
                   device_ms_per_step=device_us / steps / 1e3,
                   outside_ms_per_step=sum(outside.values()) / steps / 1e3,
                   largest_outside=(largest[0][:60], largest[1] / steps),
                   largest_op=(op[0], op[1] / steps),
                   top_ops_us_per_step={k: v / steps for k, v in sorted(
                       by_op.items(), key=lambda kv: -kv[1])[:6]},
                   busy_share=device_us / wall_us,
                   busy_share_unprofiled=device_us / steps / 1e3
                   / ms_per_step,
                   top_us_per_step={k[:60]: v / steps for k, v in top})
        self.report.setdefault("profiles", []).append(out)
        log(f"  profile {label} ({steps} steps, profiler on): wall "
            f"{out['wall_ms_per_step']:.4f} ms/step, device "
            f"{out['device_ms_per_step']:.4f} ms/step (outside the port's "
            f"kernels {out['outside_ms_per_step']:.4f}; largest kernel "
            f"{largest[0][:50]} {largest[1] / steps:.1f} us; by op: "
            + ", ".join(f"{k} {v:.1f} us"
                        for k, v in out["top_ops_us_per_step"].items())
            + f"), busy share "
            f"{out['busy_share']:.3f} (of {ms_per_step:.4f} ms/step with "
            f"the profiler off: {out['busy_share_unprofiled']:.3f}); per "
            f"step: "
            + ", ".join(f"{k[:40]} {v:.1f} us"
                        for k, v in out["top_us_per_step"].items()))
        return out

    def main_path(self, cfg, params, state):
        torch, M = self.torch, self.M
        counter = torch.zeros(1, dtype=torch.int64, device=self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        fused, ms, wall, launches = self.timed_run(cfg, params, state,
                                                   "cuda_fused", counter)
        # every launch on the staged path: fused_step.wide stays at 0
        if launches != self.expected_launches(fused_step=MAIN_STEPS,
                                              keyed_drive=MAIN_STEPS):
            raise AssertionError(f"cuda_fused launches {launches}")
        for name in ("fused_step", "keyed_drive"):
            self.report["kernels"][name]["launches"] = launches[name]
        v = fused.state.lif.v
        if not bool(torch.isfinite(v).all()):
            raise AssertionError("main path: non-finite v")
        rate = self.run_rate(cfg, fused, state)
        if not 0.0 < rate < 100.0:
            raise AssertionError(f"main path rate {rate} Hz outside (0, 100)")
        events = float(fused.events - state.event_count)
        n_sblk = -(-cfg.neurons_per_column // 128)
        silent = int(counter) / (cfg.n_columns * n_sblk * MAIN_STEPS)
        peak_gb = torch.cuda.max_memory_allocated(self.dev) / 1e9
        main = dict(
            steps=MAIN_STEPS, rate_hz=rate, events=events,
            ms_per_step=ms, wall_s=wall,
            s_per_event=M.time_per_synaptic_event(ms * 1e-3 * MAIN_STEPS,
                                                  events),
            realtime_factor=M.realtime_factor(ms * 1e-3 * MAIN_STEPS,
                                              MAIN_STEPS, cfg.neuron.dt_ms),
            bytes_per_synapse=M.bytes_per_synapse(cfg, params, fused.state),
            silent_block_share=silent, launches=launches,
            peak_memory_gb=peak_gb)
        self.report["main_path"] = main
        log(f"phase 3 main path {cfg.name} impl=cuda_fused, {MAIN_STEPS} "
            f"steps after {WARMUP_STEPS}, every fused_step launch on the "
            f"staged path: rate {rate:.4f} Hz, events "
            f"{events:.6e}, {ms:.4f} ms/step (device), wall {wall:.3f} s, "
            f"{main['s_per_event']:.4e} s/event, realtime factor "
            f"{main['realtime_factor']:.4f}, bytes/synapse "
            f"{main['bytes_per_synapse']:.4f}, silent 128-block share "
            f"{silent:.4f}, peak memory {peak_gb:.2f} GB, launches "
            f"{launches}")

        self.profile("cuda_fused", lambda k: self.sim.run(
            cfg, params, fused.state, k, impl="cuda_fused"), ms)

        plain, ms_ref, wall_ref, launches_ref = self.timed_run(
            cfg, params, state, "ref")
        if launches_ref != self.expected_launches(keyed_drive=MAIN_STEPS):
            raise AssertionError(f"ref path launches {launches_ref}")
        rate_ref = self.run_rate(cfg, plain, state)
        if abs(rate - rate_ref) > 0.05 * rate_ref:
            raise AssertionError(f"main path rate {rate} Hz vs plain "
                                 f"{rate_ref} Hz: beyond 5 %")
        self.report["plain_path"] = dict(rate_hz=rate_ref,
                                         ms_per_step=ms_ref, wall_s=wall_ref)
        log(f"  plain path (impl=ref) same steps and drive: rate "
            f"{rate_ref:.4f} Hz, {ms_ref:.4f} ms/step (device), wall "
            f"{wall_ref:.3f} s, launches {launches_ref}")

        # one step from the same state, kernel against plain
        one_k = self.sim.run(cfg, params, fused.state, 1, impl="cuda_fused")
        one_p = self.sim.run(cfg, params, fused.state, 1, impl="ref")
        sk, sp = one_k.state, one_p.state
        t = int(fused.state.t)
        d = sk.hist.shape[0]
        x = self.step_inputs(cfg, params, fused.state)
        scale = self.scale_step(x["s_loc"], params.w_local, x["s_flat"],
                                params.rem_flat, params.rem_w, x["ext"])
        _err, flips = self.close_step(
            "one step", (sk.lif.v, sk.lif.c, sk.lif.refrac, sk.hist[t % d]),
            (sp.lif.v, sp.lif.c, sp.lif.refrac, sp.hist[t % d]), scale=scale)
        cur_k = (self.ops.synapse_matmul(x["s_loc"], params.w_local)
                 + self.ops.ell_gather(x["s_flat"], params.rem_flat,
                                       params.rem_w) + x["ext"])
        cur_p = (self.net.deliver_local_ref(x["s_loc"], params.w_local)
                 + self.net.deliver_remote_ref(x["s_flat"], params.rem_flat,
                                               params.rem_w) + x["ext"])
        cur_err = self.close("one step currents", cur_k, cur_p, scale=scale)
        self.note(f"  one step from step {t}: currents max abs err "
                  f"{cur_err:.2e}, v allclose 1e-5, spike flips {flips} of "
                  f"{v.numel()}")

        staged, ms_st, wall_st, launches_st = self.timed_run(
            cfg, params, state, "cuda")
        if launches_st != self.expected_launches(
                lif_step=MAIN_STEPS, synapse_matmul=MAIN_STEPS,
                ell_gather=MAIN_STEPS,      # ell_gather.wide stays at 0
                keyed_drive=MAIN_STEPS):
            raise AssertionError(f"cuda launches {launches_st}")
        for name in ("lif_step", "synapse_matmul", "ell_gather"):
            self.report["kernels"][name]["launches"] = launches_st[name]
        self.profile("cuda", lambda k: self.sim.run(
            cfg, params, fused.state, k, impl="cuda"), ms_st)
        rate_st = self.run_rate(cfg, staged, state)
        if abs(rate_st - rate_ref) > 0.05 * rate_ref:
            raise AssertionError(f"staged path rate {rate_st} Hz vs plain "
                                 f"{rate_ref} Hz: beyond 5 %")
        self.report["staged_path"] = dict(rate_hz=rate_st, ms_per_step=ms_st,
                                          wall_s=wall_st,
                                          launches=launches_st)
        log(f"  staged path (impl=cuda) same steps: rate {rate_st:.4f} Hz, "
            f"{ms_st:.4f} ms/step (device), wall {wall_st:.3f} s, launches "
            f"{launches_st}")
        return fused


    def plastic_path(self, pcfg, params0, pwarm):
        """The plastic guarded path at full width: ``cuda_fused``, then
        ``cuda`` and ``ref`` over the same steps from the same state and
        drive, each with the launch counts set to 0 just before and read
        just after."""
        torch, M = self.torch, self.M
        params, state = pwarm.params, pwarm.state
        counter = torch.zeros(1, dtype=torch.int64, device=self.dev)
        self.sync()
        torch.cuda.reset_peak_memory_stats(self.dev)
        runs, out = {}, {}
        for impl in ("cuda_fused", "cuda", "ref"):
            res, ms, wall, launches = self.timed_run(
                pcfg, params, state, impl,
                counter if impl == "cuda_fused" else None)
            per_step = {"cuda_fused": dict(fused_step=MAIN_STEPS),
                        "cuda": dict(lif_step=MAIN_STEPS,
                                     synapse_matmul=MAIN_STEPS,
                                     ell_gather=MAIN_STEPS),
                        "ref": {}}[impl]
            if impl != "ref":
                per_step["stdp_dense_update"] = MAIN_STEPS
                per_step["stdp_remote_update"] = MAIN_STEPS
            per_step["keyed_drive"] = MAIN_STEPS
            if launches != self.expected_launches(**per_step):
                raise AssertionError(f"plastic {impl} launches {launches}")
            if impl == "cuda_fused":
                for name in ("stdp_dense_update", "stdp_remote_update"):
                    self.report["kernels"][name]["launches"] = launches[name]
                peak_gb = torch.cuda.max_memory_allocated(self.dev) / 1e9
            g = res.state.guard
            if bool(g.tripped):
                raise AssertionError(f"plastic {impl}: guard tripped "
                                     f"({int(g.trip_code)} at step "
                                     f"{int(g.trip_step)})")
            if not bool(torch.isfinite(res.state.lif.v).all()):
                raise AssertionError(f"plastic {impl}: non-finite v")
            self.check_weights(f"plastic {impl}", pcfg, params0, res.params)
            dw = (res.params.w_local - params.w_local).abs()
            rate = self.run_rate(pcfg, res, state)
            events = float(res.events - state.event_count)
            out[impl] = dict(
                rate_hz=rate, events=events, ms_per_step=ms, wall_s=wall,
                s_per_event=M.time_per_synaptic_event(ms * 1e-3 * MAIN_STEPS,
                                                      events),
                realtime_factor=M.realtime_factor(ms * 1e-3 * MAIN_STEPS,
                                                  MAIN_STEPS,
                                                  pcfg.neuron.dt_ms),
                launches=launches,
                mean_abs_dw=float(dw.sum() / (params.w_local != 0).sum()),
                max_abs_dw=float(dw.max()))
            del dw
            runs[impl] = res
            log(f"phase 4 plastic guarded {pcfg.name} impl={impl}, "
                f"{MAIN_STEPS} steps after {WARMUP_STEPS}: rate {rate:.4f} Hz"
                f", {ms:.4f} ms/step (device), wall {wall:.3f} s, "
                f"{out[impl]['s_per_event']:.4e} s/event, realtime factor "
                f"{out[impl]['realtime_factor']:.4f}, STDP weight drift: "
                f"mean |dw| {out[impl]['mean_abs_dw']:.3e}, max "
                f"{out[impl]['max_abs_dw']:.3e}; no trip; launches "
                f"{launches}")
            if impl == "cuda_fused":
                self.profile(f"plastic {impl}", lambda k: self.sim.run(
                    pcfg, res.params, res.state, k, impl=impl), ms)
        fused = out["cuda_fused"]
        n_sblk = -(-pcfg.neurons_per_column // 128)
        fused.update(
            bytes_per_synapse=M.bytes_per_synapse(
                pcfg, runs["cuda_fused"].params, runs["cuda_fused"].state),
            silent_block_share=int(counter) / (pcfg.n_columns * n_sblk
                                               * MAIN_STEPS),
            peak_memory_gb=peak_gb)
        for impl in ("cuda_fused", "cuda"):
            r, p = out[impl]["rate_hz"], out["ref"]["rate_hz"]
            if abs(r - p) > 0.05 * p:
                raise AssertionError(f"plastic {impl} rate {r} Hz vs plain "
                                     f"{p} Hz: beyond 5 %")
            out[impl]["w_local_max_abs_diff_vs_ref"] = float(
                (runs[impl].params.w_local
                 - runs["ref"].params.w_local).abs().max())
        self.report["plastic_path"] = out
        log(f"  plastic cuda_fused: bytes/synapse "
            f"{fused['bytes_per_synapse']:.4f}, peak memory "
            f"{peak_gb:.2f} GB, silent 128-block share "
            f"{fused['silent_block_share']:.4f}; rates within 5 % of ref; "
            f"w_local max |diff| vs ref: cuda_fused "
            f"{out['cuda_fused']['w_local_max_abs_diff_vs_ref']:.2e}, cuda "
            f"{out['cuda']['w_local_max_abs_diff_vs_ref']:.2e}")

    def guard_neutrality(self, pcfg, pwarm, steps=NEUTRAL_STEPS):
        """``steps`` plastic steps under ``cuda_fused`` from one state and
        drive, guard on against guard off: history, spike and event counts
        and the weights to the bit."""
        params, state = pwarm.params, pwarm.state
        off_cfg = dataclasses.replace(pcfg, guard=self.GuardConfig())
        on = self.sim.run(pcfg, params, state, steps, impl="cuda_fused")
        off = self.sim.run(off_cfg, params, state._replace(guard=None), steps,
                           impl="cuda_fused")
        for name, a, b in (("hist", on.state.hist, off.state.hist),
                           ("spikes", on.spikes, off.spikes),
                           ("events", on.events, off.events),
                           ("w_local", on.params.w_local, off.params.w_local),
                           ("rem_w", on.params.rem_w, off.params.rem_w)):
            self.equal(f"guard neutrality {name}", a, b)
        if bool(on.state.guard.tripped) or off.state.guard is not None:
            raise AssertionError("guard neutrality: tripped, or a guard "
                                 "state without the guard")
        self.note(f"  guard on vs off, {steps} plastic steps under "
                  f"cuda_fused: hist, spikes ({float(on.spikes):.0f}), events "
                  f"and weights equal to the bit; no trip")

    # ------------------------------------------------------------ phase 5
    def hold_against_single(self, name, spec, res, final, fused):
        """A multi-rank run of the main path against phase 3's single-shard
        ``cuda_fused`` run (same seed, same 220 steps): spikes, the
        per-step spike counts, v and the last spike frame to the bit;
        events to the bit while float32 holds them exactly, else within
        EVENTS_RTOL (a total past 2**24 rounds by how it was split over
        shards). Returns the run's ISI totals and whether every shard's
        ISI accumulators stayed exact."""
        ld = self.ld
        if float(res.spikes) != float(fused.spikes):
            raise AssertionError(f"{name}: {float(res.spikes)} spikes, "
                                 f"single shard {float(fused.spikes)}")
        self.equal(f"{name} per-step spikes", res.rate_trace,
                   fused.rate_trace)
        self.equal(f"{name} v", self.part.columns_to_global(final.lif.v,
                                                            spec),
                   fused.state.lif.v)
        t, d = int(fused.state.t), fused.state.hist.shape[0]
        self.equal(f"{name} last spike frame",
                   self.part.tiles_to_global(final.pending, spec).reshape(
                       fused.state.hist[0].shape),
                   fused.state.hist[(t - 1) % d])
        if not ld.events_agree(float(res.events), float(fused.events)):
            raise AssertionError(f"{name}: events {float(res.events)} vs "
                                 f"single shard {float(fused.events)}")
        leaves = (final.isi_sum, final.isi_sumsq, final.isi_count)
        return (tuple(float(x.double().sum()) for x in leaves),
                tuple(float(x.max()) < ld.EXACT for x in leaves))

    def hold_isi(self, runs):
        """ISI totals over runs, ``(name, (sum, sum of squares, count),
        (exact, exact, exact))``: each total equal to the bit among the
        runs whose per-shard float32 accumulators of it stayed exact
        integers (below 2**24), the others within EVENTS_RTOL of them.
        Returns, per total, its value and how many runs held it bitwise."""
        held = []
        for i, label in enumerate(("ISI sum", "ISI sum of squares",
                                   "ISI count")):
            exact = [isi[i] for _name, isi, ok in runs if ok[i]]
            want = exact[0] if exact else runs[0][1][i]
            for name, isi, ok in runs:
                got = isi[i]
                if (got != want if ok[i] and exact else
                        abs(got - want) > self.ld.EVENTS_RTOL * want):
                    raise AssertionError(f"{name}: {label} {got}, held "
                                         f"against {want}")
            held.append((label, want, len(exact), len(runs)))
        return held

    def mesh_run(self, cfg, mesh, params, impl):
        """WARMUP_STEPS untimed steps from the seed, then MAIN_STEPS timed
        from there, the launch counts set to 0 just before and read just
        after; device time by CUDA events, host time by the wall clock."""
        torch, ex = self.torch, self.ex
        kw = dict(impl=impl, with_state=True, params=params)
        warm, spec = ex.make_distributed_run(cfg, mesh,
                                             n_steps=WARMUP_STEPS, **kw)
        timed, _ = ex.make_distributed_run(cfg, mesh, n_steps=MAIN_STEPS,
                                           **kw)
        warm_res, state = warm()
        self.sync()
        self.ops.reset_launches()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        w0 = time.perf_counter()
        e0.record()
        res, final = timed(state)
        e1.record()
        self.sync()
        wall = time.perf_counter() - w0
        launches = dict(self.ops.LAUNCHES)

        def run_k(k):
            return ex.make_distributed_run(cfg, mesh, n_steps=k,
                                           **kw)[0](final)
        return (res, final, spec, e0.elapsed_time(e1) / MAIN_STEPS, wall,
                launches, run_k, warm_res)

    def mesh_path(self, cfg, params, fused):
        """Phase 5a: the main path's grid over in-process shard grids from
        1x1 to 24x24 (all shards stacked into each launch), under
        ``cuda_fused``, and 2x2 under ``cuda`` and pipelined. Each mesh
        takes the single shard's network (``params``) in its own column
        order; on the finest mesh ``exchange.build_shard`` builds it from
        the seed as well, and the two must agree to the bit."""
        torch = self.torch
        per_step = {"cuda_fused": dict(fused_step=MAIN_STEPS,
                                       keyed_drive=MAIN_STEPS),
                    "cuda": dict(lif_step=MAIN_STEPS,
                                 synapse_matmul=MAIN_STEPS,
                                 ell_gather=MAIN_STEPS,
                                 keyed_drive=MAIN_STEPS)}
        # (shape, impl, pipelined, compress); the last packs every strip
        # on the finest mesh as a process rank does, to show what the
        # packed wire costs there
        cases = [(shape, "cuda_fused", False, False) for shape in MESHES]
        cases[2:2] = [((2, 2), "cuda", False, False),
                      ((2, 2), "cuda_fused", True, False)]
        cases.append((MESHES[-1], "cuda_fused", False, True))
        out, isi_runs, built = [], [], {}
        for shape, impl, pipelined, compress in cases:
            name = (f"mesh {shape[0]}x{shape[1]} {impl}"
                    f"{' pipelined' if pipelined else ''}"
                    f"{' packed wire' if compress else ''}")
            mesh = self.LocalMesh(*shape, self.dev, compress=compress)
            build_s = None
            if shape not in built:
                built.clear()
                spec = self.part.make_tile_spec(cfg, *shape)
                ids = self.ex.shard_col_ids(cfg, spec, mesh, self.dev).long()
                built[shape] = self.net.NetworkParams(*(x[ids]
                                                        for x in params))
                if shape == MESHES[-1]:
                    t0 = time.perf_counter()
                    seeded = self.ex.build_shard(cfg, spec, mesh)
                    self.sync()
                    build_s = time.perf_counter() - t0
                    for leaf, a, b in zip(seeded._fields, seeded,
                                          built[shape]):
                        self.equal(f"{name} build_shard {leaf}", a, b)
                    del seeded
            run_cfg = dataclasses.replace(
                cfg, exchange=self.ExchangeConfig(pipelined=pipelined))
            res, final, spec, ms, wall, launches, run_k, _ = self.mesh_run(
                run_cfg, mesh, built[shape], impl)
            # every launch on the staged path: the .wide counts stay at 0
            if launches != self.expected_launches(**per_step[impl]):
                raise AssertionError(f"{name} launches {launches}")
            isi, exact = self.hold_against_single(name, spec, res, final,
                                                  fused)
            isi_runs.append((name, isi, exact))
            prof = self.profile(name, run_k, ms, steps=10)
            payload = self.payload_bytes(run_cfg, spec)["bytes_per_step"]
            row = dict(mesh=list(shape), impl=impl, pipelined=pipelined,
                       compress=compress,
                       tile=f"{spec.tile_h}x{spec.tile_w}",
                       rings=[spec.rings_y, spec.rings_x],
                       shifts_per_step=spec.permutes_per_step,
                       ms_per_step=ms, wall_s=wall, build_s=build_s,
                       device_ms_per_step=prof["device_ms_per_step"],
                       outside_kernels_ms_per_step=prof[
                           "outside_ms_per_step"],
                       largest_outside=prof["largest_outside"],
                       largest_outside_op=prof["largest_op"],
                       halo_payload_bytes_per_step=payload,
                       ring_mb=final.hist_ext.numel() * 4 / 1e6,
                       launches=launches, isi_exact=exact)
            out.append(row)
            log(f"phase 5 {name}: tiles {row['tile']}, rings "
                f"{spec.rings_y}+{spec.rings_x}, {ms:.4f} ms/step (device "
                f"events), wall {wall:.3f} s, device time "
                f"{row['device_ms_per_step']:.4f} ms/step of which outside "
                f"the kernels {row['outside_kernels_ms_per_step']:.4f}, "
                f"halo {payload} B/step per interior shard on the packed "
                f"wire, ring {row['ring_mb']:.1f} MB"
                + ("" if build_s is None else
                   f", build_shard from the seed in {build_s:.2f} s, equal "
                   f"to the single shard's network to the bit")
                + "; "
                f"spikes, per-step spikes, v, last frame bitwise, events "
                f"{float(res.events):.6e} (single "
                f"{float(fused.events):.6e}); launches {launches}")
            del res, final
        built.clear()
        isi = self.hold_isi(isi_runs)
        self.report["mesh_path"] = out
        big = out[-2]
        first, last = ("x".join(map(str, m)) for m in (MESHES[0],
                                                       MESHES[-1]))
        self.note(f"phase 5a: every mesh {first}..{last} one "
                  f"fused_step and one keyed_drive launch per step (all "
                  f"staged), 2x2 cuda one of each staged kernel; each held "
                  f"to phase 3 (spikes, per-step spikes, v bitwise; events "
                  f"within {self.ld.EVENTS_RTOL:g} past 2**24); "
                  + "; ".join(f"{label} {v:.9g} bitwise in {n} of {m} runs "
                              f"(the rest past 2**24, within "
                              f"{self.ld.EVENTS_RTOL:g})"
                              for label, v, n, m in isi)
                  + f"; largest item outside the kernels at "
                  f"{last}: kernel {big['largest_outside'][0]} "
                  f"{big['largest_outside'][1]:.1f} us/step, op "
                  f"{big['largest_outside_op'][0]} "
                  f"{big['largest_outside_op'][1]:.1f} us/step")
        torch.cuda.empty_cache()
        return isi_runs

    def rank_path(self, cfg, fused, isi_runs):
        """Phase 5b: 2 and 4 ranks as OS processes on gloo, each on this
        card, through the launcher, against its single_process_reference
        (and that against phase 3), their ISI totals with phase 5a's
        ``isi_runs``. Ranks sharing one card time-slice it: their ms/step
        is no scaling figure."""
        import tempfile

        import numpy as np
        ld = self.ld
        common = ["--grid", f"{cfg.grid_h}x{cfg.grid_w}",
                  "--neurons", str(cfg.neurons_per_column),
                  "--steps", str(WARMUP_STEPS + MAIN_STEPS),
                  "--seed", str(cfg.seed), "--impl", "cuda_fused",
                  "--device", self.dev.type, "--timeout", str(RANK_TIMEOUT_S)]
        single, out = None, []
        for ranks in RANKS:
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
                args = ld.make_parser().parse_args(
                    ["--ranks", str(ranks), *common, "--state-dir", d])
                w0 = time.perf_counter()
                row = ld.launch(args)
                row["launch_wall_s"] = time.perf_counter() - w0
                states = self.mp.load_states(d, ranks)
            if single is None:
                single = ld.single_process_reference(args)
                if (single["spikes"] != float(fused.spikes)
                        or not np.array_equal(
                            single["v"], fused.state.lif.v.cpu().numpy())):
                    raise AssertionError("single_process_reference differs "
                                         "from phase 3's run")
            spec = self.part.make_rank_tile_spec(cfg, ranks)
            v = self.part.columns_to_global(states["v"], spec)
            if (row["spikes"] != single["spikes"]
                    or not np.array_equal(v, single["v"])):
                raise AssertionError(f"{ranks} ranks: spikes or v differ "
                                     f"from single_process_reference")
            if not ld.events_agree(row["events"], single["events"]):
                raise AssertionError(f"{ranks} ranks: events {row['events']}"
                                     f" vs {single['events']}")
            if row["library_build_s_max"] != 0.0:
                raise AssertionError(f"{ranks} ranks: a rank rebuilt the "
                                     f"kernel library")
            isi = tuple(float(states[k].astype(np.float64).sum())
                        for k in ("isi_sum", "isi_sumsq", "isi_count"))
            exact = tuple(float(states[k].max()) < ld.EXACT
                          for k in ("isi_sum", "isi_sumsq", "isi_count"))
            isi_runs.append((f"{ranks} ranks", isi, exact))
            out.append(row)
            log(f"phase 5 {ranks} ranks as processes (gloo, every rank on "
                f"this card, time-sliced: no scaling figure): process grid "
                f"{row['process_grid']}, tiles {row['tile']}, "
                f"{row['step_ms']:.4f} ms/step (wall, {row['steps']} steps), "
                f"halo {row['halo_payload_bytes_per_step']} B/step per "
                f"interior rank, launch {row['launch_wall_s']:.1f} s; spikes "
                f"and v bitwise, events {row['events']:.6e} vs "
                f"{single['events']:.6e}; no rank rebuilt the library; row "
                f"{json.dumps(row, sort_keys=True)}")
        self.report["isi"] = self.hold_isi(isi_runs)
        self.report["rank_path"] = out
        self.note(f"phase 5b: {' and '.join(map(str, RANKS))} ranks equal "
                  f"to single_process_reference (spikes, v bitwise; events "
                  f"within {ld.EVENTS_RTOL:g} past 2**24), which equals "
                  f"phase 3's run; over every phase-5 run: "
                  + "; ".join(f"{label} {v:.9g} bitwise in {n} of {m}"
                              for label, v, n, m in self.report["isi"]))

    # ----------------------------------------------------------- phase 5c
    def wire_cfg(self, cfg, mode="dense_packed", rate=None, auto=False):
        """``cfg`` with the halo's wire format, AER rate bound and per-ring
        policy set."""
        conn = dataclasses.replace(
            cfg.conn, exchange_mode=mode,
            aer_rate_bound_hz=rate or cfg.conn.aer_rate_bound_hz)
        return dataclasses.replace(cfg, conn=conn, exchange=self.ExchangeConfig(
            exchange_mode="auto" if auto else "inherit"))

    def hold_prefix(self, name, res, warm, fused):
        """A run whose event lists overflowed: its per-step spike counts
        (warm-up and timed) equal phase 3's on every step before the first
        flagged one. Returns the flagged steps and the first's index."""
        torch = self.torch
        sat = torch.cat([warm.aer_saturated, res.aer_saturated]).cpu()
        flagged = sat.nonzero().flatten().tolist()
        first = flagged[0] if flagged else len(sat)
        got = torch.cat([warm.rate_trace, res.rate_trace])[:first]
        want = torch.cat([self.warm_trace, fused.rate_trace])[:first]
        self.equal(f"{name} per-step spikes before the first flagged step",
                   got, want)
        return flagged, first

    def wire_path(self, cfg, params, fused):
        """Phase 5c: the AER event-list wire, the per-ring auto wire and
        the hierarchical two-level exchange on in-process meshes, each
        WARMUP_STEPS + MAIN_STEPS from the seed as phase 5a. AER at a bound
        whose capacity reaches every strip's units, and the hierarchical
        mesh (24x24 shards in nodes of 1x4, dense and AER), equal phase 3
        to the bit; AER and auto at the default bound print their
        saturated steps and equal phase 3 up to the first of them."""
        torch, comp = self.torch, self.comp
        per_step = self.expected_launches(fused_step=MAIN_STEPS,
                                          keyed_drive=MAIN_STEPS)
        free = AER_FREE_HZ
        node24 = self.part.make_node_spec(24, 24, 4)
        cases = [  # (name, shape, cfg, node, saturation allowed)
            ("aer 2x2 at the free bound", (2, 2),
             self.wire_cfg(cfg, "aer_sparse", free), None, False),
            ("aer 2x2 at the default bound", (2, 2),
             self.wire_cfg(cfg, "aer_sparse"), None, True),
            ("aer 24x24 at the free bound", (24, 24),
             self.wire_cfg(cfg, "aer_sparse", free), None, False),
            ("aer 24x24 at the default bound", (24, 24),
             self.wire_cfg(cfg, "aer_sparse"), None, True),
            ("auto 24x24 at the default bound", (24, 24),
             self.wire_cfg(cfg, auto=True), None, True),
            ("hier 24x24 nodes of 1x4 dense", (24, 24), cfg, node24, False),
            ("hier 24x24 nodes of 1x4 aer at the free bound", (24, 24),
             self.wire_cfg(cfg, "aer_sparse", free), node24, False),
        ]
        out, built, sat_runs = [], {}, {}
        for name, shape, run_cfg, node, may_saturate in cases:
            mesh = self.LocalMesh(*shape, self.dev, node=node)
            spec = self.part.make_tile_spec(cfg, *shape)
            if shape not in built:
                built.clear()
                ids = self.ex.shard_col_ids(cfg, spec, mesh, self.dev).long()
                built[shape] = self.net.NetworkParams(*(x[ids]
                                                        for x in params))
            res, final, spec, ms, wall, launches, run_k, warm = \
                self.mesh_run(run_cfg, mesh, built[shape], "cuda_fused")
            if launches != per_step:
                raise AssertionError(f"{name} launches {launches}")
            mode = ("auto" if run_cfg.exchange.exchange_mode == "auto"
                    else run_cfg.conn.exchange_mode)
            row = dict(case=name, mesh=list(shape), mode=mode,
                       rate_bound_hz=run_cfg.conn.aer_rate_bound_hz,
                       node=None if node is None else list(node),
                       tile=f"{spec.tile_h}x{spec.tile_w}")
            if node is None:
                pay = comp.halo_payload_bytes(run_cfg, spec, mode=mode)
                row["aer_capacities"] = sorted(set(pay["aer_capacities"]))
            else:
                pay = comp.hier_payload_bytes(run_cfg, spec, node, mode=mode)
                row["inter_node_bytes_per_node"] = pay[
                    "inter_node_bytes_per_node"]
                row["intra_node_bytes_per_rank"] = pay[
                    "intra_node_bytes_per_rank"]
            row["halo_payload_bytes_per_step"] = pay["bytes_per_step"]
            if mode == "auto":
                table = comp.ring_mode_table(run_cfg, spec)
                want = {(e["phase"], e["ring"]): e["mode"] for e in table}
                got = self.ex.resolve_ring_modes(
                    run_cfg, spec, compress=mesh.priced_compress)
                if got != want:
                    raise AssertionError(f"{name}: ring modes {got}, "
                                         f"ring_mode_table {want}")
                row["per_ring"] = [
                    {k: e[k] for k in ("phase", "ring", "rows", "cols",
                                       "dense_bytes", "aer_bytes",
                                       "aer_capacity", "mode")}
                    for e in table]
            flagged, first = self.hold_prefix(name, res, warm, fused)
            row.update(saturated_steps=len(flagged),
                       first_saturated_step=flagged[0] if flagged else None)
            if not may_saturate:
                if flagged:
                    raise AssertionError(f"{name}: {len(flagged)} saturated "
                                         f"steps at a bound that cannot "
                                         f"saturate")
                self.hold_against_single(name, spec, res, final, fused)
                held = "spikes, per-step spikes, v, last frame bitwise"
            elif flagged:
                held = (f"per-step spikes bitwise on the {first} steps "
                        f"before the first flagged one")
            else:
                self.hold_against_single(name, spec, res, final, fused)
                # why not: the largest count of one strip's units that
                # the ring's last frames hold (a horizontal strip on 1x1
                # tiles is one column)
                r = spec.radius
                inner = final.hist_ext[:, :, r:r + spec.tile_h,
                                       r:r + spec.tile_w]
                row["largest_column_count"] = float(inner.sum(-1).max())
                held = (f"no step flagged (largest column count in the "
                        f"ring's last frames {row['largest_column_count']:.0f}"
                        f"); spikes, per-step spikes, v bitwise")
            if may_saturate:
                sat_runs[name] = (float(res.spikes), res.aer_saturated)
            prof = self.profile(name, run_k, ms, steps=10)
            row.update(ms_per_step=ms, wall_s=wall,
                       device_ms_per_step=prof["device_ms_per_step"],
                       outside_kernels_ms_per_step=prof[
                           "outside_ms_per_step"],
                       largest_outside=prof["largest_outside"],
                       largest_outside_op=prof["largest_op"],
                       launches=launches)
            out.append(row)
            log(f"phase 5c {name}: tiles {row['tile']}, {ms:.4f} ms/step "
                f"(device events), wall {wall:.3f} s, device time "
                f"{row['device_ms_per_step']:.4f} ms/step of which outside "
                f"the kernels {row['outside_kernels_ms_per_step']:.4f} "
                f"(largest op {row['largest_outside_op'][0]} "
                f"{row['largest_outside_op'][1]:.1f} us/step), halo "
                f"{row['halo_payload_bytes_per_step']} B/step per interior "
                f"{'shard' if node is None else 'rank (hierarchical)'} "
                f"({mode}), saturated steps {len(flagged)} of "
                f"{WARMUP_STEPS + MAIN_STEPS}"
                + (f" (first at step {flagged[0]})" if flagged else "")
                + f"; {held}; launches {launches}"
                + (f"; per-ring table {row['per_ring']}"
                   if mode == "auto" else ""))
            del res, final
        built.clear()
        # auto resolves every ring to AER at 24x24 and the default bound:
        # the same run as the uniform AER one, overflows included
        aer, auto = (sat_runs[f"{m} 24x24 at the default bound"]
                     for m in ("aer", "auto"))
        if all(e["mode"] == "aer_sparse" for e in out[4]["per_ring"]):
            if aer[0] != auto[0]:
                raise AssertionError(f"auto 24x24: {auto[0]} spikes, aer "
                                     f"{aer[0]}")
            self.equal("auto 24x24 saturation flags", auto[1], aer[1])
        self.report["wire_path"] = out
        self.note(f"phase 5c: AER at {free:g} Hz (2x2, 24x24) and the "
                  f"hierarchical 24x24 mesh in nodes of 1x4 (dense, AER) "
                  f"equal phase 3 to the bit with no saturated step; at the "
                  f"default {cfg.conn.aer_rate_bound_hz:g} Hz bound AER 2x2 "
                  f"saturated {out[1]['saturated_steps']}, AER 24x24 "
                  f"{out[3]['saturated_steps']}, auto 24x24 "
                  f"{out[4]['saturated_steps']} of "
                  f"{WARMUP_STEPS + MAIN_STEPS} steps, each equal to phase 3 "
                  f"before its first flagged step")
        torch.cuda.empty_cache()

    def launch_ranks(self, cfg, ranks, flags, d):
        """``ranks`` gloo ranks on this card through the launcher, from the
        seed for WARMUP_STEPS + MAIN_STEPS steps, states written to
        ``d``."""
        args = self.ld.make_parser().parse_args(
            ["--ranks", str(ranks), "--grid", f"{cfg.grid_h}x{cfg.grid_w}",
             "--neurons", str(cfg.neurons_per_column),
             "--steps", str(WARMUP_STEPS + MAIN_STEPS),
             "--seed", str(cfg.seed), "--impl", "cuda_fused",
             "--device", self.dev.type, "--timeout", str(RANK_TIMEOUT_S),
             "--state-dir", d, *flags])
        w0 = time.perf_counter()
        row = self.ld.launch(args)
        row["launch_wall_s"] = time.perf_counter() - w0
        return row, self.mp.load_states(d, ranks)

    def wire_rank_path(self, cfg, fused):
        """Phase 5c, ranks: 4 gloo ranks in nodes of 2 (dense), held to
        phase 3's run (which phase 5b holds to single_process_reference);
        and 2 ranks on AER at a 1 Hz bound, which overflows, held to an
        in-process 1x2 mesh of the same config: spikes, v and the
        per-step saturation flags to the bit, across transports."""
        import tempfile

        import numpy as np
        torch = self.torch
        out = []
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            row, states = self.launch_ranks(cfg, 4,
                                            ["--ranks-per-node", "2"], d)
        spec = self.part.make_rank_tile_spec(cfg, 4)
        v = self.part.columns_to_global(states["v"], spec)
        if (row["spikes"] != float(fused.spikes)
                or not np.array_equal(v, fused.state.lif.v.cpu().numpy())):
            raise AssertionError("4 ranks in nodes of 2: spikes or v differ "
                                 "from phase 3")
        if not self.ld.events_agree(row["events"], float(fused.events)):
            raise AssertionError(f"4 ranks in nodes of 2: events "
                                 f"{row['events']}")
        out.append(row)
        log(f"phase 5c 4 ranks in nodes of 2 (dense, gloo, every rank on "
            f"this card): node grid {row['node_grid']}, "
            f"{row['step_ms']:.4f} ms/step (wall), halo "
            f"{row['halo_payload_bytes_per_step']} B/step per rank "
            f"(inter-node {row['inter_node_bytes_per_node']} B per node, "
            f"intra-node {row['intra_node_bytes_per_rank']} B per rank), "
            f"saturated steps {row['aer_saturated_steps']}, launch "
            f"{row['launch_wall_s']:.1f} s; spikes and v equal phase 3 to "
            f"the bit; device time not measured (other processes)")
        low = self.wire_cfg(cfg, "aer_sparse", RANK_AER_HZ)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            row, states = self.launch_ranks(
                cfg, 2, ["--exchange-mode", "aer_sparse", "--aer-rate-bound",
                         str(RANK_AER_HZ)], d)
        mesh = self.LocalMesh(1, 2, self.dev)
        run, spec = self.ex.make_distributed_run(
            low, mesh, n_steps=WARMUP_STEPS + MAIN_STEPS, impl="cuda_fused",
            with_state=True)
        res, final = run()
        sat = res.aer_saturated.cpu()
        if (row["spikes"] != float(res.spikes)
                or row["aer_saturated_per_step"] != sat.tolist()
                or not np.array_equal(states["v"],
                                      final.lif.v.cpu().numpy())):
            raise AssertionError("2 AER ranks: spikes, saturation flags or "
                                 "v differ from the in-process 1x2 mesh")
        if not int(sat.sum()):
            raise AssertionError(f"2 AER ranks at {RANK_AER_HZ} Hz: no step "
                                 f"saturated")
        out.append(row)
        log(f"phase 5c 2 ranks on AER at {RANK_AER_HZ:g} Hz (gloo): "
            f"{row['step_ms']:.4f} ms/step (wall), halo "
            f"{row['halo_payload_bytes_per_step']} B/step per interior rank, "
            f"saturated steps {row['aer_saturated_steps']} of "
            f"{row['steps']}, launch {row['launch_wall_s']:.1f} s; spikes "
            f"({row['spikes']:.0f}), v and every step's saturation flag "
            f"equal the in-process 1x2 mesh to the bit")
        del res, final
        torch.cuda.empty_cache()
        self.report["wire_rank_path"] = out


if __name__ == "__main__":
    sys.exit(main())
