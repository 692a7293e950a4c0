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
   included; (d) the multi-rank plastic step (STDP on, guard off) on the
   same grid and steps, the pre-trace halo on every wire beside the
   spikes: 2x2 shards under ``cuda_fused`` and ``cuda``, 24x24 shards
   (two chained rings) and 24x24 in nodes of 1x4 under ``cuda_fused``,
   2x2 AER at the bound that cannot overflow, and 2 ranks as processes
   with ``--stdp``, each held to a single-shard plastic run of the same
   impl from the same seed: spikes, per-step spikes, v, the live weights
   ``w_local`` and ``rem_w`` and the traces ``x_pre`` and ``x_post`` to
   the bit, events as in (a); each in-process mesh with one launch of
   each of its kernels per step for all its shards (``fused_step`` with
   its STDP epilogue, ``stdp_dense_update``, ``stdp_remote_update``,
   ``keyed_drive``; or the staged kernels), its device time and largest
   op outside the kernels, halo bytes with the trace strips, and peak
   memory;
6. drives the batched multi-tenant service (``core/batched.py``,
   ``launch/serve.py``) on the same grid under ``cuda_fused``, after
   holding every tenant-axis kernel (one launch for B tenants) to one
   launch per tenant and to its plain version on random inputs
   (``synapse_matmul`` also over each of ``SYNAPSE_TENANT_CASES``, to
   the FMA chain): (a) a
   one-slot server's job of seed 42 equals phase 3's run to the bit;
   (b) four static tenants (seeds 42-45, ``nu_scale`` 1.0, 0.8, 1.0,
   1.5) each equal their dedicated ``simulation.run(seed=, nu_scale=)``,
   with one ``fused_step`` and one ``keyed_drive`` launch per loop step
   for all four and one copy of the weights; (c) 8 jobs of staggered
   durations recycled through 4 slots, under ``cuda_fused`` and under
   ``cuda``, every JobResult equal to its dedicated run; (d) four plastic
   guarded tenants of 30 to 50 steps in one chunk, weights and traces
   equal to their dedicated plastic runs (the first kept its weights
   through its batch-mates' last steps), with peak memory; (e) the guard
   on and one of
   four tenants poisoned at step 9: quarantined at step 9, its
   batch-mates equal an unpoisoned server's; then the static service's
   ms per loop step, tenant-steps/s and device time at B = 1, 2, 4, 8,
   and ``fused_step`` and ``keyed_drive`` over B tenants beside their
   bounds (``fused_step`` also as one launch per tenant); the
   tenant-axis kernels at B = 4 join the ``{"kernels": ...}`` line with
   their library calls (``torch.bmm`` for ``synapse_matmul``, cuSPARSE
   ``A @ X`` of B columns for ``ell_gather``) and their plans
   (``synapse_matmul``'s CTAs, one tenant a CTA);
7. drives the batched service over shard meshes and ranks
   (``exchange.make_batched_distributed_run``) on the same grid: 6b's
   four tenants for 20 + 100 steps from their seeds on in-process meshes
   of 2x2 and 24x24 shards under ``cuda_fused``, on the dense wire and on
   AER at a bound that cannot overflow (0 saturated steps), 2x2 under
   ``cuda``, and the first two tenants plastic on 2x2; then 2 gloo ranks
   with 2 tenants, on one spatial grid and over 2 batch shards, through
   the launcher. Every tenant equals its dedicated single-shard run to
   the bit (spikes, per-step spikes, v, and the plastic weights and
   traces; events within 1e-6 past 2**24), with one ``fused_step`` (or
   one of each staged kernel) and one ``keyed_drive`` launch per step for
   all tenants and shards; each case prints its ms per loop step,
   tenant-steps/s, device busy share and peak memory;
8. drives the integrity guard on the multi-rank step and the supervised
   ranks on the same grid: (a) in-process meshes of 2x2 and 24x24 shards
   on the dense wire, 2x2 on AER at the bound that cannot overflow, and
   24x24 in nodes of 1x4, each with the guard on (every halo message
   framed with a checksum word, ``fused_step``'s guard-flag instance over
   all shards' rows, one launch per step) for phase 3's steps, equal to
   phase 3 to the bit (spikes, per-step spikes, v) with no checksum
   failure and every guard leaf of every shard equal to the plain
   verdict from phase 3's per-column spike counts (a shard of one
   column trips the reference's per-shard spike ceiling when more than
   half its neurons fire in one step), its ms/step beside phase 5's
   without the guard; a
   bit flipped on a halo message at step 25 and a NaN at step 30 trip
   every shard at that step with their codes; (b) 2 gloo ranks on this
   card under the launcher's supervisor, a checkpoint every 20 of 80
   steps, rank 1 killed at step 50 and the run restarted on 1 rank from
   the resharded step-40 checkpoint: one restart, 10 lost steps, the
   totals and the v of the final checkpoint equal to the single
   process's run, with the checkpoint's bytes and seconds per save; (c)
   the flip drill, ``--guard --chaos-flip-bit 0:25:3`` on 2 ranks, 60
   steps, a checkpoint every 10: the guard trips, the ranks exit with its
   code, and the restart rolls back to step 20 and finishes clean and
   equal to the single process;
9. drives what completes the simulator on the same grid: (a) the paper's
   weak-scaling protocol, a tile of 12x12 columns a rank on 1, 2 and 4
   gloo ranks (grids 12x12, 12x24 and 24x24) with ``--weak --timed-reps
   3``, each bitwise against its single-process run (the 4-rank grid is
   phase 3's, whose run serves, under ``--no-check-single``), with its
   ms/step, events/s and weak efficiency (every rank on this card: no
   scaling figure); (b) 2 ranks of 2 shards each (``--shards-per-rank
   2``, a 1x4 shard grid) on the dense wire and on AER at the bound that
   cannot overflow, each equal to phase 3 to the bit (spikes, per-step
   spikes, v), and 2 ranks x 2 shards x phase 7's 2 tenants equal to
   phase 7's tenants; (c) the guarded batched mesh, phase 7's 4 tenants
   on 2x2 shards under ``cuda_fused`` with each tenant's strips framed
   apart, bitwise against phase 7's unguarded run with no trip, its ms
   per loop step beside phase 7's, and a bit flipped at step 25 tripping
   every (shard, tenant) there with code 16; (d) the Izhikevich neuron,
   100 steps of a (576, 1240) state of RS and FS neurons on the card,
   equal to the same function on the CPU (whose run is most of the
   phase's time: 1000 steps took 64 s on the host of an H100 machine, 300
   steps 26 s, so the steps were cut, not the state);
10. drives the LM zoo's serving path (``repro_torch.models``, plain torch:
   the reference computes it in plain ``jnp``, with no Pallas kernel), its
   parameters from the port's own ``init`` on the card from a seeded
   generator, TF32 off: (a) qwen3-0.6b at full config, in float32 2
   sequences of 48 tokens teacher-forced through ``decode`` equal to
   ``forward``'s logits within 2e-2 (the reference test's tolerance),
   then in bfloat16 ``examples/serve_decode.py``'s loop at 8 requests,
   prompt 24, 48 generated, with its decode ms/step (median after the
   first step, CUDA events), tokens/s, the prefill of the prompts, device
   ops a step and busy share (profiled), parameter GB and peak memory;
   (b) gemma2-9b at full config the same way (its float32 check at full
   width and 8 of 42 layers, freed before the bfloat16 model), and a 2048-token prefill through
   ``_blockwise_attn`` (2 x 2 blocks of 1024, one call a layer) against
   the direct path, within 1e-3 in float32 and within 2.0 max abs and
   2e-2 relative in bfloat16; (c) internvl2-1b at full config,
   ``prefill_logits`` over 256 patch embeddings and 64 tokens at batch 4,
   then 32 greedy decode steps; (d) the reduced configs of qwen3-0.6b,
   granite-3-2b, gemma2-9b, gemma2-27b and internvl2-1b, drawn on the
   card and carried to the CPU: ``forward``, 48 teacher-forced decode
   steps (gemma2's rolling caches wrap) and the final caches within
   1e-4, and equal greedy tokens;
11. drives the rest of the LM zoo's serving path (MoE, Mamba2, Zamba2,
   Whisper: no Pallas kernel in the reference either) the same way, each
   model at full width from the port's ``init`` (seed 0), freed before
   the next, bfloat16 serving at 8 requests x (24 + 48) through
   ``models.model.greedy`` with phase 10's figures: (a)
   llama4-scout-17b-a16e cut to 12 of its 48 layers (54.9 GB of
   bfloat16 parameters; all 48 are 213 GB), after a float32 check at 4
   layers (1 x 8 tokens through ``decode`` equal to ``forward`` within
   2e-2; no token can drop there); (b) llama4-maverick-400b-a17b cut to
   2 of 48 layers, one (dense, MoE) group (35.0 GB), served only; (c)
   mamba2-780m and (d) zamba2-7b at full depth, each with a float32
   check on 1 x 256 tokens (at full width and 8 and 15 layers) and
   ``prefill_logits`` on 8 x 256 (whole SSD chunks of 256); (e) whisper-medium at full depth, its encoder on 8 x
   2048 frames (timed; 3000 are not whole blocks of 1024, which both
   packages refuse), the cross caches primed from it and served over,
   after a float32 check on 1 x 2048 frames x 48 tokens; (f) the reduced
   configs of the five archs, card against CPU as in (10d);
12. drives the LM zoo's training path (``repro_torch.launch.train``,
   ``optim``, ``data``; plain torch, no Pallas kernel in the reference
   either): (a) qwen3-0.6b at its published size (bfloat16, remat
   "block", parameters from ``init_state`` seeded 0), 20 AdamW steps on
   ``TokenPipeline(vocab, 8, 1024, seed=1)``, then 2 at microbatch 2,
   with the step ms (median after the first), tokens/s, the model-FLOP
   share of the dense bfloat16 peak, peak memory and a profile; the
   loss must be finite and fall (mean of the last 5 steps below the
   first 5); in float32 at 2 layers the chunked head equals the direct
   cross-entropy (loss 1e-5, gradients rtol 2e-4 atol 2e-5) and remat
   "block" the gradients of "none" (1e-6 of each leaf's largest value);
   (b) the reduced configs of all ten archs, card against CPU: the loss,
   every gradient leaf and one AdamW step within 1e-4, and 3 steps each
   of 8-bit AdamW, adafactor and int8-EF on reduced qwen3, each from the
   card's state;
13. drives the LM zoo on a ``DeviceMesh`` (``runtime/sharding.py``, the
   reference's rules as DTensor placements; plain torch): (a)
   ``launch/train.make_sharded_train_step`` on a one-rank NCCL mesh of
   shape (1, 1) over the card, for the reduced configs of qwen3-0.6b,
   llama4-scout (MoE) and mamba2-780m, 3 steps each, and qwen3 again
   under 8-bit AdamW, against the unsharded card step from the same
   seed: the losses and every parameter (and the 8-bit moments' codes
   and scales) equal to the bit (else the largest difference is printed
   and the phase fails); (b) started with the phase and collected after
   (a), so that no timed phase shares the host with them, three cells
   of the dry run
   (``launch/dryrun.py``: meta DTensors on a fake process group of 256
   or 512 ranks, on the host's cores, one process a cell): qwen3-0.6b
   ``train_4k`` on 16x16, llama4-maverick ``decode_32k`` on 2x16x16 and
   dpsnn ``96x96`` on 16x16, each timed, with its per-device bytes,
   FLOPs and collective bytes.

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
import math
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
    "(" + "|".join((*TPU_KERNELS, *PORT_KERNELS)) + ")(_cluster)?_kernel")
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
# phase 5d: the final leaves a plastic mesh or rank run is held to, bitwise
PLASTIC_LEAVES = ("v", "w_local", "rem_w", "x_pre", "x_post")
PLASTIC_TOL = dict(rtol=1e-6, atol=1e-6)   # weights across impls
# phase 6: the batched service. 6b's tenants (seed, nu_scale), the chunk,
# the batch widths timed (each for SERVICE_TIMED loop steps after
# WARMUP_STEPS), 6d's plastic durations (one per tenant), and the width
# of the tenant-axis kernels' entries in the {"kernels": ...} line: the
# width at which 6b, 6c and 6d run them
SERVICE_TENANTS = ((42, 1.0), (43, 0.8), (44, 1.0), (45, 1.5))
SERVICE_CHUNK = 32
SERVICE_WIDTHS = (1, 2, 4, 8)
SERVICE_TIMED = 100
SERVICE_PLASTIC_STEPS = (30, 50, 50, 40)
TENANT_B = 4
# the widths at which the tenant-axis ELL kernels are held to one launch
# per tenant: the cluster path's clusters of 2, 3, 4 and 8 CTAs, and two
# groups of 6
TENANT_CHECK_WIDTHS = (2, 3, 4, 8, 12)
# synapse_matmul over B tenants in one launch, each case held to one
# launch per tenant and to the FMA chain, to the bit: (tenants, columns,
# neurons, the tenants that spike nowhere). 1, 2, 3, 4, 8 and 12
# tenants; 257 neurons (4-byte copies); one tenant silent, and all;
# 8 tenants of 4096 neurons
SYNAPSE_TENANT_CASES = tuple((b, 5, 300, ()) for b in (1, 2, 3, 4, 8, 12)) + (
    (3, 5, 257, ()), (4, 5, 300, (2,)), (4, 5, 257, (0, 1, 2, 3)),
    (8, 2, 4096, ()))
# the {"kernels": ...} entry of fused_step's STDP-trace and guard-flag
# instance over 6d's plastic tenants
PLASTIC_FUSED = f"fused_step+stdp+guard[B={TENANT_B}]"
# the kernels that take the tenant axis (lif_step runs on its rows as is)
TENANT_KERNELS = ("keyed_drive", "synapse_matmul", "ell_gather",
                  "fused_step", "stdp_dense_update", "stdp_remote_update")
# phase 7: the plastic tenants of the batched mesh (the first of 6b's),
# and the steps each case's profile covers
PLASTIC_TENANTS = 2
PROFILE_STEPS = 10
# phase 8: the guard's chaos on an in-process mesh (send ordinal, step,
# word of the flip; the NaN's step), and the supervised ranks: 8b's
# steps, checkpoint cadence, killed rank and step; 8c's flip drill
CHAOS_STEPS = 40
FLIP = (0, 25, 3)
NAN_STEP = 30
SUPERVISED_STEPS, SUPERVISED_EVERY = 80, 20
KILL_RANK, KILL_STEP = 1, 50
DRILL_STEPS, DRILL_EVERY, DRILL_FLIP = 60, 10, "0:25:3"
# phase 9: the weak-scaling tile (columns a rank), rank counts and timed
# repeats; the shards a rank holds in 9b; 9d's Izhikevich state (GRID_24's
# columns and neurons), steps (100, cut from 300 to keep the script
# inside its limit: the CPU's run of the same steps took 26 s), inhibitory
# share and the bank of currents its steps cycle through
WEAK_TILE, WEAK_RANKS, WEAK_REPS = (12, 12), (1, 2, 4), 3
SHARDS_PER_RANK = 2
IZH_SHAPE, IZH_STEPS, IZH_INH, IZH_BANK = (576, 1240), 100, 0.2, 16
# phase 10, the LM serving path: the archs whose reduced configs 10d
# holds against the CPU, and its tolerance (float32, TF32 off); the
# float32 decode-against-forward check at full width (batch, tokens) and
# its tolerance (tests/test_models.py's); the served requests, prompt and
# generated tokens (examples/serve_decode.py's defaults); gemma2-9b's
# long prefill (batch 1, two blocks of 1024 each way) and its tolerance
# against the direct path in float32 (bfloat16's difference is reported,
# not gated); internvl2-1b's batch, patches, text
# tokens and decode steps; profiled decode steps (3, cut from 10 to keep
# the script inside its limit: the profiler's parse of a step's thousands
# of events took seconds a step)
LM_ARCHS = ("qwen3-0.6b", "granite-3-2b", "gemma2-9b", "gemma2-27b",
            "internvl2-1b")
LM_CARD_TOL = 1e-4
LM_CHECK, LM_CHECK_TOL = (2, 48), 2e-2
LM_SERVE = (8, 24, 48)
LM_LONG, LM_LONG_F32_TOL = 2048, 1e-3
LM_VLM = (4, 256, 64, 32)
LM_PROFILE_STEPS = 3
# phase 11, the rest of the LM zoo: the five archs (11f holds their
# reduced configs against the CPU); the layers served of the two MoE
# configs (bfloat16 parameters that fit one card: 12 of 48 is 54.9 GB
# for scout, 2 is one (dense, MoE) group of 35.0 GB for maverick); the
# float32 MoE check's layers and (batch, tokens); the SSM checks' (batch,
# tokens) and their prefill, whole chunks of 256; whisper's frames (the
# encoder's batch is LM_SERVE's) and its float32 check (batch, frames,
# tokens)
LM_FAMILY_ARCHS = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
                   "mamba2-780m", "zamba2-7b", "whisper-medium")
LM_MOE_LAYERS = {"llama4-scout-17b-a16e": 12, "llama4-maverick-400b-a17b": 2}
LM_MOE_CHECK_LAYERS, LM_MOE_CHECK = 4, (1, 8)
LM_SSM_CHECK, LM_SSM_PREFILL = (1, 256), (8, 256)
LM_WHISPER_FRAMES, LM_WHISPER_CHECK = 2048, (1, 2048, 48)
# the float32 checks of phases 10b, 11c and 11d at full width cut in
# depth (to keep the script inside its limit with phase 12): gemma2-9b
# at 8 of 42 layers, mamba2-780m at 8 of 48, zamba2-7b at 15 of 81 (two
# groups of 6 and a tail of 3, as its reduced config); bfloat16 serving
# stays at full depth
LM_CHECK_LAYERS = {"gemma2-9b": 8, "mamba2-780m": 8, "zamba2-7b": 15}
# phase 12, LM training: qwen3-0.6b at full size, bfloat16, remat
# "block", AdamW (lr 1e-3 after 5 warmup steps, as the reference's
# loss-decrease test) on TokenPipeline(vocab, 8, 1024, seed=1); the steps,
# then the steps at microbatch 2; the profiled steps; the card's dense
# bfloat16 peak (H100 SXM, FLOP/s) for the model-FLOP share; the float32
# checks at 2 layers on (batch, tokens) of two head chunks of 512, at the
# reference's tests/test_loss.py tolerances and, for remat against none,
# 1e-6 of each leaf's largest value; 12b's reduced configs (the
# reference's tests/test_models.py::_batch shapes), its learning rate
# (small, so that an element whose tiny gradient differs in sign between
# the card and the CPU, which AdamW moves by +-lr, stays inside
# LM_CARD_TOL), the optimizers' steps on reduced qwen3, and the share of
# parameter elements the quantizing ones may put beyond LM_CARD_TOL
LM_TRAIN = dict(batch=8, seq=1024, seed=1, steps=20, mb_steps=2,
                lr=1e-3, warmup=5)
LM_TRAIN_PROFILE_STEPS = 3
BF16_PEAK_FLOPS = 989e12
LM_TRAIN_CHECK, LM_TRAIN_CHECK_LAYERS = (2, 1024), 2
LM_REMAT_TOL = 1e-6
LM_TRAIN_REDUCED_LR = 1e-5
LM_TRAIN_OPTIMIZERS = ("adamw8bit", "adafactor", "int8_ef")
LM_TRAIN_OPT_STEPS = 3
LM_QUANTIZED_SHARE = 1e-3
# 12a's memory check: launch/cost.py's predicted peak of one step, and
# its temporaries, within this share of max_memory_allocated's
LM_PEAK_TOL = 0.10
# phase 13: the reduced configs the sharded step runs (dense, MoE, SSM),
# its steps, and the dry-run cells, timed while it runs (gemma2-27b
# prefill_32k, the fourth cell asked for, traces 32 x 32 attention
# blocks a layer in DTensor's Python dispatch: minutes, past the
# phase's budget; it runs under ``dryrun --all``)
LM_MESH_ARCHS = ("qwen3-0.6b", "llama4-scout-17b-a16e", "mamba2-780m")
LM_MESH_STEPS = 3
DRYRUN_CELLS = (("--arch", "qwen3-0.6b", "--shape", "train_4k"),
                ("--arch", "llama4-maverick-400b-a17b", "--shape",
                 "decode_32k", "--multipod"),
                ("--dpsnn", "96x96"))
DRYRUN_TIMEOUT = 600


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
    smoke = Smoke(torch)
    try:
        return smoke.run()
    finally:
        smoke.stop_dryrun()


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
        from repro_torch.runtime import (compression, integrity,
                                         multiprocess, transport)
        self.ex, self.part, self.ld, self.mp = (exchange, partition,
                                                launch_distributed,
                                                multiprocess)
        self.LocalMesh = transport.LocalMesh
        self.integrity = integrity
        from repro_torch.core import neuron
        self.neuron = neuron
        from repro_torch.core import batched
        from repro_torch.launch import serve
        self.batched, self.serve = batched, serve
        import repro_torch.configs as lm_configs
        from repro_torch import convert
        from repro_torch.models import attention as lm_attention
        from repro_torch.models import model as lm_model
        from repro_torch.models import transformer as lm_transformer
        self.LC, self.LA, self.LM = lm_configs, lm_attention, lm_model
        self.LT = lm_transformer
        self.convert = convert
        from repro_torch.data import pipeline as lm_data
        from repro_torch.launch import cost as lm_cost
        from repro_torch.launch import train as lm_train
        from repro_torch.optim import optimizer as lm_optim
        self.LD, self.TR, self.LO = lm_data, lm_train, lm_optim
        self.cost = lm_cost
        self.TrainConfig = base.TrainConfig
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
        # 5d. the plastic meshes, held to a single-shard plastic run
        plastic_one = self.plastic_mesh_path(cfg, params)
        del params
        torch.cuda.empty_cache()
        self.rank_path(cfg, fused, isi_runs)
        self.wire_rank_path(cfg, fused)
        self.plastic_rank_path(cfg, plastic_one)
        del plastic_one
        torch.cuda.empty_cache()

        # 6. the batched multi-tenant service, held to phase 3 and to each
        # tenant's dedicated run; 7. the batched service over shard meshes
        # and ranks, each tenant held to its dedicated run
        params, _ = self.sim.build(cfg, device=self.dev)
        self.service_path(cfg, fused, params)
        self.batched_mesh_path(cfg, params)

        # 8. the guard on the multi-rank step, held to phase 3, and the
        # supervised ranks, held to the single process
        self.guard_path(cfg, params, fused)

        # 9. weak scaling, several shards per rank, the guarded batched
        # mesh and the Izhikevich neuron
        self.completion_path(cfg, params, fused)
        del params, fused
        torch.cuda.empty_cache()

        # 10. the LM zoo's serving path: qwen3-0.6b, gemma2-9b and
        # internvl2-1b at full config, the reduced configs against the CPU
        self.lm_path()

        # 11. the rest of the LM zoo: the two llama4 MoE configs cut in
        # depth, mamba2, zamba2 and whisper at full size, the reduced
        # configs against the CPU
        self.lm_families_path()

        # 12. LM training: qwen3-0.6b at full size, its float32 checks, the
        # reduced configs and the optimizers against the CPU
        self.lm_train_path()

        # 13. the LM zoo on a DeviceMesh: the sharded train step on a
        # one-rank mesh against the unsharded step, and dry-run cells
        self.lm_mesh_path()

        tenant = {f"{name}[B={TENANT_B}]": name for name in TENANT_KERNELS}
        tenant[PLASTIC_FUSED] = "fused_step"
        names = {**{name: name for name in (*TPU_KERNELS, *PORT_KERNELS)},
                 **tenant}
        kernels = [dict(name=label, route="cuda", source=SOURCES[name],
                        replaces={**TPU_KERNELS, **PORT_KERNELS}[name],
                        tpu_kernel=TPU_KERNELS.get(name),
                        **self.report["kernels"][label])
                   for label, name in names.items()]
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
            if re.search(r"ell_gather_cluster_kernel", mangled):
                out["ell_gather"]["cluster"] = info
                continue
            m = re.search(r"(ell_gather|fused_step|stdp_remote_update)"
                          r"_kernelI((?:Lb[01]E)+)E", mangled)
            if m is None:
                continue
            # <STAGED[, STDP, GUARD, CLUSTER]>
            flags = [f == "1" for f in re.findall(r"Lb([01])E", m[2])]
            label = ("cluster" if flags[3:] == [True] else "staged"
                     if flags[0] else "wide") + "".join(
                f"+{e}" for e, on in zip(("stdp", "guard"), flags[1:3]) if on)
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
        """One cuSPARSE CSR product computing ell_gather (``ell_csr``)."""
        c, n, _ = params.rem_flat.shape
        a = self.ell_csr(params, x["s_flat"].shape[1])
        tbl = x["s_flat"].reshape(-1)
        want = self.ref.ell_gather_ref(x["s_flat"], params.rem_flat,
                                       params.rem_w)
        self.close("library spmv", (a @ tbl).reshape(c, n), want,
                   scale=self.scale_remote(x["s_flat"], params.rem_flat,
                                           params.rem_w))
        return lambda: a @ tbl

    def ell_csr(self, params, t):
        """The ELL delivery as one CSR matrix: row (c, n) holds the
        entries at columns c*T + idx[c, n, k] (duplicates summed)."""
        torch = self.torch
        c, n, k = params.rem_flat.shape
        rows = torch.arange(c * n, device=self.dev).repeat_interleave(k)
        cols = (params.rem_flat.long()
                + (torch.arange(c, device=self.dev) * t)[:, None, None])
        return torch.sparse_coo_tensor(
            torch.stack([rows, cols.reshape(-1)]), params.rem_w.reshape(-1),
            size=(c * n, c * t), check_invariants=True
        ).coalesce().to_sparse_csr()

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
        launches = 0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                by_name[ev.key] = (by_name.get(ev.key, 0.0)
                                   + ev.self_device_time_total)
                launches += ev.count
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
                   device_ops_per_step=launches / steps,
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
            + f"), {out['device_ops_per_step']:.1f} device ops a step, "
            f"busy share "
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

    # ----------------------------------------------------------- phase 5d
    def plastic_single(self, pcfg, params, impl):
        """The oracle of phase 5d: the single-shard plastic run (guard off)
        from the seed, WARMUP_STEPS + MAIN_STEPS under ``impl``: per-step
        spikes, totals, and the final v, weights and traces in global
        column order."""
        state0 = self.net.init_state(pcfg, range(pcfg.n_columns),
                                     device=self.dev)
        warm = self.sim.run(pcfg, params, state0, WARMUP_STEPS, impl=impl)
        res = self.sim.run(pcfg, warm.params, warm.state, MAIN_STEPS,
                           impl=impl)
        return dict(trace=self.torch.cat([warm.rate_trace, res.rate_trace]),
                    spikes=float(res.spikes), events=float(res.events),
                    v=res.state.lif.v, w_local=res.params.w_local,
                    rem_w=res.params.rem_w, x_pre=res.state.stdp.x_pre,
                    x_post=res.state.stdp.x_post)

    def hold_plastic(self, name, spec, got, one):
        """A plastic run's totals and final leaves (``got``: the keys of
        :meth:`plastic_single`, leaves stacked by shard) against the
        single shard's: all to the bit, events within EVENTS_RTOL past
        2**24."""
        if got["spikes"] != one["spikes"]:
            raise AssertionError(f"{name}: {got['spikes']} spikes, single "
                                 f"shard {one['spikes']}")
        self.equal(f"{name} per-step spikes", got["trace"], one["trace"])
        for leaf in PLASTIC_LEAVES:
            self.equal(f"{name} {leaf}",
                       self.part.columns_to_global(got[leaf], spec),
                       one[leaf])
        if not self.ld.events_agree(got["events"], one["events"]):
            raise AssertionError(f"{name}: events {got['events']} vs single "
                                 f"shard {one['events']}")

    def plastic_mesh_path(self, cfg, params):
        """Phase 5d: the plastic step (STDPConfig() defaults, guard off) on
        in-process meshes of the main path's grid, WARMUP_STEPS +
        MAIN_STEPS from the seed as phase 5a, each held to the single-shard
        plastic run of its impl. Returns the ``cuda_fused`` oracle's
        leaves on the host, for the plastic ranks."""
        torch, comp = self.torch, self.comp
        pcfg = dataclasses.replace(cfg, stdp=True)
        node24 = self.part.make_node_spec(24, 24, 4)
        aer = self.wire_cfg(pcfg, "aer_sparse", AER_FREE_HZ)
        per_step = {
            "cuda_fused": dict(fused_step=MAIN_STEPS),
            "cuda": dict(lif_step=MAIN_STEPS, synapse_matmul=MAIN_STEPS,
                         ell_gather=MAIN_STEPS)}
        for counts in per_step.values():
            counts.update(keyed_drive=MAIN_STEPS,
                          stdp_dense_update=MAIN_STEPS,
                          stdp_remote_update=MAIN_STEPS)
        cases = [  # (name, shape, cfg, node, impl), grouped by impl
            ("2x2 cuda_fused", (2, 2), pcfg, None, "cuda_fused"),
            (f"2x2 aer at {AER_FREE_HZ:g} Hz", (2, 2), aer, None,
             "cuda_fused"),
            ("24x24 cuda_fused", (24, 24), pcfg, None, "cuda_fused"),
            ("24x24 nodes of 1x4", (24, 24), pcfg, node24, "cuda_fused"),
            ("2x2 cuda", (2, 2), pcfg, None, "cuda")]
        out, built, oracle, host = [], {}, {}, None
        for name, shape, run_cfg, node, impl in cases:
            name = f"plastic mesh {name}"
            if impl not in oracle:
                oracle.clear()
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                oracle[impl] = self.plastic_single(pcfg, params, impl)
                self.sync()
                log(f"phase 5d single-shard plastic {impl} oracle, "
                    f"{WARMUP_STEPS + MAIN_STEPS} steps from seed "
                    f"{pcfg.seed} in {time.perf_counter() - t0:.2f} s: "
                    f"{oracle[impl]['spikes']:.0f} spikes")
                if impl == "cuda_fused":
                    host = {k: (x.cpu().numpy() if k in PLASTIC_LEAVES
                                else x) for k, x in oracle[impl].items()}
            one = oracle[impl]
            mesh = self.LocalMesh(*shape, self.dev, node=node)
            spec = self.part.make_tile_spec(cfg, *shape)
            if shape not in built:
                built.clear()
                torch.cuda.empty_cache()
                ids = self.ex.shard_col_ids(cfg, spec, mesh, self.dev).long()
                built[shape] = self.net.NetworkParams(*(x[ids]
                                                        for x in params))
            torch.cuda.reset_peak_memory_stats(self.dev)
            res, final, spec, ms, wall, launches, run_k, warm = \
                self.mesh_run(run_cfg, mesh, built[shape], impl)
            peak_gb = torch.cuda.max_memory_allocated(self.dev) / 1e9
            if launches != self.expected_launches(**per_step[impl]):
                raise AssertionError(f"{name} launches {launches}")
            if int(warm.aer_saturated.sum() + res.aer_saturated.sum()):
                raise AssertionError(f"{name}: an event list overflowed")
            pl = final.plastic
            self.hold_plastic(name, spec, dict(
                trace=torch.cat([warm.rate_trace, res.rate_trace]),
                spikes=float(res.spikes), events=float(res.events),
                v=final.lif.v, w_local=pl.w_local, rem_w=pl.rem_w,
                x_pre=pl.traces.x_pre, x_post=pl.traces.x_post), one)
            del pl
            prof = self.profile(name, run_k, ms, steps=10)
            mode = run_cfg.conn.exchange_mode
            if node is None:
                pay = comp.halo_payload_bytes(run_cfg, spec)
                static = comp.halo_payload_bytes(run_cfg, spec, stdp=False)
            else:
                pay = comp.hier_payload_bytes(run_cfg, spec, node)
                static = comp.hier_payload_bytes(run_cfg, spec, node,
                                                 stdp=False)
            row = dict(case=name, mesh=list(shape), impl=impl, mode=mode,
                       node=None if node is None else list(node),
                       tile=f"{spec.tile_h}x{spec.tile_w}",
                       ms_per_step=ms, wall_s=wall,
                       device_ms_per_step=prof["device_ms_per_step"],
                       outside_kernels_ms_per_step=prof[
                           "outside_ms_per_step"],
                       largest_outside=prof["largest_outside"],
                       largest_outside_op=prof["largest_op"],
                       halo_payload_bytes_per_step=pay["bytes_per_step"],
                       static_halo_payload_bytes_per_step=static[
                           "bytes_per_step"],
                       peak_memory_gb=peak_gb,
                       launches_per_step={k: v / MAIN_STEPS
                                          for k, v in launches.items() if v})
            out.append(row)
            log(f"phase 5d {name}: tiles {row['tile']}, {ms:.4f} ms/step "
                f"(device events), wall {wall:.3f} s, device time "
                f"{row['device_ms_per_step']:.4f} ms/step of which outside "
                f"the kernels {row['outside_kernels_ms_per_step']:.4f} "
                f"(largest op {row['largest_outside_op'][0]} "
                f"{row['largest_outside_op'][1]:.1f} us/step), halo "
                f"{row['halo_payload_bytes_per_step']} B/step per interior "
                f"{'shard' if node is None else 'rank (hierarchical)'} with "
                f"the trace strips ({row['static_halo_payload_bytes_per_step']}"
                f" without), peak memory {peak_gb:.2f} GB, launches per step "
                f"{row['launches_per_step']}; spikes, per-step spikes, v, "
                f"w_local, rem_w, x_pre, x_post bitwise against the "
                f"single-shard plastic {impl} run, events "
                f"{float(res.events):.6e} (single {one['events']:.6e})")
            del res, final, run_k, warm
        built.clear()
        oracle.clear()
        torch.cuda.empty_cache()
        self.report["plastic_mesh_path"] = out
        self.note(f"phase 5d: {len(out)} plastic meshes (2x2 and 24x24 "
                  f"cuda_fused, 2x2 AER at {AER_FREE_HZ:g} Hz, 24x24 in nodes "
                  f"of 1x4, 2x2 cuda) equal the single-shard plastic run to "
                  f"the bit (spikes, per-step spikes, v, weights, traces), "
                  f"one launch of each kernel per step for all shards")
        return host

    def plastic_rank_path(self, cfg, one):
        """Phase 5d, ranks: 2 gloo ranks with ``--stdp`` on this card,
        through the launcher, their saved states held to the single-shard
        plastic ``cuda_fused`` run (``one``, on the host)."""
        import tempfile

        import numpy as np
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            row, states = self.launch_ranks(cfg, 2, ["--stdp"], d)
        spec = self.part.make_rank_tile_spec(cfg, 2)
        got = {k: states[k] for k in PLASTIC_LEAVES}
        del states
        if row["spikes"] != one["spikes"]:
            raise AssertionError(f"2 plastic ranks: {row['spikes']} spikes, "
                                 f"single shard {one['spikes']}")
        for leaf in PLASTIC_LEAVES:
            if not np.array_equal(self.part.columns_to_global(got[leaf],
                                                              spec),
                                  one[leaf]):
                raise AssertionError(f"2 plastic ranks: {leaf} differs from "
                                     f"the single-shard plastic run")
        if not self.ld.events_agree(row["events"], one["events"]):
            raise AssertionError(f"2 plastic ranks: events {row['events']}")
        if not row["stdp"] or row["library_build_s_max"] != 0.0:
            raise AssertionError(f"2 plastic ranks: stdp {row['stdp']}, "
                                 f"build {row['library_build_s_max']} s")
        per_step = {k: v / row["steps"] for k, v in row["launches"].items()
                    if v}
        if per_step != {k: 1.0 for k in ("fused_step", "keyed_drive",
                                          "stdp_dense_update",
                                          "stdp_remote_update")}:
            raise AssertionError(f"2 plastic ranks: rank 0 launches "
                                 f"{row['launches']}")
        self.report["plastic_rank_path"] = row
        log(f"phase 5d 2 plastic ranks as processes (gloo, every rank on "
            f"this card, time-sliced: no scaling figure): tiles "
            f"{row['tile']}, {row['step_ms']:.4f} ms/step (wall, "
            f"{row['steps']} steps), halo {row['halo_payload_bytes_per_step']}"
            f" B/step per interior rank with the trace strips, rank 0 peak "
            f"memory {row['peak_memory_gb']:.2f} GB, rank 0 launches per "
            f"step {per_step}, launch {row['launch_wall_s']:.1f} s; spikes, "
            f"v, w_local, rem_w, x_pre, x_post equal the single-shard plastic "
            f"cuda_fused run to the bit, events {row['events']:.6e} vs "
            f"{one['events']:.6e}; device time not measured (other "
            f"processes)")


    # ------------------------------------------------------------ phase 6
    def per_launch(self, name, fn, args, whole, b, c):
        """One single-tenant launch of ``fn`` per tenant (every tensor of
        ``b * c`` rows cut to the tenant's ``c``, the others whole), each
        equal to its tenant's rows of ``whole`` (one launch's output or
        outputs) to the bit."""
        torch = self.torch
        whole = whole if isinstance(whole, tuple) else (whole,)
        for i in range(b):
            part = fn(*(a[i * c:(i + 1) * c] if isinstance(a, torch.Tensor)
                        and a.shape[0] == b * c else a for a in args))
            part = part if isinstance(part, tuple) else (part,)
            for j, (got, want) in enumerate(zip(part, whole)):
                self.equal(f"{name} tenant {i} output {j}", got,
                           want[i * c:(i + 1) * c])

    def check_tenant_ell(self, b, c, n, k, t, seed, path):
        """``ell_gather`` and ``fused_step`` on ``b`` tenants of ``c``
        random columns (tables of ``t`` lanes, K = ``k``) in one launch,
        which must take plan path ``path``: to the bit against one
        single-tenant launch per tenant, and against the plain versions as
        phase 1 holds them, with shared and per-tenant weights, and
        ``fused_step`` static, with its STDP epilogue, with its guard
        epilogue and with both. Returns the max abs errors and the plan."""
        torch, ops, ref, dev = self.torch, self.ops, self.ref, self.dev
        g = torch.Generator(device=dev).manual_seed(seed)
        rows = b * c

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev)

        def rand(*shape):
            return torch.rand(*shape, generator=g, device=dev)

        ncfg = self.dpsnn.GRID_24.neuron
        v, cc = rnd(rows, n) * 8 + 10, rnd(rows, n).abs()
        refrac = (rand(rows, n) < 0.05).int() * 2
        s_loc = (rand(rows, n) < 0.05).float()
        s_loc[min(c + 1, rows - 1)] = 1.0     # every source of a column
        s_flat = (rand(rows, t) < 0.02).float()
        ext = rnd(rows, n).abs()
        w, w_own = rnd(c, n, n) * 0.4, rnd(rows, n, n) * 0.4
        idx = torch.randint(0, t, (c, n, k), generator=g, device=dev,
                            dtype=torch.int32)
        rw, rw_own = rnd(c, n, k) * 0.4, rnd(rows, n, k) * 0.4
        xp, xq = rand(rows, n), rand(rows, n)
        scfg, gcfg = self.STDPConfig(), self.GuardConfig(enabled=True)
        p = self.plan.plan("fused_step", rows, n, t,
                           self.plan.sm_count(dev), tenants=b)
        if p.path != path:
            raise AssertionError(f"{b} tenants, K = {k}, T = {t}: plan path "
                                 f"{p.path}, expected {path}")
        errs = {}
        for tag, ww in (("shared", rw), ("own", rw_own)):
            got = ops.ell_gather(s_flat, idx, ww)
            errs[f"ell_gather {tag}"] = self.close(
                f"ell_gather tenants {tag}", got,
                ref.ell_gather_ref(s_flat, idx, ww),
                scale=self.scale_remote(s_flat, idx, ww))
            self.per_launch(f"ell_gather {b} tenants {tag}", ops.ell_gather,
                            (s_flat, idx, ww), got, b, c)
        for tag, ww, rr, kw in (
                ("shared", w, rw, {}),
                ("shared+stdp", w, rw, dict(scfg=scfg)),
                ("shared+guard", w, rw, dict(gcfg=gcfg)),
                ("own", w_own, rw_own, {}),
                ("own+stdp+guard", w_own, rw_own, dict(scfg=scfg,
                                                       gcfg=gcfg))):
            args = (v, cc, refrac, s_loc, ww, s_flat, idx, rr, ext,
                    *((xp, xq) if "scfg" in kw else ()))

            def fn(*a, kw=kw):
                return ops.fused_step(ncfg, *a, **kw)
            got = fn(*args)
            want = ref.fused_step_ref(ncfg, *args, **kw)
            errs[f"fused_step {tag}"], _ = self.close_step(
                f"fused_step {b} tenants {tag}", got[:4], want[:4],
                scale=self.scale_step(s_loc, ww, s_flat, idx, rr, ext))
            agree = got[3] == want[3]
            if "scfg" in kw:
                for j in (4, 5):
                    self.equal(f"fused_step {b} tenants {tag} trace {j}",
                               got[j][agree], want[j][agree])
            if "gcfg" in kw:
                self.equal(f"fused_step {b} tenants {tag} flags", got[-1],
                           want[-1])
            self.per_launch(f"fused_step {b} tenants {tag}", fn, args, got,
                            b, c)
        return errs, dict(path=p.path, cluster=p.cluster, groups=p.groups,
                          ctas=p.ctas, smem_bytes=p.smem_bytes)

    def check_tenant_kernels(self, widths=TENANT_CHECK_WIDTHS, b=3, c=5,
                             n=300, k=248, o=9, seed=21):
        """Every tenant-axis kernel on tenants of ``c`` random columns in
        one launch: to the bit against one single-tenant launch per tenant
        (a row's arithmetic does not depend on its launch's other rows),
        and against its plain version with the tenant axis. ``ell_gather``
        and ``fused_step`` at every width of ``widths`` on the cluster
        path (shared and per-tenant weights; ``fused_step`` static, with
        the STDP and with the guard epilogue, and with both), and at ``b``
        tenants on a wide table (the wide path) and with K = 7 (the cluster
        path's 4-byte rows), held as phase 1 holds them
        (``check_tenant_ell``); the
        other kernels at ``b`` tenants (``synapse_matmul`` against the FMA
        chain, ``keyed_drive`` and both STDP kernels to the bit, with an
        ``active`` mask with one tenant off, whose weights come back as
        they were). Returns the max abs errors and the plans taken."""
        torch, ops, ref, dev = self.torch, self.ops, self.ref, self.dev
        errs, plans = {}, {}
        for i, width in enumerate(widths):
            e, plans[f"B={width}"] = self.check_tenant_ell(
                width, c, n, k, o * n, seed + i, "cluster")
            errs.update({f"{key} B={width}": v for key, v in e.items()})
        for label, kk, t, path in (("wide", k, 180_000, "wide"),
                                   ("K=7", 7, o * n, "cluster")):
            e, plans[f"B={b} {label}"] = self.check_tenant_ell(
                b, 3, n, kk, t, seed, path)
            errs.update({f"{key} B={b} {label}": v for key, v in e.items()})
        g = torch.Generator(device=dev).manual_seed(seed)
        rows, t = b * c, o * n

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev)

        def rand(*shape):
            return torch.rand(*shape, generator=g, device=dev)

        s_loc = (rand(rows, n) < 0.05).float()
        s_loc[c + 1] = 1.0            # every source of one column spikes
        w = rnd(c, n, n) * 0.4
        idx = torch.randint(0, t, (c, n, k), generator=g, device=dev,
                            dtype=torch.int32)
        w_own, rw_own = rnd(rows, n, n) * 0.4, rnd(rows, n, k) * 0.4
        xp, xq = rand(rows, n), rand(rows, n)
        got = ops.synapse_matmul(s_loc, w)
        self.equal("synapse_matmul tenants", got,
                   ref.synapse_matmul_chain_ref(s_loc, w))
        self.per_launch("synapse_matmul", ops.synapse_matmul, (s_loc, w),
                        got, b, c)
        for case in SYNAPSE_TENANT_CASES:
            plans["synapse_matmul B={} C={} N={} silent {}".format(
                *case)] = self.check_synapse_matmul_tenants(*case)

        ids = torch.arange(7, 7 + c, dtype=torch.int32, device=dev)
        seeds = torch.tensor([42, -5, 2**31 - 1], dtype=torch.int32,
                             device=dev)
        steps = torch.tensor([0, 20, 2**31 - 1], dtype=torch.int32,
                             device=dev)
        lams = torch.tensor([1.62, 0.0, 9.9], dtype=torch.float32,
                            device=dev)
        cur, counts = ops.keyed_drive_tenants(seeds, steps, ids, n, lams, 0.5)
        want = ref.keyed_poisson_tenants_ref(seeds.tolist(), steps.tolist(),
                                             ids, n, lams.tolist())
        self.equal("keyed_drive tenants counts", counts, want)
        self.equal("keyed_drive tenants currents", cur, want * 0.5)
        for i in range(b):
            one = ops.keyed_drive(int(seeds[i]), int(steps[i]), ids, n,
                                  float(lams[i]), 0.5)
            self.equal(f"keyed_drive tenant {i}", torch.cat(one),
                       torch.cat((cur[i * c:(i + 1) * c],
                                  counts[i * c:(i + 1) * c])))

        kw = dict(a_plus=0.01, a_minus=0.012, lr=0.7, w_max=0.84)
        spikes = (rand(rows, n) < 0.1).float()
        tbl = rand(rows, t)
        active = torch.tensor([True, False, True], device=dev)
        exc = (rand(n) < 0.8).float()
        for name, fn, plain, args in (
                ("stdp_remote_update", ops.stdp_remote_update,
                 ref.stdp_remote_update_ref, (tbl, idx, rw_own, spikes, xq)),
                ("stdp_dense_update", ops.stdp_dense_update,
                 ref.stdp_dense_update_ref,
                 (w_own, xp * exc, spikes * exc, spikes, xq))):
            got = fn(*args, **kw)
            self.equal(f"{name} tenants", got, plain(*args, **kw))
            self.per_launch(name, lambda *a, fn=fn: fn(*a, **kw), args, got,
                            b, c)
            off = fn(*args, **kw, active=active)
            self.equal(f"{name} tenants, one inactive", off,
                       plain(*args, **kw, active=active))
            w0 = args[2] if name == "stdp_remote_update" else args[0]
            self.equal(f"{name} inactive tenant passed through",
                       off[c:2 * c], w0[c:2 * c])
            self.equal(f"{name} active tenants",
                       torch.cat((off[:c], off[2 * c:])),
                       torch.cat((got[:c], got[2 * c:])))
        return errs, plans

    def check_synapse_matmul_tenants(self, b, c, n, silent=(), seed=31):
        """``synapse_matmul`` over ``b`` tenants of ``c`` random columns of
        ``n`` neurons in one launch (one column of a tenant spiking in
        every source, spike values other than 1, the tenants in
        ``silent`` spiking nowhere): to the bit against one launch per
        tenant and against the FMA chain, its silent-block count the
        plain count. Returns the plan."""
        torch, ops, ref, dev = self.torch, self.ops, self.ref, self.dev
        g = torch.Generator(device=dev).manual_seed(seed + 97 * b + n)
        rows = b * c
        s = (torch.rand(rows, n, generator=g, device=dev) < 0.05).float()
        s[min(c + 1, rows - 1)] = 1.0
        s[:, ::3] *= torch.rand(rows, 1, generator=g, device=dev) + 0.5
        for i in silent:
            s[i * c:(i + 1) * c] = 0.0
        w = torch.randn(c, n, n, generator=g, device=dev) * 0.4
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        name = f"synapse_matmul B={b} C={c} N={n} silent {silent}"
        got = ops.synapse_matmul(s, w, silent_blocks=counter)
        self.equal(f"{name} chain", got, ref.synapse_matmul_chain_ref(s, w))
        if int(counter) != int(ref.silent_block_count(s)):
            raise AssertionError(f"{name}: {int(counter)} silent blocks, "
                                 f"plain {int(ref.silent_block_count(s))}")
        self.per_launch(name, ops.synapse_matmul, (s, w), got, b, c)
        if silent and len(silent) == b and bool(got.any()):
            raise AssertionError(f"{name}: all-silent tenants are not 0")
        return self.tenant_plan("synapse_matmul", rows, n, 0, b)

    def hold_slot(self, name, state, b, want):
        """Slot ``b`` of a batch's state against a single-tenant state: v,
        c, refrac, the ring, the spike and event counts (and the traces
        under STDP) to the bit."""
        pairs = [("v", state.lif.v[b], want.lif.v),
                 ("c", state.lif.c[b], want.lif.c),
                 ("refrac", state.lif.refrac[b], want.lif.refrac),
                 ("hist", state.hist[b], want.hist),
                 ("spikes", state.spike_count[b], want.spike_count),
                 ("events", state.event_count[b], want.event_count)]
        if want.stdp is not None:
            pairs += [("x_pre", state.stdp.x_pre[b], want.stdp.x_pre),
                      ("x_post", state.stdp.x_post[b], want.stdp.x_post)]
        for leaf, got, ref_ in pairs:
            self.equal(f"{name} {leaf}", got, ref_)

    def raster_rates(self, cfg, raster):
        """A (steps, C, N) bool raster's per-step population rates, as
        ``simulation.run``'s ``rate_trace`` computes them from the
        counters."""
        torch, f32 = self.torch, self.torch.float32
        per_step = float(
            torch.tensor(self.sim._recip(cfg.n_neurons), dtype=f32)
            * torch.tensor(self.sim._recip(cfg.neuron.dt_ms * 1e-3),
                           dtype=f32))
        counts = torch.as_tensor(raster, device=self.dev).sum((1, 2))
        return counts.to(f32) * per_step

    def dedicated(self, cfg, params, seed, n_steps, impl="cuda_fused",
                  nu_scale=None):
        """A tenant's dedicated single-tenant run on the card."""
        state = self.net.init_state(cfg, range(cfg.n_columns),
                                    device=self.dev, seed=seed)
        return self.sim.run(cfg, params, state, n_steps, impl=impl,
                            seed=seed, nu_scale=nu_scale)

    def serve_jobs(self, cfg, params, jobs, slots, impl="cuda_fused"):
        """``jobs`` through a server of ``slots`` slots (chunk
        SERVICE_CHUNK), with the launch counts set to 0 just before the
        drain and read just after: ``(server, results by id, launches)``."""
        srv = self.serve.BatchedSimServer(cfg, slots=slots,
                                          chunk=SERVICE_CHUNK, impl=impl,
                                          params=params, device=self.dev)
        for job in jobs:
            srv.submit(dataclasses.replace(job))
        srv.close()
        self.sync()
        self.ops.reset_launches()
        results = {r.job_id: r for r in srv.drain()}
        self.sync()
        return srv, results, dict(self.ops.LAUNCHES)

    def service_path(self, cfg, fused, params):
        """Phase 6: the batched service on ``cfg`` (6a-6e), its timing at
        B = SERVICE_WIDTHS, and the tenant-axis kernels' entries."""
        t0 = time.perf_counter()
        errs, plans = self.check_tenant_kernels()
        self.report["tenant_check_plans"] = plans
        self.note("phase 6 tenant-axis kernels (tenants of 5 random columns "
                  "of 300 neurons, K = 248): one launch equal to one launch "
                  "per tenant, to the bit, for all six; ell_gather and "
                  "fused_step (shared and per-tenant weights; static, STDP, "
                  "guard, both) at B = "
                  + ", ".join(str(w) for w in TENANT_CHECK_WIDTHS)
                  + " on the cluster path, and at B = 3 on a wide table "
                  "(T = 180,000) and with K = 7; plans " + "; ".join(
                      f"{key}: {p['path']}, clusters of {p['cluster']} x "
                      f"{p['groups']} groups, {p['ctas']} CTAs, "
                      f"{p['smem_bytes']} B" for key, p in plans.items())
                  + "; synapse_matmul equal to the FMA chain (also over "
                  "SYNAPSE_TENANT_CASES), keyed_drive "
                  "and both STDP kernels (one tenant inactive: its weights "
                  "passed through) equal to their plain versions to the "
                  "bit; max abs err " + ", ".join(
                      f"{k} {v:.2e}" for k, v in errs.items()))
        out = dict(b1=self.service_one(cfg, params, fused),
                   b4=self.service_four(cfg, params),
                   recycle=self.service_recycle(cfg, params),
                   guard=self.service_guard(cfg, params),
                   timing=self.service_timing(cfg, params))
        out["plastic"] = self.service_plastic(cfg, params)
        out["seconds"] = time.perf_counter() - t0
        self.report["service_path"] = out
        log(f"phase 6 took {out['seconds']:.1f} s")

    def service_one(self, cfg, params, fused):
        """6a: a one-slot server, one job of seed cfg.seed for phase 3's
        WARMUP_STEPS + MAIN_STEPS steps, equal to phase 3's run to the
        bit."""
        steps = WARMUP_STEPS + MAIN_STEPS
        srv, res, launches = self.serve_jobs(
            cfg, params, [self.serve.SimJob(job_id="one", seed=cfg.seed,
                                            n_steps=steps)], 1)
        res = res["one"]
        self.hold_slot("6a", srv.state, 0, fused.state)
        self.equal("6a per-step spikes", self.raster_rates(cfg, res.raster),
                   self.torch.cat([self.warm_trace, fused.rate_trace]))
        if (res.spikes, res.events) != (float(fused.spikes),
                                        float(fused.events)):
            raise AssertionError(f"6a: spikes/events {res.spikes}/"
                                 f"{res.events}")
        if launches != self.expected_launches(fused_step=steps,
                                              keyed_drive=steps):
            raise AssertionError(f"6a launches {launches}")
        self.note(f"phase 6a one slot, seed {cfg.seed}, {steps} steps in "
                  f"chunks of {SERVICE_CHUNK}: spikes {res.spikes:.0f}, per-"
                  f"step spikes from the raster, v, c, refrac, hist and "
                  f"events {res.events:.6e} equal phase 3's cuda_fused run "
                  f"to the bit")
        return dict(spikes=res.spikes, events=res.events, launches=launches)

    def service_four(self, cfg, params):
        """6b: four static tenants (SERVICE_TENANTS) for MAIN_STEPS, one
        fused_step and one keyed_drive launch per loop step for all, the
        weights one tensor, each slot equal to its dedicated run."""
        jobs = [self.serve.SimJob(job_id=f"t{i}", seed=s, n_steps=MAIN_STEPS,
                                  nu_scale=nu)
                for i, (s, nu) in enumerate(SERVICE_TENANTS)]
        srv, res, launches = self.serve_jobs(cfg, params, jobs, 4)
        loop = srv.stats["loop_steps"]
        if loop != MAIN_STEPS or launches != self.expected_launches(
                fused_step=loop, keyed_drive=loop):
            raise AssertionError(f"6b: {loop} loop steps, launches "
                                 f"{launches}")
        ptr = params.w_local.data_ptr()
        if not (srv._bparams is params and srv.params.w_local.data_ptr()
                == ptr):
            raise AssertionError("6b: the static weights were copied")
        for name in ("fused_step", "keyed_drive"):
            self.report["kernels"][f"{name}[B={TENANT_B}]"] = dict(
                launches=launches[name], launches_from="phase 6b, 4 slots")
        rates = []
        for i, (seed, nu) in enumerate(SERVICE_TENANTS):
            one = self.dedicated(cfg, params, seed, MAIN_STEPS, nu_scale=nu)
            self.hold_slot(f"6b tenant {i}", srv.state, i, one.state)
            self.equal(f"6b tenant {i} per-step spikes",
                       self.raster_rates(cfg, res[f"t{i}"].raster),
                       one.rate_trace)
            rates.append(res[f"t{i}"].rate_hz)
        self.note(f"phase 6b four static tenants (seed, nu_scale) "
                  f"{list(SERVICE_TENANTS)}, {MAIN_STEPS} steps: {loop} loop "
                  f"steps, launches {launches} (one fused_step and one "
                  f"keyed_drive per loop step for all four); the weights "
                  f"one tensor (data_ptr {ptr:#x}); rates "
                  + ", ".join(f"{r:.4f}" for r in rates)
                  + " Hz; each slot equal to its dedicated run to the bit "
                  "(v, c, refrac, hist, spikes, events, per-step spikes)")
        return dict(loop_steps=loop, launches=launches, rates_hz=rates)

    def service_recycle(self, cfg, params):
        """6c: 8 jobs on TENANT_B slots under cuda_fused and under cuda,
        durations 60 + (i % 3) * 7 as the reference's command line mixes
        them: every JobResult equal to its dedicated run, one launch of
        each kernel per loop step."""
        jobs = [self.serve.SimJob(job_id=f"job{i}", seed=cfg.seed + i,
                                  n_steps=60 + (i % 3) * 7) for i in range(8)]
        out = {}
        for impl, slots in (("cuda_fused", TENANT_B), ("cuda", TENANT_B)):
            srv, res, launches = self.serve_jobs(cfg, params, jobs, slots,
                                                 impl)
            loop = srv.stats["loop_steps"]
            want = (dict(fused_step=loop) if impl == "cuda_fused" else
                    dict(synapse_matmul=loop, ell_gather=loop, lif_step=loop))
            if launches != self.expected_launches(keyed_drive=loop, **want):
                raise AssertionError(f"6c {impl}: {loop} loop steps, "
                                     f"launches {launches}")
            for job in jobs:
                one = self.dedicated(cfg, params, job.seed, job.n_steps, impl)
                r = res[job.job_id]
                # the rate as the server computes it
                sim_s = job.n_steps * cfg.neuron.dt_ms * 1e-3
                rate = float(one.spikes) / (cfg.n_neurons * sim_s)
                got = (r.status, r.spikes, r.events, r.rate_hz)
                if got != ("ok", float(one.spikes), float(one.events), rate):
                    raise AssertionError(
                        f"6c {impl} {job.job_id}: (status, spikes, events, "
                        f"rate) {got} against {float(one.spikes)}, "
                        f"{float(one.events)}, {rate}")
                self.equal(f"6c {impl} {job.job_id} per-step spikes",
                           self.raster_rates(cfg, r.raster), one.rate_trace)
            row = srv.metrics_row()
            out[impl] = dict(slots=slots, launches=launches, **{
                k: row[k] for k in ("loop_steps", "tenant_steps",
                                    "occupancy", "slot_recycles",
                                    "tenant_steps_per_s", "wall_s")})
            if impl == "cuda":
                for name in ("synapse_matmul", "ell_gather"):
                    self.report["kernels"][f"{name}[B={TENANT_B}]"] = dict(
                        launches=launches[name],
                        launches_from=f"phase 6c, {slots} slots, impl=cuda")
            self.note(f"phase 6c {impl}: 8 jobs on {slots} slots, "
                      f"{row['loop_steps']} loop steps, occupancy "
                      f"{row['occupancy']:.4f}, {row['slot_recycles']} "
                      f"recycles, {row['tenant_steps_per_s']:.1f} tenant-"
                      f"steps/s (wall, chunk {SERVICE_CHUNK}), launches "
                      f"{launches}; every JobResult (spikes, events, rate, "
                      f"per-step spikes) equal to its dedicated run")
        return out

    def service_guard(self, cfg, params):
        """6e: the guard on, four tenants of 40 steps, job 2 poisoned with
        NaN at its step 9: quarantined with a trip at step 9 and a raster
        of 10 rows; its batch-mates equal an unpoisoned server's run."""
        gcfg = dataclasses.replace(cfg, guard=self.GuardConfig(enabled=True))
        jobs = [self.serve.SimJob(job_id=f"g{i}", seed=100 + i, n_steps=40)
                for i in range(4)]
        poisoned = list(jobs)
        poisoned[2] = dataclasses.replace(jobs[2], chaos_nan_at_step=9)
        _, clean, _ = self.serve_jobs(gcfg, params, jobs, 4)
        srv, dirty, _ = self.serve_jobs(gcfg, params, poisoned, 4)
        bad = dirty["g2"]
        if (bad.status, bad.guard["guard_trip_what"],
                bad.guard["guard_trip_step"], bad.raster.shape[0]) != (
                    "quarantined", "nan", 9, 10):
            raise AssertionError(f"6e: poisoned job {bad.status}, "
                                 f"{bad.guard}, raster {bad.raster.shape}")
        for jid in ("g0", "g1", "g3"):
            a, b = dirty[jid], clean[jid]
            if (a.status, a.spikes, a.events) != ("ok", b.spikes, b.events) \
                    or not (a.raster == b.raster).all():
                raise AssertionError(f"6e: {jid} differs from the clean run")
        if srv.metrics_row()["quarantined"] != 1:
            raise AssertionError("6e: quarantine count")
        self.note("phase 6e guard on, 4 tenants, job 2 poisoned at step 9: "
                  "quarantined, trip nan at step 9, raster of 10 rows; its "
                  "batch-mates' spikes, events and rasters equal an "
                  "unpoisoned server's to the bit")
        return dict(guard=bad.guard)

    def tenant_inputs(self, cfg, params, st):
        """The kernels' inputs of a batch's next step, as the batched step
        builds them, from its state ``st`` (tenants at the configured
        rate, seeds cfg.seed + b)."""
        torch, B = self.torch, self.batched
        b, d, c, n = st.hist.shape
        rows, tl = b * c, st.t.long()
        ar = torch.arange(b, device=self.dev)
        seeds = torch.arange(cfg.seed, cfg.seed + b, dtype=torch.int32,
                             device=self.dev)
        lam = B.tenant_rates(cfg, None, b).to(self.dev)
        ext, counts = self.ops.keyed_drive_tenants(
            seeds, st.t, self.col_ids(cfg), n, lam, cfg.conn.j_ext)
        return dict(
            tenants=b, v=st.lif.v.reshape(rows, n),
            c=st.lif.c.reshape(rows, n),
            refrac=st.lif.refrac.reshape(rows, n),
            s_loc=st.hist[ar, (tl - cfg.conn.min_delay_steps) % d].reshape(
                rows, n),
            s_flat=B.neighbour_tables(st.hist, tl,
                                      self.conn.build_stencil(cfg),
                                      (cfg.grid_h, cfg.grid_w)),
            ext=ext, counts=counts, seeds=seeds, t=st.t, lam=lam)

    def fused_args(self, x, params):
        return (x["v"], x["c"], x["refrac"], x["s_loc"], params.w_local,
                x["s_flat"], params.rem_flat, params.rem_w, x["ext"])

    def entry(self, nbytes, flops, int_ops=0.0, **kw):
        """A kernel entry's bound from the bytes it must move and the
        operations it must do (float32, or int32 ``int_ops``)."""
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3 + int_ops / PEAK_INT32_OPS * 1e3
        return dict(bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bytes=nbytes, flops=flops, int_ops=int_ops, **kw)

    def tenant_plan(self, name, rows, n, t, b):
        """The path, cluster size, tenant groups, CTAs and shared memory of
        ``name`` over ``b`` tenants' ``rows`` rows."""
        p = self.plan.plan(name, rows, n, t, self.plan.sm_count(self.dev),
                           tenants=b)
        return dict(path=p.path, cluster=p.cluster, groups=p.groups,
                    ctas=p.ctas, smem_bytes=p.smem_bytes)

    def time_tenant_step(self, cfg, params, x):
        """``fused_step`` and ``keyed_drive`` over ``x``'s tenants in one
        launch, beside their bounds (the ELL idx and weights and the
        weight rows of the sources that spike in any tenant counted once,
        each tenant's table, state and drive once per tenant), and
        ``fused_step`` as one launch per tenant (no sharing)."""
        ops, torch = self.ops, self.torch
        b = x["tenants"]
        rows, n = x["v"].shape
        c, k = rows // b, params.rem_flat.shape[-1]
        t = x["s_flat"].shape[1]
        args = self.fused_args(x, params)
        spiking = x["s_loc"].reshape(b, c, n) != 0
        nnz, union = float(spiking.sum()), float(spiking.any(0).sum())
        f4 = 4
        fused = self.entry(
            2 * c * n * k * f4 + union * n * f4 + b * (c * t + 9 * c * n) * f4,
            2 * nnz * n + 2 * rows * n * k + 14 * rows * n,
            ms=self.time_ms(lambda: ops.fused_step(cfg.neuron, *args)),
            weight_rows=nnz, weight_rows_union=union,
            plan=self.tenant_plan("fused_step", rows, n, t, b))

        def separate():
            for i in range(b):
                ops.fused_step(cfg.neuron, *(
                    a if a.shape[0] == c else a[i * c:(i + 1) * c]
                    for a in args))
        fused["ms_one_launch_per_tenant"] = self.time_ms(separate)
        counts = x["counts"].reshape(b, c, n)
        draws = float((counts + 1).sum())
        chain = float((2 + 2 * (counts.max(dim=2).values + 1)).sum())
        ids = self.col_ids(cfg)
        keyed = self.entry(
            2 * rows * n * f4 + c * f4 + 12 * b, 0.0,
            int_ops=OPS_PER_THREEFRY * (draws + chain),
            ms=self.time_ms(lambda: ops.keyed_drive_tenants(
                x["seeds"], x["t"], ids, n, x["lam"], cfg.conn.j_ext)),
            draws=draws)
        return fused, keyed

    def service_timing(self, cfg, params):
        """Static service at B = SERVICE_WIDTHS: SERVICE_TIMED loop steps
        after WARMUP_STEPS (CUDA events around ``run_chunk``), its
        profile, and fused_step and keyed_drive over its tenants beside
        their bounds; at B = TENANT_B the tenant-axis kernels' entries."""
        torch, B = self.torch, self.batched
        rows = []
        for b in SERVICE_WIDTHS:
            seeds = [cfg.seed + i for i in range(b)]
            warm = B.run_chunk(cfg, params, B.init_tenants(cfg, seeds,
                                                           self.dev),
                               seeds, [WARMUP_STEPS] * b, WARMUP_STEPS)
            st = warm.state
            del warm

            def run(k, st=st, seeds=seeds, b=b):
                return B.run_chunk(cfg, params, st, seeds, [k] * b, k)
            self.sync()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            w0 = time.perf_counter()
            e0.record()
            res = run(SERVICE_TIMED)
            e1.record()
            self.sync()
            wall = time.perf_counter() - w0
            if res.steps_taken != SERVICE_TIMED:
                raise AssertionError(f"B={b}: {res.steps_taken} loop steps")
            ms = e0.elapsed_time(e1) / SERVICE_TIMED
            del res
            prof = self.profile(f"service B={b}", run, ms)
            x = self.tenant_inputs(cfg, params, st)
            fused, keyed = self.time_tenant_step(cfg, params, x)
            row = dict(tenants=b, ms_per_step=ms, wall_s=wall,
                       tenant_steps_per_s=b * 1e3 / ms,
                       device_ms_per_step=prof["device_ms_per_step"],
                       outside_ms_per_step=prof["outside_ms_per_step"],
                       largest_outside=prof["largest_outside"],
                       largest_op=prof["largest_op"],
                       fused_step=fused, keyed_drive=keyed)
            rows.append(row)
            log(f"phase 6 service B={b} static cuda_fused: {ms:.4f} ms per "
                f"loop step (device clock), {row['tenant_steps_per_s']:.1f} "
                f"tenant-steps/s, device {prof['device_ms_per_step']:.4f} "
                f"ms/step (outside the kernels "
                f"{prof['outside_ms_per_step']:.4f}, largest "
                f"{prof['largest_outside'][0]} "
                f"{prof['largest_outside'][1]:.1f} us, op "
                f"{prof['largest_op'][0]} {prof['largest_op'][1]:.1f} us); "
                f"fused_step {fused['ms']:.4f} ms ({fused['plan']['path']} "
                f"path, clusters of {fused['plan']['cluster']}, "
                f"{fused['plan']['ctas']} CTAs; bound "
                f"{fused['bound_ms']:.4f} by {fused['bound_by']}, "
                f"{fused['bytes'] / 1e9:.4f} GB; one launch per tenant "
                f"{fused['ms_one_launch_per_tenant']:.4f} ms; weight rows "
                f"{fused['weight_rows']:.0f}, union "
                f"{fused['weight_rows_union']:.0f}), keyed_drive "
                f"{keyed['ms']:.4f} ms (bound {keyed['bound_ms']:.4f} by "
                f"{keyed['bound_by']})")
            if b == TENANT_B:
                self.tenant_entries(cfg, params, x, fused, keyed)
            del x, st
        widths = {r["tenants"]: dict(
            ms=r["fused_step"]["ms"],
            ms_one_launch_per_tenant=r["fused_step"][
                "ms_one_launch_per_tenant"],
            bound_ms=r["fused_step"]["bound_ms"], plan=r["fused_step"]["plan"])
            for r in rows}
        self.report["kernels"][f"fused_step[B={TENANT_B}]"]["by_width"] = \
            widths
        log("  fused_step by width (one launch / one launch per tenant / "
            "bound, ms): " + "; ".join(
                f"B={b} {w['ms']:.4f} / {w['ms_one_launch_per_tenant']:.4f} "
                f"/ {w['bound_ms']:.4f} ({w['plan']['path']}, clusters of "
                f"{w['plan']['cluster']})" for b, w in widths.items()))
        return rows

    def tenant_entries(self, cfg, params, x, fused, keyed):
        """The {"kernels": ...} entries of fused_step, keyed_drive,
        synapse_matmul and ell_gather over x's tenants: held to their
        plain versions (and synapse_matmul to one launch per tenant, to
        the bit), timed beside their bounds and the library call that
        computes the same function."""
        torch, ops, ref = self.torch, self.ops, self.ref
        b = x["tenants"]
        rows, n = x["v"].shape
        c, k = rows // b, params.rem_flat.shape[-1]
        t = x["s_flat"].shape[1]
        ncfg, f4 = cfg.neuron, 4
        args = self.fused_args(x, params)
        kern = self.report["kernels"]
        scale = self.scale_step(x["s_loc"], params.w_local, x["s_flat"],
                                params.rem_flat, params.rem_w, x["ext"])
        err, flips = self.close_step(
            f"fused_step[B={b}]", ops.fused_step(ncfg, *args),
            ref.fused_step_ref(ncfg, *args), scale=scale)
        kern[f"fused_step[B={b}]"].update(
            max_abs_err=err, spike_flips=flips, library_ms=None,
            plain_ms=self.time_ms(lambda: ref.fused_step_ref(ncfg, *args),
                                  iters=3), **fused)
        ids = self.col_ids(cfg)
        want = ref.keyed_poisson_tenants_ref(
            x["seeds"].tolist(), x["t"].tolist(), ids, n, x["lam"].tolist())
        self.equal(f"keyed_drive[B={b}]", x["counts"], want)
        kern[f"keyed_drive[B={b}]"].update(
            max_abs_err=0.0, library_ms=None,
            plain_ms=self.time_ms(lambda: ref.keyed_poisson_tenants_ref(
                x["seeds"].tolist(), x["t"].tolist(), ids, n,
                x["lam"].tolist()), iters=2), **keyed)
        # synapse_matmul: one launch equal to one per tenant, to the bit
        s, w = x["s_loc"], params.w_local
        got = ops.synapse_matmul(s, w)
        for i in range(b):
            self.equal(f"synapse_matmul[B={b}] tenant {i}",
                       got[i * c:(i + 1) * c],
                       ops.synapse_matmul(s[i * c:(i + 1) * c], w))
        self.equal(f"synapse_matmul[B={b}] chain", got,
                   ref.synapse_matmul_chain_ref(s, w))
        spiking = s.reshape(b, c, n) != 0
        nnz, union = float(spiking.sum()), float(spiking.any(0).sum())
        sb = s.reshape(b, c, n).transpose(0, 1).contiguous()
        bmm = torch.bmm(sb, w)
        kern[f"synapse_matmul[B={b}]"].update(
            max_abs_err=self.close(f"synapse_matmul[B={b}]", got,
                                   ref.synapse_matmul_ref(s, w),
                                   scale=self.scale_local(s, w)),
            ms=self.time_ms(lambda: ops.synapse_matmul(s, w)),
            plain_ms=self.time_ms(lambda: ref.synapse_matmul_ref(s, w)),
            library_ms=self.time_ms(lambda: torch.bmm(sb, w)),
            library="torch.bmm of (C, B, N) x (C, N, N)",
            plan=self.tenant_plan("synapse_matmul", rows, n, 0, b),
            library_max_abs_err=self.close(
                f"synapse_matmul[B={b}] bmm",
                bmm.transpose(0, 1).reshape(rows, n), got,
                scale=self.scale_local(s, w)),
            **self.entry(union * n * f4 + 2 * rows * n * f4, 2 * nnz * n,
                         weight_rows=nnz, weight_rows_union=union))
        del bmm, sb
        # ell_gather beside cuSPARSE CSR A @ X, X of B columns
        tbl, idx, rw = x["s_flat"], params.rem_flat, params.rem_w
        got = ops.ell_gather(tbl, idx, rw)
        a = self.ell_csr(params, t)
        xb = tbl.reshape(b, c * t).t().contiguous()
        spmm = (a @ xb).t().reshape(rows, n)
        kern[f"ell_gather[B={b}]"].update(
            max_abs_err=self.close(f"ell_gather[B={b}]", got,
                                   ref.ell_gather_ref(tbl, idx, rw),
                                   scale=self.scale_remote(tbl, idx, rw)),
            library_max_abs_err=self.close(
                f"ell_gather[B={b}] spmm", spmm, got,
                scale=self.scale_remote(tbl, idx, rw)),
            ms=self.time_ms(lambda: ops.ell_gather(tbl, idx, rw)),
            plain_ms=self.time_ms(lambda: ref.ell_gather_ref(tbl, idx, rw),
                                  iters=3),
            library_ms=self.time_ms(lambda: a @ xb),
            library="cuSPARSE CSR A @ X, X of B columns",
            plan=self.tenant_plan("ell_gather", rows, n, t, b),
            **self.entry(2 * c * n * k * f4 + b * (c * t + c * n) * f4,
                         2 * rows * n * k))
        del a, xb, spmm
        for name in ("fused_step", "keyed_drive", "synapse_matmul",
                     "ell_gather"):
            e = kern[f"{name}[B={b}]"]
            plan = e.get("plan")
            log(f"  {name}[B={b}]: {e['ms']:.4f} ms (plain "
                f"{e['plain_ms']:.4f} ms, library "
                + ("-" if e["library_ms"] is None else
                   f"{e['library_ms']:.4f}")
                + f" ms, bound {e['bound_ms']:.4f} ms by {e['bound_by']}, "
                f"max abs err {e['max_abs_err']:.2e}, launches "
                f"{e['launches']} ({e['launches_from']})"
                + ("" if plan is None else
                   f"; {plan['path']} path, "
                   + ("one tenant a CTA"
                      if name == "synapse_matmul" else
                      f"clusters of {plan['cluster']} x {plan['groups']} "
                      "groups")
                   + f", {plan['ctas']} CTAs, "
                   f"{plan['smem_bytes']} B shared")
                + ")")


    def service_plastic(self, cfg, params):
        """6d: TENANT_B plastic guarded tenants of SERVICE_PLASTIC_STEPS
        steps in one chunk: each equal to its dedicated plastic run to the
        bit, weights and traces included (the one that finishes first kept
        its weights through its batch-mates' last steps); then both STDP
        kernels on the batch's last step, timed beside their bounds."""
        torch, B = self.torch, self.batched
        pcfg = self.plastic_cfg(cfg)
        seeds = [cfg.seed + i for i in range(TENANT_B)]
        steps = max(SERVICE_PLASTIC_STEPS)
        torch.cuda.empty_cache()
        self.sync()
        torch.cuda.reset_peak_memory_stats(self.dev)
        bp = B.batch_params(pcfg, params, len(seeds))
        bs = B.init_tenants(pcfg, seeds, self.dev)
        self.sync()
        self.ops.reset_launches()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = B.run_chunk(pcfg, bp, bs, seeds, list(SERVICE_PLASTIC_STEPS),
                          steps)
        e1.record()
        self.sync()
        launches = dict(self.ops.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(self.dev) / 1e9
        ms = e0.elapsed_time(e1) / steps
        del bp, bs
        if out.steps_taken != steps or launches != self.expected_launches(
                fused_step=steps, keyed_drive=steps,
                stdp_dense_update=steps, stdp_remote_update=steps):
            raise AssertionError(f"6d: {out.steps_taken} loop steps, "
                                 f"launches {launches}")
        if bool(out.state.guard.tripped.any()):
            raise AssertionError("6d: a guard tripped")
        for name in ("stdp_dense_update", "stdp_remote_update"):
            self.report["kernels"][f"{name}[B={TENANT_B}]"] = dict(
                launches=launches[name],
                launches_from=f"phase 6d, {TENANT_B} slots")
        self.report["kernels"][PLASTIC_FUSED] = dict(
            launches=launches["fused_step"],
            launches_from=f"phase 6d, {TENANT_B} slots")
        for i, (seed, n_steps) in enumerate(zip(seeds, SERVICE_PLASTIC_STEPS)):
            one = self.dedicated(pcfg, params, seed, n_steps)
            self.hold_slot(f"6d tenant {i}", out.state, i, one.state)
            for leaf in ("w_local", "rem_w"):
                self.equal(f"6d tenant {i} {leaf}",
                           getattr(out.params, leaf)[i],
                           getattr(one.params, leaf))
            del one
        self.note(f"phase 6d {TENANT_B} plastic guarded tenants (seeds "
                  f"{seeds}, "
                  f"{SERVICE_PLASTIC_STEPS} steps, one chunk): {ms:.4f} ms "
                  f"per loop step, peak memory {peak_gb:.2f} GB, launches "
                  f"{launches}; each tenant's v, c, refrac, hist, spikes, "
                  f"events, x_pre, x_post, w_local and rem_w equal its "
                  f"dedicated plastic run to the bit (the first kept its "
                  f"weights through its batch-mates' last "
                  f"{steps - min(SERVICE_PLASTIC_STEPS)} steps); no trip")
        self.plastic_fused_entry(pcfg, params, out)
        # both STDP kernels on the batch's state after its last step: each
        # tenant's last frame, traces and weights
        b, c, n = TENANT_B, cfg.n_columns, cfg.neurons_per_column
        d = out.state.hist.shape[1]
        ar = torch.arange(b, device=self.dev)
        spikes = out.state.hist[ar, (out.state.t.long() - 1) % d].reshape(
            b * c, n)
        x_pre = out.state.stdp.x_pre.reshape(b * c, n)
        x_post = out.state.stdp.x_post.reshape(b * c, n)
        w = out.params.w_local.reshape(b * c, n, n)
        rw = out.params.rem_w.reshape(b * c, n, -1)
        del out
        torch.cuda.empty_cache()
        self.stdp_entries(pcfg, params, w, rw, spikes, x_pre, x_post)
        return dict(ms_per_step=ms, peak_memory_gb=peak_gb,
                    launches=launches)

    def plastic_fused_entry(self, pcfg, params, out):
        """fused_step's STDP-trace and guard-flag instance over 6d's
        TENANT_B plastic tenants, on their state after the chunk and their
        own weights (w_local and rem_w of B * C rows), as the plastic
        service launches it: held to its plain version as phase 1 holds
        it, timed beside its bound (the shared ELL idx once, each tenant's
        ELL weights, spiking sources' weight rows, table, state and traces
        once per tenant)."""
        torch, ops, ref = self.torch, self.ops, self.ref
        x = self.tenant_inputs(pcfg, params, out.state)
        b = x["tenants"]
        rows, n = x["v"].shape
        c, k = rows // b, params.rem_flat.shape[-1]
        t = x["s_flat"].shape[1]
        w = out.params.w_local.reshape(rows, n, n)
        rw = out.params.rem_w.reshape(rows, n, k)
        x_pre = out.state.stdp.x_pre.reshape(rows, n)
        x_post = out.state.stdp.x_post.reshape(rows, n)
        ncfg, f4 = pcfg.neuron, 4
        args = (x["v"], x["c"], x["refrac"], x["s_loc"], w, x["s_flat"],
                params.rem_flat, rw, x["ext"], x_pre, x_post)
        kw = dict(scfg=pcfg.stdp_cfg, gcfg=pcfg.guard)
        got = ops.fused_step(ncfg, *args, **kw)
        want = ref.fused_step_ref(ncfg, *args, **kw)
        err, flips = self.close_step(
            PLASTIC_FUSED, got[:4], want[:4], scale=self.scale_step(
                x["s_loc"], w, x["s_flat"], params.rem_flat, rw, x["ext"]))
        agree = got[3] == want[3]
        for j in (4, 5):
            self.equal(f"{PLASTIC_FUSED} trace {j}", got[j][agree],
                       want[j][agree])
        self.equal(f"{PLASTIC_FUSED} flags", got[6], want[6])
        del got, want
        nnz = float((x["s_loc"] != 0).sum())
        e = self.report["kernels"][PLASTIC_FUSED]
        e.update(
            max_abs_err=err, spike_flips=flips, library_ms=None,
            ms=self.time_ms(lambda: ops.fused_step(ncfg, *args, **kw)),
            plain_ms=self.time_ms(
                lambda: ref.fused_step_ref(ncfg, *args, **kw), iters=2),
            plan=self.tenant_plan("fused_step", rows, n, t, b),
            **self.entry(c * n * k * f4 + rows * n * k * f4 + nnz * n * f4
                         + (rows * t + 13 * rows * n + rows) * f4,
                         2 * nnz * n + 2 * rows * n * k + 18 * rows * n,
                         weight_rows=nnz))
        log(f"  {PLASTIC_FUSED}: {e['ms']:.4f} ms (plain {e['plain_ms']:.4f} "
            f"ms, library -, bound {e['bound_ms']:.4f} ms by "
            f"{e['bound_by']}, {e['bytes'] / 1e9:.3f} GB; max abs err "
            f"{err:.2e}, spike flips {flips}, traces and flags equal; "
            f"{e['plan']['path']} path, clusters of {e['plan']['cluster']}; "
            f"launches {e['launches']} ({e['launches_from']}))")
        del x, args

    def stdp_entries(self, pcfg, params, w, rw, spikes, x_pre, x_post):
        """stdp_dense_update and stdp_remote_update over TENANT_B tenants'
        own weights (every tenant active): to the bit against their plain
        versions, timed beside their bounds (the shared ELL idx once)."""
        torch, ops, ref = self.torch, self.ops, self.ref
        rows, n = spikes.shape
        b, k = TENANT_B, rw.shape[-1]
        c = rows // b
        exc = (~self.neuron_types(pcfg, self.dev)).float()
        scfg = pcfg.stdp_cfg
        kw = dict(a_plus=scfg.a_plus, a_minus=scfg.a_minus, lr=scfg.lr,
                  w_max=scfg.w_max_factor * pcfg.conn.j_exc,
                  active=torch.ones(b, dtype=torch.bool, device=self.dev))
        dense = (w, x_pre * exc, spikes * exc, spikes, x_post)
        table = self.plast.pre_trace_table(
            x_pre, self.conn.build_stencil(pcfg), (pcfg.grid_h, pcfg.grid_w))
        remote = (table, params.rem_flat, rw, spikes, x_post)
        t = table.shape[1]
        f4 = 4
        cases = (
            ("stdp_dense_update", ops.stdp_dense_update,
             ref.stdp_dense_update_ref, dense,
             self.entry(2 * rows * n * n * f4 + 4 * rows * n * f4,
                        6 * rows * n * n)),
            ("stdp_remote_update", ops.stdp_remote_update,
             ref.stdp_remote_update_ref, remote,
             self.entry(c * n * k * f4 + 2 * rows * n * k * f4
                        + (rows * t + 2 * rows * n) * f4, 8 * rows * n * k)))
        for name, fn, plain, args, bound in cases:
            label = f"{name}[B={b}]"
            self.equal(label, fn(*args, **kw), plain(*args, **kw))
            self.sync()
            self.report["kernels"][label].update(
                max_abs_err=0.0, library_ms=None,
                ms=self.time_ms(lambda: fn(*args, **kw), iters=5),
                plain_ms=self.time_ms(lambda: plain(*args, **kw), iters=2),
                **bound)
            e = self.report["kernels"][label]
            log(f"  {label}: {e['ms']:.4f} ms (plain {e['plain_ms']:.4f} ms, "
                f"library -, bound {e['bound_ms']:.4f} ms by "
                f"{e['bound_by']}, {e['bytes'] / 1e9:.3f} GB; equal to the "
                f"plain version to the bit; launches {e['launches']} "
                f"({e['launches_from']}))")

    # ------------------------------------------------------------ phase 7
    def tenant_oracle(self, cfg, params, impl, tenants, steps):
        """The oracle of phase 7: each tenant's dedicated single-shard run
        of ``steps`` from its seed under ``impl`` (``tenants``: (seed,
        nu_scale) pairs): per-step spikes, totals, and the final v (and,
        under STDP, weights and traces), all on the card."""
        out = []
        for seed, nu in tenants:
            one = self.dedicated(cfg, params, seed, steps, impl, nu)
            got = dict(trace=one.rate_trace, spikes=float(one.spikes),
                       events=float(one.events), v=one.state.lif.v)
            if cfg.stdp:
                got.update(w_local=one.params.w_local,
                           rem_w=one.params.rem_w,
                           x_pre=one.state.stdp.x_pre,
                           x_post=one.state.stdp.x_post)
            out.append(got)
            del one
        return out

    def batched_mesh_run(self, cfg, mesh, params, impl, tenants):
        """``tenants`` over ``mesh`` through
        ``exchange.make_batched_distributed_run``: WARMUP_STEPS untimed
        from the seeds, then SERVICE_TIMED timed from there (the launch
        counts set to 0 just before and read just after; device time by
        CUDA events, host time by the wall clock), the peak memory of
        both."""
        torch = self.torch
        seeds, nu = [s for s, _ in tenants], [x for _, x in tenants]

        def runner(k):
            return self.ex.make_batched_distributed_run(
                cfg, mesh, n_steps=k, batch=len(seeds), impl=impl,
                with_stimulus=True, with_state=True, params=params)[0]
        torch.cuda.empty_cache()
        self.sync()
        torch.cuda.reset_peak_memory_stats(self.dev)
        warm_res, state = runner(WARMUP_STEPS)(seeds, nu)
        timed = runner(SERVICE_TIMED)
        self.sync()
        self.ops.reset_launches()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        w0 = time.perf_counter()
        e0.record()
        res, final = timed(seeds, nu, state=state)
        e1.record()
        self.sync()
        wall = time.perf_counter() - w0
        peak_gb = torch.cuda.max_memory_allocated(self.dev) / 1e9
        launches = dict(self.ops.LAUNCHES)
        del state
        # the profile's runners, built outside its window (at 24x24 the
        # shards' column ids alone are hundreds of small launches)
        runners = {k: runner(k) for k in (2, PROFILE_STEPS)}

        def run_k(k):
            return runners[k](seeds, nu, state=final)
        return dict(res=res, final=final, warm=warm_res, run_k=run_k,
                    ms=e0.elapsed_time(e1) / SERVICE_TIMED,
                    wall_ms=wall * 1e3 / SERVICE_TIMED, peak_gb=peak_gb,
                    launches=launches)

    def hold_tenants(self, name, spec, out, oracle):
        """Every tenant of a batched mesh run against its dedicated run:
        spikes, per-step spikes, v (and under STDP the weights and
        traces) to the bit, events within EVENTS_RTOL past 2**24."""
        res, final = out["res"], out["final"]
        trace = self.torch.cat([out["warm"].rate_trace, res.rate_trace], 1)
        leaves = dict(v=final.lif.v)
        if final.plastic is not None:
            pl = final.plastic
            leaves.update(w_local=pl.w_local, rem_w=pl.rem_w,
                          x_pre=pl.traces.x_pre, x_post=pl.traces.x_post)
        for i, one in enumerate(oracle):
            if float(res.spikes[i]) != one["spikes"]:
                raise AssertionError(f"{name} tenant {i}: "
                                     f"{float(res.spikes[i])} spikes, "
                                     f"dedicated {one['spikes']}")
            self.equal(f"{name} tenant {i} per-step spikes", trace[i],
                       one["trace"])
            for leaf, x in leaves.items():
                self.equal(f"{name} tenant {i} {leaf}",
                           self.part.columns_to_global(x[:, i], spec),
                           one[leaf])
            if not self.ld.events_agree(float(res.events[i]),
                                        one["events"]):
                raise AssertionError(f"{name} tenant {i}: events "
                                     f"{float(res.events[i])} vs "
                                     f"{one['events']}")

    def batched_mesh_path(self, cfg, params):
        """Phase 7: the multi-rank batched service at full width, 6b's
        tenants (seeds 42-45 at nu_scale 1.0, 0.8, 1.0, 1.5) on in-process
        meshes of 2x2 and 24x24 shards, on the dense wire and on AER at a
        bound that cannot overflow, one case under ``cuda``, 2 plastic
        tenants on 2x2, then 2 gloo ranks with 2 tenants, with and
        without batch shards. Each tenant is held to its dedicated
        single-shard run, and each in-process run to one ``fused_step``
        (or one of each staged kernel) and one ``keyed_drive`` launch per
        step for all its tenants and shards."""
        torch = self.torch
        t0 = time.perf_counter()
        steps = WARMUP_STEPS + SERVICE_TIMED
        aer = self.wire_cfg(cfg, "aer_sparse", AER_FREE_HZ)
        pcfg = dataclasses.replace(cfg, stdp=True)
        per_step = {"cuda_fused": dict(fused_step=SERVICE_TIMED),
                    "cuda": dict(lif_step=SERVICE_TIMED,
                                 synapse_matmul=SERVICE_TIMED,
                                 ell_gather=SERVICE_TIMED)}
        cases = [  # (name, shape, cfg, impl, tenants), grouped by oracle
            ("2x2 cuda_fused", (2, 2), cfg, "cuda_fused", SERVICE_TENANTS),
            ("24x24 cuda_fused", (24, 24), cfg, "cuda_fused",
             SERVICE_TENANTS),
            (f"2x2 aer at {AER_FREE_HZ:g} Hz", (2, 2), aer, "cuda_fused",
             SERVICE_TENANTS),
            (f"24x24 aer at {AER_FREE_HZ:g} Hz", (24, 24), aer, "cuda_fused",
             SERVICE_TENANTS),
            ("2x2 cuda", (2, 2), cfg, "cuda", SERVICE_TENANTS),
            ("2x2 plastic cuda_fused", (2, 2), pcfg, "cuda_fused",
             SERVICE_TENANTS[:PLASTIC_TENANTS])]
        rows, built, oracle = [], {}, {}
        for name, shape, run_cfg, impl, tenants in cases:
            name = f"batched mesh {name}"
            key = (impl, run_cfg.stdp)
            if key not in oracle:
                oracle.clear()
                torch.cuda.empty_cache()
                oracle[key] = self.tenant_oracle(
                    dataclasses.replace(run_cfg, conn=cfg.conn), params,
                    impl, tenants, steps)
            mesh = self.LocalMesh(*shape, self.dev)
            spec = self.part.make_tile_spec(cfg, *shape)
            if shape not in built:
                built.clear()
                torch.cuda.empty_cache()
                ids = self.ex.shard_col_ids(cfg, spec, mesh, self.dev).long()
                built[shape] = self.net.NetworkParams(*(x[ids]
                                                        for x in params))
            out = self.batched_mesh_run(run_cfg, mesh, built[shape], impl,
                                        tenants)
            b = len(tenants)
            want = dict(per_step[impl], keyed_drive=SERVICE_TIMED)
            if run_cfg.stdp:
                want.update(stdp_dense_update=SERVICE_TIMED,
                            stdp_remote_update=SERVICE_TIMED)
            if out["launches"] != self.expected_launches(**want):
                raise AssertionError(f"{name} launches {out['launches']}")
            sat = int(out["warm"].aer_saturated.sum()
                      + out["res"].aer_saturated.sum())
            if sat:
                raise AssertionError(f"{name}: {sat} saturated steps")
            self.hold_tenants(name, spec, out, oracle[key])
            if name == "batched mesh 2x2 cuda_fused":
                # phase 9c's guard-off run
                self.unguarded_2x2 = dict(
                    ms=out["ms"], spikes=out["res"].spikes.clone(),
                    events=out["res"].events.clone(),
                    trace=torch.cat([out["warm"].rate_trace,
                                     out["res"].rate_trace], 1),
                    v=out["final"].lif.v.clone())
            prof = self.profile(name, out["run_k"], out["wall_ms"],
                                steps=PROFILE_STEPS)
            ring = out["final"].hist_ext
            row = dict(case=name, mesh=list(shape), impl=impl, tenants=b,
                       wire=run_cfg.conn.exchange_mode, stdp=run_cfg.stdp,
                       tile=f"{spec.tile_h}x{spec.tile_w}",
                       ms_per_step=out["ms"], wall_ms_per_step=out["wall_ms"],
                       tenant_steps_per_s=b * 1e3 / out["wall_ms"],
                       device_ms_per_step=prof["device_ms_per_step"],
                       busy_share=prof["busy_share_unprofiled"],
                       outside_kernels_ms_per_step=prof[
                           "outside_ms_per_step"],
                       largest_outside_op=prof["largest_op"],
                       saturated_steps=sat,
                       ring_mb_per_tenant=ring.numel() * 4 / 1e6 / b,
                       peak_memory_gb=out["peak_gb"],
                       launches_per_step={k: v / SERVICE_TIMED
                                          for k, v in out["launches"].items()
                                          if v})
            rows.append(row)
            log(f"phase 7 {name}, {b} tenants: tiles {row['tile']}, "
                f"{row['ms_per_step']:.4f} ms per loop step (device events), "
                f"wall {row['wall_ms_per_step']:.4f} ms, "
                f"{row['tenant_steps_per_s']:.1f} tenant-steps/s (wall), "
                f"device {row['device_ms_per_step']:.4f} ms/step, busy share "
                f"{row['busy_share']:.3f} (the profiled device time, with one "
                f"copy of the ring, over the unprofiled wall), outside the "
                f"kernels "
                f"{row['outside_kernels_ms_per_step']:.4f} ms (largest op "
                f"{row['largest_outside_op'][0]} "
                f"{row['largest_outside_op'][1]:.1f} us), saturated steps "
                f"{sat}, ring {row['ring_mb_per_tenant']:.1f} MB per tenant, "
                f"peak memory {row['peak_memory_gb']:.2f} GB, launches per "
                f"step {row['launches_per_step']}; every tenant's spikes, "
                f"per-step spikes, v"
                + (", w_local, rem_w, x_pre, x_post" if run_cfg.stdp else "")
                + f" equal its dedicated {impl} run to the bit, events "
                + ", ".join(f"{float(x):.6e}" for x in out["res"].events))
            del out, ring
        built.clear()
        oracle.clear()
        torch.cuda.empty_cache()
        ranks = self.batched_rank_path(cfg)
        self.report["batched_mesh_path"] = dict(
            meshes=rows, ranks=ranks, seconds=time.perf_counter() - t0)
        self.note(f"phase 7: {len(rows)} batched meshes (2x2 and 24x24 "
                  f"cuda_fused, dense and AER at {AER_FREE_HZ:g} Hz with no "
                  f"saturated step, 2x2 cuda, {PLASTIC_TENANTS} plastic "
                  f"tenants on 2x2) and 2 gloo ranks with 2 tenants (1 and 2 "
                  f"batch shards): every tenant equal to its dedicated "
                  f"single-shard run to the bit; one launch of each kernel "
                  f"per step for all tenants and shards")
        log(f"phase 7 took {time.perf_counter() - t0:.1f} s")

    def batched_rank_path(self, cfg):
        """Phase 7, ranks: 2 gloo ranks on this card with 2 tenants (seeds
        42, 43), on one spatial grid and over 2 batch shards, through the
        launcher; each tenant held to its dedicated single-tenant run by
        the launcher's own check (spikes and events per tenant, v from
        the saved states)."""
        import tempfile

        ld, out, ref = self.ld, [], None
        for shards in (1, 2):
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
                args = ld.make_parser().parse_args(
                    ["--ranks", "2", "--batch", "2", "--batch-shards",
                     str(shards), "--grid", f"{cfg.grid_h}x{cfg.grid_w}",
                     "--neurons", str(cfg.neurons_per_column),
                     "--steps", str(WARMUP_STEPS + SERVICE_TIMED),
                     "--seed", str(cfg.seed), "--impl", "cuda_fused",
                     "--device", self.dev.type,
                     "--timeout", str(RANK_TIMEOUT_S), "--state-dir", d])
                w0 = time.perf_counter()
                row = ld.launch(args)
                row["launch_wall_s"] = time.perf_counter() - w0
                if ref is None:
                    # kept for phase 9b's tenants
                    ref = self.tenant_ref = ld.single_process_reference(args)
                if not ld.report_check(args, row, ref, ["v"]):
                    raise AssertionError(f"2 ranks, {shards} batch shards: "
                                         f"a tenant differs from its "
                                         f"dedicated run")
            per_step = {k: v / row["steps"] for k, v in row["launches"].items()
                        if v}
            if per_step != {"fused_step": 1.0, "keyed_drive": 1.0} \
                    or row["library_build_s_max"] != 0.0:
                raise AssertionError(f"2 ranks, {shards} batch shards: rank 0 "
                                     f"launches {row['launches']}, build "
                                     f"{row['library_build_s_max']} s")
            out.append(row)
            log(f"phase 7 2 ranks x 2 tenants, {shards} batch shard(s) (gloo, "
                f"every rank on this card, time-sliced: no scaling figure): "
                f"process grid {row['process_grid']}, tiles {row['tile']}, "
                f"{row['step_ms']:.4f} ms per loop step (wall, "
                f"{row['steps']} steps), "
                f"{row['batch_size'] * 1e3 / row['step_ms']:.1f} tenant-steps"
                f"/s, rank 0 peak memory {row['peak_memory_gb']:.2f} GB, "
                f"rank 0 launches per step {per_step}, launch "
                f"{row['launch_wall_s']:.1f} s; per-tenant spikes "
                f"{row['per_tenant_spikes']} and v equal the dedicated runs; "
                f"device time not measured (other processes)")
        return out


    # ------------------------------------------------------------ phase 8
    def guard_path(self, cfg, params, fused):
        """Phase 8: 8a the guarded in-process meshes, each held to phase 3
        (its time beside phase 5's guard-off run of the same mesh and
        wire), and the chaos flip and NaN on 2x2; 8b and 8c the
        supervised ranks (:meth:`supervised_path`)."""
        torch = self.torch
        t0 = time.perf_counter()
        guard = self.GuardConfig(enabled=True)
        node24 = self.part.make_node_spec(24, 24, 4)
        aer = self.wire_cfg(cfg, "aer_sparse", AER_FREE_HZ)
        off = {r["case"]: r["ms_per_step"]
               for r in self.report.get("wire_path", [])}
        off.update({f"mesh {'x'.join(map(str, r['mesh']))}":
                    r["ms_per_step"] for r in self.report.get("mesh_path", [])
                    if r["impl"] == "cuda_fused" and not r["pipelined"]
                    and not r["compress"]})
        cases = [  # (name, shape, cfg, node, phase 5's guard-off case)
            ("2x2 dense", (2, 2), cfg, None, "mesh 2x2"),
            ("24x24 dense", (24, 24), cfg, None, "mesh 24x24"),
            (f"2x2 aer at {AER_FREE_HZ:g} Hz", (2, 2), aer, None,
             "aer 2x2 at the free bound"),
            ("24x24 in nodes of 1x4", (24, 24), cfg, node24,
             "hier 24x24 nodes of 1x4 dense")]
        want = self.expected_launches(fused_step=MAIN_STEPS,
                                      keyed_drive=MAIN_STEPS)
        counts = self.column_spike_counts(cfg, params,
                                          WARMUP_STEPS + MAIN_STEPS)
        if float(counts.sum()) != float(fused.spikes):
            raise AssertionError("phase 8a: the per-column spike counts "
                                 "are not phase 3's run")
        rows, built = [], {}
        for name, shape, run_cfg, node, off_case in cases:
            name = f"guarded mesh {name}"
            run_cfg = dataclasses.replace(run_cfg, guard=guard)
            mesh = self.LocalMesh(*shape, self.dev, node=node)
            spec = self.part.make_tile_spec(cfg, *shape)
            if shape not in built:
                built.clear()
                ids = self.ex.shard_col_ids(cfg, spec, mesh, self.dev).long()
                built[shape] = self.net.NetworkParams(*(x[ids]
                                                        for x in params))
            res, final, spec, ms, wall, launches, _, warm = self.mesh_run(
                run_cfg, mesh, built[shape], "cuda_fused")
            # the guard-flag instance of fused_step, once per step
            if launches != want:
                raise AssertionError(f"{name} launches {launches}")
            if not rows:
                self.report["kernels"]["fused_step"][
                    "launches_guarded_mesh"] = launches["fused_step"]
            sat = int(warm.aer_saturated.sum() + res.aer_saturated.sum())
            if sat:
                raise AssertionError(f"{name}: {sat} saturated steps")
            self.hold_against_single(name, spec, res, final, fused)
            ceiling = self.hold_guard(name, run_cfg, spec, final.guard,
                                      counts)
            row = dict(case=name, mesh=list(shape),
                       node=None if node is None else list(node),
                       wire=run_cfg.conn.exchange_mode, ms_per_step=ms,
                       guard_off_ms_per_step=off.get(off_case),
                       wall_s=wall, launches=launches, **ceiling)
            rows.append(row)
            log(f"phase 8a {name}: {ms:.4f} ms/step with the guard (device "
                f"events; phase 5 without it: "
                + (f"{row['guard_off_ms_per_step']:.4f}"
                   if row["guard_off_ms_per_step"] is not None
                   else "not run") +
                f"), wall {wall:.3f} s; every halo message checksummed, no "
                f"checksum failure; "
                + (f"{ceiling['ceiling_trips']} of "
                   f"{spec.tiles_y * spec.tiles_x} shards tripped the spike ceiling ({ceiling['ceiling']:g}"
                   f" spikes a step per shard; first at step "
                   f"{ceiling['first_ceiling_step']}), as their own spike "
                   f"counts say"
                   if ceiling["ceiling_trips"] else "no trip")
                + f"; every guard leaf of every shard as recomputed from "
                f"phase 3's per-column counts; spikes, per-step spikes, v, "
                f"last frame equal phase 3 to the bit; launches {launches}")
            del res, final, warm
        built.clear()
        chaos = self.guard_chaos(cfg, params)
        torch.cuda.empty_cache()
        self.note(f"phase 8a: {len(rows)} guarded meshes (2x2, 24x24 dense, "
                  f"2x2 AER at {AER_FREE_HZ:g} Hz, 24x24 in nodes of 1x4) "
                  f"equal phase 3 to the bit with no checksum failure and "
                  f"every guard leaf as its per-shard spike counts say ("
                  + ", ".join(f"{r['case']}: {r['ceiling_trips']} ceiling "
                              f"trips" for r in rows)
                  + f"); fused_step's guard-flag instance once per step over "
                  f"all shards' rows; {chaos}")
        ranks = self.supervised_path(cfg, params)
        self.report["guard_path"] = dict(meshes=rows, ranks=ranks,
                                         seconds=time.perf_counter() - t0)
        log(f"phase 8 took {time.perf_counter() - t0:.1f} s")

    def column_spike_counts(self, cfg, params, steps):
        """(steps, columns) spikes of every column at every step of phase
        3's single-shard run (from the seed, one step at a time)."""
        state = self.net.init_state(cfg, range(cfg.n_columns),
                                    device=self.dev)
        d = state.hist.shape[0]
        out = []
        for _ in range(steps):
            state = self.sim.run(cfg, params, state, 1,
                                 impl="cuda_fused").state
            out.append(state.hist[(int(state.t) - 1) % d].sum(-1))
        return self.torch.stack(out)

    def hold_guard(self, name, cfg, spec, g, counts):
        """Every leaf of a healthy guarded run's (S,) guard to the bit
        against the plain verdict from the per-column ``counts``: a shard
        trips the spike ceiling (``max_spike_fraction`` of its neurons,
        per shard as in the reference) at the first step its own count
        exceeds it; nothing else trips, no frame fails. Returns the
        ceiling and how many shards tripped it, and when first."""
        torch, integ = self.torch, self.integrity
        per = self.part.global_to_columns(counts.T.contiguous(), spec).sum(1)
        ceiling = cfg.guard.max_spike_fraction * (spec.columns_per_tile
                                                  * cfg.neurons_per_column)
        over = per > ceiling                       # (S, steps)
        tripped = over.any(1)
        first = torch.where(tripped, over.int().argmax(1), -1)
        want = dict(tripped=tripped,
                    trip_code=torch.where(tripped, integ.TRIP_SPIKES, 0),
                    trip_step=first, sat_run=torch.zeros_like(first),
                    checksum_fails=torch.zeros_like(first))
        for leaf, x in want.items():
            self.equal(f"{name} guard {leaf}", g._asdict()[leaf],
                       x.to(g._asdict()[leaf].dtype))
        return dict(ceiling=ceiling, ceiling_trips=int(tripped.sum()),
                    first_ceiling_step=(int(first[tripped].min())
                                        if bool(tripped.any()) else None))

    def guard_chaos(self, cfg, params):
        """A bit flipped on halo send FLIP[0] at step FLIP[1] (word FLIP[2]
        of every received frame) and a NaN at NAN_STEP, each on 2x2
        shards for CHAOS_STEPS from the seed: every shard's guard trips
        at that step with its code."""
        mesh = self.LocalMesh(2, 2, self.dev)
        spec = self.part.make_tile_spec(cfg, 2, 2)
        ids = self.ex.shard_col_ids(cfg, spec, mesh, self.dev).long()
        params2 = self.net.NetworkParams(*(x[ids] for x in params))
        ring, step, word = FLIP
        integ = self.integrity
        out = []
        for what, kw, at, code in (
                ("flip", dict(chaos_flip_ring=ring, chaos_flip_step=step,
                              chaos_flip_word=word), step,
                 integ.TRIP_CHECKSUM),
                ("NaN", dict(chaos_nan_at_step=NAN_STEP), NAN_STEP,
                 integ.TRIP_NAN)):
            run_cfg = dataclasses.replace(cfg, guard=self.GuardConfig(
                enabled=True, **kw))
            run, _ = self.ex.make_distributed_run(
                run_cfg, mesh, n_steps=CHAOS_STEPS, impl="cuda_fused",
                with_state=True, params=params2)
            _, final = run()
            g = final.guard
            rep = integ.guard_report(g)
            if not (bool(g.tripped.all()) and bool((g.trip_step == at).all())
                    and bool(((g.trip_code & code) != 0).all())):
                raise AssertionError(f"phase 8a {what} at step {at}: guard "
                                     f"{rep}")
            out.append(f"a {what} at step {at} trips every shard at step "
                       f"{rep['guard_trip_step']} ({rep['guard_trip_what']}, "
                       f"{rep['guard_checksum_fails']} checksum failures)")
            log(f"phase 8a chaos: {out[-1]}")
            del final
        return "; ".join(out)

    def supervised_single(self, cfg, params, steps):
        """The single process's run of ``steps`` from the seed on this
        card (``single_process_reference``'s, with phase 1's network):
        totals and the final v."""
        state = self.net.init_state(cfg, range(cfg.n_columns),
                                    device=self.dev)
        res = self.sim.run(cfg, params, state, steps, impl="cuda_fused")
        return dict(spikes=float(res.spikes), events=float(res.events),
                    v=res.state.lif.v.cpu().numpy())

    def supervised_path(self, cfg, params):
        """Phase 8b and 8c: 2 gloo ranks on this card under the launcher's
        supervisor. 8b: a checkpoint every SUPERVISED_EVERY steps, rank
        KILL_RANK killed at KILL_STEP, the restart on 1 rank; 8c: the flip
        drill under the guard. Each finished run's totals and the v of its
        final checkpoint are held to the single process's run."""
        import tempfile

        import numpy as np
        ld = self.ld
        common = ["--ranks", "2", "--grid", f"{cfg.grid_h}x{cfg.grid_w}",
                  "--neurons", str(cfg.neurons_per_column),
                  "--seed", str(cfg.seed), "--impl", "cuda_fused",
                  "--device", self.dev.type, "--timeout",
                  str(RANK_TIMEOUT_S), "--supervise"]
        (ROOT / "build").mkdir(exist_ok=True)
        flip_step = int(DRILL_FLIP.split(":")[1])
        drills = [  # (name, flags, lost steps, resumed from)
            ("8b", ["--steps", str(SUPERVISED_STEPS), "--checkpoint-every",
                    str(SUPERVISED_EVERY), "--chaos-kill-rank",
                    str(KILL_RANK), "--chaos-at-step", str(KILL_STEP),
                    "--restart-ranks", "1"],
             KILL_STEP % SUPERVISED_EVERY,
             KILL_STEP - KILL_STEP % SUPERVISED_EVERY),
            # the guard latches at the flip, the ranks abort one step later
            ("8c", ["--steps", str(DRILL_STEPS), "--checkpoint-every",
                    str(DRILL_EVERY), "--guard", "--chaos-flip-bit",
                    DRILL_FLIP],
             flip_step % DRILL_EVERY + 1,
             flip_step - flip_step % DRILL_EVERY)]
        out = []
        for name, flags, lost, resumed in drills:
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
                args = ld.make_parser().parse_args(
                    [*common, *flags, "--ckpt-dir", d])
                ld.refuse_before_spawn(args)
                row = ld.supervise(args)
                run_cfg = ld.build_cfg(args)
                single = self.supervised_single(run_cfg, params, args.steps)
                states, spec = ld.checkpoint_states(run_cfg, d)
                v = self.part.columns_to_global(states["v"], spec)
            if (row["restarts"], row["lost_steps"],
                    row["resumed_from_step"]) != (1, lost, resumed):
                raise AssertionError(f"phase {name}: restarts "
                                     f"{row['restarts']}, lost "
                                     f"{row['lost_steps']}, resumed from "
                                     f"{row['resumed_from_step']}")
            if (row["spikes"] != single["spikes"]
                    or not ld.events_agree(row["events"], single["events"])
                    or not np.array_equal(v, single["v"])):
                raise AssertionError(f"phase {name}: spikes {row['spikes']}"
                                     f" events {row['events']} or v differ "
                                     f"from the single process "
                                     f"({single['spikes']}, "
                                     f"{single['events']})")
            if args.guard and row["guard_trip_what"] != "clean":
                raise AssertionError(f"phase {name}: final guard "
                                     f"{row['guard_trip_what']}")
            out.append(row)
            log(f"phase {name} supervised ranks (gloo, every rank on this "
                f"card): {' '.join(flags)}; {row['restarts']} restart, "
                f"{row['lost_steps']} lost steps, resumed from step "
                f"{row['resumed_from_step']} on {row['rank_count']} "
                f"rank(s); checkpoint {row['checkpoint_bytes']} B, seconds "
                f"per save (last attempt, rank 0) "
                + ", ".join(f"{x:.3f}" for x in row["save_s"])
                + f"; wall_s {row['wall_s']:.2f} (last attempt), "
                f"supervised_wall_s {row['supervised_wall_s']:.1f}"
                + (f", final guard {row['guard_trip_what']}"
                   if args.guard else "")
                + f"; BITWISE-EQUAL vs the single process (spikes "
                f"{single['spikes']:.0f}, events {single['events']:.6e}, v "
                f"of the final checkpoint)")
        self.note(f"phase 8b/8c: the killed rank restarted on 1 rank from "
                  f"the resharded step-{out[0]['resumed_from_step']} "
                  f"checkpoint and the flip drill rolled back to step "
                  f"{out[1]['resumed_from_step']}, each equal to the single "
                  f"process to the bit")
        return out


    # ------------------------------------------------------------ phase 9
    def completion_path(self, cfg, params, fused):
        """Phase 9: 9a weak scaling (:meth:`weak_path`), 9b several shards
        per rank (:meth:`shards_path`), 9c the guarded batched mesh
        (:meth:`guarded_batched_path`), 9d the Izhikevich neuron
        (:meth:`izhikevich_path`)."""
        t0 = time.perf_counter()
        self.report["phase9"] = dict(
            weak=self.weak_path(cfg, fused),
            shards_per_rank=self.shards_path(cfg, fused),
            guarded_batched=self.guarded_batched_path(cfg, params),
            izhikevich=self.izhikevich_path())
        self.report["phase9"]["seconds"] = time.perf_counter() - t0
        log(f"phase 9 took {time.perf_counter() - t0:.1f} s")

    def hold_row(self, name, row, states, spec, fused):
        """A rank run of WARMUP_STEPS + MAIN_STEPS steps from the seed
        against phase 3's: spikes, every step's rate, v to the bit; events
        as :meth:`hold_against_single`; no saturated step; rank 0 one
        ``fused_step`` and one ``keyed_drive`` launch per step."""
        import numpy as np
        ld = self.ld
        trace = self.torch.cat([self.warm_trace, fused.rate_trace]).tolist()
        v = self.part.columns_to_global(states["v"], spec)
        if (row["spikes"] != float(fused.spikes)
                or row["rate_trace"] != trace
                or not np.array_equal(v, fused.state.lif.v.cpu().numpy())):
            raise AssertionError(f"{name}: spikes, per-step spikes or v "
                                 f"differ from phase 3")
        if not ld.events_agree(row["events"], float(fused.events)):
            raise AssertionError(f"{name}: events {row['events']} vs "
                                 f"{float(fused.events)}")
        per_step = {k: x / row["steps"] for k, x in row["launches"].items()
                    if x}
        if (per_step != {"fused_step": 1.0, "keyed_drive": 1.0}
                or row["aer_saturated_steps"]
                or row["library_build_s_max"] != 0.0):
            raise AssertionError(f"{name}: launches {row['launches']}, "
                                 f"saturated {row['aer_saturated_steps']}, "
                                 f"build {row['library_build_s_max']} s")

    def weak_path(self, cfg, fused):
        """Phase 9a: the weak-scaling protocol (``--weak``, the paper's Fig
        3): a tile of WEAK_TILE columns a rank on WEAK_RANKS gloo ranks,
        WARMUP_STEPS + MAIN_STEPS steps from the seed, the fastest of
        WEAK_REPS timed runs; each held to its single-process run by the
        launcher's own check, the last (GRID_24) to phase 3's run. Ranks
        share this card: the weak efficiency t_1 / t_N is no scaling
        figure."""
        import tempfile
        ld, rows = self.ld, []
        for ranks in WEAK_RANKS:
            on_grid24 = ranks == WEAK_RANKS[-1]
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
                args = ld.make_parser().parse_args(
                    ["--ranks", str(ranks), "--weak", "--grid",
                     "x".join(map(str, WEAK_TILE)),
                     "--neurons", str(cfg.neurons_per_column),
                     "--steps", str(WARMUP_STEPS + MAIN_STEPS),
                     "--seed", str(cfg.seed), "--impl", "cuda_fused",
                     "--device", self.dev.type,
                     "--timeout", str(RANK_TIMEOUT_S),
                     "--timed-reps", str(WEAK_REPS), "--state-dir", d,
                     *(["--no-check-single"] if on_grid24 else [])])
                w0 = time.perf_counter()
                row = ld.launch(args)
                row["launch_wall_s"] = time.perf_counter() - w0
                wcfg = ld.workload_cfg(args)
                spec = ld.shard_spec(args, wcfg)
                if on_grid24:
                    if (wcfg.grid_h, wcfg.grid_w) != (cfg.grid_h, cfg.grid_w):
                        raise AssertionError(f"{ranks} weak ranks: grid "
                                             f"{row['grid']}")
                    self.hold_row(f"{ranks} weak ranks", row,
                                  self.mp.load_states(d, ranks), spec, fused)
                elif not ld.report_check(args, row,
                                         ld.single_process_reference(args),
                                         ["v"]):
                    raise AssertionError(f"{ranks} weak ranks differ from "
                                         f"their single process")
            row["weak_efficiency"] = rows[0]["step_ms"] / row["step_ms"] \
                if rows else 1.0
            rows.append(row)
            log(f"phase 9a {ranks} weak rank(s) of {row['tile']} columns "
                f"(grid {row['grid']}, gloo, every rank on this card, "
                f"time-sliced: no scaling figure): fastest of "
                f"{row['timed_reps']} runs "
                f"{row['step_ms']:.4f} ms/step (wall, {row['steps']} steps; "
                f"runs " + ", ".join(f"{x:.3f}" for x in row["wall_s_reps"])
                + f" s), {row['events_per_s']:.4e} events/s, weak efficiency "
                f"t_1/t_{ranks} {row['weak_efficiency']:.4f}, launch "
                f"{row['launch_wall_s']:.1f} s; spikes {row['spikes']:.0f} and "
                f"v bitwise against "
                + ("phase 3's run of the same grid" if on_grid24 else
                   "its single process"))
        self.note(f"phase 9a: weak scaling on {', '.join(map(str, WEAK_RANKS))}"
                  f" ranks, every run bitwise against its single process; "
                  f"weak efficiency " + ", ".join(
                      f"{r['weak_efficiency']:.4f}" for r in rows))
        return rows

    def shards_path(self, cfg, fused):
        """Phase 9b: 2 ranks of SHARDS_PER_RANK shards each (a 1x4 shard
        grid) on the dense wire and on AER at the bound that cannot
        overflow, held to phase 3; then 2 ranks x SHARDS_PER_RANK shards x
        phase 7's 2 tenants, held to phase 7's tenants (their per-tenant
        totals, and by the launcher's check their dedicated runs with v)."""
        import tempfile
        ld, rows = self.ld, []
        k = ["--shards-per-rank", str(SHARDS_PER_RANK)]
        spec = self.part.make_tile_spec(cfg, 1, 2 * SHARDS_PER_RANK)
        for name, flags in (
                ("dense", []),
                (f"aer at {AER_FREE_HZ:g} Hz",
                 ["--exchange-mode", "aer_sparse", "--aer-rate-bound",
                  str(AER_FREE_HZ)])):
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
                row, states = self.launch_ranks(cfg, 2, [*k, *flags], d)
            self.hold_row(f"2 ranks x {SHARDS_PER_RANK} shards {name}", row,
                          states, spec, fused)
            rows.append(row)
            log(f"phase 9b 2 ranks x {SHARDS_PER_RANK} shards, {name} (gloo, "
                f"every rank on this card): shard grid {row['process_grid']}"
                f", tiles {row['tile']}, {row['step_ms']:.4f} ms/step (wall), "
                f"halo {row['halo_payload_bytes_per_step']} B/step per "
                f"interior shard, launch {row['launch_wall_s']:.1f} s; "
                f"spikes, per-step spikes and v equal phase 3 to the bit")
        want = self.report["batched_mesh_path"]["ranks"][0]
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            args = ld.make_parser().parse_args(
                ["--ranks", "2", *k, "--batch", "2",
                 "--grid", f"{cfg.grid_h}x{cfg.grid_w}",
                 "--neurons", str(cfg.neurons_per_column),
                 "--steps", str(WARMUP_STEPS + SERVICE_TIMED),
                 "--seed", str(cfg.seed), "--impl", "cuda_fused",
                 "--device", self.dev.type, "--timeout", str(RANK_TIMEOUT_S),
                 "--state-dir", d])
            w0 = time.perf_counter()
            row = ld.launch(args)
            row["launch_wall_s"] = time.perf_counter() - w0
            if (row["per_tenant_spikes"] != want["per_tenant_spikes"]
                    or not all(ld.events_agree(x, y) for x, y in zip(
                        row["per_tenant_events"], want["per_tenant_events"]))
                    or not ld.report_check(args, row, self.tenant_ref,
                                           ["v"])):
                raise AssertionError("2 ranks x 2 shards x 2 tenants differ "
                                     "from phase 7's tenants")
        rows.append(row)
        log(f"phase 9b 2 ranks x {SHARDS_PER_RANK} shards x 2 tenants (gloo):"
            f" shard grid {row['process_grid']}, {row['step_ms']:.4f} ms per "
            f"loop step (wall), launch {row['launch_wall_s']:.1f} s; "
            f"per-tenant spikes {row['per_tenant_spikes']} equal phase 7's 2 "
            f"ranks x 2 tenants' (events "
            + ", ".join(f"{x:.9e}" for x in row["per_tenant_events"])
            + f" against "
            + ", ".join(f"{x:.9e}" for x in want["per_tenant_events"])
            + f", within {ld.EVENTS_RTOL:g} past 2**24), v equal the "
            f"dedicated runs")
        self.note(f"phase 9b: 2 ranks x {SHARDS_PER_RANK} shards on the dense "
                  f"and AER wires equal phase 3 to the bit, and with 2 "
                  f"tenants equal phase 7's")
        return rows

    def guarded_batched_path(self, cfg, params):
        """Phase 9c: phase 7's 4 tenants on 2x2 shards under ``cuda_fused``
        with the guard on (each tenant's strips framed apart, a verdict
        per (shard, tenant)): bitwise against phase 7's unguarded run, no
        trip; its ms per loop step beside phase 7's; then a bit flipped on
        send FLIP[0] at step FLIP[1] trips every (shard, tenant) there with
        the checksum code, and only there."""
        torch, integrity = self.torch, self.integrity
        off = self.unguarded_2x2
        mesh = self.LocalMesh(2, 2, self.dev)
        spec = self.part.make_tile_spec(cfg, 2, 2)
        ids = self.ex.shard_col_ids(cfg, spec, mesh, self.dev).long()
        built = self.net.NetworkParams(*(x[ids] for x in params))
        gcfg = dataclasses.replace(cfg, guard=self.GuardConfig(enabled=True))
        out = self.batched_mesh_run(gcfg, mesh, built, "cuda_fused",
                                    SERVICE_TENANTS)
        if out["launches"] != self.expected_launches(
                fused_step=SERVICE_TIMED, keyed_drive=SERVICE_TIMED):
            raise AssertionError(f"guarded batched mesh launches "
                                 f"{out['launches']}")
        res, g = out["res"], out["final"].guard
        self.equal("guarded batched mesh spikes", res.spikes, off["spikes"])
        self.equal("guarded batched mesh events", res.events, off["events"])
        self.equal("guarded batched mesh per-step spikes",
                   torch.cat([out["warm"].rate_trace, res.rate_trace], 1),
                   off["trace"])
        self.equal("guarded batched mesh v", out["final"].lif.v, off["v"])
        b = len(SERVICE_TENANTS)
        if g.tripped.shape != (4, b) or bool(g.tripped.any()) \
                or int(g.checksum_fails.max()):
            raise AssertionError(f"guarded batched mesh: guard {g}")
        row = dict(tenants=b, mesh=[2, 2], ms_per_step=out["ms"],
                   wall_ms_per_step=out["wall_ms"],
                   off_ms_per_step=off["ms"],
                   on_minus_off_ms=out["ms"] - off["ms"],
                   peak_memory_gb=out["peak_gb"])
        del out
        seeds, nu = ([x for x, _ in SERVICE_TENANTS],
                     [x for _, x in SERVICE_TENANTS])
        ring, step, word = FLIP
        fcfg = dataclasses.replace(cfg, guard=self.GuardConfig(
            enabled=True, chaos_flip_ring=ring, chaos_flip_step=step,
            chaos_flip_word=word))
        run, _ = self.ex.make_batched_distributed_run(
            fcfg, mesh, n_steps=CHAOS_STEPS, batch=b, impl="cuda_fused",
            with_stimulus=True, with_state=True, params=built)
        _, final = run(seeds, nu)
        fg = final.guard
        if not (bool(fg.tripped.all())
                and bool((fg.trip_code == integrity.TRIP_CHECKSUM).all())
                and bool((fg.trip_step == step).all())
                and bool((fg.checksum_fails == 1).all())):
            raise AssertionError(f"flip at step {step}: guard {fg}")
        del final, built
        torch.cuda.empty_cache()
        log(f"phase 9c guarded batched mesh 2x2 cuda_fused, {b} tenants, "
            f"{WARMUP_STEPS} + {SERVICE_TIMED} steps: guard leaves "
            f"{tuple(g.tripped.shape)} (shard, tenant), no trip, no checksum "
            f"failure; spikes, per-step spikes, events and v equal phase 7's "
            f"unguarded run to the bit; {row['ms_per_step']:.4f} ms per loop "
            f"step (device events) against phase 7's "
            f"{row['off_ms_per_step']:.4f}: guard on - off "
            f"{row['on_minus_off_ms']:+.4f} ms (wall "
            f"{row['wall_ms_per_step']:.4f}), peak memory "
            f"{row['peak_memory_gb']:.2f} GB; a bit flipped on send {ring} "
            f"at step {step} (word {word}) trips all {4 * b} (shard, tenant)"
            f" pairs at step {step} with code {integrity.TRIP_CHECKSUM} "
            f"(halo-checksum) and one failed frame each")
        return row

    def izhikevich_path(self):
        """Phase 9d: the Izhikevich neuron (plain torch, off the main
        path) over IZH_SHAPE RS and FS neurons (IZH_INH of them FS) for
        IZH_STEPS steps on the card, the currents cycling through a bank
        of IZH_BANK drawn from a seeded generator; the final v and u and
        every step's spike count equal the same function on the CPU to
        the bit (on failure the largest difference in float32 ulps is
        printed first)."""
        torch, N = self.torch, self.neuron
        g = torch.Generator().manual_seed(42)
        inh = torch.rand(IZH_SHAPE, generator=g) < IZH_INH
        bank = torch.randn((IZH_BANK, *IZH_SHAPE), generator=g) * 3.0 + 5.0

        def run(dev):
            inh_d, bank_d = inh.to(dev), bank.to(dev)
            s = N.izh_init(IZH_SHAPE, inh_d)
            counts = torch.zeros(IZH_STEPS, device=dev)
            for t in range(IZH_STEPS):
                s, spk = N.izhikevich_step(s, bank_d[t % IZH_BANK], inh_d)
                counts[t] = spk.sum()
            return s, counts
        self.sync()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        w0 = time.perf_counter()
        e0.record()
        card, card_counts = run(self.dev)
        e1.record()
        self.sync()
        card_wall = time.perf_counter() - w0
        w0 = time.perf_counter()
        cpu, cpu_counts = run("cpu")
        cpu_wall = time.perf_counter() - w0

        def ulps(a, b):
            ai, bi = (x.cpu().view(torch.int32).long() for x in (a, b))
            # float32 bits as a line of integers across zero
            ai = torch.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
            bi = torch.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
            return int((ai - bi).abs().max())
        worst = max(ulps(card.v, cpu.v), ulps(card.u, cpu.u))
        same_counts = torch.equal(card_counts.cpu(), cpu_counts)
        row = dict(shape=list(IZH_SHAPE), steps=IZH_STEPS,
                   card_ms_per_step=e0.elapsed_time(e1) / IZH_STEPS,
                   card_wall_s=card_wall, cpu_wall_s=cpu_wall,
                   max_ulp=worst, spikes=float(cpu_counts.sum()),
                   counts_equal=same_counts)
        if worst or not same_counts:
            log(f"phase 9d Izhikevich: card against CPU max {worst} ulp, "
                f"per-step spike counts equal: {same_counts}")
            raise AssertionError("phase 9d: the card's Izhikevich run "
                                 "differs from the CPU's")
        log(f"phase 9d Izhikevich {IZH_SHAPE[0]}x{IZH_SHAPE[1]} neurons "
            f"({IZH_INH:.0%} FS), {IZH_STEPS} steps: "
            f"{row['card_ms_per_step']:.4f} ms/step on the card (device "
            f"events; plain torch, no kernel), {cpu_wall:.1f} s on the CPU; "
            f"{row['spikes']:.0f} spikes; final v and u and every step's "
            f"spike count equal the CPU's to the bit (0 ulp)")
        return row

    # ------------------------------------------------------ phase 10: LMs
    def lm_path(self):
        """Phase 10: the LM zoo's serving path (``repro_torch.models``,
        plain torch, no kernel of this repo): 10a qwen3-0.6b and 10b
        gemma2-9b at full config (:meth:`lm_full`), 10c internvl2-1b
        (:meth:`lm_vlm`), 10d the reduced configs of LM_ARCHS against the
        CPU (:meth:`lm_reduced`). Parameters from the port's own ``init``
        on the card, from a seeded generator."""
        t0 = time.perf_counter()
        LC = self.LC
        self.report["phase10"] = dict(
            qwen3=self.lm_full(LC.get_config("qwen3-0.6b"), "10a"),
            gemma2=self.lm_full(LC.get_config("gemma2-9b"), "10b",
                                long=True),
            internvl2=self.lm_vlm(LC.get_config("internvl2-1b")),
            reduced=self.lm_reduced())
        self.report["phase10"]["seconds"] = time.perf_counter() - t0
        log(f"phase 10 took {time.perf_counter() - t0:.1f} s")

    def event_ms(self, fn):
        """(device ms between CUDA events around ``fn()``, its result)."""
        torch = self.torch
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn()
        e1.record()
        self.sync()
        return e0.elapsed_time(e1), out

    def lm_model(self, cfg):
        """``build_model(cfg)`` on the card and its parameters from the
        port's ``init`` with a generator on the card seeded with 0 (the
        generator goes on to draw the inputs); :meth:`lm_peak_gb` counts
        from here."""
        torch = self.torch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.lm_base = torch.cuda.memory_allocated(self.dev)
        model = self.LM.build_model(cfg, device=self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(0)
        return model, model.init(gen), gen

    def lm_peak_gb(self):
        """Peak device memory since :meth:`lm_model`, less what was
        allocated then (what earlier phases still hold)."""
        return (self.torch.cuda.max_memory_allocated(self.dev)
                - self.lm_base) / 1e9

    @staticmethod
    def param_gb(params):
        return sum(p.numel() * p.element_size()
                   for p in params.parameters()) / 1e9

    def lm_full(self, cfg, tag, long=False):
        """10a/10b: ``cfg`` at full width. In float32, LM_CHECK tokens
        teacher-forced through ``decode`` equal ``forward``'s logits
        within LM_CHECK_TOL (and with ``long`` the LM_LONG-token prefill
        through ``_blockwise_attn`` equals the direct path's); the float32
        parameters are freed, then the config's bfloat16 model serves
        LM_SERVE (:meth:`lm_serve`, and with ``long`` the prefill again).
        The float32 model has LM_CHECK_LAYERS[name] layers where that
        names it, else all."""
        torch = self.torch
        cfg32 = dataclasses.replace(
            cfg, dtype="float32",
            num_layers=LM_CHECK_LAYERS.get(cfg.name, cfg.num_layers))
        model, params, gen = self.lm_model(cfg32)
        gb32 = self.param_gb(params)
        b, s = LM_CHECK
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device=self.dev)
        with torch.no_grad():
            full, _, _ = model.forward(params, {"tokens": toks})
            dec, _ = self.LM.decode_all(model, params, toks)
        err = self.close(f"phase {tag} {cfg.name} float32 decode against "
                         f"forward", dec, full, rtol=LM_CHECK_TOL,
                         atol=LM_CHECK_TOL)
        if not bool(torch.isfinite(full).all()):
            raise AssertionError(f"phase {tag}: non-finite logits")
        row = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
                   vocab=cfg.vocab_size, f32_layers=cfg32.num_layers,
                   f32_param_gb=gb32,
                   f32_decode_vs_forward_max_abs=err)
        log(f"phase {tag} {cfg.name} (full config: {cfg.num_layers} layers, "
            f"d {cfg.d_model}, vocab {cfg.vocab_size}), float32 at "
            f"{cfg32.num_layers} layers "
            f"{gb32:.3f} GB of parameters: {s} tokens x {b} teacher-forced "
            f"through decode equal forward's logits within {LM_CHECK_TOL} "
            f"(max abs err {err:.3e})")
        del full, dec
        if long:
            row["long_f32"] = self.lm_long(model, params, gen, tag)
        del params
        model, params, gen = self.lm_model(cfg)
        row.update(self.lm_serve(model, params, tag))
        if long:
            row["long_bf16"] = self.lm_long(model, params, gen, tag)
        del params
        torch.cuda.empty_cache()
        return row

    def lm_serve(self, model, params, tag, prefill=None, caches=None):
        """:meth:`lm_greedy`'s serving loop, each step between CUDA events
        (a host-bound step's device time includes the gaps between its
        launches), and its wall time; one ``prefill_logits`` over the
        prompts, updated with ``prefill`` (whisper's frames, or the SSMs'
        longer tokens; median of 3 after one untimed); LM_PROFILE_STEPS
        profiled steps; peak memory from the parameters' draw on
        (:meth:`lm_peak_gb`). ``caches()``, if given, makes the loop's
        and the profile's starting caches (whisper's primed ones), else
        ``cache_init``."""
        torch, cfg = self.torch, model.cfg
        b, prompt, n_gen = LM_SERVE
        s_cache = prompt + n_gen
        prompts = self.prng.randint(self.prng.prng_key(1, self.dev),
                                    (b, prompt), 0, cfg.vocab_size)
        batch = {"tokens": prompts, **(prefill or {})}
        pb, ps = batch["tokens"].shape
        over = (f" over {batch['frames'].shape[1]} frames"
                if "frames" in batch else "")
        with torch.no_grad():
            def prefill():
                return model.prefill_logits(params, batch)
            self.event_ms(prefill)
            prefill_ms = statistics.median(self.event_ms(prefill)[0]
                                           for _ in range(3))
            events = []

            def mark():
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            self.sync()
            w0 = time.perf_counter()
            gen, logits = self.lm_greedy(model, params, mark,
                                         caches() if caches else None)
            self.sync()
            wall = time.perf_counter() - w0
            if (not bool(torch.isfinite(logits).all())
                    or gen.shape != (b, n_gen)
                    or not bool(((gen >= 0) & (gen < cfg.vocab_size)).all())):
                raise AssertionError(f"phase {tag} {cfg.name}: the served "
                                     f"logits or tokens are not valid")
            ms = [e0.elapsed_time(e1) for e0, e1 in zip(events, events[1:])]
            step_ms = statistics.median(ms[1:])
            peak = self.lm_peak_gb()
            pcache = caches() if caches else model.cache_init(b, s_cache)
            at = [0]

            def run(k):
                for _ in range(k):
                    model.decode(params, pcache, prompts[:, :1], at[0])
                    at[0] += 1
            prof = self.profile(f"{cfg.name} {cfg.dtype} decode B={b}", run,
                                step_ms, steps=LM_PROFILE_STEPS)
        gb = self.param_gb(params)
        row = dict(requests=b, prompt=prompt, generated=n_gen, param_gb=gb,
                   decode_ms_per_step=step_ms, first_step_ms=ms[0],
                   tokens_per_s=b * 1e3 / step_ms,
                   loop_wall_s=wall,
                   tokens_per_s_wall=b * (s_cache - 1) / wall,
                   prefill_ms=prefill_ms, prefill_shape=[pb, ps],
                   peak_memory_gb=peak,
                   device_ops_per_step=prof["device_ops_per_step"],
                   busy_share=prof["busy_share_unprofiled"],
                   request0=gen[0, :12].tolist())
        log(f"phase {tag} {cfg.name} {cfg.dtype} ({gb:.3f} GB of "
            f"parameters) serve, {b} requests, "
            f"prompt {prompt}, {n_gen} generated: decode "
            f"{step_ms:.4f} ms/step (median of {len(ms) - 1} after the "
            f"first, {ms[0]:.2f} ms), {row['tokens_per_s']:.1f} tokens/s "
            f"({row['tokens_per_s_wall']:.1f} over the loop's "
            f"{wall:.3f} s wall), prefill of {pb}x{ps}{over} "
            f"{prefill_ms:.4f} ms, {prof['device_ops_per_step']:.0f} "
            f"device ops a step, device busy "
            f"{row['busy_share']:.3f} of the step, peak memory "
            f"{peak:.2f} GB; request 0: {row['request0']}")
        return row

    def lm_long(self, model, params, gen, tag):
        """10b: one LM_LONG-token prefill (batch 1) through
        ``_blockwise_attn`` (two query and two key blocks of 1024; one
        call a layer, counted) against the direct ``_sdpa`` path
        (``BLOCK_Q`` raised to LM_LONG, no blockwise call): the
        last-position logits within LM_LONG_F32_TOL in float32; in
        bfloat16 the max abs and relative norm of the difference are
        reported, not gated (the float32 check carries the blockwise
        path's correctness). Both timed once after one untimed call."""
        torch, LA, cfg = self.torch, self.LA, model.cfg
        toks = torch.randint(0, cfg.vocab_size, (1, LM_LONG), generator=gen,
                             device=self.dev)
        calls, real, block_q = [0], LA._blockwise_attn, LA.BLOCK_Q

        def counted(*args, **kw):
            calls[0] += 1
            return real(*args, **kw)

        def prefill():
            return model.prefill_logits(params, {"tokens": toks})
        LA._blockwise_attn = counted
        try:
            with torch.no_grad():
                prefill()
                calls[0] = 0
                block_ms, blocked = self.event_ms(prefill)
                n_blocked = calls[0]
                LA.BLOCK_Q = LM_LONG
                prefill()
                calls[0] = 0
                direct_ms, direct = self.event_ms(prefill)
                n_direct = calls[0]
        finally:
            LA._blockwise_attn, LA.BLOCK_Q = real, block_q
        if (n_blocked, n_direct) != (cfg.num_layers, 0):
            raise AssertionError(f"phase {tag}: {n_blocked} blockwise calls "
                                 f"on the long path, {n_direct} on the "
                                 f"direct one")
        a, d = blocked.float(), direct.float()
        max_abs = float((a - d).abs().max())
        rel = float((a - d).norm() / d.norm())
        if cfg.dtype == "float32":
            self.close(f"phase {tag} {cfg.name} float32 {LM_LONG}-token "
                       f"prefill, blockwise against direct", a, d,
                       rtol=LM_LONG_F32_TOL, atol=LM_LONG_F32_TOL)
        row = dict(tokens=LM_LONG, dtype=cfg.dtype, blockwise_ms=block_ms,
                   direct_ms=direct_ms, max_abs=max_abs, rel_norm=rel,
                   same_argmax=bool(a.argmax() == d.argmax()))
        log(f"phase {tag} {cfg.name} {cfg.dtype} prefill of {LM_LONG} "
            f"tokens (batch 1): blockwise {block_ms:.3f} ms "
            f"({n_blocked} calls of 2x2 blocks), direct {direct_ms:.3f} ms; "
            f"last-position logits max abs difference {max_abs:.3e}, "
            f"relative {rel:.3e}, same argmax {row['same_argmax']}")
        return row

    def lm_vlm(self, cfg):
        """10c: ``cfg`` (internvl2-1b, bfloat16) at full width:
        ``prefill_logits`` over LM_VLM's patch embeddings and text tokens
        (median of 3 after one untimed), then greedy decode steps from its
        token on a cache of patches + text + steps slots. The reference's
        decode has no way to write a prefill's keys into the cache (nor
        has the port's), so the steps time decode at that cache's size,
        not a continuation of the prefill."""
        torch = self.torch
        b, n_patch, n_text, n_steps = LM_VLM
        model, params, gen = self.lm_model(cfg)
        gb = self.param_gb(params)
        batch = {
            "patches": torch.randn(b, n_patch, cfg.d_model, generator=gen,
                                   device=self.dev).to(torch.bfloat16),
            "tokens": torch.randint(0, cfg.vocab_size, (b, n_text),
                                    generator=gen, device=self.dev)}
        with torch.no_grad():
            def prefill():
                return model.prefill_logits(params, batch)
            self.event_ms(prefill)
            timed = [self.event_ms(prefill) for _ in range(3)]
            prefill_ms = statistics.median(ms for ms, _ in timed)
            logits = timed[0][1]
            caches = model.cache_init(b, n_patch + n_text + n_steps)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            ms = []
            for pos in range(n_steps):
                step_ms, (logits, caches) = self.event_ms(
                    lambda: model.decode(params, caches, tok, pos))
                tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
                ms.append(step_ms)
        if (timed[0][1].shape != (b, 1, cfg.vocab_size)
                or not bool(torch.isfinite(timed[0][1]).all())
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError("phase 10c: prefill or decode logits not "
                                 "finite or of the wrong shape")
        step_ms = statistics.median(ms[1:])
        row = dict(arch=cfg.name, batch=b, patches=n_patch, text=n_text,
                   decode_steps=n_steps, param_gb=gb, prefill_ms=prefill_ms,
                   decode_ms_per_step=step_ms,
                   tokens_per_s=b * 1e3 / step_ms,
                   peak_memory_gb=self.lm_peak_gb())
        log(f"phase 10c {cfg.name} {cfg.dtype} (full config, {gb:.3f} GB "
            f"of parameters): prefill_logits over {n_patch} patches + "
            f"{n_text} tokens at batch {b} {prefill_ms:.4f} ms; {n_steps} "
            f"greedy decode steps on a {n_patch + n_text + n_steps}-slot "
            f"cache {step_ms:.4f} ms/step (median after the first), "
            f"{row['tokens_per_s']:.1f} tokens/s; peak memory "
            f"{row['peak_memory_gb']:.2f} GB")
        del params
        torch.cuda.empty_cache()
        return row

    def lm_reduced(self, archs=LM_ARCHS, tag="10d"):
        """10d, 11f: the reduced config of each arch, its parameters drawn
        on the card and carried to the CPU through the
        converter: ``forward``'s logits, LM_CHECK[1] teacher-forced decode
        steps (past gemma2's reduced window of 32, so its rolling caches
        wrap; whisper's from ``cache_init``'s zeroed cross caches, over 64
        frames in ``forward``) and the final caches agree within
        LM_CARD_TOL, and the greedy tokens of an LM_SERVE loop are
        equal."""
        torch, cv = self.torch, self.convert
        rows = {}
        for arch in archs:
            cfg = self.LC.reduced_config(arch)
            model, params, _ = self.lm_model(cfg)
            host = self.LM.build_model(cfg, device="cpu")
            host_params = cv.lm_params_from_numpy(
                cfg, cv.lm_params_to_numpy(params), "cpu")
            g = torch.Generator().manual_seed(1)
            b, s = LM_CHECK
            toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
            batch = {"tokens": toks}
            if cfg.family == "vlm":
                batch = {"patches": torch.randn(b, 8, cfg.d_model,
                                                generator=g),
                         "tokens": toks[:, 8:]}
            if cfg.family == "audio":
                batch["frames"] = torch.randn(b, 64, cfg.d_model, generator=g)
            runs = []
            for m, p, dev in ((model, params, self.dev),
                              (host, host_params, host.device)):
                with torch.no_grad():
                    on = {k: x.to(dev) for k, x in batch.items()}
                    fwd, _, _ = m.forward(p, on)
                    dec, caches = self.LM.decode_all(m, p, toks.to(dev))
                    gen, _ = self.lm_greedy(m, p)
                runs.append((fwd.cpu(), dec.cpu(),
                             cv.lm_cache_to_numpy(cfg, caches), gen.cpu()))
            (fc, dc, cc, gc), (fh, dh, ch, gh) = runs
            cc, ch = cv.lm_flatten(cc), cv.lm_flatten(ch)
            if sorted(cc) != sorted(ch):
                raise AssertionError(f"phase {tag} {arch}: cache leaves "
                                     f"{sorted(cc)} against {sorted(ch)}")
            err = max(
                self.close(f"phase {tag} {arch} forward", fc, fh,
                           rtol=LM_CARD_TOL, atol=LM_CARD_TOL),
                self.close(f"phase {tag} {arch} decode", dc, dh,
                           rtol=LM_CARD_TOL, atol=LM_CARD_TOL),
                *(self.close(f"phase {tag} {arch} cache {path}",
                             torch.from_numpy(x), torch.from_numpy(ch[path]),
                             rtol=LM_CARD_TOL, atol=LM_CARD_TOL)
                  for path, x in cc.items()))
            if not torch.equal(gc, gh):
                raise AssertionError(f"phase {tag} {arch}: greedy tokens on "
                                     f"the card differ from the CPU's")
            rows[arch] = dict(max_abs_err=err, greedy_equal=True)
            del params
        wrap = (" (gemma2's rolling caches wrap at 32)"
                if any(a.startswith("gemma2") for a in archs) else "")
        log(f"phase {tag} reduced configs of {', '.join(archs)}: "
            f"parameters drawn on the card, carried to the CPU; forward, "
            f"{LM_CHECK[1]} teacher-forced decode steps{wrap} and the final "
            f"caches agree within "
            f"{LM_CARD_TOL} (max abs "
            f"err {max(r['max_abs_err'] for r in rows.values()):.3e}), and "
            f"the greedy tokens of a {LM_SERVE[0]}-request loop are equal")
        return rows

    def lm_greedy(self, model, params, on_step=None, caches=None):
        """``models.model.greedy`` at LM_SERVE, on the prompts of
        ``examples/serve_decode.py`` (``randint(PRNGKey(1))``), from
        ``caches`` (default ``cache_init``'s): (tokens (B, gen), the last
        logits)."""
        b, prompt, n_gen = LM_SERVE
        prompts = self.prng.randint(self.prng.prng_key(1, model.device),
                                    (b, prompt), 0, model.cfg.vocab_size)
        return self.LM.greedy(model, params, prompts, n_gen, on_step,
                              caches=caches)

    # ------------------------------------- phase 11: the rest of the LM zoo
    def lm_families_path(self):
        """Phase 11: the MoE, Mamba2, Zamba2 and Whisper stacks
        (``repro_torch.models``, plain torch, no kernel of this repo):
        11a llama4-scout and 11b llama4-maverick cut in depth
        (:meth:`lm_moe`), 11c mamba2-780m and 11d zamba2-7b
        (:meth:`lm_ssm`), 11e whisper-medium (:meth:`lm_whisper`), 11f the
        reduced configs of LM_FAMILY_ARCHS against the CPU. Each model at
        full width from the port's own ``init`` on the card, freed before
        the next."""
        t0 = time.perf_counter()
        get = self.LC.get_config
        self.report["phase11"] = dict(
            scout=self.lm_moe(get("llama4-scout-17b-a16e"), "11a"),
            maverick=self.lm_moe(get("llama4-maverick-400b-a17b"), "11b",
                                 check=False),
            mamba2=self.lm_ssm(get("mamba2-780m"), "11c"),
            zamba2=self.lm_ssm(get("zamba2-7b"), "11d"),
            whisper=self.lm_whisper(get("whisper-medium"), "11e"),
            reduced=self.lm_reduced(LM_FAMILY_ARCHS, "11f"))
        self.report["phase11"]["seconds"] = time.perf_counter() - t0
        log(f"phase 11 took {time.perf_counter() - t0:.1f} s")

    def lm_check(self, tag, cfg, batch, caches=None):
        """``cfg`` in float32 (its draw, freed after): ``toks``
        teacher-forced through ``decode`` (from ``caches(params)`` if
        given) equal ``forward``'s logits over ``batch(gen)`` within
        LM_CHECK_TOL; finite logits. Returns the row."""
        torch = self.torch
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model, params, gen = self.lm_model(cfg32)
        batch = batch(gen)
        with torch.no_grad():
            full, aux, _ = model.forward(params, batch)
            dec, _ = self.LM.decode_all(model, params, batch["tokens"],
                                        caches(params, batch) if caches
                                        else None)
        err = self.close(f"phase {tag} {cfg.name} float32 decode against "
                         f"forward", dec, full, rtol=LM_CHECK_TOL,
                         atol=LM_CHECK_TOL)
        if not bool(torch.isfinite(full).all()):
            raise AssertionError(f"phase {tag}: non-finite logits")
        shape = "x".join(str(n) for n in batch["tokens"].shape)
        if "frames" in batch:
            shape += f" (over {batch['frames'].shape[1]} frames)"
        row = dict(layers=cfg.num_layers, f32_param_gb=self.param_gb(params),
                   tokens=list(batch["tokens"].shape),
                   f32_decode_vs_forward_max_abs=err,
                   aux=[float(a) for a in aux])
        log(f"phase {tag} {cfg.name} float32 at {cfg.num_layers} layers "
            f"({row['f32_param_gb']:.3f} GB of parameters): {shape} tokens "
            f"teacher-forced through decode equal forward's logits within "
            f"{LM_CHECK_TOL} (max abs err {err:.3e}); aux (load balance, "
            f"router z) {row['aux']}")
        del params, full, dec
        torch.cuda.empty_cache()
        return row

    def lm_served(self, tag, cfg, full_layers, setup=None):
        """``cfg`` (bfloat16) drawn and served (:meth:`lm_serve`, with the
        keyword arguments that ``setup(model, params, gen)`` returns),
        then freed."""
        model, params, gen = self.lm_model(cfg)
        kw = setup(model, params, gen) if setup else {}
        row = dict(arch=cfg.name, layers=cfg.num_layers,
                   published_layers=full_layers, d_model=cfg.d_model,
                   vocab=cfg.vocab_size)
        row.update(self.lm_serve(model, params, tag, **kw))
        del params, kw
        self.torch.cuda.empty_cache()
        return row

    def lm_moe(self, cfg, tag, check=True):
        """11a/11b: a llama4 config at full width cut to
        LM_MOE_LAYERS[name] of its layers (what one card holds in
        bfloat16), served; with ``check`` first LM_MOE_CHECK_LAYERS layers
        in float32 through :meth:`lm_check` on LM_MOE_CHECK tokens, where
        ``cap = min(T, 8) = T``, so no token can drop."""
        torch = self.torch
        row = {}
        if check:
            b, s = LM_MOE_CHECK
            small = dataclasses.replace(cfg, num_layers=LM_MOE_CHECK_LAYERS)
            row["check"] = self.lm_check(tag, small, lambda g: {
                "tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                        generator=g, device=self.dev)})
        cut = dataclasses.replace(cfg, num_layers=LM_MOE_LAYERS[cfg.name])
        row.update(self.lm_served(tag, cut, cfg.num_layers))
        log(f"phase {tag} {cfg.name}: {cut.num_layers} of "
            f"{cfg.num_layers} layers served (cut in depth to fit one card "
            f"in bfloat16; full width)")
        return row

    def lm_ssm(self, cfg, tag):
        """11c/11d: mamba2 or zamba2 at full width: :meth:`lm_check` on
        LM_SSM_CHECK tokens at LM_CHECK_LAYERS[name] layers, then served
        at full depth, with ``prefill_logits`` over LM_SSM_PREFILL (whole
        SSD chunks; the serving prompts of 24 are not)."""
        torch = self.torch
        b, s = LM_SSM_CHECK
        pb, ps = LM_SSM_PREFILL
        small = dataclasses.replace(cfg, num_layers=LM_CHECK_LAYERS[cfg.name])
        row = dict(check=self.lm_check(tag, small, lambda g: {
            "tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                    device=self.dev)}))
        row.update(self.lm_served(tag, cfg, cfg.num_layers, lambda m, p, g: {
            "prefill": {"tokens": torch.randint(
                0, cfg.vocab_size, (pb, ps), generator=g, device=self.dev)}}))
        return row

    def lm_whisper(self, cfg, tag):
        """11e: whisper-medium at full size. :meth:`lm_check` on
        LM_WHISPER_CHECK (decode over the cross caches primed from the
        forward's frames); then in bfloat16 the encoder over LM_SERVE[0] x
        LM_WHISPER_FRAMES frames (median of 3 after one untimed), the
        cross caches primed from its output, and the serving loop over
        them (``prefill_logits`` runs the encoder too)."""
        torch, LT = self.torch, self.LT
        b, frames, s = LM_WHISPER_CHECK
        row = dict(check=self.lm_check(
            tag, cfg, lambda g: {
                "frames": torch.randn(b, frames, cfg.d_model, generator=g,
                                      device=self.dev),
                "tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                        generator=g, device=self.dev)},
            lambda p, batch: p.primed_caches(batch["frames"], s)))
        n, (batch, prompt, n_gen) = LM_WHISPER_FRAMES, LM_SERVE
        enc_ms = []

        def setup(model, params, gen):
            frames = torch.randn(batch, n, cfg.d_model, generator=gen,
                                 device=self.dev).to(torch.bfloat16)
            with torch.no_grad():
                self.event_ms(lambda: params.encode(frames))
                timed = [self.event_ms(lambda: params.encode(frames))
                         for _ in range(3)]
                cross = params.prime_cross(timed[0][1])
            enc_ms.append(statistics.median(ms for ms, _ in timed))
            return dict(prefill={"frames": frames}, caches=lambda: {
                "self": LT.whisper_self_caches(cfg, batch, prompt + n_gen,
                                               self.dev),
                "cross": cross})
        row.update(self.lm_served(tag, cfg, cfg.num_layers, setup))
        row.update(frames=n, encoder_ms=enc_ms[0])
        log(f"phase {tag} {cfg.name} encoder over {batch}x{n} frames "
            f"{enc_ms[0]:.4f} ms (median of 3 after one); served over the "
            f"cross caches primed from it")
        return row

    # ------------------------------------------- phase 12: LM training
    def lm_train_path(self):
        """Phase 12: the LM zoo's training path (``launch/train.py``,
        ``optim/``, ``data/``, the chunked head and remat; plain torch,
        no kernel of this repo): 12a qwen3-0.6b at its published size
        (:meth:`lm_train_full`) and its float32 checks at
        LM_TRAIN_CHECK_LAYERS layers (:meth:`lm_train_checks`); 12b the
        reduced configs of all ten archs and the three other optimizer
        settings on reduced qwen3, card against CPU
        (:meth:`lm_train_reduced`)."""
        t0 = time.perf_counter()
        qwen3 = self.LC.get_config("qwen3-0.6b")
        self.report["phase12"] = dict(
            qwen3=self.lm_train_full(qwen3),
            checks=self.lm_train_checks(qwen3),
            reduced=self.lm_train_reduced())
        self.report["phase12"]["seconds"] = time.perf_counter() - t0
        log(f"phase 12 took {time.perf_counter() - t0:.1f} s")

    def lm_train_steps(self, step_fn, state, batches, tag):
        """``step_fn`` over ``batches`` (each on the card), CUDA events
        at every step's start and after the last (the device's timeline,
        so a host-bound step's gaps count), no host wait in between:
        (state, losses, ms per step, loop wall s)."""
        torch = self.torch
        events, losses = [], []

        def mark():
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        self.sync()
        w0 = time.perf_counter()
        for batch in batches:
            mark()
            state, m = step_fn(state, batch)
            losses.append(m["loss"])
        mark()
        self.sync()
        wall = time.perf_counter() - w0
        losses = [float(x) for x in losses]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"phase {tag}: a loss is not finite: "
                                 f"{losses}")
        return (state, losses,
                [e0.elapsed_time(e1) for e0, e1 in zip(events, events[1:])],
                wall)

    def lm_train_full(self, cfg):
        """12a: ``cfg`` (qwen3-0.6b: 28 layers, d 1024, vocab 151936,
        bfloat16, remat "block") from ``init_state`` with a generator on
        the card seeded 0: LM_TRAIN["steps"] AdamW steps on the Markov
        stream, then LM_TRAIN["mb_steps"] at ``microbatch=2``, then
        LM_TRAIN_PROFILE_STEPS profiled. The batches are drawn and put on
        the card first (set-up). Median step ms after the first,
        tokens/s, peak memory, and the model-FLOP share: 6 x parameters
        x tokens (every product's forward and two backward products; the
        tied table once, for the head) + 12 x layers x heads x head_dim x
        seq x tokens (the score and value products over the full S x S,
        as the port computes them), over the step time, over the card's
        dense bfloat16 peak; remat's recompute is not counted. The loss
        must be finite and the mean of the last 5 steps below that of the
        first 5. Last, one more step's memory against its prediction
        (:meth:`lm_train_peak`)."""
        torch, TR = self.torch, self.TR
        t, b, s = LM_TRAIN, LM_TRAIN["batch"], LM_TRAIN["seq"]
        if cfg.dtype != "bfloat16" or cfg.remat != "block":
            raise AssertionError(f"phase 12a: {cfg.name} is {cfg.dtype}, "
                                 f"remat {cfg.remat!r}")
        tcfg = self.TrainConfig(learning_rate=t["lr"],
                                warmup_steps=t["warmup"])
        pipe = self.LD.TokenPipeline(cfg.vocab_size, b, s, seed=t["seed"])
        n_batches = t["steps"] + t["mb_steps"] + LM_TRAIN_PROFILE_STEPS + 3
        batches = [{k: torch.from_numpy(v).to(self.dev)
                    for k, v in pipe.make_batch(i).items()}
                   for i in range(n_batches)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.lm_base = torch.cuda.memory_allocated(self.dev)
        model = self.LM.build_model(cfg, device=self.dev)
        state = TR.init_state(model, tcfg,
                              torch.Generator(device=self.dev).manual_seed(0))
        n_params = sum(p.numel() for p in state.params.parameters())
        step_fn = TR.make_train_step(model, tcfg)
        state, losses, ms, wall = self.lm_train_steps(
            step_fn, state, batches[:t["steps"]], "12a")
        step_ms = statistics.median(ms[1:])
        first5, last5 = (statistics.mean(losses[:5]),
                         statistics.mean(losses[-5:]))
        if not last5 < first5:
            raise AssertionError(f"phase 12a: the loss did not fall: "
                                 f"{losses}")
        peak = self.lm_peak_gb()
        mb_fn = TR.make_train_step(model, dataclasses.replace(
            tcfg, microbatch=2))
        state, mb_losses, mb_ms, _ = self.lm_train_steps(
            mb_fn, state, batches[t["steps"]:t["steps"] + t["mb_steps"]],
            "12a microbatch")
        mb_peak = self.lm_peak_gb()
        tokens = b * s
        flops = (6 * n_params * tokens + 12 * cfg.num_layers
                 * cfg.attn.num_heads * cfg.head_dim * s * tokens)
        share = flops / (step_ms / 1e3) / BF16_PEAK_FLOPS
        rest = iter(batches[t["steps"] + t["mb_steps"]:])
        box = [state]

        def run(k):
            for _ in range(k):
                box[0], _ = step_fn(box[0], next(rest))
        prof = self.profile(f"{cfg.name} train step B={b} S={s}", run,
                            step_ms, steps=LM_TRAIN_PROFILE_STEPS)
        memory = self.lm_train_peak(cfg, tcfg, step_fn, box, batches[-1])
        row = dict(arch=cfg.name, params=n_params, dtype=cfg.dtype,
                   remat=cfg.remat, batch=b, seq=s, steps=t["steps"],
                   step_ms=step_ms, first_step_ms=ms[0],
                   loop_wall_s=wall, tokens_per_s=tokens * 1e3 / step_ms,
                   model_flops_per_step=flops, model_flop_share=share,
                   peak_memory_gb=peak, losses=losses,
                   first5_mean=first5, last5_mean=last5,
                   microbatch2_ms=mb_ms, microbatch2_losses=mb_losses,
                   microbatch2_peak_memory_gb=mb_peak,
                   device_ops_per_step=prof["device_ops_per_step"],
                   device_ms_per_step=prof["device_ms_per_step"],
                   busy_share=prof["busy_share_unprofiled"],
                   top_ops_us_per_step=prof["top_ops_us_per_step"],
                   step_memory=memory)
        log(f"phase 12a {cfg.name} training at full size "
            f"({n_params / 1e6:.1f}M parameters, {cfg.num_layers} layers, d {cfg.d_model}, vocab "
            f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}), AdamW, "
            f"batch {b} x {s} tokens: {step_ms:.2f} ms/step (median of "
            f"{len(ms) - 1} after the first, {ms[0]:.1f} ms; loop "
            f"{wall:.2f} s wall), {row['tokens_per_s']:.0f} tokens/s, "
            f"model-FLOP share {share:.4f} of {BF16_PEAK_FLOPS / 1e12:.0f} "
            f"TFLOP/s ({flops:.3e} FLOPs a step), peak memory {peak:.2f} GB; "
            f"{prof['device_ops_per_step']:.0f} device ops and "
            f"{prof['device_ms_per_step']:.1f} device ms a step, busy "
            f"{row['busy_share']:.3f}")
        log(f"phase 12a losses: first {losses[0]:.4f}, last "
            f"{losses[-1]:.4f}; mean of the first 5 {first5:.4f} > mean of "
            f"the last 5 {last5:.4f}; every step: "
            + ", ".join(f"{x:.3f}" for x in losses))
        log(f"phase 12a {t['mb_steps']} steps at microbatch 2: "
            + ", ".join(f"{x:.2f}" for x in mb_ms) + " ms, losses "
            + ", ".join(f"{x:.4f}" for x in mb_losses)
            + f", peak memory {mb_peak:.2f} GB")
        del state, box, batches, step_fn, mb_fn
        torch.cuda.empty_cache()
        return row

    def lm_train_peak(self, cfg, tcfg, step_fn, box, batch):
        """12a's memory check: one step of ``step_fn`` on ``box[0]`` and
        ``batch``. Predicted first from the shapes alone: ``cfg``'s model,
        ``init_state`` and the batch as fake tensors on the card's device
        type (``FakeTensorMode``: nothing allocated), one step of a fresh
        ``make_train_step`` under ``launch/cost.count``: the arguments'
        bytes and the temporaries (the peak of live storages beyond them,
        in the allocator's 512-byte blocks). Then measured:
        ``max_memory_allocated`` after ``reset_peak_memory_stats`` around
        the real step, less what was allocated at its start, and the real
        state's and batch's bytes. Fails unless the predicted peak
        (arguments and temporaries) and the predicted temporaries are
        each within LM_PEAK_TOL of the measured."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        torch, TR = self.torch, self.TR
        t0 = time.perf_counter()
        fake = FakeTensorMode()
        with fake:
            model = self.LM.build_model(cfg, device=self.dev)
            state = TR.init_state(model, tcfg)
            fbatch = {k: fake.from_tensor(v) for k, v in batch.items()}
            _, c = self.cost.count(TR.make_train_step(model, tcfg), state,
                                   fbatch, fake_mode=fake)
        predict_s = time.perf_counter() - t0
        args_pred = self.cost.storage_bytes((state, fbatch))
        temp_pred = c["temp_bytes_by_device"].get(self.dev.type, 0)
        del model, state, fbatch
        args = self.cost.storage_bytes((box[0], batch))
        self.sync()
        torch.cuda.reset_peak_memory_stats(self.dev)
        before = torch.cuda.memory_allocated(self.dev)
        box[0], _ = step_fn(box[0], batch)
        self.sync()
        peak_raw = torch.cuda.max_memory_allocated(self.dev)
        temp = peak_raw - before
        err_peak = (args_pred + temp_pred) / (args + temp) - 1
        err_temp = temp_pred / temp - 1
        row = dict(predicted_argument_bytes=args_pred,
                   predicted_temp_bytes=temp_pred,
                   predicted_peak_bytes=args_pred + temp_pred,
                   argument_bytes=args, temp_bytes=temp,
                   peak_bytes=args + temp, allocated_before=before,
                   max_memory_allocated=peak_raw, peak_error=err_peak,
                   temp_error=err_temp, predict_s=predict_s,
                   predicted_flops=c["flops"], predicted_bytes=c["bytes"])
        log(f"phase 12a memory of one {cfg.name} step: predicted peak "
            f"{(args_pred + temp_pred) / 1e9:.3f} GB (arguments "
            f"{args_pred / 1e9:.3f} + temporaries {temp_pred / 1e9:.3f}; "
            f"launch/cost.py on fake {self.dev.type} tensors, "
            f"{predict_s:.1f} s), measured {(args + temp) / 1e9:.3f} GB "
            f"(arguments {args / 1e9:.3f} + temporaries {temp / 1e9:.3f}: "
            f"max_memory_allocated {peak_raw / 1e9:.3f} GB less "
            f"{before / 1e9:.3f} GB allocated before the step); error "
            f"{100 * err_peak:+.2f} % of the peak, {100 * err_temp:+.2f} % "
            f"of the temporaries (limit {100 * LM_PEAK_TOL:.0f} %); the "
            f"step traced {c['flops']:.4e} FLOPs and {c['bytes'] / 1e9:.1f}"
            f" GB of eager HBM traffic")
        if abs(err_peak) > LM_PEAK_TOL or abs(err_temp) > LM_PEAK_TOL:
            raise AssertionError(
                f"phase 12a: predicted step memory off by "
                f"{100 * err_peak:+.2f} % (peak), {100 * err_temp:+.2f} % "
                f"(temporaries): {row}")
        return row

    def lm_train_checks(self, cfg):
        """12a's float32 checks on ``cfg`` cut to LM_TRAIN_CHECK_LAYERS
        layers at full width: ``chunked_xent_head`` over the model's
        hidden states (two chunks of 512) against ``cross_entropy`` over
        the whole logits, loss within 1e-5, table and hidden gradients
        within rtol 2e-4, atol 2e-5 (the reference's tests/test_loss.py);
        ``remat="block"`` against ``"none"``, loss and every gradient
        leaf within LM_REMAT_TOL of its largest value (the embedding's
        backward adds with atomics on the card, so not to the bit)."""
        torch, MM = self.torch, self.LM
        from repro_torch.models import layers as L
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    num_layers=LM_TRAIN_CHECK_LAYERS)
        b, s = LM_TRAIN_CHECK
        model, params, gen = self.lm_model(cfg32)
        toks, labels = (torch.randint(0, cfg.vocab_size, (b, s),
                                      generator=gen, device=self.dev)
                        for _ in range(2))
        with torch.no_grad():
            _, _, hidden = model.forward(params, {"tokens": toks},
                                         with_logits=False)
        runs = []
        for chunked in (True, False):
            tbl = params.embed["table"].detach().clone().requires_grad_(True)
            hid = hidden.clone().requires_grad_(True)
            if chunked:
                loss = MM.chunked_xent_head(
                    tbl, hid, labels, softcap_val=cfg.final_logit_softcap)
            else:
                loss = MM.cross_entropy(L.softcap(
                    torch.einsum("bsd,vd->bsv", hid, tbl),
                    cfg.final_logit_softcap), labels)
            loss.backward()
            runs.append((loss.detach(), tbl.grad, hid.grad))
            del tbl, hid, loss
        (lc, tc, hc), (ld, td, hd) = runs
        head_err = (self.close("phase 12a chunked head loss", lc, ld,
                               rtol=1e-5, atol=0.0),
                    self.close("phase 12a chunked head table gradient", tc,
                               td, rtol=2e-4, atol=2e-5),
                    self.close("phase 12a chunked head hidden gradient", hc,
                               hd, rtol=2e-4, atol=2e-5))
        del runs, tc, td, hc, hd
        tree = self.convert.lm_params_to_numpy(params)
        del params
        grads = {}
        for remat in ("none", "block"):
            c = dataclasses.replace(cfg32, remat=remat)
            m = self.LM.build_model(c, device=self.dev)
            p = self.convert.lm_params_from_numpy(
                c, tree, self.dev).requires_grad_(True)
            loss, _ = m.train_loss(p, {"tokens": toks, "labels": labels})
            loss.backward()
            grads[remat] = (loss.detach(), self.TR.Leaves(p).grads())
            del p, loss
        (l0, g0), (l1, g1) = grads["none"], grads["block"]
        self.close("phase 12a remat loss", l1, l0, rtol=LM_REMAT_TOL,
                   atol=0.0)
        remat_err, bitwise = 0.0, []
        for k, want in g0.items():
            mag = float(want.abs().max())
            err = self.close(f"phase 12a remat gradient {k}", g1[k], want,
                             rtol=0.0, atol=LM_REMAT_TOL * mag)
            remat_err = max(remat_err, err / max(mag, 1e-30))
            bitwise.append(bool(torch.equal(g1[k], want)))
        row = dict(layers=LM_TRAIN_CHECK_LAYERS, tokens=[b, s],
                   chunked_loss_err=head_err[0], chunked_table_err=head_err[1],
                   chunked_hidden_err=head_err[2],
                   remat_max_rel_err=remat_err,
                   remat_bitwise_leaves=sum(bitwise), leaves=len(bitwise))
        log(f"phase 12a float32 at {LM_TRAIN_CHECK_LAYERS} layers, {b}x{s} "
            f"tokens: chunked head (two chunks of 512) equals the direct "
            f"cross-entropy (loss err {head_err[0]:.3e}, table gradient "
            f"{head_err[1]:.3e}, hidden {head_err[2]:.3e} max abs); remat "
            f"\"block\" gives the gradients of \"none\" within "
            f"{LM_REMAT_TOL} of each leaf's largest value (max "
            f"{remat_err:.3e}; {sum(bitwise)} of {len(bitwise)} leaves "
            f"bitwise)")
        del grads, g0, g1, hidden
        torch.cuda.empty_cache()
        return row

    @staticmethod
    def lm_train_batch(cfg, i):
        """The reference's tests/test_models.py::_batch shapes, numpy
        draws: 2 x 64 tokens and labels (whisper: 64 frames, 32 tokens;
        internvl2: 8 patches, 56 tokens)."""
        import numpy as np
        rng = np.random.default_rng(300 + i)
        b, s = 2, 64
        batch = {}
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32)
            s = 32
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (b, 8, cfg.d_model)).astype(np.float32)
            s -= 8
        for k in ("tokens", "labels"):
            batch[k] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32)
        return batch

    def lm_train_pair(self, cfg, params, tcfg):
        """(the card's model and state, the CPU's) from the card's
        ``params`` and a fresh optimizer state (EF slot under int8_ef),
        both at step 1 (step 0's learning rate is 0)."""
        TR = self.TR
        host = self.convert.lm_params_from_numpy(
            cfg, self.convert.lm_params_to_numpy(params), "cpu")
        out = []
        for p, dev in ((params, self.dev), (host, "cpu")):
            p.requires_grad_(True)
            leaves = TR.Leaves(p).params()
            opt = self.LO.make_optimizer(tcfg)[0](leaves)
            if tcfg.grad_compression == "int8_ef":
                opt["ef"] = self.comp.ef_init(leaves)
            out.append((self.LM.build_model(cfg, device=dev),
                         TR.TrainState(params=p, opt=opt, step=1)))
        return out

    def hold_train_step(self, tag, cfg, tcfg, sides, batch, share=0.0):
        """One train step on the card and on the CPU from the same state:
        loss, grad_norm and lr within LM_CARD_TOL; the new parameters
        within LM_CARD_TOL x (1 + the leaf's largest value), but for
        ``share`` of all their elements. Returns (the card's state after,
        max error of the elements within, elements beyond)."""
        torch, TR, cv = self.torch, self.TR, self.convert
        outs = []
        for model, state in sides:
            on = {k: torch.from_numpy(v).to(model.device)
                  for k, v in batch.items()}
            outs.append(TR.make_train_step(model, tcfg)(state, on))
        (sc, mc), (sh, mh) = outs
        err = max(self.close(f"phase {tag} {cfg.name} {k}", mc[k].cpu(),
                             mh[k], rtol=LM_CARD_TOL, atol=LM_CARD_TOL)
                  for k in ("loss", "grad_norm", "lr"))
        got = cv.lm_flatten(cv.lm_params_to_numpy(sc.params))
        want = cv.lm_flatten(cv.lm_params_to_numpy(sh.params))
        beyond = total = 0
        for k, w in want.items():
            g = torch.from_numpy(got[k]).float()
            w = torch.from_numpy(w).float()
            d = (g - w).abs()
            over = d > LM_CARD_TOL * (1.0 + float(w.abs().max()))
            beyond += int(over.sum())
            total += d.numel()
            err = max(err, float(d.masked_fill(over, 0.0).max()))
        if beyond > share * total:
            raise AssertionError(f"phase {tag} {cfg.name}: {beyond} of "
                                 f"{total} parameters beyond {LM_CARD_TOL}")
        return sc, err, beyond

    def lm_train_reduced(self, archs=None, optimizers=LM_TRAIN_OPTIMIZERS):
        """12b: for the reduced config of each arch (default all ten),
        parameters drawn on the card and carried to the CPU: the loss and
        every gradient leaf within LM_CARD_TOL (of the leaf's largest
        value), then one AdamW step (at lr LM_TRAIN_REDUCED_LR) through
        :meth:`hold_train_step`; then, on reduced qwen3, LM_TRAIN_OPT_STEPS
        steps of each of ``optimizers`` (``int8_ef`` with AdamW), each
        step from the card's state carried to the CPU
        (``convert.lm_opt_to_numpy`` / ``lm_opt_from_numpy``): the
        quantizing ones may put LM_QUANTIZED_SHARE of the parameters
        beyond the tolerance (a gradient a few ulps off moves a value
        across an int8 rounding boundary, and an 8-bit second moment
        rounded to 0 makes the update m / sqrt(v) of a tiny gradient)."""
        torch, TR, cv = self.torch, self.TR, self.convert
        archs = archs if archs is not None else self.LC.ARCH_IDS
        rows = {}
        tcfg = self.TrainConfig(learning_rate=LM_TRAIN_REDUCED_LR,
                                warmup_steps=0)
        for arch in archs:
            cfg = self.LC.reduced_config(arch)
            _, params, _ = self.lm_model(cfg)
            sides = self.lm_train_pair(cfg, params, tcfg)
            batch = self.lm_train_batch(cfg, self.LC.ARCH_IDS.index(arch))
            grads = []
            for m, st in sides:
                on = {k: torch.from_numpy(v).to(m.device)
                      for k, v in batch.items()}
                loss, _ = m.train_loss(st.params, on)
                loss.backward()
                grads.append((loss.detach().cpu(), {
                    k: g.cpu()
                    for k, g in TR.Leaves(st.params).grads().items()}))
                for p in st.params.parameters():
                    p.grad = None
            (lc, gc), (lh, gh) = grads
            err = self.close(f"phase 12b {arch} loss", lc, lh,
                             rtol=LM_CARD_TOL, atol=LM_CARD_TOL)
            for k, w in gh.items():
                err = max(err, self.close(
                    f"phase 12b {arch} gradient {k}", gc[k], w,
                    scale=w.abs().max(), rtol=LM_CARD_TOL, atol=LM_CARD_TOL))
            _, step_err, _ = self.hold_train_step("12b", cfg, tcfg, sides,
                                                  batch)
            rows[arch] = dict(max_abs_err=max(err, step_err))
            del params, sides, grads
        opts = {}
        cfg = self.LC.reduced_config("qwen3-0.6b")
        for name in optimizers:
            otcfg = dataclasses.replace(
                tcfg, **({"grad_compression": "int8_ef"} if name == "int8_ef"
                         else {"optimizer": name}))
            share = LM_QUANTIZED_SHARE if name != "adafactor" else 0.0
            _, params, _ = self.lm_model(cfg)
            (card, state), (host, _) = self.lm_train_pair(cfg, params, otcfg)
            pipe = self.LD.TokenPipeline(cfg.vocab_size, 4, 32, seed=5)
            err, beyond = 0.0, []
            for step in range(LM_TRAIN_OPT_STEPS):
                # the CPU starts from the card's state
                tree = TR.state_to_numpy(state)
                sides = [(card, state),
                         (host, TR.state_from_numpy(host, tree))]
                state, e, n = self.hold_train_step(
                    "12b", cfg, otcfg, sides, pipe.make_batch(step), share)
                err, beyond = max(err, e), beyond + [n]
            opts[name] = dict(max_abs_err=err, beyond=beyond)
            del params, state, sides
        worst = max(r["max_abs_err"] for r in (*rows.values(), *opts.values()))
        log(f"phase 12b reduced configs of {', '.join(archs)}: parameters "
            f"drawn on the card, carried to the CPU; the loss, every "
            f"gradient leaf and one AdamW step agree within {LM_CARD_TOL}; "
            + (f"{LM_TRAIN_OPT_STEPS} steps of {', '.join(optimizers)} on "
               f"reduced qwen3, each from the card's state, agree too ("
               + ", ".join(f"{k}: {v['beyond']} parameters beyond"
                           for k, v in opts.items()) + "); "
               if optimizers else "")
            + f"max abs err {worst:.3e}")
        self.torch.cuda.empty_cache()
        return dict(archs=rows, optimizers=opts)

    def lm_mesh_path(self):
        """Phase 13: the LM zoo on a ``DeviceMesh`` (plain torch, no
        kernel of this repo): 13b's dry-run cells start in their own
        processes on the host's cores (:meth:`dryrun_start`), 13a runs
        meanwhile (:meth:`lm_sharded`; it times nothing), then 13b
        collects the cells (:meth:`dryrun_finish`). No earlier phase
        shares the host with them."""
        t0 = time.perf_counter()
        self.dryrun_procs = self.dryrun_start()
        sharded = self.lm_sharded()
        procs, self.dryrun_procs = self.dryrun_procs, []
        cells = self.dryrun_finish(procs)
        self.report["phase13"] = dict(sharded=sharded, dryrun=cells,
                                      seconds=time.perf_counter() - t0)
        log(f"phase 13 took {time.perf_counter() - t0:.1f} s")

    def lm_sharded(self):
        """13a: a one-rank NCCL process group and its (1, 1) ``("data",
        "model")`` mesh over the card; for each of LM_MESH_ARCHS (reduced,
        float32) two states from ``init_state`` with a card generator
        seeded 0, one placed on the mesh (``shard_state``):
        LM_MESH_STEPS AdamW steps of ``make_sharded_train_step`` and of
        ``make_train_step`` on the same batches, and as many 8-bit AdamW
        steps of the first; every loss, every parameter and (8-bit) every
        moment's codes and scales after the last step equal to the bit."""
        import socket

        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        torch, TR = self.torch, self.TR
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        on_card = self.dev.type == "cuda"     # gloo on a CPU rehearsal
        dist.init_process_group(
            "nccl" if on_card else "gloo",
            init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
            **({"device_id": self.dev} if on_card else {}))
        rows = {}
        try:
            mesh = init_device_mesh(self.dev.type, (1, 1),
                                    mesh_dim_names=("data", "model"))
            cases = [(arch, "adamw") for arch in LM_MESH_ARCHS] + [
                (LM_MESH_ARCHS[0], "adamw8bit")]
            for arch, optimizer in cases:
                tcfg = self.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                                        optimizer=optimizer)
                label = arch if optimizer == "adamw" else f"{arch} {optimizer}"
                t0 = time.perf_counter()
                cfg = self.LC.reduced_config(arch)
                model = self.LM.build_model(cfg, device=self.dev)

                def state():
                    return TR.init_state(model, tcfg, torch.Generator(
                        device=self.dev).manual_seed(0))
                plain = state()
                sharded = TR.shard_state(state(), model, mesh)
                f_plain = TR.make_train_step(model, tcfg)
                f_sharded = TR.make_sharded_train_step(model, tcfg, mesh)
                pipe = self.LD.TokenPipeline(cfg.vocab_size, 4, 32, seed=2)
                losses = []
                for i in range(LM_MESH_STEPS):
                    batch = {k: torch.from_numpy(v).to(self.dev)
                             for k, v in pipe.make_batch(i).items()}
                    plain, m1 = f_plain(plain, batch)
                    sharded, m2 = f_sharded(sharded, batch)
                    losses.append((float(m1["loss"]), float(m2["loss"])))
                pairs = list(zip(plain.params.parameters(),
                                 sharded.params.parameters()))
                worst = max(float((p.detach().float()
                                   - q.to_local().detach().float()).abs().max())
                            for p, q in pairs)
                equal = (all(a == b for a, b in losses)
                         and all(torch.equal(p.detach(), q.to_local().detach())
                                 for p, q in pairs))
                if optimizer == "adamw8bit":
                    equal &= all(
                        torch.equal(z.q, sharded.opt[slot][k].q.to_local())
                        and torch.equal(
                            z.scale, sharded.opt[slot][k].scale.to_local())
                        for slot in ("m", "v")
                        for k, z in plain.opt[slot].items())
                log(f"phase 13a {label} (reduced, float32) on a (1, 1) "
                    f"{dist.get_backend()} mesh: {LM_MESH_STEPS} sharded steps against the "
                    f"unsharded card step, losses "
                    + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in losses)
                    + f", {len(pairs)} parameters; largest difference "
                    f"{worst:.3e}; {'equal to the bit' if equal else 'NOT EQUAL'}"
                    f" ({time.perf_counter() - t0:.1f} s)")
                if not equal:
                    raise AssertionError(
                        f"phase 13a {label}: the sharded step differs from "
                        f"the unsharded one (largest difference {worst:.3e}, "
                        f"losses {losses})")
                rows[label] = dict(losses=losses, parameters=len(pairs),
                                   max_abs_diff=worst,
                                   seconds=time.perf_counter() - t0)
                del plain, sharded, pairs
        finally:
            dist.destroy_process_group()
        if on_card:
            self.torch.cuda.empty_cache()
        return rows

    def stop_dryrun(self):
        """Stop any dry-run process not yet collected (a phase failed)."""
        for _, _, p in getattr(self, "dryrun_procs", None) or []:
            if p.poll() is None:
                p.kill()
            p.communicate()
        self.dryrun_procs = []

    def dryrun_start(self):
        """13b's processes, one a cell of DRYRUN_CELLS, on the host's
        cores (no card: ``CUDA_VISIBLE_DEVICES`` empty), writing under
        ``build/dryrun``; collected by :meth:`dryrun_finish`."""
        import os
        out = ROOT / "build" / "dryrun"
        out.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT / "src") + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        return [(cell, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *cell,
             "--out", str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)) for cell in DRYRUN_CELLS]

    def dryrun_finish(self, procs):
        """13b: each cell's JSON (its process exited 0 within
        DRYRUN_TIMEOUT, else the phase fails after every process is
        stopped), its wall time, and a line with its per-device argument
        bytes, temporaries, whether the step fits the card, FLOPs, HBM
        bytes and collective bytes; a DPSNN cell's traced halo, state and
        network bytes beside the port's reckoning (the phase fails where
        they differ)."""
        rows, failed = {}, []
        for cell, t0, p in procs:
            try:
                out, err = p.communicate(timeout=max(
                    1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
                failed.append(f"{' '.join(cell)}: timed out")
                continue
            wall = time.perf_counter() - t0
            if p.returncode:
                failed.append(f"{' '.join(cell)}: exit {p.returncode}: "
                              f"{err[-1500:]}")
                continue
            r = json.loads(out)
            tag = f"{r['arch']} {r['shape']} on {r['mesh']}"
            mem, c = r["memory"], r["cost"]
            coll = r["collectives"]
            log(f"phase 13b dry run {tag} ({r['chips']} ranks of a fake "
                f"group): {r['cell_s']:.1f} s in its process (started "
                f"{wall:.1f} s before its collection); per device {mem['argument_bytes']:,} "
                f"argument bytes ("
                + ", ".join(f"{k[:-6]} {v:,}" for k, v in mem.items()
                            if k.endswith("_bytes") and k not in (
                                "argument_bytes", "temp_bytes",
                                "output_bytes")) + "), "
                f"{mem['temp_bytes'] / 1e9:.3f} GB of temporaries, "
                f"{mem['output_bytes']:,} output bytes, step fits "
                f"{r['hw']['hbm_bytes'] / 1e9:.0f} GB: {r['step_fits_hbm']}; "
                f"{c['flops']:.4e} FLOPs ({c['matmul_flops']:.4e} in "
                f"products), {c['bytes'] / 1e9:.2f} GB of eager HBM traffic "
                f"({c['hbm_ms_at_rate']:.2f} ms at "
                f"{r['hw']['hbm_bytes_per_s'] / 1e12:.2f} TB/s), "
                f"{coll['total_bytes']:,} collective bytes "
                + json.dumps(coll.get("bytes", {})))
            if r["kind"] == "simulate":
                rec = r["reckoned"]
                traced = (coll["halo_bytes_per_step"], mem["state_bytes"],
                          mem["params_bytes"])
                reckoned = (rec["halo_bytes_per_step"], rec["state_bytes"],
                            rec["params_bytes"])
                log(f"phase 13b dry run {tag}: rank {r['rank']} of the "
                    f"{r['process_grid'][0]}x{r['process_grid'][1]} process "
                    f"grid, tile {r['tile'][0]}x{r['tile'][1]}, "
                    f"{r['traced_steps']} steps traced; halo "
                    f"{traced[0]:,.0f} bytes a step traced, "
                    f"{reckoned[0]:,} by halo_payload_bytes; state "
                    f"{traced[1]:,} / {reckoned[1]:,}, network "
                    f"{traced[2]:,} / {reckoned[2]:,} bytes traced / reckoned")
                if traced != reckoned:
                    failed.append(f"{tag}: traced (halo, state, network) "
                                  f"bytes {traced} differ from the "
                                  f"reckoning {reckoned}")
            rows[tag] = dict(r, wall_s=wall)
        if failed:
            raise AssertionError("phase 13b: " + "; ".join(failed))
        return rows


if __name__ == "__main__":
    sys.exit(main())
