"""The port's CUDA kernels on the card: against their plain PyTorch
versions (``chip_smoke.py``'s ragged-shape checks), the wrappers' input
checks, a small run under the three impls, and the reduced LMs against
the CPU, serving and a train step (plain torch, no kernel). Marked
``cuda``: they skip with a reason where there is no card or no nvcc.
This file imports neither JAX nor the reference, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import pathlib
import sys

import pytest
import torch

from repro_torch.configs.base import DPSNNConfig, GuardConfig, STDPConfig
from repro_torch.core import simulation as sim
from repro_torch.kernels import _build, ops

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    if _build.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernels_match_plain(cuda_device):
    """All four kernels against their plain versions at N = 70, 130, 257
    with odd column counts, and all-silent spikes giving exact zeros: the
    checks of ``chip_smoke.Smoke.check_ragged``, which raises on a miss."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    chip_smoke.Smoke(torch, str(cuda_device)).check_ragged()


@pytest.mark.cuda
def test_wide_table_matches_plain(cuda_device):
    """ell_gather and the four fused_step instances on a table wider than
    the staged path's shared memory (T = 180,000), against their plain
    versions, each launch on the wide path: the checks of
    ``chip_smoke.Smoke.check_wide_table``, which raises on a miss."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    chip_smoke.Smoke(torch, str(cuda_device)).check_wide_table()


@pytest.mark.cuda
def test_staging_a_row_too_wide_is_an_error(cuda_device):
    """Asked to stage a 180,000-lane row (720 KB, more than a CTA's shared
    memory), the C entry point refuses: an error, never a fallback."""
    from repro_torch.kernels import plan
    c, n, k, t = 1, 256, 4, 180_000
    tbl = torch.zeros(c, t, device=cuda_device)
    idx = torch.zeros(c, n, k, dtype=torch.int32, device=cuda_device)
    w = torch.zeros(c, n, k, device=cuda_device)
    out = torch.empty(c, n, device=cuda_device)
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("ell_gather", "repro_ell_gather", cuda_device,
                      tbl.data_ptr(), idx.data_ptr(), w.data_ptr(),
                      out.data_ptr(), c, 1, c, n, t, k, 1, 1,
                      plan.smem_bytes("ell_gather", True, n, t), 1, 1, 0, 0,
                      None)
    assert _build.LAUNCHES["ell_gather"] == 0


@pytest.mark.cuda
def test_synapse_matmul_matches_the_fma_chain(cuda_device):
    """synapse_matmul to the bit against the fused multiply-add chain over
    each column's spiking sources in ascending order, with its silent-block
    count, on ragged shapes (4-byte copies) and on 1240-neuron columns
    (16-byte copies) with one column in which every source spikes; and
    shared memory short of the kernel's need refused by the C entry
    point."""
    from repro_torch.kernels import plan, ref
    g = torch.Generator(device=cuda_device).manual_seed(4)
    for c, n in [(3, 70), (7, 257), (3, 1240)]:
        s = (torch.rand(c, n, generator=g, device=cuda_device) < 0.1).float()
        s[-1] = 1.0
        w = torch.randn(c, n, n, generator=g, device=cuda_device)
        counter = torch.zeros(1, dtype=torch.int64, device=cuda_device)
        got = ops.synapse_matmul(s, w, silent_blocks=counter)
        assert torch.equal(got, ref.synapse_matmul_chain_ref(s, w))
        assert int(counter) == int(ref.silent_block_count(s))
    p = plan.plan("synapse_matmul", c, n, 0, plan.sm_count(cuda_device))
    out = torch.empty_like(s)
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("synapse_matmul", "repro_synapse_matmul", cuda_device,
                      s.data_ptr(), w.data_ptr(), out.data_ptr(), c, 1, n,
                      None, p.smem_bytes - 16)
    assert _build.LAUNCHES["synapse_matmul"] == 0


@pytest.mark.cuda
def test_keyed_drive_matches_plain(cuda_device):
    """keyed_drive to the bit against keyed_poisson_ref on the 24x24x1240
    grid at steps 0, 1, 20 and 2**31 - 1, on ragged shapes and on a tile
    of the grid, and the threefry and JAX known answers: the checks of
    ``chip_smoke.Smoke.check_keyed_drive``, which raises on a miss."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import dpsnn
    _build.reset_launches()
    chip_smoke.Smoke(torch, str(cuda_device)).check_keyed_drive(
        dpsnn.GRID_24, 20)
    assert _build.LAUNCHES["keyed_drive"] > 0
    ids = torch.arange(3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.keyed_drive(0, 0, ids.repeat(2)[::2], 40, 1.62, 0.5)
    with pytest.raises(TypeError, match="int32"):
        ops.keyed_drive(0, 0, ids.long(), 40, 1.62, 0.5)


@pytest.mark.cuda
def test_stdp_remote_update_matches_plain(cuda_device):
    """stdp_remote_update to the bit against stdp_remote_update_ref at
    lr 1 and 0.7, staged (K = 7 and 248, and weights one element off) and
    wide (T = 180,000, K = 248 and 7), each launch on the path its plan
    names: the checks of ``chip_smoke.Smoke.check_stdp_remote_shapes``,
    which raises on a miss. Asked to stage a row too wide for a block,
    the C entry point refuses."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import plan
    chip_smoke.Smoke(torch, str(cuda_device)).check_stdp_remote_shapes()
    c, n, k, t = 1, 256, 4, 180_000
    tbl = torch.zeros(c, t, device=cuda_device)
    idx = torch.zeros(c, n, k, dtype=torch.int32, device=cuda_device)
    w = torch.zeros(c, n, k, device=cuda_device)
    vec = torch.zeros(c, n, device=cuda_device)
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("stdp_remote_update", "repro_stdp_remote_update",
                      cuda_device, tbl.data_ptr(), idx.data_ptr(),
                      w.data_ptr(), vec.data_ptr(), vec.data_ptr(),
                      torch.empty_like(w).data_ptr(), c, 1, c, None, n, t, k,
                      0.01, 0.012, 1.0, 0.84, 1, 1,
                      plan.smem_bytes("stdp_remote_update", True, n, t))
    assert _build.LAUNCHES["stdp_remote_update"] == 0


@pytest.mark.cuda
def test_lif_step_ragged_and_unaligned_match_plain(cuda_device):
    """lif_step to the bit on n = 1, 3 and 4097 and on views one element
    off (the scalar path), beside aligned inputs (the vector path): the
    checks of ``chip_smoke.Smoke.check_lif_shapes``, which raises on a
    miss."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import dpsnn
    _build.reset_launches()
    chip_smoke.Smoke(torch, str(cuda_device)).check_lif_shapes(
        dpsnn.GRID_24.neuron)
    assert _build.LAUNCHES["lif_step"] == 7


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["cuda_fused", "cuda"])
def test_plastic_step_never_waits_for_the_card(cuda_device, impl):
    """Plastic guarded steps under sync debug mode "error": no operation
    of the step, the STDP update or the guard makes the host wait for the
    card (the remote rule's ``nonzero`` did, once per step), and the
    remote rule runs as its kernel."""
    cfg = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=48, seed=3,
                      stdp=True, guard=GuardConfig(enabled=True))
    params, state = sim.build(cfg, device=cuda_device)
    sim.run(cfg, params, state, 2, impl=impl)        # builds the kernels
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = sim.run(cfg, params, state, 3, impl=impl)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _build.LAUNCHES["stdp_remote_update"] == 3
    assert float(res.spikes) > 0


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda_device):
    s = torch.zeros(2, 40, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.synapse_matmul(s, torch.zeros(2, 40, 40, dtype=torch.bfloat16,
                                          device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        ops.synapse_matmul(s, torch.zeros(2, 40, 40, device=cuda_device)
                           .transpose(1, 2))


@pytest.mark.cuda
def test_small_run_impls_agree(cuda_device):
    cfg = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=64, seed=0)
    params, state = sim.build(cfg, device=cuda_device)
    runs = {impl: sim.run(cfg, params, state, 60, impl=impl)
            for impl in ("ref", "cuda", "cuda_fused")}
    for impl in ("cuda", "cuda_fused"):
        assert float(runs[impl].spikes) == float(runs["ref"].spikes)
        assert float(runs[impl].events) == float(runs["ref"].events)
        torch.testing.assert_close(runs[impl].state.lif.v,
                                   runs["ref"].state.lif.v,
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_small_plastic_guarded_run_impls_agree(cuda_device):
    """4x4x48, STDP and the guard on, 100 steps: equal spikes and events
    under the three impls, weights at 1e-6, no trip."""
    cfg = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=48, seed=3,
                      stdp=True, stdp_cfg=STDPConfig(a_plus=0.05,
                                                     a_minus=0.055),
                      guard=GuardConfig(enabled=True))
    params, state = sim.build(cfg, device=cuda_device)
    runs = {impl: sim.run(cfg, params, state, 100, impl=impl)
            for impl in ("ref", "cuda", "cuda_fused")}
    for impl in ("cuda", "cuda_fused"):
        assert float(runs[impl].spikes) == float(runs["ref"].spikes) > 0
        assert float(runs[impl].events) == float(runs["ref"].events)
        torch.testing.assert_close(runs[impl].params.w_local,
                                   runs["ref"].params.w_local,
                                   rtol=1e-6, atol=1e-6)
    for res in runs.values():
        assert not bool(res.state.guard.tripped)


@pytest.mark.cuda
def test_mesh_run_equals_single_shard_on_the_card(cuda_device):
    """A 4x4x64 grid over an in-process 2x2 mesh under cuda_fused: one
    fused_step and one keyed_drive launch per step for all four shards,
    and spikes, events, the rate trace and v equal to the single-shard
    card run to the bit."""
    from repro_torch.core import exchange
    from repro_torch.core.partition import columns_to_global
    from repro_torch.runtime.transport import LocalMesh
    cfg = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=64, seed=0)
    params, state = sim.build(cfg, device=cuda_device)
    single = sim.run(cfg, params, state, 60, impl="cuda_fused")
    run, spec = exchange.make_distributed_run(
        cfg, LocalMesh(2, 2, cuda_device), n_steps=60, impl="cuda_fused",
        with_state=True)
    _build.reset_launches()
    res, st = run()
    assert _build.LAUNCHES["fused_step"] == 60
    assert _build.LAUNCHES["keyed_drive"] == 60
    assert float(res.spikes) == float(single.spikes) > 0
    assert float(res.events) == float(single.events)
    assert torch.equal(res.rate_trace, single.rate_trace)
    assert torch.equal(columns_to_global(st.lif.v, spec), single.state.lif.v)


@pytest.mark.cuda
def test_fused_step_stacked_equals_per_shard_launches(cuda_device):
    """fused_step over four shards' columns stacked into one launch equals
    four launches of one shard's columns each, column by column to the
    bit: a column's arithmetic does not depend on the launch's plan."""
    from repro_torch.configs import dpsnn
    g = torch.Generator(device=cuda_device).manual_seed(7)
    shards, c, n, k, t = 4, 9, 1240, 248, 20 * 1240
    ncfg = dpsnn.GRID_24.neuron

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device)

    v, cc = rnd(shards * c, n) * 8 + 10, rnd(shards * c, n).abs()
    refrac = (torch.rand(shards * c, n, generator=g, device=cuda_device)
              < 0.05).int() * 2
    s_loc = (torch.rand(shards * c, n, generator=g, device=cuda_device)
             < 0.02).float()
    s_flat = (torch.rand(shards * c, t, generator=g, device=cuda_device)
              < 0.01).float()
    w, rw, ext = rnd(shards * c, n, n) * 0.4, rnd(shards * c, n, k) * 0.4, \
        rnd(shards * c, n).abs()
    idx = torch.randint(0, t, (shards * c, n, k), generator=g,
                        device=cuda_device, dtype=torch.int32)
    args = (v, cc, refrac, s_loc, w, s_flat, idx, rw, ext)
    whole = ops.fused_step(ncfg, *args)
    for s in range(shards):
        part = ops.fused_step(ncfg, *(a[s * c:(s + 1) * c] for a in args))
        for got, want in zip(part, whole):
            assert torch.equal(got, want[s * c:(s + 1) * c])


@pytest.mark.cuda
def test_aer_codec_on_the_card_equals_the_cpu(cuda_device):
    """The AER codec on the card against its CPU result on the same
    frames: stacked event lists (sentinel fill and truncation at overflow
    included), the overflow flags, the decoded frames, the gathered and
    scattered side payload, and a zero-filled list decoding to
    silence."""
    from repro_torch.core import exchange as ex
    g = torch.Generator().manual_seed(11)
    frames = (torch.rand(6, 3, 5, 40, generator=g) < 0.1).float()
    frames[0] = 0.0
    frames[1] = 1.0
    vals = torch.rand(frames.shape, generator=g)
    for cap in (1, 7, 60, 600):
        cpu = ex.aer_encode_stack(frames, cap)
        card = ex.aer_encode_stack(frames.to(cuda_device), cap)
        for a, b in zip(cpu, card):
            assert torch.equal(a, b.cpu())
        assert torch.equal(
            ex.aer_decode_stack(card[0], frames.shape[1:]).cpu(),
            ex.aer_decode_stack(cpu[0], frames.shape[1:]))
        got = ex.aer_gather_values(vals.to(cuda_device), card[0])
        assert torch.equal(got.cpu(), ex.aer_gather_values(vals, cpu[0]))
        assert torch.equal(
            ex.aer_scatter_values(card[0], got, frames.shape[1:]).cpu(),
            ex.aer_scatter_values(cpu[0], got.cpu(), frames.shape[1:]))
    silent = torch.zeros(4, 9, dtype=torch.int32, device=cuda_device)
    assert not bool(ex.aer_decode_stack(silent, (2, 3, 5)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["aer_sparse", "auto", "hier_aer"])
def test_wire_steps_never_wait_for_the_card(cuda_device, wire):
    """AER, per-ring auto and hierarchical AER steps on an in-process
    2x2 mesh under sync debug mode "error": no encode, decode, move or
    saturation flag makes the host wait for the card. The run saturates
    (bound 0.5 Hz), so the overflow path runs too."""
    import dataclasses

    from repro_torch.configs.base import ExchangeConfig
    from repro_torch.core import exchange
    from repro_torch.core.partition import NodeSpec
    from repro_torch.runtime.transport import LocalMesh
    base = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=48, seed=3)
    cfg = dataclasses.replace(
        base, conn=dataclasses.replace(
            base.conn, aer_rate_bound_hz=0.5,
            exchange_mode="dense_packed" if wire == "auto" else "aer_sparse"),
        exchange=ExchangeConfig(
            exchange_mode="auto" if wire == "auto" else "inherit"))
    node = NodeSpec(2, 1, 1, 2) if wire == "hier_aer" else None
    run, _ = exchange.make_distributed_run(
        cfg, LocalMesh(2, 2, cuda_device, node=node), n_steps=4,
        impl="cuda_fused", with_state=True)
    _, state = run()                     # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res, _ = run(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(res.aer_saturated.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["dense_packed", "aer_sparse", "hier"])
@pytest.mark.parametrize("impl", ["cuda", "cuda_fused"])
def test_plastic_mesh_step_never_waits_for_the_card(cuda_device, wire,
                                                    impl):
    """Plastic steps on an in-process 2x2 mesh under sync debug mode
    "error": neither the trace halo (dense, AER with its rebuild from
    ``trace_ext``, hierarchical) nor the STDP update over the stacked
    shards makes the host wait for the card; one launch of each plastic
    kernel per step for all four shards."""
    import dataclasses

    from repro_torch.core import exchange
    from repro_torch.core.partition import NodeSpec
    from repro_torch.runtime.transport import LocalMesh
    base = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=48, seed=3,
                       stdp=True)
    cfg = dataclasses.replace(base, conn=dataclasses.replace(
        base.conn, aer_rate_bound_hz=500.0,
        exchange_mode="aer_sparse" if wire == "aer_sparse"
        else "dense_packed"))
    node = NodeSpec(2, 1, 1, 2) if wire == "hier" else None
    run, _ = exchange.make_distributed_run(
        cfg, LocalMesh(2, 2, cuda_device, node=node, compress=True),
        n_steps=3, impl=impl, with_state=True)
    _, state = run()                     # builds the kernels
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res, final = run(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _build.LAUNCHES["stdp_dense_update"] == 3
    assert _build.LAUNCHES["stdp_remote_update"] == 3
    assert (final.plastic.trace_ext is not None) == (wire == "aer_sparse")
    assert float(res.spikes) > 0


@pytest.mark.cuda
def test_tenant_axis_kernels_match_plain(cuda_device):
    """Every tenant-axis kernel, one launch for tenants of five random
    columns: to the bit against one launch per tenant, and against its
    plain version with the tenant axis. ell_gather and fused_step at 2,
    3, 4, 8 and 12 tenants on the cluster path (shared and per-tenant
    weights; fused_step static, with the STDP, with the guard epilogue and
    with both), and at 3 on a wide table and with K = 7; the others at 3
    (one tenant inactive under both STDP kernels): the checks of
    ``chip_smoke.Smoke.check_tenant_kernels``, which raises on a miss."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    chip_smoke.Smoke(torch, str(cuda_device)).check_tenant_kernels()


@pytest.mark.cuda
def test_refused_cluster_launch_raises(cuda_device, monkeypatch):
    """A cluster launch that the C entry point or the card refuses (more
    than 8 CTAs a cluster, groups that do not hold the tenants, more
    shared memory than a CTA may have) raises, from the C entry's caller
    and from the wrapper, and launches nothing: no other instance stands
    behind the cluster path."""
    from repro_torch.kernels import fused_step as fs_mod
    from repro_torch.kernels import plan
    b, c, n, k, t = 4, 2, 256, 8, 512
    tbl = torch.zeros(b * c, t, device=cuda_device)
    idx = torch.zeros(c, n, k, dtype=torch.int32, device=cuda_device)
    w = torch.zeros(c, n, k, device=cuda_device)
    out = torch.empty(b * c, n, device=cuda_device)
    next_item = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    smem = plan.plan("ell_gather", b * c, n, t, plan.sm_count(cuda_device),
                     tenants=b).smem_bytes
    _build.reset_launches()
    for cluster, groups, nbytes in ((16, 1, smem), (3, 1, smem),
                                    (4, 1, 240_000)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.launch("ell_gather", "repro_ell_gather", cuda_device,
                          tbl.data_ptr(), idx.data_ptr(), w.data_ptr(),
                          out.data_ptr(), b * c, b, c, n, t, k, 2,
                          2 * cluster, nbytes, cluster, groups,
                          next_item.data_ptr())
    assert _build.LAUNCHES["ell_gather"] == 0
    cfg = DPSNNConfig(grid_h=2, grid_w=2, neurons_per_column=64, seed=0)
    params, state = sim.build(cfg, device=cuda_device)
    good = plan.plan
    monkeypatch.setattr(fs_mod, "plan", lambda *a, **kw: good(
        *a, **kw)._replace(cluster=9))
    rows = lambda x: torch.cat([x] * b)                       # noqa: E731
    lif = state.lif
    s = torch.zeros_like(lif.v)
    with pytest.raises(RuntimeError, match="fused_step: CUDA error"):
        ops.fused_step(cfg.neuron, rows(lif.v), rows(lif.c),
                       rows(lif.refrac), rows(s), params.w_local,
                       torch.zeros(b * 4, 4 * 9 * 64, device=cuda_device),
                       params.rem_flat, params.rem_w, rows(s))
    assert _build.LAUNCHES["fused_step"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["cuda_fused", "cuda"])
def test_batched_service_equals_dedicated_runs(cuda_device, impl):
    """Three tenants (one with nu_scale 1.5) on two slots of a 4x4x64
    server: one launch of each kernel per loop step for all the slots,
    the static weights one tensor, and every job's spikes, events and
    per-step spikes equal to its dedicated run on the card."""
    from repro_torch.core import network as net
    from repro_torch.launch.serve import BatchedSimServer, SimJob
    cfg = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=64, seed=0)
    params, _ = sim.build(cfg, device=cuda_device)
    srv = BatchedSimServer(cfg, slots=2, chunk=8, impl=impl, params=params,
                           device=cuda_device)
    jobs = [SimJob(job_id="a", seed=0, n_steps=20),
            SimJob(job_id="b", seed=5, n_steps=13, nu_scale=1.5),
            SimJob(job_id="c", seed=-3, n_steps=9)]
    for job in jobs:
        srv.submit(job)
    _build.reset_launches()
    results = {r.job_id: r for r in srv.drain()}
    loop = srv.stats["loop_steps"]
    kernels = (["fused_step"] if impl == "cuda_fused" else
               ["synapse_matmul", "ell_gather", "lif_step"])
    for name in kernels + ["keyed_drive"]:
        assert _build.LAUNCHES[name] == loop, name
    assert srv.params.w_local.data_ptr() == params.w_local.data_ptr()
    # the per-step rate of simulation.run's rate_trace
    f32 = torch.float32
    per_step = float(torch.tensor(sim._recip(cfg.n_neurons), dtype=f32)
                     * torch.tensor(sim._recip(cfg.neuron.dt_ms * 1e-3),
                                    dtype=f32))
    for job in jobs:
        state = net.init_state(cfg, range(cfg.n_columns), device=cuda_device,
                               seed=job.seed)
        one = sim.run(cfg, params, state, job.n_steps, impl=impl,
                      seed=job.seed, nu_scale=job.nu_scale)
        r = results[job.job_id]
        assert (r.spikes, r.events) == (float(one.spikes), float(one.events))
        counts = torch.from_numpy(r.raster).to(cuda_device).sum((1, 2))
        assert torch.equal(counts.to(f32) * per_step, one.rate_trace)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["cuda_fused", "cuda"])
def test_batched_step_never_waits_for_the_card(cuda_device, impl):
    """Plastic guarded steps of three tenants under sync debug mode
    "error": the batched step (per-tenant ring slots, drive, guard, STDP
    with the tenants' active mask, the freeze) makes the host wait for
    nothing."""
    from repro_torch.core import batched
    cfg = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=48, seed=3,
                      stdp=True, guard=GuardConfig(enabled=True))
    params, _ = sim.build(cfg, device=cuda_device)
    seeds = [3, 4, 5]
    bp = batched.batch_params(cfg, params, 3)
    st = batched.init_tenants(cfg, seeds, cuda_device)
    step = batched.make_batched_step(cfg, impl=impl)
    dev_seeds = torch.tensor(seeds, dtype=torch.int32, device=cuda_device)
    lam = batched.tenant_rates(cfg, [1.0, 0.8, 1.2], 3).to(cuda_device)
    active = torch.tensor([True, True, False], device=cuda_device)
    chaos = torch.full((3,), -1, dtype=torch.int32, device=cuda_device)
    bp, st, _ = step(bp, st, dev_seeds, lam, active, chaos)   # builds
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            bp, st, frame = step(bp, st, dev_seeds, lam, active, chaos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _build.LAUNCHES["stdp_remote_update"] == 3
    assert _build.LAUNCHES["keyed_drive"] == 3
    assert st.t.tolist() == [4, 4, 0]
    assert not bool(frame[2].any())


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["cuda_fused", "cuda"])
def test_batched_mesh_equals_dedicated_runs(cuda_device, impl):
    """Three tenants (seeds 0, 5, -3; one at nu_scale 1.5) over an
    in-process 2x2 mesh of a 4x4x64 grid: one launch of each kernel per
    step for every tenant and shard, and each tenant's spikes, events,
    per-step spikes and v equal to its dedicated single-shard card run to
    the bit."""
    from repro_torch.core import exchange
    from repro_torch.core import network as net
    from repro_torch.core.partition import columns_to_global
    from repro_torch.runtime.transport import LocalMesh
    cfg = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=64, seed=0)
    params, _ = sim.build(cfg, device=cuda_device)
    seeds, nu = [0, 5, -3], [1.0, 1.5, 1.0]
    run, spec = exchange.make_batched_distributed_run(
        cfg, LocalMesh(2, 2, cuda_device), n_steps=40, batch=3, impl=impl,
        with_stimulus=True, with_state=True)
    _build.reset_launches()
    res, st = run(seeds, nu)
    kernels = (["fused_step"] if impl == "cuda_fused" else
               ["synapse_matmul", "ell_gather", "lif_step"])
    for name in kernels + ["keyed_drive"]:
        assert _build.LAUNCHES[name] == 40, name
    for i, (seed, scale) in enumerate(zip(seeds, nu)):
        state = net.init_state(cfg, range(cfg.n_columns), device=cuda_device,
                               seed=seed)
        one = sim.run(cfg, params, state, 40, impl=impl, seed=seed,
                      nu_scale=scale)
        assert float(res.spikes[i]) == float(one.spikes) > 0
        assert float(res.events[i]) == float(one.events)
        assert torch.equal(res.rate_trace[i], one.rate_trace)
        assert torch.equal(columns_to_global(st.lif.v[:, i], spec),
                           one.state.lif.v)


@pytest.mark.cuda
@pytest.mark.parametrize("node", [False, True], ids=["flat", "nodes"])
def test_guarded_mesh_is_neutral_and_trips(cuda_device, node):
    """A guarded 2x2 mesh of a 4x4x64 grid on the card (flat, and in
    nodes of 1x2): one fused_step (its guard-flag instance over every
    shard's rows) per step, spikes and v equal to the unguarded mesh to
    the bit with no trip; a bit flipped on send 0 at step 7 trips every
    shard at step 7 with the checksum code."""
    import dataclasses

    from repro_torch.core import exchange
    from repro_torch.core.partition import make_node_spec
    from repro_torch.runtime import integrity
    from repro_torch.runtime.transport import LocalMesh
    cfg = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=64, seed=0)
    mesh = LocalMesh(2, 2, cuda_device, compress=True,
                     node=make_node_spec(2, 2, 2) if node else None)

    def run(guard):
        r, _ = exchange.make_distributed_run(
            dataclasses.replace(cfg, guard=guard), mesh, n_steps=30,
            impl="cuda_fused", with_state=True)
        _build.reset_launches()
        return r()

    off_res, off = run(GuardConfig())
    on_res, on = run(GuardConfig(enabled=True))
    assert _build.LAUNCHES["fused_step"] == 30
    assert float(on_res.spikes) == float(off_res.spikes) > 0
    assert torch.equal(on.lif.v, off.lif.v)
    assert not bool(on.guard.tripped.any())
    assert int(on.guard.checksum_fails.max()) == 0
    _, flip = run(GuardConfig(enabled=True, chaos_flip_ring=0,
                              chaos_flip_step=7, chaos_flip_word=1))
    assert bool((flip.guard.trip_step == 7).all())
    assert bool((flip.guard.trip_code == integrity.TRIP_CHECKSUM).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-9b",
                                  "llama4-maverick-400b-a17b", "mamba2-780m",
                                  "zamba2-7b", "whisper-medium"])
def test_lm_reduced_on_the_card_equals_the_cpu(cuda_device, arch):
    """The reduced config's parameters drawn on the card and carried to
    the CPU: forward logits, 48 teacher-forced decode steps (gemma2's
    rolling caches wrap) and the final caches within 1e-4, and equal
    greedy tokens: ``chip_smoke.Smoke.lm_reduced`` (phases 10d and
    11f), which raises on a miss."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rows = chip_smoke.Smoke(torch, str(cuda_device)).lm_reduced(
        archs=(arch,))
    assert rows[arch]["greedy_equal"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama4-scout-17b-a16e",
                                  "zamba2-7b", "whisper-medium"])
def test_lm_train_step_on_the_card_equals_the_cpu(cuda_device, arch):
    """A reduced config's parameters drawn on the card and carried to the
    CPU: the loss, every gradient leaf and one AdamW step within 1e-4;
    for qwen3 also 3 steps each of 8-bit AdamW, adafactor and int8-EF
    from the card's state: ``chip_smoke.Smoke.lm_train_reduced`` (phase
    12b), which raises on a miss."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    out = chip_smoke.Smoke(torch, str(cuda_device)).lm_train_reduced(
        archs=(arch,), optimizers=(chip_smoke.LM_TRAIN_OPTIMIZERS
                                   if arch == "qwen3-0.6b" else ()))
    assert list(out["archs"]) == [arch]
