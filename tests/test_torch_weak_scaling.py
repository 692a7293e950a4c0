"""The weak-scaling protocol of the port's ranks (the paper's Fig 3):
``--weak`` reads ``--grid`` as one rank's tile and scales the global grid
with the rank count (``configs.dpsnn.with_ranks``), as the reference's
worker and launcher do; each weak run equals its single-process run to
the bit and the reference's single shard of the scaled grid (one JAX
subprocess for the module, started in the background); ``--timed-reps
N`` reports the fastest of N timed runs; ``--no-check-single`` skips the
single-process run; and a resized restart of a weak run is refused with
the reference's text before any rank starts."""
import argparse
import json

import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

from repro_torch.core.partition import columns_to_global, make_rank_tile_spec
from repro_torch.launch import launch_distributed as ld
from repro_torch.runtime import multiprocess as mp
from repro_torch.runtime.multiprocess import load_states


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def one_thread_ranks():
    """One intra-op thread in every spawned rank too."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("OMP_NUM_THREADS", "1")
        yield


TILE, NEURONS, STEPS, SEED = "4x4", 32, 30, 0
# ranks -> the scaled grid (1x1, 1x2 and 2x2 process grids of 4x4 tiles)
WEAK = {1: "4x4", 2: "4x8", 4: "8x8"}
TIMEOUT = "120"

JAX_WEAK = """
import numpy as np
from repro.configs.base import DPSNNConfig
from repro.configs.dpsnn import with_ranks
from repro.core import simulation as sim
for n in {ranks!r}:
    cfg = with_ranks(DPSNNConfig(grid_h=4, grid_w=4,
                                 neurons_per_column={neurons},
                                 seed={seed}), n)
    params, state = sim.build(cfg)
    res = sim.run(cfg, params, state, {steps}, impl='ref')
    np.savez('{out}/r%d.npz' % n, spikes=np.asarray(res.spikes),
             events=np.asarray(res.events),
             v=np.asarray(res.state.lif.v).reshape(cfg.n_columns, -1),
             grid=np.asarray([cfg.grid_h, cfg.grid_w]))
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    """The reference's single shard of each scaled grid, in one
    subprocess started when the module starts."""
    out = tmp_path_factory.mktemp("jax_weak")
    job = JaxInBackground(JAX_WEAK.format(ranks=tuple(WEAK), neurons=NEURONS,
                                          seed=SEED, steps=STEPS, out=out),
                          timeout=600)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def jax_weak(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return {n: dict(np.load(out / f"r{n}.npz")) for n in WEAK}


def weak_argv(ranks, *flags):
    return ["--ranks", str(ranks), "--weak", "--grid", TILE, "--neurons",
            str(NEURONS), "--steps", str(STEPS), "--seed", str(SEED),
            "--impl", "ref", "--device", "cpu", "--timeout", TIMEOUT,
            "--json", "-", *flags]


@pytest.mark.parametrize("ranks", sorted(WEAK))
def test_weak_ranks_equal_single_process_and_jax(tmp_path, capsys, jax_weak,
                                                 ranks):
    """``--weak`` on 1, 2 and 4 ranks: the grid scales to 4x4, 4x8 and
    8x8 with a 4x4 tile on every rank; BITWISE-EQUAL against the port's
    single process (v included), and the totals equal the reference's
    single shard of the same scaled grid, v within the parity bar."""
    states = tmp_path / "states"
    status = ld.main(weak_argv(ranks, "--state-dir", str(states)))
    out = capsys.readouterr().out
    assert status == 0, out
    assert "BITWISE-EQUAL vs single-process" in out and ", v)" in out
    row = json.loads(out.strip().splitlines()[-1])
    assert row["grid"] == WEAK[ranks] and row["tile"] == TILE
    assert row["rank_count"] == ranks and row["single_process_match"]
    want = jax_weak[ranks]
    assert "x".join(map(str, want["grid"])) == WEAK[ranks]
    assert row["spikes"] == float(want["spikes"]) > 0
    assert row["events"] == float(want["events"])
    cfg = ld.workload_cfg(ld.make_parser().parse_args(weak_argv(ranks)))
    v = columns_to_global(load_states(str(states), ranks)["v"],
                          make_rank_tile_spec(cfg, ranks))
    np.testing.assert_allclose(v, want["v"], rtol=0, atol=2e-4)


@pytest.mark.parametrize("nranks", [1, 2, 3, 4, 6, 8])
def test_weak_config_equals_the_references(nranks):
    """The worker's ``build_cfg`` under ``--weak`` scales the tile as the
    reference's does, at every rank count's process grid."""
    from repro.runtime.multiprocess import build_cfg as jax_build_cfg

    ap = argparse.ArgumentParser()
    mp.add_workload_args(ap)
    args = ap.parse_args(["--weak", "--grid", "3x2", "--neurons", "16"])
    args.nranks = nranks
    ours, theirs = mp.build_cfg(args), jax_build_cfg(args)
    assert (ours.grid_h, ours.grid_w) == (theirs.grid_h, theirs.grid_w)
    assert ours.name == theirs.name
    args.weak = False
    assert (mp.build_cfg(args).grid_h, mp.build_cfg(args).grid_w) == (3, 2)


def test_timed_reps_report_the_fastest(capsys):
    """``--timed-reps 3``: each rank times three runs after the untimed
    one, and the row's wall time (and ms/step, events/s) is the
    fastest."""
    status = ld.main(weak_argv(2, "--timed-reps", "3", "--no-check-single"))
    out = capsys.readouterr().out
    assert status == 0, out
    assert "(fastest of 3)" in out and "BITWISE" not in out
    row = json.loads(out.strip().splitlines()[-1])
    assert row["timed_reps"] == 3 and len(row["wall_s_reps"]) == 3
    assert row["wall_s"] == min(row["wall_s_reps"])
    assert row["step_ms"] == row["wall_s"] / STEPS * 1e3
    assert row["events_per_s"] == row["events"] / row["wall_s"]
    assert "single_process_match" not in row


def test_no_check_single_skips_the_single_process(monkeypatch, capsys):
    """With ``--no-check-single`` the launcher never builds the single
    process's run and exits 0 on the ranks' row alone."""
    row = dict(rank_count=2, grid="4x8", tile="4x4", neurons=1024,
               steps=STEPS, step_ms=1.0, events_per_s=1.0, spikes=1.0,
               device="cpu", exchange_mode="dense_packed",
               halo_payload_bytes_per_step=0, aer_saturated_steps=0)
    monkeypatch.setattr(ld, "launch", lambda args: dict(row))

    def refuse(args):
        raise AssertionError("the single process ran")
    monkeypatch.setattr(ld, "single_process_reference", refuse)
    assert ld.main(weak_argv(2, "--no-check-single")) == 0
    assert "single_process_match" not in json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    with pytest.raises(AssertionError, match="the single process ran"):
        ld.main(weak_argv(2))


def test_resized_restart_of_a_weak_run_is_refused_as_the_reference():
    """``--restart-ranks`` with ``--weak`` changes the network on a
    resized restart: refused before any rank starts, supervised or not,
    with the text of the reference's supervisor."""
    from repro.launch import launch_distributed as jld

    flags = ["--ranks", "2", "--weak", "--supervise", "--checkpoint-every",
             "10", "--restart-ranks", "1"]
    with pytest.raises(SystemExit) as theirs:
        jld.supervise(jld.make_parser().parse_args(flags))
    for ours_flags in (flags, [f for f in flags if f != "--supervise"]):
        with pytest.raises(SystemExit) as ours:
            ld.main([*ours_flags, "--device", "cpu"])
        assert str(ours.value) == str(theirs.value)
    assert "--restart-ranks cannot be combined with --weak" in str(ours.value)
