"""Several shards per rank (``--shards-per-rank k``, the port's
counterpart of the reference's k local devices per process): 2 gloo
ranks of 2 shards each lay out a 1x4 shard grid, rank r holding shards
2r and 2r + 1 of its row, and every move rolls the local stack and sends
only the strip at its edge. Each run equals the port's single process
and ``LocalMesh(1, 4)`` to the bit (spikes, per-step flags, v, and the
live weights and traces when plastic), on the dense and AER wires, and
batched over one spatial grid or two batch shards; the totals equal the
reference's 1x4 mesh of a forced 4-device subprocess (one for the
module, started in the background). Node groups of ranks with several
shards are refused with the reference's text, and a supervised run
names the ROADMAP item that takes it up."""
import dataclasses
import json

import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

from repro_torch import convert
from repro_torch.configs import dpsnn
from repro_torch.core import exchange as ex
from repro_torch.launch import launch_distributed as ld
from repro_torch.runtime import sharding
from repro_torch.runtime.multiprocess import load_states, tenant_state_dir
from repro_torch.runtime.transport import LocalMesh, check_shards_per_rank


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


STEPS, SEED, AER_HZ = 20, 4, 500.0
TIMEOUT = "120"
# name -> (--stdp, --exchange-mode); a tile of one column is thinner than
# the radius-2 stencil, so every horizontal halo runs two chained rings,
# one of them across a rank's edge
CASES = {"dense": (False, "dense_packed"), "aer": (False, "aer_sparse"),
         "plastic": (True, "dense_packed"),
         "plastic_aer": (True, "aer_sparse")}

JAX_1X4 = """
import dataclasses, jax, jax.numpy as jnp, numpy as np
from repro.configs import dpsnn
from repro.core import exchange
mesh = jax.make_mesh((1, 4), ('data', 'model'))
for name, (stdp, mode) in {cases!r}.items():
    cfg = dpsnn.reduced(4, 4, 32, seed={seed}, stdp=stdp)
    cfg = dataclasses.replace(cfg, conn=dataclasses.replace(
        cfg.conn, exchange_mode=mode, aer_rate_bound_hz={hz}))
    run, _ = exchange.make_distributed_run(cfg, mesh, n_steps={steps},
                                           impl='ref')
    res = run()
    np.savez('{out}/' + name, spikes=np.asarray(res.spikes),
             events=np.asarray(res.events))
cfg = dpsnn.reduced(4, 4, 32, seed={seed})
run, _ = exchange.make_batched_distributed_run(cfg, mesh, n_steps={steps},
                                               batch=2)
res = run(cfg.seed + jnp.arange(2, dtype=jnp.int32))
np.savez('{out}/batched', spikes=np.asarray(res.spikes),
         events=np.asarray(res.events))
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    """The reference's 1x4 mesh (4 forced CPU devices), every case and
    the batched one, in one subprocess started when the module starts."""
    out = tmp_path_factory.mktemp("jax_1x4")
    job = JaxInBackground(JAX_1X4.format(cases=CASES, seed=SEED, hz=AER_HZ,
                                         steps=STEPS, out=out), timeout=600)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def jax_1x4(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return {name: dict(np.load(out / f"{name}.npz"))
            for name in (*CASES, "batched")}


def argv(*flags):
    return ["--ranks", "2", "--shards-per-rank", "2", "--grid", "4x4",
            "--neurons", "32", "--steps", str(STEPS), "--seed", str(SEED),
            "--impl", "ref", "--device", "cpu", "--timeout", TIMEOUT,
            "--aer-rate-bound", str(AER_HZ), "--json", "-", *flags]


def case_cfg(name):
    stdp, mode = CASES[name]
    cfg = dpsnn.reduced(4, 4, 32, seed=SEED, stdp=stdp)
    return dataclasses.replace(cfg, conn=dataclasses.replace(
        cfg.conn, exchange_mode=mode, aer_rate_bound_hz=AER_HZ))


@pytest.mark.parametrize("name", list(CASES))
def test_two_shards_per_rank_equal_single_process_local_mesh_and_jax(
        tmp_path, capsys, jax_1x4, name):
    """2 ranks x 2 shards: BITWISE-EQUAL against the single process (v,
    and the plastic leaves); every saved leaf of both ranks equals
    ``LocalMesh(1, 4)``'s final state; the totals equal the reference's
    1x4 mesh."""
    stdp, mode = CASES[name]
    states = tmp_path / "states"
    status = ld.main(argv("--exchange-mode", mode, "--state-dir",
                          str(states), *(["--stdp"] if stdp else [])))
    out = capsys.readouterr().out
    assert status == 0, out
    assert "BITWISE-EQUAL vs single-process" in out
    assert (", v, w_local, rem_w, x_pre, x_post)" if stdp else ", v)") in out
    row = json.loads(out.strip().splitlines()[-1])
    assert row["process_grid"] == [1, 4] and row["tile"] == "4x1"
    assert row["shards_per_rank"] == 2 and row["aer_saturated_steps"] == 0
    run, _ = ex.make_distributed_run(case_cfg(name), LocalMesh(1, 4, "cpu"),
                                     n_steps=STEPS, impl="ref",
                                     with_state=True)
    res, st = run()
    assert row["spikes"] == float(res.spikes) > 0
    assert row["events"] == float(res.events)
    assert row["aer_saturated_per_step"] == res.aer_saturated.tolist()
    got = load_states(str(states), 2)
    want = convert.dist_state_to_numpy(st)
    assert set(got) == set(want)
    for leaf in want:
        np.testing.assert_array_equal(got[leaf], want[leaf], leaf)
    assert row["spikes"] == float(jax_1x4[name]["spikes"])
    assert row["events"] == float(jax_1x4[name]["events"])


@pytest.mark.parametrize("batch_shards", [1, 2])
def test_batched_two_shards_per_rank_equal_dedicated_runs(
        tmp_path, capsys, jax_1x4, batch_shards):
    """2 tenants on 2 ranks x 2 shards: on one 1x4 grid, or one tenant a
    rank on a 1x2 grid of its own (``--batch-shards 2``). Every tenant
    equals its dedicated single-process run, v included, and the 1x4
    grid's tenants equal the reference's batched 1x4 mesh."""
    states = tmp_path / "states"
    status = ld.main(argv("--batch", "2", "--batch-shards",
                          str(batch_shards), "--state-dir", str(states)))
    out = capsys.readouterr().out
    assert status == 0, out
    assert "BITWISE-EQUAL vs 2 single-tenant single-process runs" in out
    row = json.loads(out.strip().splitlines()[-1])
    grid = [1, 4] if batch_shards == 1 else [1, 2]
    assert row["process_grid"] == [batch_shards, *grid]
    assert row["shards_per_rank"] == 2
    spatial = 2 // batch_shards
    for i in range(2):
        v = load_states(tenant_state_dir(str(states), i), spatial)["v"]
        assert v.shape[0] == grid[1]
    if batch_shards == 1:
        want = jax_1x4["batched"]
        assert row["per_tenant_spikes"] == want["spikes"].tolist()
        assert row["per_tenant_events"] == want["events"].tolist()


def test_node_groups_of_several_shards_are_refused_with_the_references_text():
    """The reference's hierarchical mesh of processes takes one device a
    process: its text, before any rank starts."""
    text = ("--ranks-per-node assumes one device per process (the CPU rank "
            "runtime); got 2 local devices per rank")
    with pytest.raises(SystemExit) as err:
        ld.main(["--ranks", "4", "--ranks-per-node", "2",
                 "--shards-per-rank", "2", "--device", "cpu"])
    assert str(err.value) == text
    with pytest.raises(ValueError) as err:
        check_shards_per_rank(2, ranks_per_node=2)
    assert str(err.value) == text
    check_shards_per_rank(1, ranks_per_node=2)
    with pytest.raises(ValueError, match="must be >= 1"):
        check_shards_per_rank(0)


def test_supervised_runs_name_their_roadmap_item():
    """A supervised run checkpoints one shard per rank: several are
    refused before any rank starts, naming the ROADMAP item."""
    with pytest.raises(SystemExit, match="item 7g"):
        ld.main(["--ranks", "2", "--shards-per-rank", "2", "--supervise",
                 "--checkpoint-every", "10", "--device", "cpu"])


def test_service_mesh_counts_ranks_of_several_shards():
    """One process is one rank: a service mesh of two batch shards of
    1x4 shards, 2 a rank, needs 4 ranks, and says so with every factor;
    one batch shard is a ``LocalMesh`` of every shard."""
    with pytest.raises(ValueError,
                       match=r"2\(batch\) x 1\(data\) x 4\(model\) needs 4 "
                             r"ranks of 2 shards, have 1"):
        sharding.service_mesh(2, 1, 4, "cpu", shards_per_rank=2)
    mesh = sharding.service_mesh(1, 1, 4, "cpu", shards_per_rank=2)
    assert isinstance(mesh, LocalMesh) and mesh.shape == (1, 4)
