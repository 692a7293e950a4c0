"""The port's fault-tolerant supervisor (``launch_distributed --supervise``,
``multiprocess.worker_run_supervised``) on real gloo ranks with
``--device cpu``: the reference's ``tests/test_supervisor.py`` cases (no
chaos, a SIGKILLed rank, a restart resized to one rank, the refusal
without a checkpoint cadence), the two guard drills of EXPERIMENTS.md
§Guard (a flipped halo bit and a NaN, each rolled back to the last clean
checkpoint), and a checkpoint the JAX reference wrote at step 20,
resumed by the port's supervisor to step 40. Every finished run is
held bitwise to the port's single-process run (spikes, events, and v
from the final checkpoint)."""
import json

import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

from repro_torch.checkpoint import checkpointer as CK
from repro_torch.configs import dpsnn
from repro_torch.core import exchange as ex
from repro_torch.launch import launch_distributed as ld


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
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


WORKLOAD = ["--grid", "4x4", "--neurons", "16", "--steps", "40"]


def run_supervised(capsys, ckpt_dir, args):
    status = ld.main(["--json", "-", "--timeout", "120", "--supervise",
                      "--checkpoint-every", "10", "--heartbeat-timeout",
                      "120", "--device", "cpu", "--impl", "ref",
                      "--ckpt-dir", str(ckpt_dir), *WORKLOAD, *args])
    out = capsys.readouterr().out
    assert status == 0, out
    assert "BITWISE-EQUAL vs single-process" in out and ", v)" in out, out
    row = json.loads(out.strip().splitlines()[-1])
    assert row["supervised"] is True
    assert row["single_process_match"] is True
    # a supervised row is recovery observability, not a timing row
    assert "step_ms" not in row
    return row, out


def test_supervised_no_chaos_matches_single_process(capsys, tmp_path):
    row, _ = run_supervised(capsys, tmp_path, ["--ranks", "2"])
    assert row["restarts"] == 0 and row["lost_steps"] == 0
    assert row["resumed_from_step"] == -1
    assert CK.latest_step(str(tmp_path)) == 40


def test_supervised_survives_sigkill_bitwise(capsys, tmp_path):
    """SIGKILL of rank 1 at step 25 (a checkpoint every 10): one restart
    from step 20, 5 lost steps."""
    row, out = run_supervised(capsys, tmp_path, [
        "--ranks", "2", "--chaos-kill-rank", "1", "--chaos-at-step", "25"])
    assert row["restarts"] == 1
    assert row["lost_steps"] == 5
    assert row["resumed_from_step"] == 20
    assert "SUPERVISOR restart 1/3: resuming from step 20 on 2 ranks" in out


def test_supervised_restart_resized_bitwise(capsys, tmp_path):
    """The 2-rank run dies at step 25 and finishes on one rank: the
    checkpoint is resharded."""
    row, _ = run_supervised(capsys, tmp_path, [
        "--ranks", "2", "--chaos-kill-rank", "0", "--chaos-at-step", "25",
        "--restart-ranks", "1"])
    assert row["restarts"] == 1
    assert row["lost_steps"] == 5
    assert row["rank_count"] == 1
    assert CK.load_manifest(str(tmp_path))["meta"]["n_ranks"] == 1


def test_supervise_requires_checkpoint_every():
    with pytest.raises(SystemExit, match="--checkpoint-every"):
        ld.main(["--ranks", "2", "--supervise", "--device", "cpu",
                 *WORKLOAD])


@pytest.mark.parametrize("chaos", [["--chaos-flip-bit", "0:25:3"],
                                   ["--chaos-nan-at-step", "25"]],
                         ids=["flip", "nan"])
def test_guard_drill_rolls_back_clean(capsys, tmp_path, chaos):
    """EXPERIMENTS.md §Guard: 60 steps, a checkpoint every 10, the
    corruption at step 25. The guard trips within the step, the ranks
    exit with the guard's code before step 30 is saved, and the restart
    (without the chaos) resumes from step 20: one restart, 6 lost steps,
    a clean final guard, the single process's run."""
    row, out = run_supervised(capsys, tmp_path, [
        "--ranks", "2", "--guard", "--steps", "60", *chaos])
    assert row["restarts"] == 1
    assert row["lost_steps"] == 6
    assert row["resumed_from_step"] == 20
    assert row["guard_trip_what"] == "clean"
    assert row["guard_checksum_fails"] == 0
    assert "exited 13" in out


JAX_CKPT = """
import jax, numpy as np
from repro.checkpoint import checkpointer as CK
from repro.configs import dpsnn
from repro.core import exchange
cfg = dpsnn.reduced(4, 4, 16, seed=0)
mesh = jax.make_mesh((1, 2), ('data', 'model'))
for n in (20, 40):
    run, _ = exchange.make_distributed_run(cfg, mesh, n_steps=n,
                                           with_state=True,
                                           replicate_state=True)
    res, st = run()
    st = jax.tree_util.tree_map(np.asarray, st)
    if n == 20:
        CK.save('{out}/ckpt', 20, st, meta={{
            'mesh': [1, 2], 'n_ranks': 2, 'grid': [4, 4], 'stdp': False,
            'total_steps': 40}})
    else:
        CK.save('{out}/straight', 40, st)
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    """The reference's 2-rank (1x2) stack of 4x4x16, seed 0: saved at
    step 20 as its supervisor saves it, and after 40 straight steps;
    started in a forced 2-device subprocess when the module starts."""
    out = tmp_path_factory.mktemp("jax_sup")
    job = JaxInBackground(JAX_CKPT.format(out=out), n_devices=2,
                          timeout=300)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def jax_run(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return out


def test_port_supervisor_resumes_a_jax_checkpoint(capsys, jax_run):
    """The gate of the durability slice: the JAX-written step-20
    checkpoint, resumed by the port's supervisor through --ckpt-dir,
    finishes at step 40 bitwise equal to the port's single-process run,
    and within the parity bar of the reference's uninterrupted run
    (integer leaves bitwise, v within 2e-4)."""
    row, _ = run_supervised(capsys, jax_run / "ckpt", ["--ranks", "2"])
    assert row["resumed_from_step"] == 20 and row["restarts"] == 0
    tpl, _, _ = ex.stacked_state_template(dpsnn.reduced(4, 4, 16, seed=0), 2)
    mine, step = CK.restore(str(jax_run / "ckpt"), tpl)
    theirs, _ = CK.restore(str(jax_run / "straight"), tpl)
    assert step == 40
    for path, a, b in zip(*CK._flatten_with_paths(mine),
                          CK._flatten_with_paths(theirs)[1]):
        if path == ".lif/.v" or path == ".lif/.c":
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-4, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
