"""The integrity guard on the port's multi-rank step (the reference's
``tests/test_integrity_dist.py``): ``frame_checksum`` equals the
reference's; with the guard on, every wire (flat dense, AER, STDP,
pipelined) on a 2x2 in-process mesh and in nodes of 1x2 runs bitwise as
with it off, with no trip and no checksum failure; a bit flipped on the
dense and AER wires, flat and hierarchical, and a NaN, trip at the exact
step with every guard leaf of every shard equal to the reference's
(``make_distributed_run`` on a forced 4-device subprocess), and so do
the spikes and events of the corrupted run; a message the guard cannot
frame raises; and a 2-rank gloo run with ``--guard`` and a flipped bit
trips at the flipped step."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

from repro.runtime import integrity as jint
from repro_torch.configs import dpsnn
from repro_torch.configs.base import ExchangeConfig, GuardConfig
from repro_torch.core import exchange as ex
from repro_torch.core.partition import make_node_spec
from repro_torch.launch import launch_distributed as ld
from repro_torch.runtime import integrity
from repro_torch.runtime.transport import LocalMesh


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


STEPS = 20


def build(guard=None, exchange_mode="dense_packed", stdp=False,
          pipelined=False):
    """The reference test's workload: 4x4x32, seed 3, a 100 Hz AER bound."""
    cfg = dataclasses.replace(dpsnn.reduced(4, 4, 32, seed=3), stdp=stdp)
    cfg = dataclasses.replace(cfg, conn=dataclasses.replace(
        cfg.conn, exchange_mode=exchange_mode, aer_rate_bound_hz=100.0))
    if pipelined:
        cfg = dataclasses.replace(cfg, exchange=ExchangeConfig(pipelined=True))
    if guard is not None:
        cfg = dataclasses.replace(cfg, guard=guard)
    return cfg


def mesh_of(kind):
    """The 2x2 shard grid, flat or in nodes of 1x2 (the reference's
    (2, 1, 1, 2) mesh), on the packed wire the reference's compress=True
    sends."""
    node = make_node_spec(2, 2, 2) if kind == "hier" else None
    return LocalMesh(2, 2, "cpu", compress=True, node=node)


def dist(cfg, mesh):
    run, _ = ex.make_distributed_run(cfg, mesh, n_steps=STEPS, impl="ref",
                                     with_state=True)
    return run()


def test_frame_checksum_equals_the_references():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 468, 4097):
        words = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
        words[: min(n, 3)] = [2 ** 31, 2 ** 32 - 1, 2 ** 31 + 5][:min(n, 3)]
        want = np.uint32(jint.frame_checksum(jnp.asarray(words)))
        got = integrity.frame_checksum(torch.from_numpy(words.view(np.int32)))
        assert np.int32(got).view(np.uint32) == want, n
    # one checksum per leading index, and a transposition is caught
    stack = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (3, 50),
                                          dtype=np.int64).astype(np.int32))
    per = integrity.frame_checksum(stack)
    assert all(per[i] == integrity.frame_checksum(stack[i]) for i in range(3))
    swapped = stack[0].clone()
    swapped[[4, 9]] = swapped[[9, 4]]
    assert swapped[4] != swapped[9]
    assert integrity.frame_checksum(swapped) != per[0]


def test_a_message_the_guard_cannot_frame_raises():
    guard = integrity.HaloGuard(GuardConfig(enabled=True), 0, 4, "cpu")
    move = guard.wrap(LocalMesh(2, 2, "cpu").move)
    with pytest.raises(ValueError, match="cannot be framed"):
        move(torch.zeros(2, 2, 3, dtype=torch.int16), 0, 1)


@pytest.mark.parametrize("kind", ["flat", "hier"])
@pytest.mark.parametrize("case", ["dense", "aer", "stdp", "pipelined"])
def test_guard_is_neutral_on_every_wire(case, kind):
    """Guard on equals guard off to the bit (totals, per-step spikes,
    v, the ring), with no trip and no checksum failure."""
    kw = {"dense": {}, "aer": dict(exchange_mode="aer_sparse"),
          "stdp": dict(stdp=True), "pipelined": dict(pipelined=True)}[case]
    res0, st0 = dist(build(**kw), mesh_of(kind))
    res1, st1 = dist(build(guard=GuardConfig(enabled=True), **kw),
                     mesh_of(kind))
    assert float(res1.spikes) == float(res0.spikes) > 0
    assert float(res1.events) == float(res0.events)
    assert torch.equal(res1.rate_trace, res0.rate_trace)
    assert torch.equal(st1.lif.v, st0.lif.v)
    assert torch.equal(st1.hist_ext, st0.hist_ext)
    assert st0.guard is None and st1.guard.trip_step.shape == (4,)
    assert not bool(st1.guard.tripped.any())
    assert int(st1.guard.checksum_fails.max()) == 0
    if case == "stdp":
        assert torch.equal(st1.plastic.w_local, st0.plastic.w_local)
        assert torch.equal(st1.plastic.rem_w, st0.plastic.rem_w)


def test_guarded_ranks_trip_at_the_flipped_step():
    """Two gloo ranks, unsupervised, ``--guard`` with a bit flipped on
    send 0 at step 5: the ranks' gathered guard reports the checksum
    trip at step 5 on every shard, as the in-process 1x2 mesh does."""
    args = ld.make_parser().parse_args(
        ["--ranks", "2", "--grid", "4x4", "--neurons", "32", "--steps",
         str(STEPS), "--seed", "3", "--impl", "ref", "--device", "cpu",
         "--timeout", "120", "--guard"])
    row = ld.launch(args, extra=["--chaos-flip-bit", "0:5:3"])
    cfg = dataclasses.replace(dpsnn.reduced(4, 4, 32, seed=3),
                              guard=GuardConfig(enabled=True,
                                                chaos_flip_ring=0,
                                                chaos_flip_step=5,
                                                chaos_flip_word=3))
    res, st = dist(cfg, LocalMesh(1, 2, "cpu", compress=True))
    assert row["guard_tripped"] is True
    assert row["guard_trip_what"] == "halo-checksum"
    assert row["guard_trip_step"] == 5 == int(st.guard.trip_step.max())
    assert row["guard_checksum_fails"] == int(st.guard.checksum_fails.max())
    assert row["spikes"] == float(res.spikes)


# (name, exchange mode, mesh kind, guard config): the reference test's
# flips (ring 0 flat, ring 1 hierarchical, step 5, word 3) and its NaN
CHAOS = (
    ("flip_dense_flat", "dense_packed", "flat",
     dict(chaos_flip_ring=0, chaos_flip_step=5, chaos_flip_word=3)),
    ("flip_dense_hier", "dense_packed", "hier",
     dict(chaos_flip_ring=1, chaos_flip_step=5, chaos_flip_word=3)),
    ("flip_aer_flat", "aer_sparse", "flat",
     dict(chaos_flip_ring=0, chaos_flip_step=5, chaos_flip_word=3)),
    ("flip_aer_hier", "aer_sparse", "hier",
     dict(chaos_flip_ring=1, chaos_flip_step=5, chaos_flip_word=3)),
    ("nan_flat", "dense_packed", "flat", dict(chaos_nan_at_step=7)),
)

JAX_CHAOS = """
import dataclasses, jax, numpy as np
from repro.configs import dpsnn
from repro.configs.base import GuardConfig
from repro.core import exchange
meshes = dict(flat=jax.make_mesh((2, 2), ('data', 'model')),
              hier=jax.make_mesh((2, 1, 1, 2),
                                 ('ndata', 'data', 'nmodel', 'model')))
for name, mode, kind, kw in {cases!r}:
    cfg = dpsnn.reduced(4, 4, 32, seed=3)
    cfg = dataclasses.replace(cfg, conn=dataclasses.replace(
        cfg.conn, exchange_mode=mode, aer_rate_bound_hz=100.0),
        guard=GuardConfig(enabled=True, **kw))
    run, _ = exchange.make_distributed_run(cfg, meshes[kind], n_steps={steps},
                                           impl='ref', compress=True,
                                           with_state=True,
                                           replicate_state=True)
    res, st = run()
    np.savez('{out}/' + name, spikes=np.asarray(res.spikes),
             events=np.asarray(res.events),
             **{{k: np.asarray(x) for k, x in st.guard._asdict().items()}})
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    """The reference's chaos cases, started in one forced 4-device
    subprocess when the module starts (its port-only tests run
    meanwhile)."""
    out = tmp_path_factory.mktemp("jax_chaos")
    job = JaxInBackground(JAX_CHAOS.format(cases=CHAOS, steps=STEPS,
                                           out=out), timeout=600)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def jax_chaos(jax_started):
    """The reference's guard leaves, spikes and events of every chaos
    case."""
    out, job = jax_started
    assert "OK" in job.result()
    return {name: dict(np.load(out / f"{name}.npz"))
            for name, *_ in CHAOS}


@pytest.mark.parametrize("case", CHAOS, ids=[c[0] for c in CHAOS])
def test_chaos_trips_at_the_exact_step_as_the_reference(jax_chaos, case):
    name, mode, kind, kw = case
    cfg = build(guard=GuardConfig(enabled=True, **kw), exchange_mode=mode)
    res, st = dist(cfg, mesh_of(kind))
    want = jax_chaos[name]
    step = kw.get("chaos_flip_step", kw.get("chaos_nan_at_step"))
    code = integrity.TRIP_NAN if "nan" in name else integrity.TRIP_CHECKSUM
    for leaf, x in st.guard._asdict().items():
        np.testing.assert_array_equal(x.numpy(), want[leaf], err_msg=leaf)
    assert bool(st.guard.tripped.all())
    assert (st.guard.trip_step == step).all()
    assert ((st.guard.trip_code & code) != 0).all()
    if "flip" in name:
        assert (st.guard.checksum_fails >= 1).all()
    assert float(res.spikes) == float(want["spikes"])
    assert float(res.events) == float(want["events"])
