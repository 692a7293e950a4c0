"""The integrity guard on the batched service's mesh
(``exchange.make_batched_distributed_run`` with ``cfg.guard.enabled``):
each tenant's strip of every halo message is framed with its own
checksum word, the reference's ``vmap`` of its guarded step. Held to the
reference's batched runner on a forced 4-device CPU mesh (one subprocess
for the module, started in the background): guard leaves of (n_shards,
b_local), bitwise neutral on a healthy run, and a bit flipped at step 5
(dense and AER wires) or a NaN at step 7 tripping every (shard, tenant)
at that step with the reference's codes and counts; the guard over gloo
ranks; and a saturating per-ring ``auto`` run (8x8x32 ``gauss_exp``,
seed 5, a 1 Hz bound, 40 steps), single-tenant and batched, bitwise
against the reference's."""
import dataclasses
import json

import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

from repro_torch import convert
from repro_torch.configs import dpsnn
from repro_torch.configs.base import ExchangeConfig, GuardConfig
from repro_torch.core import exchange as ex
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
    with pytest.MonkeyPatch.context() as m:
        m.setenv("OMP_NUM_THREADS", "1")
        yield


STEPS, SEED = 12, 42
FLIP = dict(chaos_flip_ring=0, chaos_flip_step=5, chaos_flip_word=3)
# name -> (batch, conn fields, guard fields): the guarded batched cases
GUARDED = {
    "neutral": (2, {}, {}),
    "flip": (3, {}, FLIP),
    "flip_aer": (2, dict(exchange_mode="aer_sparse", aer_rate_bound_hz=100.0),
                 FLIP),
    "nan": (2, {}, dict(chaos_nan_at_step=7)),
}
# the saturating auto case: tenants' stimulus scales (None: one tenant
# through make_distributed_run)
AUTO_STEPS, AUTO_SEED = 40, 5
AUTO = {"auto_single": None, "auto_batched": [1.2, 0.9]}
EXACT_LEAVES = ("hist_ext", "pending", "t", "spike_count", "event_count",
                "aer_sat", "last_spike_t", "isi_sum", "isi_sumsq",
                "isi_count", "refrac", "c")

JAX_RUN = """
import dataclasses, jax, jax.numpy as jnp, numpy as np
from repro.configs import dpsnn
from repro.configs.base import ExchangeConfig, GuardConfig
from repro.core import exchange
mesh = jax.make_mesh((2, 2), ('data', 'model'))
def leaves(st):
    out = dict(v=st.lif.v, c=st.lif.c, refrac=st.lif.refrac,
               hist_ext=st.hist_ext, pending=st.pending, t=st.t,
               spike_count=st.spike_count, event_count=st.event_count,
               aer_sat=st.aer_sat, last_spike_t=st.last_spike_t,
               isi_sum=st.isi_sum, isi_sumsq=st.isi_sumsq,
               isi_count=st.isi_count)
    if st.guard is not None:
        out.update({{'guard_' + k: x for k, x in st.guard._asdict().items()}})
    return {{k: np.asarray(x) for k, x in out.items()}}
for name, (batch, conn, guard) in {guarded!r}.items():
    base = dpsnn.reduced(4, 4, 32, seed={seed})
    for on in (False, True):
        cfg = dataclasses.replace(
            base, conn=dataclasses.replace(base.conn, **conn),
            guard=GuardConfig(enabled=on, **(guard if on else {{}})))
        run, _ = exchange.make_batched_distributed_run(
            cfg, mesh, n_steps={steps}, batch=batch, with_state=True)
        res, st = run(cfg.seed + jnp.arange(batch, dtype=jnp.int32))
        np.savez('{out}/%s_%d' % (name, on), spikes=np.asarray(res.spikes),
                 events=np.asarray(res.events), **leaves(st))
for name, nu in {auto!r}.items():
    cfg = dpsnn.reduced_family('gauss_exp', 8, 8, 32, radius=4,
                               seed={auto_seed})
    cfg = dataclasses.replace(
        cfg, conn=dataclasses.replace(cfg.conn, aer_rate_bound_hz=1.0),
        exchange=ExchangeConfig(exchange_mode='auto'))
    if nu is None:
        run, _ = exchange.make_distributed_run(
            cfg, mesh, n_steps={auto_steps}, with_state=True)
        res, st = run()
    else:
        run, _ = exchange.make_batched_distributed_run(
            cfg, mesh, n_steps={auto_steps}, batch=len(nu),
            with_stimulus=True, with_state=True)
        res, st = run(cfg.seed + jnp.arange(len(nu), dtype=jnp.int32),
                      jnp.asarray(nu, jnp.float32))
    np.savez('{out}/' + name, spikes=np.asarray(res.spikes),
             events=np.asarray(res.events),
             sat=np.asarray(res.aer_saturated), **leaves(st))
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    """Every case through the reference on a forced 4-device CPU mesh, in
    one subprocess started when the module starts."""
    out = tmp_path_factory.mktemp("jax_batched_guard")
    job = JaxInBackground(JAX_RUN.format(
        guarded=GUARDED, seed=SEED, steps=STEPS, auto=AUTO,
        auto_seed=AUTO_SEED, auto_steps=AUTO_STEPS, out=out), timeout=600)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def jax_runs(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    runs = {f"{name}_{on}": dict(np.load(out / f"{name}_{on}.npz"))
            for name in GUARDED for on in (0, 1)}
    runs.update({name: dict(np.load(out / f"{name}.npz")) for name in AUTO})
    return runs


def guarded_run(name, on=True, impl="ref", compress=True):
    """The case on the port's 2x2 in-process mesh (the packed wire of the
    reference's ``compress=True`` with ``compress``)."""
    batch, conn, guard = GUARDED[name]
    base = dpsnn.reduced(4, 4, 32, seed=SEED)
    cfg = dataclasses.replace(
        base, conn=dataclasses.replace(base.conn, **conn),
        guard=GuardConfig(enabled=on, **(guard if on else {})))
    run, _ = ex.make_batched_distributed_run(
        cfg, LocalMesh(2, 2, "cpu", compress=compress), n_steps=STEPS,
        batch=batch, impl=impl, with_state=True)
    return run([SEED + i for i in range(batch)])


def assert_guard_equals(st, want):
    """Every guard leaf of every (shard, tenant) to the bit."""
    for leaf, x in st.guard._asdict().items():
        assert x.shape == want["guard_" + leaf].shape, leaf
        np.testing.assert_array_equal(x.numpy(), want["guard_" + leaf], leaf)


@pytest.mark.parametrize("impl", ["ref", "cuda", "cuda_fused"])
def test_guard_is_neutral_with_leaves_per_shard_and_tenant(jax_runs, impl):
    """Guard on equals guard off to the bit (totals, per-step rates, v,
    the ring), and both equal the reference's totals; the guard leaves
    are (n_shards, b_local) = (4, 2), all clean, equal to the
    reference's."""
    res0, st0 = guarded_run("neutral", on=False, impl=impl)
    res1, st1 = guarded_run("neutral", impl=impl)
    assert torch.equal(res1.spikes, res0.spikes)
    assert torch.equal(res1.events, res0.events)
    assert torch.equal(res1.rate_trace, res0.rate_trace)
    assert torch.equal(st1.lif.v, st0.lif.v)
    assert torch.equal(st1.hist_ext, st0.hist_ext)
    assert st0.guard is None and st1.guard.tripped.shape == (4, 2)
    want = jax_runs["neutral_1"]
    np.testing.assert_array_equal(res1.spikes.numpy(), want["spikes"])
    np.testing.assert_array_equal(res1.events.numpy(), want["events"])
    np.testing.assert_array_equal(want["spikes"], jax_runs["neutral_0"]
                                  ["spikes"])
    assert_guard_equals(st1, want)
    assert not bool(st1.guard.tripped.any())


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("name", ["flip", "flip_aer", "nan"])
def test_chaos_trips_every_shard_and_tenant_as_the_reference(jax_runs, name,
                                                             compress):
    """A bit flipped on send 0 at step 5 lands in every tenant's received
    frame, and each tenant's strip carries its own checksum: every
    (shard, tenant) trips at step 5 with code 16 and one failed frame; a
    NaN at step 7 trips each with code 1. Every guard leaf equals the
    reference's; on the packed wire (the reference's) so do the corrupted
    run's totals. Float32 strips flip another word's bit, so their
    totals may differ, not their verdict."""
    res, st = guarded_run(name, compress=compress)
    want = jax_runs[f"{name}_1"]
    assert_guard_equals(st, want)
    g = st.guard
    b = GUARDED[name][0]
    assert g.tripped.shape == (4, b) and bool(g.tripped.all())
    if name == "nan":
        assert (g.trip_code == integrity.TRIP_NAN).all()
        assert (g.trip_step == 7).all()
    else:
        assert (g.trip_code == integrity.TRIP_CHECKSUM).all()
        assert (g.trip_step == 5).all() and (g.checksum_fails == 1).all()
    if compress or name == "nan":
        np.testing.assert_array_equal(res.spikes.numpy(), want["spikes"])
        np.testing.assert_array_equal(res.events.numpy(), want["events"])


def test_guarded_batched_ranks_report_the_trip(capsys):
    """2 gloo ranks x 2 tenants with ``--guard``: BITWISE-EQUAL against
    the dedicated runs and clean, reporting ``"guard": true``; with a bit
    flipped on send 0 at step 5 every (shard, tenant) trips there."""
    argv = ["--ranks", "2", "--batch", "2", "--grid", "4x4", "--neurons",
            "32", "--steps", str(STEPS), "--seed", str(SEED), "--impl",
            "ref", "--device", "cpu", "--timeout", "120", "--guard",
            "--json", "-"]
    assert ld.main(argv) == 0
    out = capsys.readouterr().out
    assert "BITWISE-EQUAL vs 2 single-tenant single-process runs" in out
    row = json.loads(out.strip().splitlines()[-1])
    assert row["guard"] is True and row["guard_tripped"] is False
    assert row["guard_trip_code"] == 0 and row["guard_trip_step"] == -1
    row = ld.launch(ld.make_parser().parse_args(argv),
                    extra=["--chaos-flip-bit", "0:5:3"])
    assert row["guard_tripped"] is True
    assert row["guard_trip_what"] == "halo-checksum"
    assert row["guard_trip_code"] == integrity.TRIP_CHECKSUM
    assert row["guard_trip_step"] == 5 and row["guard_checksum_fails"] == 1


def auto_cfg():
    cfg = dpsnn.reduced_family("gauss_exp", 8, 8, 32, radius=4,
                               seed=AUTO_SEED)
    return dataclasses.replace(
        cfg, conn=dataclasses.replace(cfg.conn, aer_rate_bound_hz=1.0),
        exchange=ExchangeConfig(exchange_mode="auto"))


@pytest.mark.parametrize("name", list(AUTO))
def test_saturating_auto_mesh_equals_jax(jax_runs, name):
    """The per-ring ``auto`` wire at a 1 Hz bound overflows its event
    lists on most steps: the per-step saturation flags, the totals and
    every integer or event leaf (the truncated rings included) equal the
    reference's to the bit, v within the parity bar; one tenant through
    ``make_distributed_run``, and two with stimulus scales 1.2 and 0.9
    through the batched runner."""
    cfg, nu = auto_cfg(), AUTO[name]
    mesh = LocalMesh(2, 2, "cpu")
    if nu is None:
        run, _ = ex.make_distributed_run(cfg, mesh, n_steps=AUTO_STEPS,
                                         with_state=True)
        res, st = run()
    else:
        run, _ = ex.make_batched_distributed_run(
            cfg, mesh, n_steps=AUTO_STEPS, batch=len(nu), with_stimulus=True,
            with_state=True)
        res, st = run([AUTO_SEED + i for i in range(len(nu))], nu)
    want = jax_runs[name]
    assert int(res.aer_saturated.sum()) > AUTO_STEPS // 2
    np.testing.assert_array_equal(res.aer_saturated.numpy(), want["sat"])
    np.testing.assert_array_equal(res.spikes.numpy(), want["spikes"])
    np.testing.assert_array_equal(res.events.numpy(), want["events"])
    got = convert.dist_state_to_numpy(st)
    for leaf in EXACT_LEAVES:
        np.testing.assert_array_equal(got[leaf], want[leaf], leaf)
    np.testing.assert_allclose(got["v"], want["v"], rtol=0, atol=2e-4)
