"""The port's halo wire and exchange against the reference: spike
bit-packing (``runtime/transport.py``) bitwise against
``repro.core.exchange.pack_spikes`` (the reference's uint32 words read
as the port's int32 bits), the two-phase chained-ring exchange on an
in-process mesh, with and without the packed wire, against the window
of the zero-padded global frame, the ring widths and payload
accounting against the reference's, and the schedule and wire checks
with the reference's text."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dpsnn as jdpsnn
from repro.core import exchange as jex
from repro.core import partition as jpart
from repro.runtime import compression as jcomp
from repro_torch.configs import dpsnn
from repro_torch.configs.base import ExchangeConfig
from repro_torch.core import exchange as ex
from repro_torch.core import partition as part
from repro_torch.core.connectivity import build_stencil
from repro_torch.runtime import compression as comp
from repro_torch.runtime import transport as tr
from repro_torch.runtime.transport import (LocalMesh, ProcessGroupMesh,
                                           assert_axis_sizes)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 1240])
def test_pack_spikes_bitwise_against_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.random((3, 5, n)) < 0.3).astype(np.float32)
    x[0, 0] = 1.0                         # every bit, the sign bit included
    mine = tr.pack_spikes(torch.from_numpy(x))
    theirs = np.asarray(jex.pack_spikes(jnp.asarray(x)))
    assert mine.dtype == torch.int32
    assert mine.shape[-1] == tr.packed_width(n) == jex.packed_width(n)
    np.testing.assert_array_equal(mine.numpy().view(np.uint32), theirs)
    back = tr.unpack_spikes(mine, n)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        tr.unpack_spikes(torch.from_numpy(theirs.view(np.int32).copy()),
                         n).numpy(),
        np.asarray(jex.unpack_spikes(jnp.asarray(theirs), n)))


@pytest.mark.parametrize("radius", [0, 1, 2, 3, 5, 7])
@pytest.mark.parametrize("tile", [1, 2, 3, 4])
def test_ring_widths_match_reference(radius, tile):
    assert ex.halo_ring_widths(radius, tile) == jex.halo_ring_widths(radius,
                                                                     tile)


def _padded_window(g, spec, r):
    """Each shard's (th+2r, tw+2r) window of the zero-padded global frame:
    what the exchange must deliver."""
    gh, gw, n = g.shape
    pad = torch.zeros((gh + 2 * r, gw + 2 * r, n))
    pad[r:r + gh, r:r + gw] = g
    return torch.stack([
        pad[ty * spec.tile_h:ty * spec.tile_h + spec.tile_h + 2 * r,
            tx * spec.tile_w:tx * spec.tile_w + spec.tile_w + 2 * r]
        for ty, tx in (part.shard_tile_coords(spec, s)
                       for s in range(spec.tiles_y * spec.tiles_x))])


@pytest.mark.parametrize("mesh,grid", [((2, 2), (8, 8)), ((1, 4), (4, 8)),
                                       ((4, 1), (8, 4)), ((4, 4), (8, 8)),
                                       ((4, 4), (4, 4)), ((3, 2), (6, 2))])
@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("compress", [True, False])
def test_exchange_halo_is_the_padded_global_window(mesh, grid, radius,
                                                   compress):
    """Every shard's extended frame equals its window of the zero-padded
    global frame, tiles thinner than the radius included (chained
    rings: 1x1 and 1x2 tiles at radius 2 and 3); so does the extended
    STDP trace frame that rides beside it, raw even on the packed
    wire."""
    ry, rx = mesh
    gh, gw = grid
    n = 37
    spec = part.TileSpec(ry, rx, gh // ry, gw // rx, radius)
    rng = np.random.default_rng(radius)
    g = (torch.from_numpy(rng.random((gh, gw, n))) < 0.4).to(torch.float32)
    tr = torch.from_numpy(rng.uniform(0, 5, (gh, gw, n)).astype(np.float32))
    frames = part.global_to_tiles(g, spec)
    mesh = LocalMesh(ry, rx, "cpu", compress=compress)
    ext = ex.exchange_halo(frames, spec, mesh)
    assert ext.shape == (ry * rx, spec.tile_h + 2 * radius,
                         spec.tile_w + 2 * radius, n)
    assert torch.equal(ext, _padded_window(g, spec, radius))
    ext2, ext_tr = ex.exchange_halo(frames, spec, mesh,
                                    trace=part.global_to_tiles(tr, spec))
    assert torch.equal(ext2, ext)
    assert torch.equal(ext_tr, _padded_window(tr, spec, radius))


def test_local_mesh_shift_and_edges():
    m = LocalMesh(2, 3, "cpu")
    x = torch.arange(6.0).reshape(2, 3, 1) + 1
    assert torch.equal(m.shift(x, 1, +1)[:, :, 0],
                       torch.tensor([[2.0, 3.0, 0.0], [5.0, 6.0, 0.0]]))
    assert torch.equal(m.shift(x, 0, -1)[:, :, 0],
                       torch.tensor([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]]))
    assert torch.equal(LocalMesh(1, 1, "cpu").shift(x[:1, :1], 0, 1),
                       torch.zeros(1, 1, 1))
    with pytest.raises(ValueError):
        LocalMesh(0, 2, "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        ProcessGroupMesh("cpu")


def test_mesh_mismatch_raises_the_reference_text():
    spec = part.make_tile_spec(dpsnn.reduced(8, 8), 2, 2)
    with pytest.raises(ValueError) as err:
        assert_axis_sizes(spec, LocalMesh(2, 4, "cpu"))
    assert str(err.value) == (
        f"mesh axes 2x4 (row_axes='data', col_axis='model') do not match "
        f"the tile grid 2x2 of {spec} — the halo exchange would pair "
        f"wrong neighbours. Rebuild the spec from the mesh "
        f"(partition.make_tile_spec) or fix the mesh shape.")
    assert_axis_sizes(spec, LocalMesh(2, 2, "cpu"))


def test_schedule_checks_raise_the_reference_text():
    """Both raise from the runner, before it builds anything: every
    remote delay >= 2, and a pipelined exchange needs an axonal-delay
    ring."""
    cfg = dpsnn.reduced(4, 4, 16)
    short = dataclasses.replace(
        cfg, conn=dataclasses.replace(cfg.conn, delay_per_step=0.0))
    assert min(d for (_, _, _, d, _) in build_stencil(short).offsets) == 1
    with pytest.raises(ValueError) as err:
        ex.make_distributed_run(short, LocalMesh(2, 2, "cpu"), n_steps=1)
    assert str(err.value) == (
        "comm/compute overlap requires every remote delay >= 2 steps "
        "(distance-proportional delays guarantee this)")
    flat = build_stencil(cfg)._replace(offsets=(), max_delay=0)
    with pytest.raises(ValueError) as err:
        ex.check_delays(flat, pipelined=True)
    assert str(err.value) == (
        "pipelined halo exchange requires an axonal-delay ring "
        "(stencil.max_delay >= 1): with no delay there is no future step "
        "to defer the exchanged spike table into — disable "
        "ExchangeConfig.pipelined or restore min_delay_steps >= 1")
    ex.check_delays(flat, pipelined=False)


@pytest.mark.parametrize("gh,gw,ry,rx", [(8, 8, 2, 2), (24, 24, 12, 12),
                                         (24, 24, 24, 24), (6, 6, 3, 3),
                                         (24, 24, 1, 1), (24, 24, 2, 2),
                                         (24, 24, 4, 4), (24, 24, 8, 3),
                                         (12, 6, 6, 6), (6, 12, 1, 12)])
@pytest.mark.parametrize("compress", [True, False])
def test_payload_accounting_equals_reference(gh, gw, ry, rx, compress):
    """Static and plastic bytes (the STDP trace strips counted, from the
    config's flag and from ``stdp=``) under dense_packed, aer_sparse and
    auto equal the reference's."""
    for plastic in (False, True):
        mine = dpsnn.reduced_family("exp", gh, gw, 1240, radius=3)
        theirs = jdpsnn.reduced_family("exp", gh, gw, 1240, radius=3)
        mine = dataclasses.replace(mine, stdp=plastic)
        theirs = dataclasses.replace(theirs, stdp=plastic)
        spec = part.make_tile_spec(mine, ry, rx)
        jspec = jpart.make_tile_spec(theirs, ry, rx)
        assert comp.halo_send_shapes(spec) == jcomp.halo_send_shapes(jspec)
        assert comp.halo_payload_bytes(mine, spec, compress=compress) == \
            jcomp.halo_payload_bytes(theirs, jspec, compress=compress)
        for mode in ("aer_sparse", "auto"):
            assert comp.halo_payload_bytes(mine, spec, mode=mode,
                                           compress=compress) == \
                jcomp.halo_payload_bytes(theirs, jspec, mode=mode,
                                         compress=compress)
            assert comp.halo_payload_bytes(
                mine, spec, mode=mode, compress=compress,
                stdp=not plastic) == jcomp.halo_payload_bytes(
                    theirs, jspec, mode=mode, compress=compress,
                    stdp=not plastic)


def test_mesh_refusals_name_their_roadmap_items():
    """A guarded mesh runs (item 6), static and plastic; the batched mesh
    refuses the guard, naming item 7; an unknown wire format or policy
    raises the reference's text."""
    from repro_torch.configs.base import GuardConfig
    base = dpsnn.reduced(4, 4, 16)
    mesh = LocalMesh(2, 2, "cpu")
    for change in (dict(stdp=True), dict(guard=GuardConfig(enabled=True)),
                   dict(stdp=True, guard=GuardConfig(enabled=True))):
        run, _ = ex.make_distributed_run(dataclasses.replace(base, **change),
                                         mesh, n_steps=1, with_state=True)
        _, st = run()
        assert (st.guard is not None) == ("guard" in change)
    for change, item in [(dict(guard=GuardConfig(enabled=True)), "item 7"),
                         (dict(stdp=True, guard=GuardConfig(enabled=True)),
                          "item 7")]:
        with pytest.raises(NotImplementedError, match=item):
            ex.make_batched_distributed_run(
                dataclasses.replace(base, **change), mesh, n_steps=1,
                batch=2)
    for change, text in [
            (dict(conn=dataclasses.replace(base.conn,
                                           exchange_mode="morse_code")),
             "unknown exchange_mode 'morse_code' (expected 'dense_packed' "
             "or 'aer_sparse')"),
            (dict(exchange=ExchangeConfig(exchange_mode="sometimes")),
             "unknown ExchangeConfig.exchange_mode 'sometimes' (expected "
             "'inherit' or 'auto')")]:
        with pytest.raises(ValueError) as err:
            ex.make_distributed_run(dataclasses.replace(base, **change),
                                    mesh, n_steps=1)
        assert str(err.value) == text


def test_step_matches_the_reference_step_on_a_mesh():
    """One JAX ``dist_step`` from a shared random state on a 1-device
    mesh (a 1x1 tile grid, so the whole halo is the sheet's zero edge)
    against the port's step: the ring, pending frame, ISI statistics and
    counts bitwise."""
    jcfg = jdpsnn.reduced(4, 4, 32, seed=4)
    cfg = dpsnn.reduced(4, 4, 32, seed=4)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    run, _ = jex.make_distributed_run(jcfg, mesh, n_steps=12,
                                      with_state=True)
    jres, jst = run()
    mine, _ = ex.make_distributed_run(cfg, LocalMesh(1, 1, "cpu"),
                                      n_steps=12, impl="ref",
                                      with_state=True)
    res, st = mine()
    assert float(res.spikes) == float(jres.spikes)
    assert float(res.events) == float(jres.events)
    for leaf in ("hist_ext", "pending", "last_spike_t", "isi_sum",
                 "isi_sumsq", "isi_count", "spike_count", "event_count"):
        np.testing.assert_array_equal(getattr(st, leaf).numpy(),
                                      np.asarray(getattr(jst, leaf)), leaf)
