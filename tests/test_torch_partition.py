"""The port's partition module against ``repro.core.partition`` on the
same inputs: tile specs and their ring counts, the process grid, the
error text of an indivisible grid, shard coordinates, global column ids,
and the maps between stacked tiles and the global frame (numpy and
torch), with their round trips."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dpsnn as jdpsnn
from repro.core import partition as jpart
from repro_torch.configs import dpsnn
from repro_torch.core import partition as part


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


GRIDS = [(8, 8, 1, 1), (8, 8, 2, 2), (8, 8, 1, 4), (8, 8, 4, 1),
         (8, 8, 8, 8), (6, 6, 3, 3), (24, 24, 12, 12), (24, 24, 24, 24),
         (6, 10, 2, 5)]


def _cfgs(gh, gw, family=None):
    if family:
        return (dpsnn.reduced_family(family, gh, gw, radius=3),
                jdpsnn.reduced_family(family, gh, gw, radius=3))
    return dpsnn.reduced(gh, gw), jdpsnn.reduced(gh, gw)


@pytest.mark.parametrize("gh,gw,ry,rx", GRIDS)
@pytest.mark.parametrize("family", [None, "exp"])
def test_tile_spec_matches_reference(gh, gw, ry, rx, family):
    mine, theirs = _cfgs(gh, gw, family)
    a, b = part.make_tile_spec(mine, ry, rx), jpart.make_tile_spec(theirs,
                                                                  ry, rx)
    assert tuple(a) == tuple(b)
    assert repr(a) == repr(b)
    for prop in ("columns_per_tile", "rings_y", "rings_x",
                 "permutes_per_step"):
        assert getattr(a, prop) == getattr(b, prop), prop


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 64, 97, 1024])
def test_process_grid_and_rank_spec(n):
    assert part.process_grid(n) == jpart.process_grid(n)
    mine, theirs = dpsnn.with_ranks(dpsnn.RANK_TILE_PAPER, n), \
        jdpsnn.with_ranks(jdpsnn.RANK_TILE_PAPER, n)
    assert tuple(part.make_rank_tile_spec(mine, n)) == tuple(
        jpart.make_rank_tile_spec(theirs, n))


def test_bad_inputs_raise_the_reference_text():
    with pytest.raises(ValueError) as a:
        part.process_grid(0)
    with pytest.raises(ValueError) as b:
        jpart.process_grid(0)
    assert str(a.value) == str(b.value)
    for ry, rx in [(3, 2), (2, 3), (5, 7)]:
        mine, theirs = _cfgs(8, 8)
        with pytest.raises(ValueError) as a:
            part.make_tile_spec(mine, ry, rx)
        with pytest.raises(ValueError) as b:
            jpart.make_tile_spec(theirs, ry, rx)
        assert str(a.value) == str(b.value)


@pytest.mark.parametrize("gh,gw,ry,rx", GRIDS)
def test_coords_and_column_ids(gh, gw, ry, rx):
    mine, theirs = _cfgs(gh, gw)
    spec, jspec = part.make_tile_spec(mine, ry, rx), \
        jpart.make_tile_spec(theirs, ry, rx)
    seen = []
    for s in range(ry * rx):
        ty, tx = part.shard_tile_coords(spec, s)
        assert (ty, tx) == jpart.shard_tile_coords(jspec, s)
        ids = part.tile_column_ids(mine, spec, ty, tx)
        want = jpart.tile_column_ids(theirs, jspec, jnp.int32(ty),
                                     jnp.int32(tx))
        assert ids.dtype == torch.int32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
        seen.append(ids)
    assert sorted(torch.cat(seen).tolist()) == list(range(gh * gw))


@pytest.mark.parametrize("gh,gw,ry,rx", GRIDS)
def test_global_maps_match_and_round_trip(gh, gw, ry, rx):
    mine, theirs = _cfgs(gh, gw)
    spec, jspec = part.make_tile_spec(mine, ry, rx), \
        jpart.make_tile_spec(theirs, ry, rx)
    rng = np.random.default_rng(gh * 100 + ry * 10 + rx)
    g = rng.standard_normal((gh, gw, 3, 5)).astype(np.float32)
    tiles = part.global_to_tiles(g, spec)
    np.testing.assert_array_equal(tiles, jpart.global_to_tiles(g, jspec))
    np.testing.assert_array_equal(part.tiles_to_global(tiles, spec), g)
    cols = part.global_to_columns(g.reshape(gh * gw, 3, 5), spec)
    np.testing.assert_array_equal(
        cols, jpart.global_to_columns(g.reshape(gh * gw, 3, 5), jspec))
    np.testing.assert_array_equal(part.columns_to_global(cols, spec),
                                  g.reshape(gh * gw, 3, 5))
    # torch tensors take the same maps
    tt = part.global_to_tiles(torch.from_numpy(g), spec)
    np.testing.assert_array_equal(tt.numpy(), tiles)
    np.testing.assert_array_equal(
        part.columns_to_global(torch.from_numpy(cols), spec).numpy(),
        g.reshape(gh * gw, 3, 5))
    # columns stacked shard by shard, in tile order, are global columns
    ids = torch.stack([part.tile_column_ids(mine, spec,
                                            *part.shard_tile_coords(spec, s))
                       for s in range(ry * rx)])
    np.testing.assert_array_equal(part.columns_to_global(ids, spec).numpy(),
                                  np.arange(gh * gw))
    u = part.unflatten_tile(torch.from_numpy(cols[0]), spec)
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jpart.unflatten_tile(jnp.asarray(cols[0]),
                                                   jspec)))


def test_global_maps_refuse_wrong_shapes():
    spec = part.make_tile_spec(dpsnn.reduced(8, 8), 2, 2)
    with pytest.raises(ValueError, match="does not match"):
        part.tiles_to_global(np.zeros((3, 4, 4)), spec)
    with pytest.raises(ValueError, match="does not match"):
        part.global_to_tiles(np.zeros((8, 6)), spec)
