"""Elastic resharding in the port (``checkpoint.checkpointer.reshard``,
``exchange.stacked_state_template``): the template's leaf paths, shapes
and dtypes are the reference's; ``reshard`` equals the reference's
bitwise on the same numpy tree for every divisible pair of rank counts
on a 4x4 grid, static, plastic and pipelined with the guard's leaves;
the rejections raise the reference's texts; and static and plastic runs
resumed after a reshard on an in-process mesh are the uninterrupted
run, bitwise."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as JCK
from repro.configs import dpsnn as jdpsnn
from repro.configs.base import ExchangeConfig as JEx
from repro.configs.base import GuardConfig as JGuard
from repro.core import exchange as jex
from repro.core import partition as jpart
from repro_torch.checkpoint import checkpointer as CK
from repro_torch.configs import dpsnn
from repro_torch.configs.base import ExchangeConfig, GuardConfig
from repro_torch.core import exchange as ex
from repro_torch.core.partition import make_rank_tile_spec
from repro_torch.runtime.transport import LocalMesh


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


RANKS = (1, 2, 4, 8, 16)      # every rank count that tiles the 4x4 grid
FORMS = ("static", "plastic", "pipelined_guarded", "aer_plastic")


def _cfgs(form, grid=4, neurons=16):
    """(port cfg, JAX cfg) of one form."""
    kw, jkw = {}, {}
    if form in ("plastic", "aer_plastic"):
        kw["stdp"] = jkw["stdp"] = True
    if form == "pipelined_guarded":
        kw.update(guard=GuardConfig(enabled=True),
                  exchange=ExchangeConfig(pipelined=True))
        jkw.update(guard=JGuard(enabled=True), exchange=JEx(pipelined=True))
    cfg = dataclasses.replace(dpsnn.reduced(grid, grid, neurons, seed=0),
                              **kw)
    jcfg = dataclasses.replace(jdpsnn.reduced(grid, grid, neurons, seed=0),
                               **jkw)
    if form == "aer_plastic":
        cfg = dataclasses.replace(cfg, conn=dataclasses.replace(
            cfg.conn, exchange_mode="aer_sparse"))
        jcfg = dataclasses.replace(jcfg, conn=dataclasses.replace(
            jcfg.conn, exchange_mode="aer_sparse"))
    return cfg, jcfg


def _synthetic(cfg, ranks, seed=0):
    """A random but consistent stacked state (halo cells equal their
    neighbours' interiors: the identity reshard makes them so), the
    reference's ``_synthetic_state``."""
    tpl, spec, _ = ex.stacked_state_template(cfg, ranks)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1][1] == "t":
            return np.full(leaf.shape, 11, leaf.dtype)
        if leaf.dtype == np.bool_:
            return rng.integers(0, 2, leaf.shape).astype(np.bool_)
        return rng.integers(-1, 7, leaf.shape).astype(leaf.dtype)

    return CK.reshard(CK._map(fill, tpl), spec, spec), spec


@pytest.mark.parametrize("form", FORMS)
def test_template_is_the_references(form):
    cfg, jcfg = _cfgs(form)
    for ranks in (1, 2, 4):
        mine, spec, _ = ex.stacked_state_template(cfg, ranks)
        theirs, jspec, _ = jex.stacked_state_template(jcfg, ranks)
        flat, _ = jax.tree_util.tree_flatten_with_path(theirs)
        paths, leaves = CK._flatten_with_paths(mine)
        assert paths == ["/".join(str(k) for k in p) for p, _ in flat]
        assert [(x.shape, x.dtype) for x in leaves] == [
            (x.shape, x.dtype) for _, x in flat]
        assert not any(x.any() for x in leaves)
        assert tuple(spec) == tuple(jspec)


@pytest.mark.parametrize("r_from", RANKS)
@pytest.mark.parametrize("form", FORMS)
def test_reshard_equals_the_references(form, r_from):
    """From ``r_from`` ranks to every rank count, the port's reshard and
    the reference's give the same leaves to the bit, and back again to
    the same state."""
    cfg, jcfg = _cfgs(form)
    state, spec_from = _synthetic(cfg, r_from, seed=r_from)
    jfrom = jpart.make_rank_tile_spec(jcfg, r_from)
    for r_to in RANKS:
        spec_to = make_rank_tile_spec(cfg, r_to)
        jto = jpart.make_rank_tile_spec(jcfg, r_to)
        mine = CK.reshard(state, spec_from, spec_to)
        theirs = JCK.reshard(state, jfrom, jto)
        a, b = CK._flatten_with_paths(mine), CK._flatten_with_paths(theirs)
        assert a[0] == b[0]
        for path, x, y in zip(a[0], a[1], b[1]):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            np.testing.assert_array_equal(x, y, err_msg=f"{r_to}: {path}")
        # the synthetic state is canonical (counter totals on shard 0,
        # flags and guard cleared), so the round trip is exact
        back = CK.reshard(mine, spec_to, spec_from)
        for path, x, y in zip(*CK._flatten_with_paths(back),
                              CK._flatten_with_paths(state)[1]):
            np.testing.assert_array_equal(x, y, err_msg=f"back: {path}")


def _error(fn, *args):
    with pytest.raises(ValueError) as err:
        fn(*args)
    return str(err.value)


def test_reshard_rejects_mismatched_geometry():
    cfg, jcfg = _cfgs("static")
    state, spec = _synthetic(cfg, 4)
    other_cfg, other_j = _cfgs("static", grid=8)
    mine = _error(CK.reshard, state, spec, make_rank_tile_spec(other_cfg, 4))
    theirs = _error(JCK.reshard, state, jpart.make_rank_tile_spec(jcfg, 4),
                    jpart.make_rank_tile_spec(other_j, 4))
    assert mine == theirs and "same global column grid" in mine


def test_reshard_rejects_disagreeing_step_counter():
    cfg, jcfg = _cfgs("static")
    state, spec = _synthetic(cfg, 4)
    broken = state._replace(t=np.array([11, 11, 12, 11], np.int32))
    mine = _error(CK.reshard, broken, spec, make_rank_tile_spec(cfg, 2))
    theirs = _error(JCK.reshard, broken, jpart.make_rank_tile_spec(jcfg, 4),
                    jpart.make_rank_tile_spec(jcfg, 2))
    assert mine == theirs and "disagrees" in mine


def test_reshard_names_unknown_leaf():
    cfg, jcfg = _cfgs("static")
    spec = make_rank_tile_spec(cfg, 4)
    jspec = jpart.make_rank_tile_spec(jcfg, 4)
    mine = _error(CK._reshard_leaf, "mystery_field", np.zeros((4, 3)), spec,
                  spec)
    theirs = _error(JCK._reshard_leaf, "mystery_field", np.zeros((4, 3)),
                    jspec, jspec)
    assert mine == theirs and "mystery_field" in mine


def _named(tree) -> dict:
    """A numpy stack's leaves under the last part of their paths."""
    paths, leaves = CK._flatten_with_paths(tree)
    return {p.rsplit("/", 1)[-1].lstrip("."): x
            for p, x in zip(paths, leaves)}


@pytest.mark.parametrize("form", ["static", "plastic"])
def test_resume_after_reshard_is_bitwise(form):
    """30 steps on 2x2 shards, resharded to 2 ranks' tiling (1x2) and to
    one shard, 30 more steps: totals, the last step's spikes and every
    final leaf equal the straight 60-step 2x2 run's, resharded the same
    way (the counters' totals, which reshard moves to shard 0)."""
    cfg, _ = _cfgs(form)
    spec4 = make_rank_tile_spec(cfg, 4)
    ref, ref_stack = ex.make_distributed_run(
        cfg, LocalMesh(2, 2, "cpu"), n_steps=60, impl="ref",
        replicate_state=True)[0]()
    _, mid = ex.make_distributed_run(cfg, LocalMesh(2, 2, "cpu"),
                                     n_steps=30, impl="ref",
                                     replicate_state=True)[0]()
    for r_new, shape in ((2, (1, 2)), (1, (1, 1))):
        spec = make_rank_tile_spec(cfg, r_new)
        run, _ = ex.make_distributed_run(cfg, LocalMesh(*shape, "cpu"),
                                         n_steps=30, impl="ref",
                                         replicate_state=True)
        res, final = run(CK.reshard(mid, spec4, spec))
        # the counters ride the state: the totals are the whole run's
        assert float(res.spikes) == float(ref.spikes)
        assert float(res.events) == float(ref.events)
        want = _named(CK.reshard(ref_stack, spec4, spec))
        got = _named(final)
        assert sorted(got) == sorted(want)
        for k in got:
            if k in CK._SUM_LEAVES:
                assert got[k].sum(dtype=np.float64) == want[k].sum(
                    dtype=np.float64), k
            elif k != "aer_sat":
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert torch.equal(res.rate_trace[-1:], ref.rate_trace[-1:])
