"""The port's configs and connectivity against the JAX reference: the
config copy equal field by field and property by property, the stencil
equal, and the port's keyed generator holding the reference's structural
invariants and the Table-1 calibration (tests/test_torch_simulation.py
holds the generated network equal to the reference's)."""
import dataclasses
import math

import pytest
import torch

from repro.configs import base as jbase
from repro.configs import dpsnn as jdpsnn
from repro.core import connectivity as jconn
from repro_torch.configs import base, dpsnn
from repro_torch.core import connectivity as conn


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PROPS = ("n_columns", "n_neurons", "stencil_radius", "local_fanin",
         "remote_fanin", "recurrent_synapses", "total_equivalent_synapses",
         "max_delay_steps")


def _pairs():
    yield dpsnn.GRID_24, jdpsnn.GRID_24
    yield dpsnn.GRID_48, jdpsnn.GRID_48
    yield dpsnn.GRID_96, jdpsnn.GRID_96
    yield dpsnn.reduced(), jdpsnn.reduced()
    for fam in ("gauss", "exp", "gauss_exp"):
        yield dpsnn.reduced_family(fam), jdpsnn.reduced_family(fam)
        yield (dpsnn.with_family(dpsnn.GRID_24, fam),
               jdpsnn.with_family(jdpsnn.GRID_24, fam))
    yield dpsnn.RANK_TILE_PAPER, jdpsnn.RANK_TILE_PAPER
    for n_ranks in (1, 6, 1024):
        yield (dpsnn.with_ranks(dpsnn.RANK_TILE_PAPER, n_ranks),
               jdpsnn.with_ranks(jdpsnn.RANK_TILE_PAPER, n_ranks))
    yield (dpsnn.with_ranks(dpsnn.reduced(), 8),
           jdpsnn.with_ranks(jdpsnn.reduced(), 8))


@pytest.mark.parametrize("pair", list(_pairs()), ids=lambda p: p[0].name)
def test_config_copy_agrees(pair):
    mine, theirs = pair
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for prop in PROPS:
        assert getattr(mine, prop) == getattr(theirs, prop), prop
    assert mine.stencil_offsets() == theirs.stencil_offsets()
    assert mine.remote_fanin_per_offset() == theirs.remote_fanin_per_offset()


def test_config_classes_have_the_same_fields():
    for name in ("NeuronConfig", "ConnectivityConfig", "ExchangeConfig",
                 "STDPConfig", "GuardConfig", "DPSNNConfig"):
        mine = [(f.name, f.type) for f in
                dataclasses.fields(getattr(base, name))]
        theirs = [(f.name, f.type) for f in
                  dataclasses.fields(getattr(jbase, name))]
        assert mine == theirs, name
    assert set(dpsnn.GRIDS) == set(jdpsnn.GRIDS)
    assert set(dpsnn.FAMILIES) == set(jdpsnn.FAMILIES)


@pytest.mark.parametrize("cfg_fn", [
    lambda m: m.GRID_24,
    lambda m: m.reduced(),
    lambda m: m.reduced_family("gauss_exp", radius=3),
    lambda m: m.with_family(m.GRID_24, "gauss_exp"),
])
def test_build_stencil_matches_reference(cfg_fn):
    mine = conn.build_stencil(cfg_fn(dpsnn))
    theirs = jconn.build_stencil(cfg_fn(jdpsnn))
    assert mine.offsets == theirs.offsets
    assert mine.k_total == theirs.k_total
    assert mine.max_delay == theirs.max_delay
    assert mine.radius == theirs.radius
    assert (mine.slot_offset == theirs.slot_offset).all()
    assert (mine.slot_delay == theirs.slot_delay).all()


def test_paper_stencil_at_full_width():
    """20 active offsets, K_tot = 248, radius 2. The farthest active offset
    is (2, 1), so the realized max delay is 3 steps; the config's
    ``max_delay_steps`` bound (4) assumes the (2, 2) corner."""
    st = conn.build_stencil(dpsnn.GRID_24)
    assert (st.n_offsets, st.k_total, st.radius, st.max_delay) == \
        (20, 248, 2, 3)
    assert dpsnn.GRID_24.max_delay_steps == 4


def _small(n=48):
    return base.DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=n, seed=3)


@pytest.mark.parametrize("n", [48, 200, 1240])
def test_local_column_structure_and_calibration(n):
    cfg = _small(n)
    w = conn.generate_local_column(cfg, 5)
    assert w.shape == (n, n) and w.dtype == torch.float32
    assert float(w.diagonal().abs().max()) == 0.0            # no autapses
    n_exc = round(cfg.conn.exc_fraction * n)
    assert float(w[:n_exc].min()) >= 0.0                      # sign = source
    assert float(w[n_exc:].max()) <= 0.0
    nz = w[w != 0]
    mag = torch.where(nz > 0, nz / cfg.conn.j_exc,
                      -nz / (cfg.conn.g_balance * cfg.conn.j_exc))
    cv = cfg.conn.weight_cv
    assert float(mag.min()) >= 1 - 2 * cv - 1e-6
    assert float(mag.max()) <= 1 + 2 * cv + 1e-6
    if n == 1240:   # Table-1 calibration: realized fan-in within 2 %
        fanin = float((w != 0).sum()) / n
        assert abs(fanin - cfg.local_fanin) / cfg.local_fanin < 0.02


def test_remote_column_structure():
    cfg = _small(1240)
    st = conn.build_stencil(cfg)
    idx, w = conn.generate_remote_column(cfg, st, 2)
    n = cfg.neurons_per_column
    assert idx.shape == (n, st.k_total) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < n
    assert st.k_total == cfg.remote_fanin
    inh = conn.neuron_types(cfg)[idx.long()]
    assert bool((w[inh] < 0).all()) and bool((w[~inh] > 0).all())
    mag = torch.where(inh, -w / (cfg.conn.g_balance * cfg.conn.j_exc),
                      w / cfg.conn.j_exc)
    assert float(mag.min()) >= 1 - 2 * cfg.conn.weight_cv - 1e-6
    assert float(mag.max()) <= 1 + 2 * cfg.conn.weight_cv + 1e-6
    # the jitter is a truncated normal: mean 1, std below cv
    assert abs(float(mag.mean()) - 1.0) < 0.01
    assert float(mag.std()) < cfg.conn.weight_cv


def test_columns_deterministic_per_column():
    """A column regenerated alone equals the same column generated in a
    batch (of ids, and in chunks), and other columns differ."""
    cfg = _small(48)
    st = conn.build_stencil(cfg)
    w_local, rem_idx, rem_w = conn.generate_columns(cfg, [3, 7, 11])
    assert torch.equal(w_local[1], conn.generate_local_column(cfg, 7))
    idx7, w7 = conn.generate_remote_column(cfg, st, 7)
    assert torch.equal(rem_idx[1], idx7) and torch.equal(rem_w[1], w7)
    ids = torch.tensor([3, 7, 11])
    assert torch.equal(conn.generate_local_column(cfg, ids), w_local)
    idx, w = conn.generate_remote_column(cfg, st, ids)
    assert torch.equal(idx, rem_idx) and torch.equal(w, rem_w)
    chunked = dataclasses.replace(cfg, neurons_per_column=1240)
    assert torch.equal(conn.generate_columns(chunked, [2, 9])[0][1],
                       conn.generate_local_column(chunked, 9))
    assert not torch.equal(w_local[0], w_local[1])
    again = conn.generate_columns(cfg, [7])
    assert torch.equal(again[0][0], w_local[1])
    other_seed = dataclasses.replace(cfg, seed=4)
    assert not torch.equal(conn.generate_local_column(other_seed, 7),
                           w_local[1])


def test_flat_gather_index_and_out_degree():
    cfg = _small(48)
    st = conn.build_stencil(cfg)
    _, rem_idx, _ = conn.generate_columns(cfg, [0, 1])
    flat = conn.flat_gather_index(st, rem_idx, 48)
    off = torch.as_tensor(st.slot_offset)
    assert torch.equal(flat, off[None, None, :] * 48 + rem_idx)
    assert flat.dtype == torch.int32
    assert int(flat.max()) < st.n_offsets * 48
    w = torch.tensor([[[0.0, 1.0], [2.0, 0.0]]])
    assert conn.local_out_degree(w).tolist() == [[1, 1]]
    assert conn.expected_syn_per_neuron(cfg) == \
        jconn.expected_syn_per_neuron(jbase.DPSNNConfig(
            grid_h=4, grid_w=4, neurons_per_column=48, seed=3))


def test_table1_figures():
    expect = {(24, 24): (0.7e6, 0.9e9), (48, 48): (2.9e6, 3.5e9),
              (96, 96): (11.4e6, 14.2e9)}
    for (gh, gw), (neu, rec) in expect.items():
        cfg = base.DPSNNConfig(grid_h=gh, grid_w=gw)
        assert abs(cfg.n_neurons - neu) / neu < 0.03
        assert abs(cfg.recurrent_synapses - rec) / rec < 0.03
    per = base.DPSNNConfig().local_fanin + base.DPSNNConfig().remote_fanin
    assert 1239 <= per <= 1245
    assert math.isclose(dpsnn.GRID_24.total_equivalent_synapses / 1e9, 1.27,
                        abs_tol=0.01)
