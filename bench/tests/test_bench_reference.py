"""The plain reference against the program's plain path at tiny sizes:
the network, the initial state and the drive to the bit; the kernel
order against the program's statement of its kernels' sums."""
from __future__ import annotations

import pytest
import torch

import _tiny
from _tiny import common
from bench.reference import dpsnn as ref


@pytest.fixture(scope="module")
def tiny():
    from repro_torch.core import simulation
    cfg = _tiny.config()
    pcfg = common.program_config(cfg, _tiny.SEED, False)
    params, state = simulation.build(pcfg, device="cpu")
    return cfg, pcfg, params, state


def test_network_and_state_equal_the_programs(tiny):
    cfg, _pcfg, params, state = tiny
    net = ref.build(cfg, _tiny.SEED, "cpu")
    assert common.mismatches(net.w_local, params.w_local) == 0
    assert common.mismatches(net.rem_src, params.rem_flat) == 0
    assert common.mismatches(net.rem_w, params.rem_w) == 0
    assert common.mismatches(net.outdeg, params.local_outdeg) == 0
    rs = ref.init_state(cfg, _tiny.SEED, "cpu", False)
    assert common.mismatches(rs.v, state.lif.v) == 0
    assert rs.hist.shape == state.hist.shape


def test_stencil_matches_the_programs(tiny):
    from repro_torch.core.connectivity import build_stencil
    cfg, pcfg, _p, _s = tiny
    ps, rs = build_stencil(pcfg), ref.stencil(cfg)
    assert [o[:4] for o in ps.offsets] == rs.offsets
    assert (ps.k_total, ps.max_delay, ps.radius) == (rs.k_total,
                                                    rs.max_delay, rs.radius)


@pytest.mark.parametrize("nu", [None, 0.8, 1.5])
def test_drive_equals_the_programs_in_both_forms(tiny, nu):
    from repro_torch.core import network as net
    cfg, pcfg, _p, _s = tiny
    c, n = 16, cfg["neurons_per_column"]
    lam = ref.drive_rate(cfg, nu)
    assert lam == net.drive_rate(pcfg, nu)
    steps = [0, 1, 7, 300]
    full = ref.poisson_counts(_tiny.SEED, steps, c, n, lam, "cpu", False)
    packed = ref.poisson_counts(_tiny.SEED, steps, c, n, lam, "cpu", True)
    cols = net.column_ids(pcfg)
    for i, t in enumerate(steps):
        _cur, counts = net.external_drive(pcfg, t, cols,
                                          nu_scale=nu)
        assert common.mismatches(full[i], counts) == 0
    assert common.mismatches(packed, full) == 0


def test_lif_constants_equal_the_programs(tiny):
    from repro_torch.kernels.ref import lif_constants
    cfg, pcfg, _p, _s = tiny
    mine = ref.lif_constants(cfg["neuron"])
    theirs = lif_constants(pcfg.neuron)
    assert mine["decay_v"] == theirs["decay_v"]
    assert mine["gain"] == theirs["gain"]
    assert mine["v_thr"] == theirs["v_threshold"]
    assert mine["arp"] == theirs["arp_steps"]


def test_fma_rounds_once():
    a = torch.tensor([1.0 + 2 ** -12], dtype=torch.float32)
    c = torch.tensor([-1.0], dtype=torch.float32)
    # (1 + u)^2 - 1 = 2u + u^2: one rounding keeps u^2, two lose it
    got = ref.fma(a, a, c)
    assert float(got) == 2 ** -11 + 2 ** -24
    assert float(a * a + c) == 2 ** -11


def test_local_sum_in_kernel_order_is_the_kernels_chain():
    from repro_torch.kernels.ref import synapse_matmul_chain_ref
    g = torch.Generator().manual_seed(1)
    s = (torch.rand(9, 200, generator=g) < 0.05).float()
    s[2] = (torch.rand(200, generator=g) < 0.9).float()
    s[4] = 0.0
    w = torch.randn(9, 200, 200, generator=g)
    got = ref.local_sum(s, w, "kernel")
    assert common.mismatches(got, synapse_matmul_chain_ref(s, w)) == 0
    assert common.mismatches(ref.local_sum(s, w, "plain"),
                             torch.einsum("cs,cst->ct", s, w)) == 0


def lanes_by_hand(x, k):
    """The 32 lanes' chains and their butterfly, one lane at a time."""
    rows = x.shape[0]
    lanes = torch.zeros(rows, 32)
    for lane in range(32):
        acc = torch.zeros(rows)
        if k % 4 == 0:
            slots = [4 * g + e for g in range(lane, k // 4, 32)
                     for e in range(4)]
        else:
            slots = list(range(lane, k, 32))
        for j in slots:
            acc = acc + x[:, j]
        lanes[:, lane] = acc
    h = 32
    while h > 1:
        h //= 2
        lanes = lanes[:, :h] + lanes[:, h:2 * h]
    return lanes[:, 0]


@pytest.mark.parametrize("k", [248, 250, 36])
def test_remote_sum_in_kernel_order_is_the_lane_butterfly(k):
    g = torch.Generator().manual_seed(k)
    c, n, t = 5, 64, 20 * 64
    table = (torch.rand(c, t, generator=g) < 0.3).float()
    src = torch.randint(0, t, (c, n, k), generator=g, dtype=torch.int32)
    w = torch.randn(c, n, k, generator=g)
    got = ref.remote_sum(table, ref.flat_index(src, t), w, "kernel")
    x = torch.gather(table, 1, src.reshape(c, -1).long()).reshape(
        c * n, k) * w.reshape(c * n, k)
    assert common.mismatches(got.reshape(-1), lanes_by_hand(x, k)) == 0


def test_remote_sum_plain_is_the_programs_plain_gather():
    from repro_torch.kernels.ref import ell_gather_ref
    g = torch.Generator().manual_seed(3)
    c, n, k, t = 4, 48, 30, 20 * 48
    table = (torch.rand(c, t, generator=g) < 0.3).float()
    src = torch.randint(0, t, (c, n, k), generator=g, dtype=torch.int32)
    w = torch.randn(c, n, k, generator=g)
    got = ref.remote_sum(table, ref.flat_index(src, t), w, "plain")
    assert common.mismatches(got, ell_gather_ref(table, src, w)) == 0


def test_local_stdp_rule_equals_the_dense_rule():
    """The rule applied to the rows and columns of the neurons that
    spiked equals the program's plain dense update everywhere."""
    from repro_torch.kernels.ref import stdp_dense_update_ref
    g = torch.Generator().manual_seed(4)
    c, n = 3, 40
    w = torch.rand(c, n, n, generator=g) * 0.6
    w[:, :, 32:] *= -1.0
    w[torch.rand(c, n, n, generator=g) < 0.2] = 0.0
    spikes = (torch.rand(c, n, generator=g) < 0.2).float()
    exc = (torch.arange(n) < 32).float()
    x_pre = torch.rand(c, n, generator=g)
    x_post = torch.rand(c, n, generator=g)
    k = dict(a_plus=0.01, a_minus=0.012, lr=1.0, w_max=0.84)
    want = stdp_dense_update_ref(w, x_pre * exc, spikes * exc, spikes,
                                 x_post, **k)
    k32 = {kk: float(torch.tensor(v, dtype=torch.float32))
           for kk, v in k.items()}
    got = ref.stdp_local_(w.clone(), x_pre * exc, spikes * exc, spikes,
                          x_post, k32)
    assert common.mismatches(got, want) == 0
