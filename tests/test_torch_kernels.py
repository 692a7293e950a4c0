"""The port's kernel wrappers against the JAX reference: each plain
PyTorch version against ``repro.kernels.ref`` and against the Pallas
kernel through ``repro.kernels.ops`` (interpret mode on the CPU), at the
shapes of tests/test_kernels.py, float32, 1e-5. Inputs are made with
numpy from a seed and handed to both sides.

On the CPU every wrapper takes its plain version; a tensor elsewhere
must reach the kernel or raise. tests/test_torch_cuda.py holds the
kernels against their plain versions on the card."""
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import NeuronConfig as JNeuronConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs.base import NeuronConfig
from repro_torch.kernels import _build, ops, ref


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = dict(rtol=1e-5, atol=1e-5)


def _spikes(rng, shape, p=0.07):
    return (rng.random(shape) < p).astype(np.float32)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _lif_inputs(rng, c, n):
    v = rng.uniform(0, 21, (c, n)).astype(np.float32)
    cc = rng.uniform(0, 3, (c, n)).astype(np.float32)
    r = rng.integers(0, 3, (c, n)).astype(np.int32)
    cur = (rng.standard_normal((c, n)) * 2).astype(np.float32)
    return v, cc, r, cur


@pytest.mark.parametrize("c,n", [(1, 32), (3, 70), (8, 128), (5, 200),
                                 (2, 257)])
def test_synapse_matmul_matches_reference(c, n):
    rng = np.random.default_rng(c * 1000 + n)
    s, w = _spikes(rng, (c, n)), _normal(rng, (c, n, n))
    got = ops.synapse_matmul(_t(s), _t(w)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jref.synapse_matmul_ref(jnp.asarray(s),
                                                jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jops.synapse_matmul(jnp.asarray(s), jnp.asarray(w))),
        **TOL)


@pytest.mark.parametrize("c,n", [(1, 32), (3, 70), (5, 200), (2, 257)])
def test_synapse_matmul_chain_ref_matches_reference(c, n):
    """The product in the CUDA kernel's order and rounding (one fused
    multiply-add chain per target over the spiking sources, ascending)
    against the JAX reference, with one column where every source
    spikes."""
    rng = np.random.default_rng(c * 7 + n)
    s, w = _spikes(rng, (c, n)), _normal(rng, (c, n, n))
    s[0] = 1.0
    got = ref.synapse_matmul_chain_ref(_t(s), _t(w)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jref.synapse_matmul_ref(jnp.asarray(s),
                                                jnp.asarray(w))), **TOL)
    zeros = ref.synapse_matmul_chain_ref(torch.zeros(c, n), _t(w))
    assert float(zeros.abs().max()) == 0.0


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest to ``x``, ties to even."""
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array(v).view(np.int32)) & 1))


def test_synapse_matmul_chain_ref_rounds_each_step_once():
    """Each step of the chain is a * b + acc rounded once to float32, as
    __fmaf_rn rounds it: against exact rational arithmetic, with spike
    values other than 1."""
    rng = np.random.default_rng(11)
    c, n = 2, 24
    s = _spikes(rng, (c, n), p=0.5) * _normal(rng, (c, n))
    w = _normal(rng, (c, n, n))
    want = np.zeros((c, n), np.float32)
    for ci in range(c):
        for t in range(n):
            acc = np.float32(0.0)
            for j in np.flatnonzero(s[ci]):
                acc = _round_f32(Fraction(float(s[ci, j]))
                                 * Fraction(float(w[ci, j, t]))
                                 + Fraction(float(acc)))
            want[ci, t] = acc
    got = ref.synapse_matmul_chain_ref(_t(s), _t(w)).numpy()
    np.testing.assert_array_equal(got, want)


def test_synapse_matmul_all_silent_exact_zeros():
    rng = np.random.default_rng(0)
    w = _t(_normal(rng, (4, 130, 130)))
    counter = torch.zeros(1, dtype=torch.int64)
    out = ops.synapse_matmul(torch.zeros(4, 130), w, silent_blocks=counter)
    assert float(out.abs().max()) == 0.0
    assert int(counter) == 4 * 2          # every (column, 128-block) skipped


def test_silent_block_count():
    s = torch.zeros(3, 300)
    s[0, 5] = 1.0          # column 0: block 0 active
    s[2, 299] = 1.0        # column 2: last (ragged) block active
    assert int(ref.silent_block_count(s)) == 3 * 3 - 2


@pytest.mark.parametrize("c,n,k,o", [(2, 64, 16, 4), (3, 130, 17, 20),
                                     (1, 40, 250, 20)])
def test_ell_gather_matches_reference(c, n, k, o):
    rng = np.random.default_rng(n * k)
    t = o * n
    s = _spikes(rng, (c, t), 0.1)
    idx = rng.integers(0, t, (c, n, k)).astype(np.int32)
    w = _normal(rng, (c, n, k))
    got = ops.ell_gather(_t(s), _t(idx), _t(w)).numpy()
    js, ji, jw = jnp.asarray(s), jnp.asarray(idx), jnp.asarray(w)
    np.testing.assert_allclose(got, np.asarray(jref.ell_gather_ref(js, ji, jw)),
                               **TOL)
    np.testing.assert_allclose(got, np.asarray(jops.ell_gather(js, ji, jw)),
                               **TOL)


def test_ell_gather_wide_table():
    """T > 131,072 lanes: the reference's table-tiled branch; the port has
    one code path for every width."""
    rng = np.random.default_rng(7)
    c, n, k, t = 1, 40, 250, 131_072 + 1_000
    s = _spikes(rng, (c, t), 0.1)
    idx = rng.integers(0, t, (c, n, k)).astype(np.int32)
    idx[0, 0, :4] = [0, t - 1, 131_071, 131_072]     # both sides of the seam
    w = _normal(rng, (c, n, k))
    got = ops.ell_gather(_t(s), _t(idx), _t(w)).numpy()
    want = jref.ell_gather_ref(jnp.asarray(s), jnp.asarray(idx),
                               jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _lif_kwargs(cfg):
    return dict(decay_v=math.exp(-cfg.dt_ms / cfg.tau_m_ms),
                decay_c=math.exp(-cfg.dt_ms / cfg.tau_c_ms),
                gain=(1 - math.exp(-cfg.dt_ms / cfg.tau_m_ms))
                * cfg.tau_m_ms / cfg.dt_ms,
                g_c=cfg.g_c, alpha_c=cfg.alpha_c, v_rest=cfg.v_rest,
                v_reset=cfg.v_reset, v_threshold=cfg.v_threshold,
                arp_steps=round(cfg.tau_arp_ms / cfg.dt_ms))


@pytest.mark.parametrize("c,n", [(5, 170), (1, 32), (9, 129)])
def test_lif_step_matches_reference(c, n):
    rng = np.random.default_rng(c + n)
    v, cc, r, cur = _lif_inputs(rng, c, n)
    got = ops.lif_step(NeuronConfig(), _t(v), _t(cc), _t(r), _t(cur))
    jin = [jnp.asarray(x) for x in (v, cc, r, cur)]
    want_ref = jref.lif_step_ref(*jin, **_lif_kwargs(JNeuronConfig()))
    want_pallas = jops.lif_step(JNeuronConfig(), *jin)
    for g, w1, w2 in zip(got, want_ref, want_pallas):
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w1, np.float32), **TOL)
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w2, np.float32), **TOL)
    assert got[2].dtype == torch.int32


def test_lif_constants_folded_in_float32():
    """The decays are the reference's float32 ``jnp.exp`` values (not a
    double ``math.exp`` nor numpy's float32 exp, which differs by an ulp)
    and the gain is folded in float32 as kernels/fused_step.py does."""
    cfg = JNeuronConfig()
    k = ref.lif_constants(NeuronConfig())
    dv = jax.jit(lambda: jnp.exp(-cfg.dt_ms / cfg.tau_m_ms)
                 .astype(jnp.float32))()
    dc = jax.jit(lambda: jnp.exp(-cfg.dt_ms / cfg.tau_c_ms)
                 .astype(jnp.float32))()
    assert k["decay_v"] == float(dv)
    assert k["decay_c"] == float(dc)
    assert k["gain"] == float((1.0 - dv) * (cfg.tau_m_ms / cfg.dt_ms))
    assert k["arp_steps"] == 2


def _fused_inputs(rng, c, n, k, o):
    t = o * n
    v, cc, r, _ = _lif_inputs(rng, c, n)
    s_loc = _spikes(rng, (c, n), 0.1)
    w = (_normal(rng, (c, n, n)) * 0.4).astype(np.float32)
    tbl = _spikes(rng, (c, t), 0.1)
    idx = rng.integers(0, t, (c, n, k)).astype(np.int32)
    rw = (_normal(rng, (c, n, k)) * 0.4).astype(np.float32)
    ext = (rng.poisson(1.62, (c, n)) * 0.6).astype(np.float32)
    return v, cc, r, s_loc, w, tbl, idx, rw, ext


@pytest.mark.parametrize("c,n,k,o", [(3, 48, 16, 4), (2, 130, 17, 20),
                                     (1, 257, 9, 3)])
def test_fused_step_matches_reference(c, n, k, o):
    rng = np.random.default_rng(c * 7 + n)
    args = _fused_inputs(rng, c, n, k, o)
    got = ops.fused_step(NeuronConfig(), *(_t(x) for x in args))
    want = jops.fused_step(JNeuronConfig(), *(jnp.asarray(x) for x in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w, np.float32), **TOL)
    counter = torch.zeros(1, dtype=torch.int64)
    ops.fused_step(NeuronConfig(), *(_t(x) for x in args),
                   silent_blocks=counter)
    assert int(counter) == int(ref.silent_block_count(_t(args[3])))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors no wrapper touches the kernel library."""
    def no_library():
        raise AssertionError("the kernel library was loaded for CPU tensors")
    monkeypatch.setattr(_build, "library", no_library)
    rng = np.random.default_rng(3)
    s, w = _spikes(rng, (2, 40)), _normal(rng, (2, 40, 40))
    torch.testing.assert_close(ops.synapse_matmul(_t(s), _t(w)),
                               ref.synapse_matmul_ref(_t(s), _t(w)))
    args = [_t(x) for x in _fused_inputs(rng, 2, 40, 5, 3)]
    want = ref.fused_step_ref(NeuronConfig(), *args)
    for g, w_ in zip(ops.fused_step(NeuronConfig(), *args), want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
    vec = [_t(rng.random((2, 40)).astype(np.float32)) for _ in range(4)]
    kw = dict(a_plus=0.01, a_minus=0.012, lr=1.0, w_max=0.84)
    assert torch.equal(ops.stdp_dense_update(_t(w), *vec, **kw),
                       ref.stdp_dense_update_ref(_t(w), *vec, **kw))
    tbl = _t(rng.random((2, 120)).astype(np.float32))
    idx = _t(rng.integers(0, 120, (2, 40, 7)).astype(np.int32))
    rw = _t(_normal(rng, (2, 40, 7)))
    assert torch.equal(ops.stdp_remote_update(tbl, idx, rw, *vec[:2], **kw),
                       ref.stdp_remote_update_ref(tbl, idx, rw, *vec[:2],
                                                  **kw))
    ids = torch.tensor([4, 0, 9], dtype=torch.int32)
    cur, counts = ops.keyed_drive(9, 4, ids, 40, 1.62, 0.6)
    assert torch.equal(counts, ref.keyed_poisson_ref(9, 4, ids, 40, 1.62))
    assert torch.equal(cur, counts * 0.6)
    assert sum(_build.LAUNCHES.values()) == 0


def test_non_cpu_tensors_never_fall_back():
    """A tensor that is not on the CPU reaches the kernel path, which
    refuses anything but CUDA tensors: no quiet plain-version fallback."""
    m = torch.zeros(2, 40, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.synapse_matmul(m, torch.zeros(2, 40, 40, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.lif_step(NeuronConfig(), m, m,
                     torch.zeros(2, 40, dtype=torch.int32, device="meta"), m)
    with pytest.raises(ValueError, match="CUDA"):
        ops.stdp_dense_update(torch.zeros(2, 40, 40, device="meta"), m, m, m,
                              m, a_plus=0.01, a_minus=0.012, lr=1.0,
                              w_max=0.84)
    with pytest.raises(ValueError, match="CUDA"):
        ops.stdp_remote_update(
            torch.zeros(2, 120, device="meta"),
            torch.zeros(2, 40, 7, dtype=torch.int32, device="meta"),
            torch.zeros(2, 40, 7, device="meta"), m, m, a_plus=0.01,
            a_minus=0.012, lr=1.0, w_max=0.84)


def test_missing_library_raises(monkeypatch, tmp_path):
    """Without nvcc the library cannot be built, and loading it raises."""
    monkeypatch.setattr(_build, "_LIBRARY", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.launch("lif_step", "repro_lif_step", torch.device("cuda"))
    assert _build.LAUNCHES["lif_step"] == 0


def test_build_key_covers_every_source():
    names = {p.name for p in _build._sources()}
    assert {"kernels.cuh", "lif_step.cu", "synapse_matmul.cu",
            "ell_gather.cu", "fused_step.cu", "stdp_update.cu",
            "keyed_drive.cu", "stdp_remote.cu", "errors.cu"} <= names
    assert len(_build.source_hash()) == 16


def test_weight_dtype_checked():
    with pytest.raises(TypeError, match="bfloat16"):
        _build.check_args("synapse_matmul", torch.device("cuda", 0),
                          w_local=(torch.zeros(2, 2, 2, dtype=torch.bfloat16,
                                               device="meta"),
                                   torch.float32, (2, 2, 2)))
