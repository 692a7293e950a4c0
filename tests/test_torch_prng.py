"""The port's threefry PRNG (``repro_torch/core/prng.py``) and keyed
Poisson drive against ``jax.random`` and the reference's
``external_drive`` on the CPU (jax 0.9.0, ``jax_threefry_partitionable``
on).

Keys, ``fold_in``, ``split``, raw bits, ``uniform``, ``bernoulli`` and
``randint`` are bitwise. ``truncated_normal`` is held to ``TN_MAX_ULP``:
its ``erf_inv`` is XLA's polynomial, but ``log1p`` inside it rounds as
torch's does (at most 3 ulp, on about 1 % of draws, over 10.5 million
draws of 40 seeds when the bound was set). The drive counts are held to
``MAX_DRIVE_MISMATCH``: a count can differ only where a ``log`` rounds
differently at the ``-lam`` boundary, and the tests print how many did.
``chip_smoke.py``'s known answers are pinned to ``jax.random`` here."""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DPSNNConfig as JCfg
from repro.core import connectivity as jconn
from repro.core import network as jnet
from repro_torch.configs.base import DPSNNConfig
from repro_torch.core import connectivity as conn
from repro_torch.core import network as net
from repro_torch.core import prng
from repro_torch.kernels import _build, ref
from repro_torch.kernels import keyed_drive as kd


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROOT = pathlib.Path(__file__).resolve().parents[1]
SEEDS = [0, 1, 42, 2**31 - 1]
SHAPES = [(7,), (64, 64), (1240,)]
TN_MAX_ULP = 4
MAX_DRIVE_MISMATCH = 1e-5


def _words(x):
    return np.asarray(x).astype(np.int64)


def _ulps(a, b):
    """Distance in units in the last place between float32 arrays of one
    sign."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_reference(seed):
    k, jk = prng.prng_key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(k.numpy(), _words(jk))
    for d in (0, 5, 2**31 + 5, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(k, d).numpy(),
                                      _words(jax.random.fold_in(jk, d)))
    for num in (2, 5):
        np.testing.assert_array_equal(prng.split(k, num).numpy(),
                                      _words(jax.random.split(jk, num)))
    ids = jnp.arange(0, 40, 3)
    batch = prng.fold_in(k, torch.from_numpy(np.array(ids)))
    jbatch = jax.vmap(lambda c: jax.random.fold_in(jk, c))(ids)
    np.testing.assert_array_equal(batch.numpy(), _words(jbatch))
    np.testing.assert_array_equal(prng.split(batch).numpy(),
                                  _words(jax.vmap(jax.random.split)(jbatch)))


def test_fold_in_refuses_what_is_not_a_uint32():
    with pytest.raises(ValueError, match="uint32"):
        prng.fold_in(prng.prng_key(0), -3)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_reference(seed, shape):
    k, jk = prng.prng_key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        prng.random_bits(k, shape).numpy(),
        _words(jax.random.bits(jk, shape, jnp.uint32)))


def test_threefry_known_answer():
    """The Random123 vector (key (0, 0), counter (0, 0)), which JAX's
    threefry reproduces, and ``chip_smoke.py``'s copy of it."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    (k1, k2), (x1, x2), want = chip_smoke.THREEFRY_KAT
    zero = torch.tensor(0)
    got = prng.threefry2x32(zero + k1, zero + k2, zero + x1, zero + x2)
    assert tuple(int(w) for w in got) == want == (0x6B200159, 0x99BA4EFE)
    from jax._src import prng as jprng
    jgot = jprng.threefry_2x32(jnp.uint32([k1, k2]), jnp.uint32([x1, x2]))
    assert tuple(int(w) for w in np.asarray(jgot)) == want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bernoulli_randint_match_reference(seed, shape):
    k, jk = prng.prng_key(seed), jax.random.PRNGKey(seed)
    for lo, hi in ((0.0, 1.0), (0.0, 19.0), (-0.9545, 2.3)):
        got = prng.uniform(k, shape, lo, hi).numpy()
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    np.testing.assert_array_equal(
        prng.bernoulli(k, 0.8, shape).numpy(),
        np.asarray(jax.random.bernoulli(jk, 0.8, shape)))
    for lo, hi in ((0, 1240), (3, 70)):
        got = prng.randint(k, shape, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(jax.random.randint(jk, shape, lo, hi, jnp.int32)))


@pytest.mark.parametrize("span", [65_536, 65_537, 151_936, 256_000])
def test_randint_wide_spans_match_reference(span):
    """Past a span of 2**16 the reference's multiplier, (2**16 mod
    span)**2 mod span taken in uint32, wraps to 0; the port's draws of a
    vocabulary's width (the LM prompts) equal ``jax.random.randint``."""
    for seed in (1, 7):
        got = prng.randint(prng.prng_key(seed), (8, 24), 0, span)
        want = jax.random.randint(jax.random.PRNGKey(seed), (8, 24), 0, span)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_remote_key_adds_to_both_words():
    """``PRNGKey(seed) + uint32(0x9E3779B9)`` adds the constant to both
    words of the key: it is not ``PRNGKey(seed + 0x9E3779B9)``."""
    jkey = jax.random.PRNGKey(42) + jnp.uint32(conn.REMOTE_STREAM)
    key = (prng.prng_key(42) + conn.REMOTE_STREAM) & prng.MASK
    np.testing.assert_array_equal(key.numpy(), _words(jkey))
    assert key.tolist() == [0x9E3779B9, (42 + 0x9E3779B9) & prng.MASK]
    assert key.tolist() != prng.prng_key(42 + 0x9E3779B9).tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_truncated_normal_within_ulp_bound(seed):
    shape = (64, 1024)
    k, jk = prng.prng_key(seed), jax.random.PRNGKey(seed)
    got = prng.truncated_normal(k, -2.0, 2.0, shape).numpy()
    want = np.asarray(jax.random.truncated_normal(jk, -2.0, 2.0, shape))
    ulps = _ulps(got, want)
    print(f"truncated_normal seed {seed}: {int((ulps > 0).sum())} of "
          f"{ulps.size} draws differ, at most {int(ulps.max())} ulp")
    assert int(ulps.max()) <= TN_MAX_ULP
    assert float(got.min()) > -2.0 and float(got.max()) < 2.0
    u = np.linspace(-0.999, 0.999, 4001, dtype=np.float32)
    assert int(_ulps(prng.erf_inv(torch.from_numpy(u)).numpy(),
                     jax.lax.erf_inv(u)).max()) <= TN_MAX_ULP


@pytest.mark.parametrize("col_ids", [list(range(16)), [5, 6, 9, 10, 13, 14]],
                         ids=["grid", "tile"])
def test_keyed_poisson_matches_reference_drive(col_ids):
    """``keyed_poisson_ref`` against the reference's drive on 4x4x64 over
    60 steps, the whole grid and a non-contiguous 2-D tile of it (rows
    1-3, columns 1-2)."""
    jcfg = JCfg(grid_h=4, grid_w=4, neurons_per_column=64, seed=0)
    lam = jcfg.c_ext * jcfg.nu_ext_hz * jcfg.neuron.dt_ms * 1e-3
    jids = jnp.asarray(col_ids, jnp.int32)
    draw = jax.jit(lambda t: jnet.external_drive(jcfg, t, jids)[1])
    ids = torch.tensor(col_ids, dtype=torch.int32)
    bad, total = 0, 60 * len(col_ids) * 64
    for t in range(60):
        got = ref.keyed_poisson_ref(0, t, ids, 64, lam)
        assert got.dtype == torch.float32 and got.shape == (len(col_ids), 64)
        bad += int((got.numpy() != np.asarray(draw(jnp.int32(t)))).sum())
    print(f"drive: {bad} of {total} counts differ from the reference's")
    assert bad <= MAX_DRIVE_MISMATCH * total



@pytest.mark.parametrize("n", [1, 33, 1240, 2049])
def test_keyed_poisson_one_column_matches_reference_drive(n):
    """``keyed_poisson_ref`` against the reference's drive on one column
    of ``n`` neurons (the edge shapes the card's kernel is held to this
    plain version at: one neuron, one warp and one more, the paper's
    column, and one more neuron than one CTA takes), over 5 steps."""
    jcfg = JCfg(grid_h=4, grid_w=4, neurons_per_column=n, seed=42)
    lam = jcfg.c_ext * jcfg.nu_ext_hz * jcfg.neuron.dt_ms * 1e-3
    jids = jnp.asarray([9], jnp.int32)
    ids = torch.tensor([9], dtype=torch.int32)
    bad = 0
    for t in range(5):
        got = ref.keyed_poisson_ref(42, t, ids, n, lam)
        assert got.shape == (1, n)
        want = np.asarray(jnet.external_drive(jcfg, jnp.int32(t), jids)[1])
        bad += int((got.numpy() != want).sum())
    assert bad <= MAX_DRIVE_MISMATCH * 5 * n

@pytest.mark.parametrize("lam", [0.0, 1.62, 5.0, 9.9])
def test_poisson_matches_reference(lam):
    """``prng.poisson`` of one key and of a batch of keys against
    ``jax.random.poisson`` at ``lam`` (every rate in Knuth's branch,
    up to the long chains of 9.9 that the card's drive is checked at),
    and at rates 4.5 and 0."""
    jk = jax.random.PRNGKey(7)
    want = np.asarray(jax.random.poisson(jk, lam, (1240,)))
    got = prng.poisson(prng.prng_key(7), lam, (1240,))
    np.testing.assert_array_equal(got.numpy(), want)
    keys = prng.split(prng.prng_key(7), 3)
    jkeys = jax.random.split(jk, 3)
    for rate in (lam, 4.5):
        np.testing.assert_array_equal(
            prng.poisson(keys, rate, (9, 11)).numpy(),
            np.asarray(jax.vmap(
                lambda k, r=rate: jax.random.poisson(k, r, (9, 11)))(jkeys)))
    assert float(prng.poisson(keys, 0.0, (5,)).abs().sum()) == 0.0
    with pytest.raises(NotImplementedError, match="Knuth"):
        prng.poisson(keys, 12.0, (5,))


def test_chip_smoke_literals_match_reference():
    """The reference's drive counts and remote ``randint`` indices that
    ``chip_smoke.py`` holds the card to, from ``jax.random`` here."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro.configs import dpsnn as jdpsnn
    cfg = jdpsnn.GRID_24
    kat = chip_smoke.DRIVE_KAT
    counts = np.asarray(jnet.external_drive(
        cfg, jnp.int32(kat["t"]), jnp.asarray([kat["col"]], jnp.int32))[1])
    assert counts[0, :len(kat["counts"])].tolist() == kat["counts"]
    assert cfg.seed == kat["seed"]
    kat = chip_smoke.RANDINT_KAT
    idx, _ = jconn.generate_remote_column(cfg, jconn.build_stencil(cfg),
                                          kat["col"])
    assert np.asarray(idx)[kat["row"], :len(kat["idx"])].tolist() == \
        kat["idx"]



def test_chip_smoke_drive_lane_model():
    """``chip_smoke.py``'s model of ``keyed_drive``'s lane work, on one
    column of 40 counts: 33 neurons of one draw, one of five and six of
    three. Rounds of two draws issue two full warps, then one (7 undone),
    then one (1 undone): 256 slots; one thread per neuron issues 32 lanes
    of one draw and 32 of five: 192. The model reads the kernel's own
    constants from its source."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    counts = torch.tensor([[0] * 33 + [4] + [2] * 6])
    assert chip_smoke.drive_lane_slots(counts, 2) == (256, 192)
    assert chip_smoke.drive_lane_slots(counts, 1) == (32 * (2 + 1 + 1 + 1 + 1),
                                                      192)
    assert chip_smoke.kernel_constant("keyed_drive", "DRAWS") >= 1
    assert chip_smoke.kernel_constant("keyed_drive", "SHARE_MAX") >= \
        DPSNNConfig().neurons_per_column

def test_external_drive_on_device_tensors_takes_the_kernel(monkeypatch):
    """On a tensor that is not on the CPU, ``network.external_drive``
    reaches the kernel wrapper's launch and never the plain version: it
    raises on anything but a CUDA tensor, and with the checks and the
    launch stubbed it launches ``keyed_drive`` once with the reference's
    seed word, step and rate."""
    def no_plain(*_args):
        raise AssertionError("keyed_poisson_ref called for a device tensor")
    monkeypatch.setattr(kd, "keyed_poisson_ref", no_plain)
    cfg = DPSNNConfig(grid_h=2, grid_w=3, neurons_per_column=40, seed=9)
    ids = torch.arange(6, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        net.external_drive(cfg, 4, ids)

    calls = []
    monkeypatch.setattr(_build, "check_args", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a))
    cur, counts = net.external_drive(cfg, 4, ids)
    assert cur.shape == counts.shape == (6, 40)
    assert cur.device.type == "meta"
    (name, c_name, _dev, *_ptrs, c, n, seed_word, t, lam, j_ext), = calls
    assert (name, c_name) == ("keyed_drive", "repro_keyed_drive")
    assert (c, n, seed_word, t) == (6, 40, 9 + ref.DRIVE_STREAM, 4)
    assert lam == cfg.c_ext * cfg.nu_ext_hz * cfg.neuron.dt_ms * 1e-3
    assert j_ext == cfg.conn.j_ext
