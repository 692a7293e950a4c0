"""The port's LM layer primitives (``repro_torch/models/layers.py``)
against the reference's ``repro.models.layers`` (one JAX subprocess for
the module, started in the background; inputs from numpy seeds, the
reference's outputs back as ``.npz``): ``rmsnorm`` (float32 and a
bfloat16 input, cast back), ``layernorm``, ``softcap`` at 0 and 50, the
rotary frequencies (to the bit) and ``apply_rope`` at positions up to
32,767 with theta 1e4 and 1e6, ``mlp_apply`` for silu, GeGLU and GELU,
the embedding lookup and tied read-out, and the sinusoidal positions.
Float32, within 1e-6 (rope within 1e-5, as its angles reach 3e4 rad;
the read-out within 1e-5 absolute, a sum of 64 terms near 3; the MLP
within 1e-6 of its sums' terms). In bfloat16, ``silu`` equals
``jax.nn.silu`` bit for bit and ``gelu_tanh`` ``jax.nn.gelu`` to one
unit in the last place (XLA's tanh). Also the port's own draws: ``dense_init``'s truncated normal and
``embed_init``'s normal."""
import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

from repro_torch.models import layers as L


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    before_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before_tf32
    torch.set_num_threads(before)


TOL = dict(rtol=1e-6, atol=1e-6)
ROPE_TOL = dict(rtol=1e-5, atol=1e-5)
ACTS = ("silu", "geglu", "gelu")
THETAS = (1e4, 1e6)
HEAD_DIMS = (16, 64, 128, 256)

JAX_LAYERS = """
import os
# every op rounded to its dtype, as written (bfloat16 activations below)
os.environ['XLA_FLAGS'] += ' --xla_allow_excess_precision=false'
import jax, jax.numpy as jnp, numpy as np
from repro.models import layers as L
rng = np.random.default_rng(5)
x = (rng.standard_normal((2, 7, 64)) * 3).astype(np.float32)
scale = (rng.standard_normal(64) * 0.3).astype(np.float32)
bias = rng.standard_normal(64).astype(np.float32)
table = rng.standard_normal((512, 64)).astype(np.float32)
tokens = rng.integers(0, 512, (3, 9)).astype(np.int32)
pos = np.concatenate([np.arange(8), [255, 4095, 4096, 8191, 16384, 30000,
                                     32766, 32767]]).astype(np.int32)
pos = np.stack([pos, pos[::-1]])
out = dict(x=x, scale=scale, bias=bias, table=table, tokens=tokens, pos=pos)
out['rmsnorm'] = L.rmsnorm({{'scale': scale}}, x)
out['rmsnorm_bf16'] = L.rmsnorm({{'scale': scale}},
                                jnp.asarray(x, jnp.bfloat16)).astype(
                                    jnp.float32)
out['layernorm'] = L.layernorm({{'scale': scale, 'bias': bias}}, x)
for cap in (0.0, 50.0):
    out['softcap_%g' % cap] = L.softcap(x * 20, cap)
for hd in {head_dims!r}:
    xr = rng.standard_normal((2, 16, 3, hd)).astype(np.float32)
    out['rope_x_%d' % hd] = xr
    for theta in {thetas!r}:
        out['freqs_%d_%g' % (hd, theta)] = L.rope_frequencies(hd, theta)
        out['rope_%d_%g' % (hd, theta)] = L.apply_rope(xr, pos, theta)
for i, act in enumerate({acts!r}):
    p = L.mlp_init(jax.random.PRNGKey(i), 64, 128, act, jnp.float32)
    for k, v in p.items():
        out['mlp_%s_%s' % (act, k)] = v
    out['mlp_%s' % act] = L.mlp_apply(p, x, act)
h = jnp.asarray(x, jnp.bfloat16)
out['silu_bf16'] = jax.nn.silu(h).astype(jnp.float32)
out['gelu_bf16'] = jax.nn.gelu(h, approximate=True).astype(jnp.float32)
out['lookup'] = L.embed_lookup({{'table': table}}, tokens)
out['readout'] = L.embed_logits({{'table': table}}, x)
out['sinusoidal'] = L.sinusoidal_positions(50, 64)
np.savez('{out}/layers', **{{k: np.asarray(v) for k, v in out.items()}})
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_lm_layers")
    job = JaxInBackground(JAX_LAYERS.format(
        out=out, head_dims=HEAD_DIMS, thetas=THETAS, acts=ACTS),
        n_devices=1, timeout=600)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def ref(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return {k: torch.from_numpy(v)
            for k, v in np.load(out / "layers.npz").items()}


def close(got, want, **tol):
    torch.testing.assert_close(got, want, **(tol or TOL))


def test_rmsnorm(ref):
    close(L.rmsnorm({"scale": ref["scale"]}, ref["x"]), ref["rmsnorm"])


def test_rmsnorm_casts_back_to_the_input_dtype(ref):
    got = L.rmsnorm({"scale": ref["scale"]}, ref["x"].to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # one bfloat16 rounding of the same float32 value
    close(got.float(), ref["rmsnorm_bf16"], rtol=2 ** -8, atol=1e-6)


def test_layernorm(ref):
    close(L.layernorm({"scale": ref["scale"], "bias": ref["bias"]},
                      ref["x"]), ref["layernorm"])


@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_softcap(ref, cap):
    x = ref["x"] * 20
    got = L.softcap(x, cap)
    close(got, ref[f"softcap_{cap:g}"])
    if not cap:
        assert got is x
    else:
        assert float(got.abs().max()) < cap


@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_rope_frequencies_are_bitwise(ref, hd, theta):
    got = L.rope_frequencies(hd, theta)
    assert torch.equal(got, ref[f"freqs_{hd}_{theta:g}"])


@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_apply_rope_to_position_32767(ref, hd, theta):
    x = ref[f"rope_x_{hd}"]
    got = L.apply_rope(x, ref["pos"], theta)
    close(got, ref[f"rope_{hd}_{theta:g}"], **ROPE_TOL)
    # split halves: position 0 is the identity, and the norm of each
    # (i, i + hd/2) pair is kept
    assert torch.equal(got[0, 0], x[0, 0])
    half = hd // 2
    pair = lambda t: t[..., :half] ** 2 + t[..., half:] ** 2
    close(pair(got), pair(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_mlp_apply(ref, act):
    """Within 1e-6 of the absolute terms of the last product's sums
    (|h| @ |wo|): ``tanh`` rounds differently in an ulp on about half of
    its inputs, and a sum of 128 terms near 10 cancels to values near 0,
    where an ulp of a term is more than 1e-6 of the result."""
    names = ("wi_gate", "wi_up", "wo") if act != "gelu" else ("wi", "wo")
    params = {k: ref[f"mlp_{act}_{k}"] for k in names}
    x = ref["x"]
    got = L.mlp_apply(params, x, act)
    if act == "gelu":
        h = torch.nn.functional.gelu(x @ params["wi"], approximate="tanh")
    else:
        h = L.mlp_apply({**params, "wo": torch.eye(128)}, x, act)
    scale = h.abs() @ params["wo"].abs()
    want = ref[f"mlp_{act}"]
    bound = TOL["atol"] + TOL["rtol"] * torch.maximum(want.abs(), scale)
    assert bool(((got - want).abs() <= bound).all()), float(
        (got - want).abs().max())


def test_embed_lookup_and_readout(ref):
    table = {"table": ref["table"]}
    assert torch.equal(L.embed_lookup(table, ref["tokens"]), ref["lookup"])
    close(L.embed_logits(table, ref["x"]), ref["readout"], rtol=1e-6,
          atol=1e-5)


def test_sinusoidal_positions(ref):
    close(L.sinusoidal_positions(50, 64), ref["sinusoidal"])


def test_dense_init_draws_a_truncated_fan_in_normal():
    g = torch.Generator().manual_seed(3)
    w = L.dense_init(g, 256, (4, 32), "bfloat16")
    assert w.shape == (256, 4, 32) and w.dtype == torch.bfloat16
    std = 256 ** -0.5
    assert float(w.float().abs().max()) <= 3 * std * (1 + 2 ** -8)
    assert abs(float(w.float().std()) / std - 0.986) < 0.03   # truncated
    again = L.dense_init(torch.Generator().manual_seed(3), 256, (4, 32),
                         "bfloat16")
    assert torch.equal(w, again)
    wo = L.dense_init(g, 64, 8, torch.float32, scale=0.5)
    assert wo.dtype == torch.float32 and float(wo.abs().max()) <= 1.5


def test_embed_init_and_the_meta_skeleton():
    table = L.embed_init(torch.Generator().manual_seed(0), 512, 64,
                         "float32")["table"]
    assert abs(float(table.std()) - 1) < 0.02
    meta = L.dense_init(None, 64, 8, "bfloat16", device="meta")
    assert meta.device.type == "meta" and meta.dtype == torch.bfloat16


def test_bfloat16_activations_round_as_the_reference(ref):
    """Every step rounded to bfloat16, as the reference's ops: ``silu``
    to the bit; ``gelu_tanh`` to one unit in the last place, where
    XLA's tanh and torch's may round apart (equal to the bit on this
    draw). Torch's fused ``F.silu`` and ``F.gelu``, rounding once, miss
    on about two elements in five here."""
    h = ref["x"].to(torch.bfloat16)
    assert torch.equal(L.silu(h).float(), ref["silu_bf16"])
    gelu = L.gelu_tanh(h).float()
    want = ref["gelu_bf16"]
    ulp = torch.finfo(torch.bfloat16).eps * want.abs()
    assert bool(((gelu - want).abs() <= ulp).all())
    assert float((gelu != want).float().mean()) < 0.01
    fused = torch.nn.functional.silu(h).float()
    assert float((fused != ref["silu_bf16"]).float().mean()) > 0.1
