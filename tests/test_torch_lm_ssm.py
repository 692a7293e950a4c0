"""The port's Mamba-2 SSD mixer (``repro_torch/models/ssm.py``) against
the reference's ``repro.models.ssm`` (one JAX subprocess for the module,
started in the background; the reference's ``ssd_init`` parameters, with
the zero and one leaves perturbed so that every one counts, inputs from
numpy seeds, outputs and caches back as ``.npz``), float32 within
1e-5: ``ssd_apply`` over 4 chunks (the inter-chunk scan, which the
reference writes as ``jax.lax.associative_scan`` and the port as a loop
over the chunks), ``ssd_apply(return_state=True)``'s final state and
conv tail, ``ssd_decode`` over 32 steps (every output and the final
cache) under ``jax.jit``, and ``softplus``. The port's own chunked
output equals its recurrent one within the reference test's 2e-4, its
prefill state the decode state within 5e-4; a length that is not whole
chunks raises ``ValueError``. In bfloat16, the reduced mamba2-780m's
``forward`` and decode logits against the reference's bfloat16 run of
the same parameters, within a relative error that the float32 path run
in bfloat16's place exceeds (:data:`BF16_REL`)."""
import dataclasses

import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

import repro_torch.configs as C
from repro_torch import convert
from repro_torch.configs.base import SSMConfig
from repro_torch.models import ssm as S
from repro_torch.models.model import build_model, decode_all


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


SCFG = dict(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8)
D_MODEL, B, T = 32, 2, 32
TOL = dict(rtol=1e-5, atol=1e-5)
MAMBA = "mamba2-780m"
MB, MS = 2, 48
# bfloat16: the limit on |port - reference| / |reference| over all
# logits of the reduced mamba2 (forward and 48 decode steps). Readings on
# this file's draw: forward 1.97e-3, decode 1.97e-3; the float32 path run
# in bfloat16's place 1.08e-2 and 1.04e-2 (as the control test asserts).
# One mixer on the same bfloat16 input is bitwise the reference's but for
# the rare last-bit differences of the in_proj product (5.6e-5 relative
# after layer 0, 1e-8 in in_proj: the two libraries sum in another
# order), which the four layers grow to 1.8e-3.
BF16_REL = 4e-3

JAX_SSM = """
import dataclasses, os
os.environ['XLA_FLAGS'] += ' --xla_allow_excess_precision=false'
import jax, jax.numpy as jnp, numpy as np
import repro.configs as C
from repro.configs.base import SSMConfig
from repro.models import ssm as S
from repro.models.model import build_model

def flat(tree, prefix=''):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {{prefix: np.asarray(tree)}}
    out = {{}}
    for k, v in items:
        out.update(flat(v, '%s.%s' % (prefix, k) if prefix else str(k)))
    return out

out = {{}}
scfg = SSMConfig(**{scfg!r})
p = S.ssd_init(jax.random.PRNGKey(3), scfg, {d}, jnp.float32)
rng = np.random.default_rng(7)
f32 = np.float32
p['conv_b'] = (rng.standard_normal(p['conv_b'].shape) * 0.1).astype(f32)
p['dt_bias'] = (rng.standard_normal(p['dt_bias'].shape) * 0.5).astype(f32)
p['d_skip'] = (1 + rng.standard_normal(p['d_skip'].shape) * 0.2).astype(f32)
p['gate_norm']['scale'] = (rng.standard_normal(
    p['gate_norm']['scale'].shape) * 0.1).astype(f32)
x = (rng.standard_normal(({b}, {t}, {d})) * 0.5).astype(f32)
out.update({{'param.' + k: v for k, v in flat(p).items()}})
out['x'] = x
out['apply'] = S.ssd_apply(p, scfg, {d}, x)
_, (out['state'], out['conv_tail']) = S.ssd_apply(p, scfg, {d}, x,
                                                  return_state=True)
decode = jax.jit(lambda p, x, c: S.ssd_decode(p, scfg, {d}, x, c))
cache = S.ssm_cache_init({b}, scfg, {d}, jnp.float32)
ys = []
for t in range({t}):
    y, cache = decode(p, x[:, t:t + 1], cache)
    ys.append(y)
out['decode'] = np.concatenate(ys, axis=1)
out['decode_state'], out['decode_conv'] = cache.state, cache.conv_buf
v = np.concatenate([np.linspace(-120, 120, 481),
                    rng.standard_normal(500) * 6]).astype(f32)
out['softplus_in'], out['softplus'] = v, jax.nn.softplus(v)

cfg = dataclasses.replace(C.reduced_config('{mamba}'), dtype='bfloat16')
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(30))
toks = np.random.default_rng(130).integers(
    0, cfg.vocab_size, ({mb}, {ms})).astype(np.int32)
for k, v in flat(params).items():
    if v.dtype == jnp.bfloat16:
        out['bf16.param16.' + k] = v.view(np.uint16)
    else:
        out['bf16.param.' + k] = v
out['bf16.tokens'] = toks
logits, _, _ = model.forward(params, {{'tokens': toks}})
out['bf16.forward'] = logits.astype(jnp.float32)
decode = jax.jit(model.decode)
caches = model.cache_init({mb}, {ms})
steps = []
for t in range({ms}):
    lg, caches = decode(params, caches, toks[:, t:t + 1], jnp.int32(t))
    steps.append(lg.astype(jnp.float32))
out['bf16.decode'] = np.concatenate(steps, axis=1)
np.savez('{out}/ssm', **{{k: np.asarray(v) for k, v in out.items()}})
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_lm_ssm")
    job = JaxInBackground(JAX_SSM.format(
        out=out, scfg=SCFG, d=D_MODEL, b=B, t=T, mamba=MAMBA, mb=MB, ms=MS),
        n_devices=1, timeout=900)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def ref(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return dict(np.load(out / "ssm.npz"))


@pytest.fixture(scope="module")
def mixer(ref):
    """(the reference's parameters as tensors, its input)."""
    tree = convert.lm_unflatten({k[len("param."):]: v for k, v in ref.items()
                                 if k.startswith("param.")})
    params = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                  if isinstance(v, dict) else torch.from_numpy(v))
              for k, v in tree.items()}
    return params, torch.from_numpy(ref["x"])


def want(ref, name):
    return torch.from_numpy(ref[name])


def test_ssd_apply_matches_jax(ref, mixer):
    params, x = mixer
    with torch.no_grad():
        y = S.ssd_apply(params, SSMConfig(**SCFG), D_MODEL, x)
    assert y.shape == (B, T, D_MODEL)
    torch.testing.assert_close(y, want(ref, "apply"), **TOL)


def test_ssd_apply_return_state_matches_jax(ref, mixer):
    """The final state (B, H, N, P) after 4 chunks and the last d_conv - 1
    pre-activation conv inputs."""
    params, x = mixer
    with torch.no_grad():
        y, (state, tail) = S.ssd_apply(params, SSMConfig(**SCFG), D_MODEL, x,
                                       return_state=True)
    torch.testing.assert_close(y, want(ref, "apply"), **TOL)
    assert state.shape == (B, 4, 16, 16) and state.dtype == torch.float32
    torch.testing.assert_close(state, want(ref, "state"), **TOL)
    torch.testing.assert_close(tail, want(ref, "conv_tail"), **TOL)


def test_ssd_decode_steps_match_jax(ref, mixer):
    params, x = mixer
    scfg = SSMConfig(**SCFG)
    cache = S.ssm_cache_init(B, scfg, D_MODEL, "float32")
    ys = []
    with torch.no_grad():
        for t in range(T):
            y, cache = S.ssd_decode(params, scfg, D_MODEL, x[:, t:t + 1],
                                    cache)
            ys.append(y)
    torch.testing.assert_close(torch.cat(ys, dim=1), want(ref, "decode"),
                               **TOL)
    torch.testing.assert_close(cache.state, want(ref, "decode_state"), **TOL)
    torch.testing.assert_close(cache.conv_buf, want(ref, "decode_conv"),
                               **TOL)


def test_softplus_matches_jax(ref):
    """``logaddexp(x, 0)``, large arguments included."""
    got = S.softplus(want(ref, "softplus_in"))
    torch.testing.assert_close(got, want(ref, "softplus"), rtol=1e-6,
                               atol=1e-7)


def own_mixer(scfg, d_model, seed):
    g = torch.Generator().manual_seed(seed)
    return S.ssd_init(g, scfg, d_model, "float32")


def test_chunked_equals_recurrent():
    """The reference test's case (``tests/test_models.py``) on the port's
    own draw: the chunked form equals the recurrent one within 2e-4."""
    scfg = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8)
    p = own_mixer(scfg, 32, 3)
    x = torch.randn(2, 32, 32, generator=torch.Generator().manual_seed(4)) * .5
    with torch.no_grad():
        y_chunk = S.ssd_apply(p, scfg, 32, x)
        cache = S.ssm_cache_init(2, scfg, 32, "float32")
        ys = []
        for t in range(32):
            yt, cache = S.ssd_decode(p, scfg, 32, x[:, t:t + 1], cache)
            ys.append(yt)
    torch.testing.assert_close(y_chunk, torch.cat(ys, dim=1), rtol=2e-4,
                               atol=2e-4)


def test_prefill_state_matches_decode_state():
    """The reference test's second case: the state after a chunked
    prefill is the recurrent one, within 5e-4."""
    scfg = SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=8, chunk=8)
    p = own_mixer(scfg, 16, 5)
    x = torch.randn(1, 24, 16, generator=torch.Generator().manual_seed(6)) * .5
    with torch.no_grad():
        _, (state, tail) = S.ssd_apply(p, scfg, 16, x, return_state=True)
        cache = S.ssm_cache_init(1, scfg, 16, "float32")
        for t in range(24):
            _, cache = S.ssd_decode(p, scfg, 16, x[:, t:t + 1], cache)
    torch.testing.assert_close(state, cache.state, rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(tail, cache.conv_buf)


def test_length_not_whole_chunks_raises():
    scfg = SSMConfig(**SCFG)
    p = own_mixer(scfg, D_MODEL, 0)
    with pytest.raises(ValueError, match="sequence of 12 is not a multiple "
                                         "of the chunk 8"):
        S.ssd_apply(p, scfg, D_MODEL, torch.zeros(1, 12, D_MODEL))
    cfg = C.reduced_config(MAMBA)
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="multiple of the chunk 16"):
        model.forward(model.init(), {"tokens": torch.zeros(1, 20, dtype=int)})


def bf16_logits(ref, dtype):
    import ml_dtypes
    flat = {}
    for key, v in ref.items():
        if key.startswith("bf16.param16."):
            flat[key[len("bf16.param16."):]] = v.view(ml_dtypes.bfloat16)
        elif key.startswith("bf16.param."):
            flat[key[len("bf16.param."):]] = v
    if dtype == "float32":
        flat = {k: v.astype(np.float32) for k, v in flat.items()}
    cfg = dataclasses.replace(C.reduced_config(MAMBA), dtype=dtype)
    model = build_model(cfg, device="cpu")
    params = convert.lm_params_from_numpy(cfg, convert.lm_unflatten(flat),
                                          "cpu")
    toks = torch.from_numpy(ref["bf16.tokens"])
    with torch.no_grad():
        fwd, _, _ = model.forward(params, {"tokens": toks})
        dec, _ = decode_all(model, params, toks)
    return fwd, dec


def rel_err(got, want):
    return float((got.float() - want).norm() / want.norm())


def test_bfloat16_logits_match_jax(ref):
    fwd, dec = bf16_logits(ref, "bfloat16")
    assert fwd.dtype == dec.dtype == torch.bfloat16
    assert rel_err(fwd, want(ref, "bf16.forward")) < BF16_REL
    assert rel_err(dec, want(ref, "bf16.decode")) < BF16_REL


def test_bfloat16_limit_rejects_the_float32_path(ref):
    """The control of BF16_REL: the same parameters run in float32 in
    bfloat16's place miss it."""
    fwd, dec = bf16_logits(ref, "float32")
    assert rel_err(fwd, want(ref, "bf16.forward")) > 1.5 * BF16_REL
    assert rel_err(dec, want(ref, "bf16.decode")) > 1.5 * BF16_REL
