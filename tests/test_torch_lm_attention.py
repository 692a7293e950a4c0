"""The port's LM attention (``repro_torch/models/attention.py``) against
the reference's ``repro.models.attention`` (one JAX subprocess for the
module, started in the background; inputs and qk-norm scales from numpy
seeds, the reference's parameters, outputs and caches back as
``.npz``), float32 within 1e-5: ``_sdpa`` with GQA, soft-cap, causal and
window masks; ``_blockwise_attn`` with both block lengths shrunk to 64,
for the reference test's three (causal, window) cases and a soft-capped
one; ``attn_apply`` (GQA, MHA, qk-norm with theta 1e6 and a soft-cap)
on the direct and the blockwise path; and ``attn_decode`` over 80 steps
on a global cache of 80 and on a rolling cache of 32, past its wrap,
every step's output and the final caches (the reference's step under
``jax.jit``, as its serving loop runs it). Also the port's own: GQA
grouping, the in-place cache, and the ``ValueError``\\ s where the
reference asserts or clamps."""
import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

from repro_torch.configs.base import AttnConfig
from repro_torch.models import attention as A


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


TOL = dict(rtol=1e-5, atol=1e-5)
MASKS = ((True, 0), (True, 7), (False, 0))
BLOCKS = ((True, 0, 0.0), (True, 37, 0.0), (False, 0, 0.0), (True, 37, 50.0))
CFGS = {
    "gqa": AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16),
    "mha": AttnConfig(num_heads=4, num_kv_heads=4, head_dim=16),
    "qknorm_cap": AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16,
                             rope_theta=1e6, qk_norm=True,
                             logit_softcap=50.0),
}
DECODES = (("global", 0, 80), ("rolling", 32, 32))
STEPS = 80
D_MODEL = 64

JAX_ATTN = """
import jax, jax.numpy as jnp, numpy as np
import repro.models.attention as A
from repro.configs.base import AttnConfig
rng = np.random.default_rng(11)
f32 = np.float32
out = {{}}
b, s, hq, hkv, hd = 2, 24, 4, 2, 16
q = (rng.standard_normal((b, s, hq, hd)) * 4).astype(f32)
k = rng.standard_normal((b, s, hkv, hd)).astype(f32)
v = rng.standard_normal((b, s, hkv, hd)).astype(f32)
pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
out.update(q=q, k=k, v=v)
for causal, window in {masks!r}:
    mask = A._mask(pos, pos, causal=causal, window=window)
    for cap in (0.0, 50.0):
        out['sdpa_%d_%d_%g' % (causal, window, cap)] = A._sdpa(
            q, k, v, mask, softcap_val=cap)
sb = 256
qb = rng.standard_normal((b, sb, hq, hd)).astype(f32)
kb = rng.standard_normal((b, sb, hkv, hd)).astype(f32)
vb = rng.standard_normal((b, sb, hkv, hd)).astype(f32)
posb = np.broadcast_to(np.arange(sb, dtype=np.int32), (b, sb))
out.update(qb=qb, kb=kb, vb=vb)
A.BLOCK_Q, A.BLOCK_K = 64, 64
for causal, window, cap in {blocks!r}:
    out['block_%d_%d_%g' % (causal, window, cap)] = A._blockwise_attn(
        qb, kb, vb, posb, posb, causal=causal, window=window,
        softcap_val=cap)
cfgs = {cfgs}
x = rng.standard_normal((b, s, {d})).astype(f32)
xl = rng.standard_normal((b, 128, {d})).astype(f32)
xs = rng.standard_normal(({steps}, b, 1, {d})).astype(f32)
out.update(x=x, xl=xl, xs=xs)
posl = np.broadcast_to(np.arange(128, dtype=np.int32), (b, 128))
decode = jax.jit(A.attn_decode, static_argnums=1, static_argnames='window')
for i, (name, cfg) in enumerate(cfgs.items()):
    p = A.attn_init(jax.random.PRNGKey(i), cfg, {d}, jnp.float32)
    if cfg.qk_norm:
        for n in ('q_norm', 'k_norm'):
            p[n] = {{'scale': (rng.standard_normal(hd) * 0.3).astype(f32)}}
    for leaf in ('wq', 'wk', 'wv', 'wo'):
        out['p_%s_%s' % (name, leaf)] = p[leaf]
    if cfg.qk_norm:
        out['p_%s_q_norm' % name] = p['q_norm']['scale']
        out['p_%s_k_norm' % name] = p['k_norm']['scale']
    for causal, window in {masks!r}:
        out['apply_%s_%d_%d' % (name, causal, window)] = A.attn_apply(
            p, cfg, x, pos, causal=causal, window=window)
    out['apply_long_%s' % name] = A.attn_apply(p, cfg, xl, posl, window=37)
    for dname, window, s_cache in {decodes!r}:
        cache = A.cache_init(b, s_cache, cfg, hd, jnp.float32)
        outs = []
        for t in range({steps}):
            o, cache = decode(p, cfg, xs[t], cache, t, window=window)
            outs.append(o)
        out['decode_%s_%s' % (name, dname)] = np.stack(outs)
        out['cache_%s_%s_k' % (name, dname)] = cache.k
        out['cache_%s_%s_v' % (name, dname)] = cache.v
np.savez('{out}/attn', **{{k: np.asarray(v) for k, v in out.items()}})
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_lm_attn")
    cfgs = "{" + ", ".join(f"{n!r}: AttnConfig(num_heads={c.num_heads}, "
                           f"num_kv_heads={c.num_kv_heads}, head_dim="
                           f"{c.head_dim}, rope_theta={c.rope_theta}, "
                           f"qk_norm={c.qk_norm}, logit_softcap="
                           f"{c.logit_softcap})"
                           for n, c in CFGS.items()) + "}"
    job = JaxInBackground(JAX_ATTN.format(
        out=out, masks=MASKS, blocks=BLOCKS, cfgs=cfgs, d=D_MODEL,
        steps=STEPS, decodes=DECODES), n_devices=1, timeout=600)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def ref(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return {k: torch.from_numpy(v)
            for k, v in np.load(out / "attn.npz").items()}


@pytest.fixture
def blocks_of_64(monkeypatch):
    monkeypatch.setattr(A, "BLOCK_Q", 64)
    monkeypatch.setattr(A, "BLOCK_K", 64)


def params(ref, name):
    p = {leaf: ref[f"p_{name}_{leaf}"] for leaf in ("wq", "wk", "wv", "wo")}
    if CFGS[name].qk_norm:
        for n in ("q_norm", "k_norm"):
            p[n] = {"scale": ref[f"p_{name}_{n}"]}
    return p


def positions(b, s):
    return torch.arange(s, dtype=torch.int32).expand(b, s)


@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("causal,window", MASKS)
def test_sdpa(ref, causal, window, cap):
    pos = positions(2, 24)
    mask = A._mask(pos, pos, causal=causal, window=window)
    got = A._sdpa(ref["q"], ref["k"], ref["v"], mask, softcap_val=cap)
    torch.testing.assert_close(
        got, ref[f"sdpa_{int(causal)}_{window}_{cap:g}"], **TOL)


@pytest.mark.parametrize("causal,window,cap", BLOCKS)
def test_blockwise_attention(ref, blocks_of_64, causal, window, cap):
    """Blocks of 64 over 256 positions (4 x 4 blocks), against the
    reference's blockwise form and the port's own direct one."""
    pos = positions(2, 256)
    got = A._blockwise_attn(ref["qb"], ref["kb"], ref["vb"], pos, pos,
                            causal=causal, window=window, softcap_val=cap)
    torch.testing.assert_close(
        got, ref[f"block_{int(causal)}_{window}_{cap:g}"], **TOL)
    mask = A._mask(pos, pos, causal=causal, window=window)
    direct = A._sdpa(ref["qb"], ref["kb"], ref["vb"], mask, softcap_val=cap)
    torch.testing.assert_close(got, direct, **TOL)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("name", CFGS)
def test_attn_apply(ref, name, causal, window):
    got = A.attn_apply(params(ref, name), CFGS[name], ref["x"],
                       positions(2, 24), causal=causal, window=window)
    torch.testing.assert_close(
        got, ref[f"apply_{name}_{int(causal)}_{window}"], **TOL)


@pytest.mark.parametrize("name", CFGS)
def test_attn_apply_blockwise(ref, blocks_of_64, name):
    """128 positions past a BLOCK_Q of 64 take the blockwise path."""
    got = A.attn_apply(params(ref, name), CFGS[name], ref["xl"],
                       positions(2, 128), window=37)
    torch.testing.assert_close(got, ref[f"apply_long_{name}"], **TOL)


@pytest.mark.parametrize("dname,window,s_cache", DECODES)
@pytest.mark.parametrize("name", CFGS)
def test_attn_decode(ref, name, dname, window, s_cache):
    """80 steps: the rolling cache of 32 wraps at steps 32 and 64."""
    cfg, p = CFGS[name], params(ref, name)
    cache = A.cache_init(2, s_cache, cfg, 16, torch.float32)
    outs = []
    for t in range(STEPS):
        out, new = A.attn_decode(p, cfg, ref["xs"][t], cache, t,
                                 window=window)
        assert new is cache                  # written in place
        outs.append(out)
    torch.testing.assert_close(torch.stack(outs),
                               ref[f"decode_{name}_{dname}"], **TOL)
    torch.testing.assert_close(cache.k, ref[f"cache_{name}_{dname}_k"],
                               **TOL)
    torch.testing.assert_close(cache.v, ref[f"cache_{name}_{dname}_v"],
                               **TOL)


def test_query_head_h_reads_kv_head_h_over_group():
    """GQA: with 6 query heads over 2 kv heads, heads 0-2 read kv head 0
    and heads 3-5 kv head 1 (``q.reshape(b, s, hkv, group, hd)``)."""
    b, s, hd = 1, 5, 4
    q = torch.randn(b, s, 6, hd)
    k = torch.randn(b, s, 2, hd)
    v = torch.stack([torch.full((b, s, hd), 1.0),
                     torch.full((b, s, hd), 2.0)], dim=2)
    pos = positions(b, s)
    out = A._sdpa(q, k, v, A._mask(pos, pos, causal=True, window=0),
                  softcap_val=0.0)
    torch.testing.assert_close(out[:, :, :3], torch.ones(b, s, 3, hd))
    torch.testing.assert_close(out[:, :, 3:], torch.full((b, s, 3, hd), 2.0))


def test_bfloat16_logits_are_float32():
    """In a bfloat16 model q and k are upcast before the product: the
    logits equal those of float32 copies of the same bfloat16 values."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 9, h, 16, generator=g).to(torch.bfloat16)
               for h in (4, 2, 2))
    pos = positions(2, 9)
    mask = A._mask(pos, pos, causal=True, window=0)
    got = A._sdpa(q, k, v, mask, softcap_val=50.0)
    assert got.dtype == torch.bfloat16
    want = A._sdpa(q.float(), k.float(), v, mask, softcap_val=50.0)
    assert torch.equal(got, want)


def test_blockwise_refuses_a_ragged_block(blocks_of_64):
    q = torch.zeros(1, 100, 2, 8)
    pos = positions(1, 100)
    with pytest.raises(ValueError, match="not whole blocks of 64"):
        A._blockwise_attn(q, q, q, pos, pos, causal=True, window=0,
                          softcap_val=0.0)


def test_decode_past_a_global_cache_raises():
    """The reference's ``dynamic_update_slice`` would clamp position 8 to
    slot 7 of an 8-slot cache and overwrite it; the port refuses, naming
    the cache's length. A rolling cache wraps instead."""
    cfg = CFGS["gqa"]
    g = torch.Generator().manual_seed(1)
    p = A.attn_init(g, cfg, D_MODEL, torch.float32)
    x = torch.randn(2, 1, D_MODEL, generator=g)
    cache = A.cache_init(2, 8, cfg, 16, torch.float32)
    with pytest.raises(ValueError, match="past the global cache of 8 slots"):
        A.attn_decode(p, cfg, x, cache, 8)
    A.attn_decode(p, cfg, x, cache, 8, window=8)      # slot 0 of 8
    assert bool(cache.k[:, 0].abs().sum() > 0)
