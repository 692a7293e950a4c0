"""The port's decoder-only LMs (``repro_torch/models/model.py`` and
``transformer.py``) against the reference's ``repro.models.model`` for
the reduced qwen3-0.6b, granite-3-2b, gemma2-9b, gemma2-27b and
internvl2-1b (one JAX subprocess for the module, started in the
background): the reference's ``model.init`` parameters come across
through ``convert.lm_params_from_numpy``, tokens and patches from numpy
seeds, and within 1e-4 in float32 the ``forward`` logits, the
``prefill_logits`` (internvl2 over 8 patches), 48 teacher-forced decode
steps (past gemma2's reduced window of 32, so its rolling caches wrap)
and the final caches agree; the greedy tokens of a ``serve_decode``-shaped
loop (batch 2, prompt 8, 16 generated; the reference's step under
``jax.jit``) are equal; the port's own decode equals its forward within
the reference test's 2e-2; the converters round-trip bit-exact and
check every leaf. In bfloat16, qwen3-0.6b and gemma2-9b: the
``forward`` and decode logits against the reference's bfloat16 run of
the same carried-in parameters, within a relative error that the
float32 path run in bfloat16's place exceeds (:data:`BF16_REL`). Also
``build_model`` over all ten published configs on the ``meta`` device,
every leaf's path, shape and dtype those of the reference's
``jax.eval_shape`` of its ``init`` at full width, and its device."""
import dataclasses
import json

import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

import repro_torch.configs as C
from repro_torch import convert
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model, decode_all, greedy


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


ARCHS = ("qwen3-0.6b", "granite-3-2b", "gemma2-9b", "gemma2-27b",
         "internvl2-1b")
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, PATCHES = 2, 48, 8
SERVE_B, PROMPT, GEN = 2, 8, 16
# bfloat16: the archs, and the limit on |port - reference| / |reference|
# over all logits. Readings on this file's draws, forward and decode
# alike: qwen3 3.7e-4, gemma2 2.2e-4 (2.1e-3 on another draw). What it
# rejects, on that other draw (qwen3, gemma2): the float32 path 8.0e-3,
# 6.0e-3 (here 8.3e-3, 6.1e-3, as the control test asserts); q and k
# left in bfloat16 for the scores 9.4e-3, 5.7e-3; the probabilities
# left in float32 9.3e-3, 5.4e-3; F.silu / F.gelu rounding once 9.0e-3,
# 5.2e-3; the residual stream in float32 (forward) 9.6e-3, 6.9e-3.
BF16_ARCHS = ("qwen3-0.6b", "gemma2-9b")
BF16_REL = 3e-3

JAX_MODELS = """
import dataclasses, os
# bfloat16 as the reference writes it: every op rounded to its dtype.
# Without this flag XLA on the CPU keeps float32 across the elementwise
# ops it fuses, a compiler's choice that op-by-op torch cannot follow;
# float32 results do not depend on it.
os.environ['XLA_FLAGS'] += ' --xla_allow_excess_precision=false'
import jax, jax.numpy as jnp, numpy as np
import repro.configs as C
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

for i, arch in enumerate({archs!r}):
    cfg = C.reduced_config(arch)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(i))
    rng = np.random.default_rng(100 + i)
    toks = rng.integers(0, cfg.vocab_size, ({b}, {s})).astype(np.int32)
    out = {{'param.' + k: v for k, v in flat(params).items()}}
    out['tokens'] = toks
    batch = {{'tokens': toks}}
    if cfg.family == 'vlm':
        patches = rng.standard_normal(({b}, {patches}, cfg.d_model)).astype(
            np.float32)
        batch = {{'patches': patches, 'tokens': toks[:, {patches}:]}}
        out['patches'] = patches
    out['forward'], _, _ = model.forward(params, batch)
    out['prefill'] = model.prefill_logits(params, batch)
    decode = jax.jit(model.decode)
    caches = model.cache_init({b}, {s})
    steps = []
    for t in range({s}):
        lg, caches = decode(params, caches, toks[:, t:t + 1], jnp.int32(t))
        steps.append(lg)
    out['decode'] = np.concatenate(steps, axis=1)
    for slot, c in enumerate(caches):
        out['cache.%d.k' % slot], out['cache.%d.v' % slot] = c.k, c.v

    @jax.jit
    def step(params, caches, tok, pos):
        logits, caches = model.decode(params, caches, tok, pos)
        return logits[:, -1].argmax(-1)[:, None].astype(jnp.int32), caches

    prompts = rng.integers(0, cfg.vocab_size, ({sb}, {prompt})).astype(
        np.int32)
    caches = model.cache_init({sb}, {prompt} + {gen})
    tok, gen = prompts[:, :1], []
    for pos in range({prompt} + {gen} - 1):
        nxt, caches = step(params, caches, tok, jnp.int32(pos))
        if pos + 1 < {prompt}:
            tok = prompts[:, pos + 1:pos + 2]
        else:
            tok = nxt
            gen.append(nxt)
    out['prompts'] = prompts
    out['greedy'] = np.concatenate(gen, axis=1)
    np.savez('{out}/%s' % arch, **{{k: np.asarray(v) for k, v in out.items()}})

for i, arch in enumerate({bf16_archs!r}):
    cfg = dataclasses.replace(C.reduced_config(arch), dtype='bfloat16')
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(50 + i))
    toks = np.random.default_rng(150 + i).integers(
        0, cfg.vocab_size, ({b}, {s})).astype(np.int32)
    out = {{'tokens': toks}}
    for k, v in flat(params).items():
        if v.dtype == jnp.bfloat16:
            out['param16.' + k] = v.view(np.uint16)
        else:
            out['param.' + k] = v
    logits, _, _ = model.forward(params, {{'tokens': toks}})
    out['forward'] = logits.astype(jnp.float32)
    decode = jax.jit(model.decode)
    caches = model.cache_init({b}, {s})
    steps = []
    for t in range({s}):
        lg, caches = decode(params, caches, toks[:, t:t + 1], jnp.int32(t))
        steps.append(lg.astype(jnp.float32))
    out['decode'] = np.concatenate(steps, axis=1)
    np.savez('{out}/bf16-%s' % arch,
             **{{k: np.asarray(v) for k, v in out.items()}})

def shapes(tree, prefix=''):
    if tree is None:
        return {{}}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {{prefix: [list(tree.shape), str(tree.dtype)]}}
    out = {{}}
    for k, v in items:
        out.update(shapes(v, '%s.%s' % (prefix, k) if prefix else str(k)))
    return out

import json
with open('{out}/full_shapes.json', 'w') as f:
    json.dump({{arch: shapes(jax.eval_shape(
        build_model(C.get_config(arch)).init, jax.random.PRNGKey(0)))
        for arch in C.ARCH_IDS}}, f)
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_lm_models")
    job = JaxInBackground(JAX_MODELS.format(
        out=out, archs=ARCHS, bf16_archs=BF16_ARCHS, b=B, s=S, patches=PATCHES, sb=SERVE_B,
        prompt=PROMPT, gen=GEN), n_devices=1, timeout=900)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def jax_models(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return {arch: dict(np.load(out / f"{arch}.npz"))
            for arch in ARCHS + tuple(f"bf16-{a}" for a in BF16_ARCHS)}


class Case:
    """One arch: the reference's arrays and the port's model and params
    (the reference's, carried in)."""

    def __init__(self, arch, ref):
        self.cfg = C.reduced_config(arch)
        self.ref = ref
        self.tree = convert.lm_unflatten({k[len("param."):]: v
                                        for k, v in ref.items()
                                        if k.startswith("param.")})
        self.model = build_model(self.cfg, device="cpu")
        self.params = convert.lm_params_from_numpy(self.cfg, self.tree,
                                                   "cpu")
        toks = torch.from_numpy(ref["tokens"])
        self.tokens = toks
        if self.cfg.family == "vlm":
            self.batch = {"patches": torch.from_numpy(ref["patches"]),
                          "tokens": toks[:, PATCHES:]}
        else:
            self.batch = {"tokens": toks}

    def want(self, name):
        return torch.from_numpy(self.ref[name])



@pytest.fixture(scope="module")
def cases(jax_models):
    return {arch: Case(arch, jax_models[arch]) for arch in ARCHS}


@pytest.fixture(scope="module")
def decoded(cases):
    with torch.no_grad():
        return {arch: decode_all(case.model, case.params, case.tokens)
                for arch, case in cases.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(cases, arch):
    case = cases[arch]
    with torch.no_grad():
        logits, aux, hidden = case.model.forward(case.params, case.batch)
    assert logits.shape == (B, S, case.cfg.vocab_size)
    assert hidden.shape == (B, S, case.cfg.d_model)
    assert float(aux[0]) == float(aux[1]) == 0.0
    torch.testing.assert_close(logits, case.want("forward"), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(cases, arch):
    case = cases[arch]
    with torch.no_grad():
        got = case.model.prefill_logits(case.params, case.batch)
    assert got.shape == (B, 1, case.cfg.vocab_size)
    torch.testing.assert_close(got, case.want("prefill"), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(cases, decoded, arch):
    """48 teacher-forced steps; gemma2's local caches hold the last 32."""
    case = cases[arch]
    logits, _ = decoded[arch]
    torch.testing.assert_close(logits, case.want("decode"), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_final_caches_match_jax(cases, decoded, arch):
    case = cases[arch]
    _, caches = decoded[arch]
    got = convert.lm_cache_to_numpy(case.cfg, caches)
    gsize = T._group_layout(case.cfg)[0]
    assert len(got) == gsize
    for slot, (k, v) in enumerate(got):
        np.testing.assert_allclose(k, case.ref[f"cache.{slot}.k"], **TOL)
        np.testing.assert_allclose(v, case.ref[f"cache.{slot}.v"], **TOL)
    sizes = [c.k.shape[1] for c in caches]
    window = case.cfg.attn.sliding_window
    assert sizes == [min(window, S) if window and layer % 2 == 0 else S
                     for layer in range(case.cfg.num_layers)]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward(cases, decoded, arch):
    """The port's own KV cache against its own forward, at the
    reference test's tolerance (``tests/test_models.py``); internvl2's
    forward here has no patches."""
    case = cases[arch]
    with torch.no_grad():
        if case.cfg.family == "vlm":
            batch = {"patches": torch.zeros(B, 0, case.cfg.d_model),
                     "tokens": case.tokens}
        else:
            batch = {"tokens": case.tokens}
        full, _, _ = case.model.forward(case.params, batch)
    torch.testing.assert_close(decoded[arch][0], full, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_jax(cases, arch):
    """The loop of ``examples/serve_decode.py``: the prompt
    teacher-forced through ``decode``, then greedy generation."""
    case = cases[arch]
    prompts = torch.from_numpy(case.ref["prompts"])
    with torch.no_grad():
        gen, _ = greedy(case.model, case.params, prompts, GEN)
    assert gen.shape == (SERVE_B, GEN)
    assert torch.equal(gen, case.want("greedy"))


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_round_trips_bit_exact(cases, arch):
    case = cases[arch]
    back = convert.lm_params_to_numpy(case.params)
    got, want = convert.lm_flatten(back), convert.lm_flatten(case.tree)
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        assert got[path].tobytes() == leaf.tobytes(), path
    names = [n for n, _ in case.params.named_parameters()]
    assert names[0] == "embed.table"
    assert f"layers.{case.cfg.num_layers - 1}.mlp.wo" in names
    assert ("adapter.proj" in names) == (case.cfg.family == "vlm")
    caches = convert.lm_cache_from_numpy(
        case.cfg, [(case.ref[f"cache.{s}.k"], case.ref[f"cache.{s}.v"])
                   for s in range(T._group_layout(case.cfg)[0])], "cpu")
    for slot, (k, v) in enumerate(convert.lm_cache_to_numpy(case.cfg,
                                                            caches)):
        assert k.tobytes() == case.ref[f"cache.{slot}.k"].tobytes()
        assert v.tobytes() == case.ref[f"cache.{slot}.v"].tobytes()


def test_converter_names_a_missing_extra_or_wrong_leaf(cases):
    case = cases["qwen3-0.6b"]
    tree = convert.lm_unflatten(convert.lm_flatten(case.tree))
    del tree["groups"][0]["attn"]["q_norm"]
    with pytest.raises(KeyError, match=r"groups\.0\.attn\.q_norm\.scale"):
        convert.lm_params_from_numpy(case.cfg, tree, "cpu")
    tree = convert.lm_unflatten(convert.lm_flatten(case.tree))
    tree["groups"][0]["attn"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match=r"groups\.0\.attn\.bias"):
        convert.lm_params_from_numpy(case.cfg, tree, "cpu")
    tree = convert.lm_unflatten(convert.lm_flatten(case.tree))
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"].astype(
        np.float64)
    with pytest.raises(ValueError, match=r"final_norm\.scale is float64"):
        convert.lm_params_from_numpy(case.cfg, tree, "cpu")
    tree = convert.lm_unflatten(convert.lm_flatten(case.tree))
    tree["groups"][0]["mlp"]["wo"] = tree["groups"][0]["mlp"]["wo"][:2]
    with pytest.raises(ValueError, match=r"groups\.0\.mlp\.wo"):
        convert.lm_params_from_numpy(case.cfg, tree, "cpu")
    with pytest.raises(KeyError, match="1 cache slots, expected 2"):
        convert.lm_cache_from_numpy(
            cases["gemma2-9b"].cfg, [(case.ref["cache.0.k"],
                                      case.ref["cache.0.v"])], "cpu")


def test_bfloat16_params_round_trip_bit_exact():
    """A bfloat16 model's leaves (norm scales float32) through numpy and
    back, as ``ml_dtypes`` arrays are what the reference hands over."""
    cfg = dataclasses.replace(C.reduced_config("gemma2-9b"), dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(4))
    tree = convert.lm_params_to_numpy(params)
    flat = convert.lm_flatten(tree)
    assert flat["embed.table"].dtype.name == "bfloat16"
    assert flat["groups.1.ln_attn_post.scale"].dtype == np.float32
    again = convert.lm_params_from_numpy(cfg, tree, "cpu")
    for (n1, a), (n2, b) in zip(params.named_parameters(),
                                again.named_parameters()):
        assert n1 == n2 and a.dtype == b.dtype and torch.equal(a, b), n1


def test_gemma_embedding_scale_is_rounded_to_the_dtype():
    """sqrt(3584) = 59.8665 is 59.75 in bfloat16 (steps of 0.25 there),
    sqrt(4608) = 67.88 is 68.0: ``jnp.asarray(d ** 0.5, bfloat16)``."""
    cfg = C.get_config("gemma2-9b")
    assert T.embed_scale(cfg, torch.bfloat16) == 59.75
    assert T.embed_scale(C.get_config("gemma2-27b"), torch.bfloat16) == 68.0
    assert T.embed_scale(cfg, torch.float32) == float(np.float32(3584 ** 0.5))
    assert T.embed_scale(C.get_config("qwen3-0.6b"), torch.float32) == 1.0


def test_gemma_layers_alternate_local_and_global():
    cfg = C.reduced_config("gemma2-9b")
    params = build_model(cfg, device="cpu").init()
    assert [blk.window for blk in params.layers] == [32, 0, 32, 0]
    assert params.layers[0].attn.wq.shape == (64, 4, 16)
    assert params.layers[0].ln_attn.scale.dtype == torch.float32
    assert hasattr(params.layers[3], "ln_mlp_post")


@pytest.fixture(scope="module")
def full_shapes(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return json.loads((out / "full_shapes.json").read_text())


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_build_model_builds_every_published_config(full_shapes, arch):
    """Every config at full width, on the ``meta`` device (no memory):
    the port's leaves, stacked as the reference stacks them, have the
    paths, shapes and dtypes of the reference's ``jax.eval_shape`` of
    ``build_model(cfg).init``."""
    cfg = C.get_config(arch)
    params = build_model(cfg, device="meta").init()
    got = {path: [list(dims + shape), dtype] for path, (dims, _, shape, dtype)
           in convert._stacks(params).items()}
    assert got == full_shapes[arch]


def test_build_model_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the model would be built on it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        build_model(C.reduced_config("qwen3-0.6b"))


def test_init_is_seeded_and_takes_a_generator():
    """``init()`` draws from a generator seeded with 0; ``init(g)``
    from ``g``."""
    model = build_model(C.reduced_config("internvl2-1b"), device="cpu")
    a, b = model.init(), model.init()
    c = model.init(torch.Generator().manual_seed(0))
    d = model.init(torch.Generator().manual_seed(1))
    for (_, x), (_, y), (_, z) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      c.named_parameters()):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert not torch.equal(a.adapter.proj, d.adapter.proj)


def bf16_run(ref, arch, dtype):
    """The reference's bfloat16 parameters carried into the port's
    ``dtype`` model (float32: each leaf widened exactly): the forward
    and teacher-forced decode logits, as float32."""
    import ml_dtypes
    flat = {}
    for key, v in ref.items():
        if key.startswith("param16."):
            flat[key[len("param16."):]] = v.view(ml_dtypes.bfloat16)
        elif key.startswith("param."):
            flat[key[len("param."):]] = v
    if dtype == "float32":
        flat = {k: v.astype(np.float32) for k, v in flat.items()}
    cfg = dataclasses.replace(C.reduced_config(arch), dtype=dtype)
    model = build_model(cfg, device="cpu")
    params = convert.lm_params_from_numpy(cfg, convert.lm_unflatten(flat),
                                          "cpu")
    toks = torch.from_numpy(ref["tokens"])
    with torch.no_grad():
        fwd, _, _ = model.forward(params, {"tokens": toks})
        dec, _ = decode_all(model, params, toks)
    return fwd, dec


def rel_err(got, want):
    return float((got.float() - want).norm() / want.norm())


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bfloat16_logits_match_jax(jax_models, arch):
    """The config's dtype: forward and 48 decode steps' logits (bfloat16)
    against the reference's bfloat16 run, within BF16_REL."""
    ref = jax_models[f"bf16-{arch}"]
    fwd, dec = bf16_run(ref, arch, "bfloat16")
    assert fwd.dtype == dec.dtype == torch.bfloat16
    assert rel_err(fwd, torch.from_numpy(ref["forward"])) < BF16_REL
    assert rel_err(dec, torch.from_numpy(ref["decode"])) < BF16_REL


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bfloat16_limit_rejects_the_float32_path(jax_models, arch):
    """The control of BF16_REL: the same parameters run in float32 in
    bfloat16's place miss it, so the limit sees where the casts are."""
    ref = jax_models[f"bf16-{arch}"]
    fwd, dec = bf16_run(ref, arch, "float32")
    assert rel_err(fwd, torch.from_numpy(ref["forward"])) > 1.5 * BF16_REL
    assert rel_err(dec, torch.from_numpy(ref["decode"])) > 1.5 * BF16_REL
