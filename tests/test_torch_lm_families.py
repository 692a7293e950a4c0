"""The port's MoE, Mamba2, Zamba2 and Whisper stacks
(``repro_torch/models/transformer.py``, ``model.py``) against the
reference's ``repro.models.model`` for the reduced llama4-scout,
llama4-maverick, mamba2-780m, zamba2-7b and whisper-medium (one JAX
subprocess for the module, started in the background): the reference's
``model.init(PRNGKey(i))`` parameters come across through
``convert.lm_params_from_numpy``, tokens and whisper's (2, 64, d) frames
from numpy seeds, and within 1e-4 in float32 the ``forward`` logits and
MoE aux pair, the ``prefill_logits``, 48 teacher-forced decode steps
(the reference's step under ``jax.jit``) and the final caches, leaf by
leaf, agree; the greedy tokens of a ``serve_decode``-shaped loop (batch
2, prompt 8, 16 generated) are equal; the port's own decode equals its
forward within the reference test's 2e-2; the converters round-trip
bit-exact. For whisper the reference's own loop runs over
``cache_init``'s 3000 zeroed cross slots, as its ``serve_decode``
does; ``whisper_prime_cross``'s caches, 48 decode steps and a greedy
loop over them are checked too, and, with ``BLOCK_Q`` / ``BLOCK_K``
shrunk to 32 / 8, the forward through the blockwise encoder and
``cross_attn_apply``'s blockwise branch (64 frames past ``4 *
BLOCK_K``), as ``tests/test_models.py`` shrinks them."""
import dataclasses

import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

import repro_torch.configs as C
from repro_torch import convert
from repro_torch.models import attention as A
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


ARCHS = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
         "mamba2-780m", "zamba2-7b", "whisper-medium")
MOE = ARCHS[:2]
WHISPER = "whisper-medium"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, FRAMES = 2, 48, 64
SERVE_B, PROMPT, GEN = 2, 8, 16
BLOCKS, BLOCKED_TOKENS = (32, 8), 32

JAX_FAMILIES = """
import jax, jax.numpy as jnp, numpy as np
import repro.configs as C
import repro.models.attention as A
from repro.models import transformer as T
from repro.models.model import build_model

def flat(tree, prefix=''):
    if tree is None:
        return {{}}
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

def decode_loop(decode, params, caches, toks):
    steps = []
    for t in range(toks.shape[1]):
        lg, caches = decode(params, caches, toks[:, t:t + 1], jnp.int32(t))
        steps.append(lg)
    return np.concatenate(steps, axis=1), caches

def greedy(step, params, caches, prompts):
    tok, gen = prompts[:, :1], []
    for pos in range({prompt} + {gen} - 1):
        nxt, caches = step(params, caches, tok, jnp.int32(pos))
        if pos + 1 < {prompt}:
            tok = prompts[:, pos + 1:pos + 2]
        else:
            tok = nxt
            gen.append(nxt)
    return np.concatenate(gen, axis=1)

for i, arch in enumerate({archs!r}):
    cfg = C.reduced_config(arch)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(i))
    rng = np.random.default_rng(200 + i)
    toks = rng.integers(0, cfg.vocab_size, ({b}, {s})).astype(np.int32)
    out = {{'param.' + k: v for k, v in flat(params).items()}}
    out['tokens'] = toks
    batch = {{'tokens': toks}}
    if cfg.family == 'audio':
        frames = rng.standard_normal(({b}, {frames}, cfg.d_model)).astype(
            np.float32)
        batch['frames'] = out['frames'] = frames
    out['forward'], aux, _ = model.forward(params, batch)
    out['aux'] = np.array(aux)
    out['prefill'] = model.prefill_logits(params, batch)
    decode = jax.jit(model.decode)
    out['decode'], caches = decode_loop(decode, params,
                                        model.cache_init({b}, {s}), toks)
    out.update({{'cache.' + k: v for k, v in flat(caches).items()}})

    @jax.jit
    def step(params, caches, tok, pos):
        logits, caches = model.decode(params, caches, tok, pos)
        return logits[:, -1].argmax(-1)[:, None].astype(jnp.int32), caches

    prompts = rng.integers(0, cfg.vocab_size, ({sb}, {prompt})).astype(
        np.int32)
    out['prompts'] = prompts
    out['greedy'] = greedy(step, params,
                           model.cache_init({sb}, {prompt} + {gen}), prompts)
    if cfg.family == 'audio':
        cross = T.whisper_prime_cross(params, cfg,
                                      T.whisper_encode(params, cfg, frames))
        out['cross.k'], out['cross.v'] = cross.k, cross.v
        primed = {{'self': model.cache_init({b}, {s})['self'], 'cross': cross}}
        out['primed_decode'], caches = decode_loop(decode, params, primed,
                                                   toks)
        out['primed_self.k'], out['primed_self.v'] = caches['self']
        cross = T.whisper_prime_cross(params, cfg, T.whisper_encode(
            params, cfg, frames[:{sb}]))
        primed = {{'self': model.cache_init({sb}, {prompt} + {gen})['self'],
                   'cross': cross}}
        out['primed_greedy'] = greedy(step, params, primed, prompts)
        A.BLOCK_Q, A.BLOCK_K = {blocks!r}
        out['blocked'], _, _ = model.forward(params, {{
            'frames': frames, 'tokens': toks[:, :{blocked}]}})
        A.BLOCK_Q, A.BLOCK_K = 1024, 1024
    np.savez('{out}/%s' % arch, **{{k: np.asarray(v) for k, v in out.items()}})
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_lm_families")
    job = JaxInBackground(JAX_FAMILIES.format(
        out=out, archs=ARCHS, b=B, s=S, frames=FRAMES, sb=SERVE_B,
        prompt=PROMPT, gen=GEN, blocks=BLOCKS, blocked=BLOCKED_TOKENS),
        n_devices=1, timeout=900)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def jax_models(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return {arch: dict(np.load(out / f"{arch}.npz")) for arch in ARCHS}


def under(ref, prefix):
    """The entries of ``ref`` under ``prefix``, the prefix dropped."""
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def ref_caches(cfg, flat):
    """The reference's cache tree from its flattened leaves: a
    ``KVCache`` or ``SSMCache`` stack as the tuple of its leaves."""
    tree = convert.lm_unflatten(flat)
    if cfg.family == "ssm":
        return tuple(tree)
    if cfg.family in ("hybrid", "audio"):
        return {k: None if v is None else tuple(v) for k, v in tree.items()}
    return [tuple(pair) for pair in tree]


class Case:
    """One arch: the reference's arrays and the port's model and params
    (the reference's, carried in)."""

    def __init__(self, arch, ref):
        self.cfg = C.reduced_config(arch)
        self.ref = ref
        self.tree = convert.lm_unflatten(under(ref, "param."))
        self.model = build_model(self.cfg, device="cpu")
        self.params = convert.lm_params_from_numpy(self.cfg, self.tree, "cpu")
        self.tokens = torch.from_numpy(ref["tokens"])
        self.batch = {"tokens": self.tokens}
        if self.cfg.family == "audio":
            self.batch["frames"] = torch.from_numpy(ref["frames"])

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


@pytest.fixture(scope="module")
def primed(cases):
    """Whisper's decode over its primed caches: (logits, final caches)."""
    case = cases[WHISPER]
    with torch.no_grad():
        caches = case.params.primed_caches(case.batch["frames"], S)
        return decode_all(case.model, case.params, case.tokens, caches)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(cases, arch):
    case = cases[arch]
    with torch.no_grad():
        logits, aux, hidden = case.model.forward(case.params, case.batch)
    assert logits.shape == (B, S, case.cfg.vocab_size)
    assert hidden.shape == (B, S, case.cfg.d_model)
    torch.testing.assert_close(logits, case.want("forward"), **TOL)
    if arch not in MOE:
        assert float(aux[0]) == float(aux[1]) == 0.0


@pytest.mark.parametrize("arch", MOE)
def test_moe_aux_pair_matches_jax(cases, arch):
    """(load balance, router z) summed over the MoE layers: 4 in scout,
    2 in maverick."""
    case = cases[arch]
    with torch.no_grad():
        _, aux, _ = case.model.forward(case.params, case.batch)
    assert float(aux[0]) > 0 and float(aux[1]) > 0
    torch.testing.assert_close(torch.stack(aux), case.want("aux"), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(cases, arch):
    case = cases[arch]
    with torch.no_grad():
        got = case.model.prefill_logits(case.params, case.batch)
    assert got.shape == (B, 1, case.cfg.vocab_size)
    torch.testing.assert_close(got, case.want("prefill"), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(cases, decoded, arch):
    """48 teacher-forced steps from ``cache_init`` (whisper's cross
    caches zeroed, as the reference's own loop runs it)."""
    case = cases[arch]
    torch.testing.assert_close(decoded[arch][0], case.want("decode"), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_final_caches_match_jax(cases, decoded, arch):
    case = cases[arch]
    got = convert.lm_flatten(convert.lm_cache_to_numpy(case.cfg,
                                                       decoded[arch][1]))
    want = under(case.ref, "cache.")
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_allclose(got[path], leaf, **TOL, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward(cases, decoded, primed, arch):
    """The port's own caches against its own forward, at the reference
    test's tolerance (``tests/test_models.py``); whisper decodes over
    the cross caches primed from the forward's frames."""
    case = cases[arch]
    with torch.no_grad():
        full, _, _ = case.model.forward(case.params, case.batch)
    dec = primed[0] if arch == WHISPER else decoded[arch][0]
    torch.testing.assert_close(dec, full, rtol=2e-2, atol=2e-2)


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
    back = convert.lm_flatten(convert.lm_params_to_numpy(case.params))
    want = convert.lm_flatten(case.tree)
    assert sorted(back) == sorted(want)
    for path, leaf in want.items():
        assert back[path].dtype == leaf.dtype, path
        assert back[path].tobytes() == leaf.tobytes(), path
    flat = under(case.ref, "cache.")
    caches = convert.lm_cache_from_numpy(case.cfg, ref_caches(case.cfg, flat),
                                         "cpu")
    again = convert.lm_flatten(convert.lm_cache_to_numpy(case.cfg, caches))
    assert sorted(again) == sorted(flat)
    for path, leaf in flat.items():
        assert again[path].tobytes() == leaf.tobytes(), path


def test_whisper_primed_cross_caches_match_jax(cases):
    case = cases[WHISPER]
    with torch.no_grad():
        cross = case.params.prime_cross(case.params.encode(
            case.batch["frames"]))
    assert len(cross) == case.cfg.num_decoder_layers
    k, v = convert.lm_cache_to_numpy(case.cfg, {"self": cross,
                                                "cross": cross})["cross"]
    assert k.shape == (2, B, FRAMES, 2, 16)
    np.testing.assert_allclose(k, case.ref["cross.k"], **TOL)
    np.testing.assert_allclose(v, case.ref["cross.v"], **TOL)


def test_whisper_decode_over_primed_caches_matches_jax(cases, primed):
    case = cases[WHISPER]
    logits, caches = primed
    torch.testing.assert_close(logits, case.want("primed_decode"), **TOL)
    k, v = convert.lm_cache_to_numpy(case.cfg, caches)["self"]
    np.testing.assert_allclose(k, case.ref["primed_self.k"], **TOL)
    np.testing.assert_allclose(v, case.ref["primed_self.v"], **TOL)


def test_whisper_greedy_over_primed_caches_equals_jax(cases):
    """``greedy`` from the primed caches of the first two requests'
    frames: the same loop, another starting cache."""
    case = cases[WHISPER]
    prompts = torch.from_numpy(case.ref["prompts"])
    with torch.no_grad():
        caches = case.params.primed_caches(case.batch["frames"][:SERVE_B],
                                           PROMPT + GEN)
        gen, _ = greedy(case.model, case.params, prompts, GEN, caches=caches)
    assert torch.equal(gen, case.want("primed_greedy"))


def test_whisper_blockwise_cross_attention_matches_jax(cases, monkeypatch):
    """``BLOCK_Q`` / ``BLOCK_K`` at 32 / 8: the 64-frame encoder and the
    cross attention of 32 queries over 64 frames (past ``4 * BLOCK_K``)
    take the blockwise form, the decoder's self attention the direct
    one; the logits are the reference's under the same blocks."""
    case = cases[WHISPER]
    calls = []
    real = A._blockwise_attn

    def counted(*args, **kw):
        calls.append(args[0].shape[1])
        return real(*args, **kw)
    monkeypatch.setattr(A, "BLOCK_Q", BLOCKS[0])
    monkeypatch.setattr(A, "BLOCK_K", BLOCKS[1])
    monkeypatch.setattr(A, "_blockwise_attn", counted)
    batch = {"frames": case.batch["frames"],
             "tokens": case.tokens[:, :BLOCKED_TOKENS]}
    with torch.no_grad():
        logits, _, _ = case.model.forward(case.params, batch)
    cfg = case.cfg
    assert calls == [FRAMES] * cfg.num_layers + [BLOCKED_TOKENS] * (
        cfg.num_decoder_layers)
    torch.testing.assert_close(logits, case.want("blocked"), **TOL)


def test_zamba_shares_one_attention_block():
    """2 groups of 6 mamba layers, each followed by the one shared
    block, then a tail of 3; one ``KVCache`` per group (the same weights
    at each site, each site's own keys); 12 layers leave no tail, which
    the reference's tree holds as None."""
    cfg = C.reduced_config("zamba2-7b")
    model = build_model(cfg, device="cpu")
    params = model.init()
    assert T.zamba_layout(cfg) == (2, 3)
    assert [len(g) for g in params.groups] == [T.ZAMBA_GROUP] * 2
    assert len(params.tail) == 3 and not params.shared.window
    names = [n for n, _ in params.named_parameters()]
    assert sum(n.endswith("attn.wq") for n in names) == 1
    assert "shared.mlp.wi" in names and "shared.mlp.wi_gate" not in names
    caches = model.cache_init(1, 10)
    assert len(caches["groups_kv"]) == 2 and len(caches["tail_ssm"]) == 3
    assert caches["groups_kv"][0].k.shape == (1, 10, 2, 16)
    short = dataclasses.replace(cfg, num_layers=12)
    model = build_model(short, device="cpu")
    tree = convert.lm_params_to_numpy(model.init())
    assert "tail" not in tree
    again = convert.lm_params_from_numpy(short, dict(tree, tail=None), "cpu")
    assert len(again.tail) == 0
    numpy_caches = convert.lm_cache_to_numpy(short, model.cache_init(1, 4))
    assert numpy_caches["tail_ssm"] is None
    assert convert.lm_cache_from_numpy(short, numpy_caches, "cpu")[
        "tail_ssm"] == []


def test_converter_names_a_wrong_cache_leaf(cases):
    case = cases["zamba2-7b"]
    good = ref_caches(case.cfg, under(case.ref, "cache."))
    with pytest.raises(KeyError, match="cache keys"):
        convert.lm_cache_from_numpy(case.cfg, {"groups_ssm": None}, "cpu")
    state, conv = good["groups_ssm"]
    with pytest.raises(ValueError, match=r"cache groups_ssm\.state is "
                                         r"float32 \(2, 5,"):
        convert.lm_cache_from_numpy(case.cfg, dict(
            good, groups_ssm=(state[:, :5], conv)), "cpu")
    k, v = good["groups_kv"]
    with pytest.raises(ValueError, match=r"cache groups_kv\.v is float64"):
        convert.lm_cache_from_numpy(case.cfg, dict(
            good, groups_kv=(k, v.astype(np.float64))), "cpu")
    with pytest.raises(KeyError, match="cache blocks holds 1 leaves"):
        convert.lm_cache_from_numpy(cases["mamba2-780m"].cfg, (state,),
                                    "cpu")


def test_whisper_encoder_refuses_3000_frames():
    """``WHISPER_ENC_FRAMES`` = 3000 is not whole blocks of ``BLOCK_Q``
    = 1024, which the reference's ``_blockwise_attn`` asserts and the
    port's raises: the encoder cannot take the published window in
    either package."""
    from repro_torch.models.model import WHISPER_ENC_FRAMES
    cfg = C.reduced_config(WHISPER)
    params = build_model(cfg, device="cpu").init()
    frames = torch.zeros(1, WHISPER_ENC_FRAMES, cfg.d_model)
    with torch.no_grad(), pytest.raises(
            ValueError, match="3000 query and 3000 key positions are not "
                              "whole blocks of 1024"):
        params.encode(frames)
