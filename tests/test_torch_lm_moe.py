"""The port's MoE FFN (``repro_torch/models/moe.py``) and the MoE slot of
its decoder-only stack against the reference's ``repro.models.moe``
(one JAX subprocess for the module, started in the background; the
reference's ``moe_init`` parameters and outputs back as ``.npz``, inputs
from numpy seeds), float32 within 1e-5 for one layer, 1e-4 for a model:
``moe_apply``'s output and aux pair (load balance, router z) on
(2, 24, 64) inputs under top-1 routing with a shared expert, with
capacity drops (capacity factor 0.5: the kept tokens are the
reference's), with every token the same row (one expert overflows, and
the stable sort keeps the first ``cap`` in token order), with a zero
router (every probability ties: the lower expert index wins, as
``jax.lax.top_k``'s), top-2 GeGLU without a shared expert, and the
non-gated GELU FFN; a reduced llama4-scout whose experts overflow
(capacity factor 0.5), its forward logits and aux pair; llama4-maverick's
(dense, MoE) alternation. In bfloat16, the reduced llama4-scout's
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
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as M
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


D, FF, B, S = 64, 128, 2, 24
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# name: (MoEConfig fields, act, inputs: "random" | "same" rows, zero router)
CASES = {
    "top1": (dict(num_experts=4, top_k=1, num_shared=1, capacity_factor=8.0),
             "silu", "random", False),
    "drops": (dict(num_experts=4, top_k=1, num_shared=1, capacity_factor=0.5),
              "silu", "random", False),
    "same_rows": (dict(num_experts=4, top_k=1, num_shared=1), "silu", "same",
                  False),
    "router_ties": (dict(num_experts=4, top_k=2, num_shared=1), "silu",
                    "random", True),
    "top2_geglu": (dict(num_experts=4, top_k=2, num_shared=0), "geglu",
                   "random", False),
    "gelu": (dict(num_experts=4, top_k=1, num_shared=1), "gelu", "random",
             False),
}
SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
DROP_FACTOR = 0.5
MB, MS = 2, 48
# bfloat16: the limit on |port - reference| / |reference| over all
# logits of the reduced scout (forward and 48 decode steps), that of
# tests/test_torch_lm_model.py. Readings on this file's draw: forward and
# decode 8.7e-6 each (all but a few logits equal); the float32 path run
# in bfloat16's place 4.6e-2 each (as the control test asserts).
BF16_REL = 3e-3

JAX_MOE = """
import dataclasses, os
os.environ['XLA_FLAGS'] += ' --xla_allow_excess_precision=false'
import jax, jax.numpy as jnp, numpy as np
import repro.configs as C
from repro.configs.base import MoEConfig
from repro.models import layers as L, moe as M
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

out = {{}}
for i, (name, (fields, act, rows, zero_router)) in enumerate(
        sorted({cases!r}.items())):
    mcfg = MoEConfig(**fields)
    p = M.moe_init(jax.random.PRNGKey(i), mcfg, {d}, {ff}, act, jnp.float32)
    if zero_router:
        p['router'] = jnp.zeros_like(p['router'])
    rng = np.random.default_rng(40 + i)
    if rows == 'same':
        x = np.broadcast_to(rng.standard_normal((1, 1, {d})),
                            ({b}, {s}, {d})).astype(np.float32)
    else:
        x = rng.standard_normal(({b}, {s}, {d})).astype(np.float32)
    y, aux = M.moe_apply(p, mcfg, x, act)
    xf = x.reshape(-1, {d})
    shared = (L.mlp_apply(p['shared'], xf, act) if mcfg.num_shared
              else np.zeros_like(xf))
    for k, v in flat(p).items():
        out['%s.param.%s' % (name, k)] = v
    out[name + '.x'] = x
    out[name + '.y'] = y
    out[name + '.routed'] = np.asarray(y).reshape(-1, {d}) - np.asarray(shared)
    out[name + '.aux'] = np.array([aux.load_balance, aux.router_z])

def model_run(cfg, key, tag, seed):
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(key))
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, ({mb}, {ms})).astype(np.int32)
    for k, v in flat(params).items():
        if v.dtype == jnp.bfloat16:
            out['%s.param16.%s' % (tag, k)] = v.view(np.uint16)
        else:
            out['%s.param.%s' % (tag, k)] = v
    out[tag + '.tokens'] = toks
    logits, aux, _ = model.forward(params, {{'tokens': toks}})
    out[tag + '.forward'] = logits.astype(jnp.float32)
    out[tag + '.aux'] = np.array(aux)
    return model, params, toks

scout = C.reduced_config('{scout}')
model_run(dataclasses.replace(scout, moe=dataclasses.replace(
    scout.moe, capacity_factor={drop})), 20, 'scout_drops', 120)
model, params, toks = model_run(
    dataclasses.replace(scout, dtype='bfloat16'), 21, 'scout_bf16', 121)
decode = jax.jit(model.decode)
caches = model.cache_init({mb}, {ms})
steps = []
for t in range({ms}):
    lg, caches = decode(params, caches, toks[:, t:t + 1], jnp.int32(t))
    steps.append(lg.astype(jnp.float32))
out['scout_bf16.decode'] = np.concatenate(steps, axis=1)
np.savez('{out}/moe', **{{k: np.asarray(v) for k, v in out.items()}})
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_lm_moe")
    job = JaxInBackground(JAX_MOE.format(
        out=out, cases=CASES, d=D, ff=FF, b=B, s=S, mb=MB, ms=MS,
        scout=SCOUT, drop=DROP_FACTOR), n_devices=1, timeout=900)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def ref(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return dict(np.load(out / "moe.npz"))


def leaves(ref, prefix):
    """The entries of ``ref`` under ``prefix`` as a flat {path: array}
    (bfloat16 leaves from their 16-bit patterns)."""
    import ml_dtypes
    flat = {}
    for key, v in ref.items():
        if key.startswith(prefix + ".param16."):
            flat[key[len(prefix) + 9:]] = v.view(ml_dtypes.bfloat16)
        elif key.startswith(prefix + ".param."):
            flat[key[len(prefix) + 7:]] = v
    return flat


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def moe_case(ref, name):
    fields, act, _, _ = CASES[name]
    mcfg = MoEConfig(**fields)
    params = as_torch(convert.lm_unflatten(leaves(ref, name)))
    x = torch.from_numpy(ref[f"{name}.x"])
    with torch.no_grad():
        y, aux = M.moe_apply(params, mcfg, x, act)
    return mcfg, params, x, y, aux


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_apply_matches_jax(ref, name):
    _, _, _, y, aux = moe_case(ref, name)
    torch.testing.assert_close(y, torch.from_numpy(ref[f"{name}.y"]), **TOL)
    torch.testing.assert_close(torch.stack(list(aux)),
                               torch.from_numpy(ref[f"{name}.aux"]), **TOL)


@pytest.mark.parametrize("name", ["drops", "same_rows"])
def test_kept_tokens_are_the_reference_s(ref, name):
    """Experts overflow: the tokens whose routed output is not zero in
    the reference are the port's ``keep``, at most ``cap`` an expert, and
    with identical rows the first ``cap`` in token order."""
    mcfg, params, x, _, _ = moe_case(ref, name)
    xf = x.reshape(-1, D)
    probs = torch.softmax(xf @ params["router"], dim=-1)
    _, expert = M.top_k(probs, 1)
    cap = M.capacity(mcfg, xf.shape[0])
    keep, slot = M.dispatch_positions(expert[:, 0], mcfg.num_experts, cap)
    kept_ref = torch.from_numpy(np.abs(ref[f"{name}.routed"]).max(1) > 0)
    assert torch.equal(keep, kept_ref)
    assert 0 < int(keep.sum()) < xf.shape[0]
    counts = torch.bincount(expert[keep, 0], minlength=mcfg.num_experts)
    assert int(counts.max()) <= cap
    assert bool((slot[~keep] == cap - 1).all())
    if name == "same_rows":
        assert len(set(expert[:, 0].tolist())) == 1
        assert torch.equal(keep, torch.arange(xf.shape[0]) < cap)


def test_top_k_puts_the_lower_index_first_on_ties():
    """``jax.lax.top_k``'s rule, which ``torch.topk`` does not promise."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4],
                          [0.3, 0.1, 0.3, 0.3]])
    values, indices = M.top_k(probs, 2)
    assert indices.tolist() == [[0, 1], [1, 3], [0, 2]]
    assert torch.equal(values, probs.gather(1, indices))


def test_zero_router_sends_every_token_to_the_lowest_experts(ref):
    """Every probability ties at 1/E: top-2 picks experts 0 and 1 for
    every token, as the reference's."""
    mcfg, params, x, _, _ = moe_case(ref, "router_ties")
    probs = torch.softmax(x.reshape(-1, D) @ params["router"], dim=-1)
    gate, expert = M.top_k(probs, mcfg.top_k)
    assert bool((expert == torch.tensor([0, 1])).all())
    assert bool((gate == 0.25).all())


def test_capacity_in_python_numbers():
    """``max(int(factor * T * k / E), min(T, 8))``."""
    cfg = MoEConfig(num_experts=16, top_k=1, capacity_factor=1.25)
    assert [M.capacity(cfg, t) for t in (1, 8, 192, 1000)] == [1, 8, 15, 78]
    cfg = MoEConfig(num_experts=128, top_k=1)
    assert M.capacity(cfg, 8) == 8
    assert M.capacity(MoEConfig(num_experts=3, top_k=2,
                                capacity_factor=0.7), 30) == 14


def model_case(ref, tag, dtype="float32"):
    cfg = C.reduced_config(SCOUT)
    if tag == "scout_drops":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=DROP_FACTOR))
    flat = leaves(ref, tag)
    if tag == "scout_bf16":
        if dtype == "float32":
            flat = {k: v.astype(np.float32) for k, v in flat.items()}
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg, device="cpu")
    params = convert.lm_params_from_numpy(cfg, convert.lm_unflatten(flat),
                                          "cpu")
    return cfg, model, params, torch.from_numpy(ref[f"{tag}.tokens"])


def test_reduced_scout_with_drops_matches_jax(ref):
    """Capacity factor 0.5 over 96 tokens and 4 experts: 12 slots an
    expert, so experts overflow; the logits and the aux pair summed over
    the layers are the reference's."""
    cfg, model, params, toks = model_case(ref, "scout_drops")
    assert M.capacity(cfg.moe, toks.numel()) == 12
    with torch.no_grad():
        logits, aux, _ = model.forward(params, {"tokens": toks})
    torch.testing.assert_close(logits,
                               torch.from_numpy(ref["scout_drops.forward"]),
                               **MODEL_TOL)
    torch.testing.assert_close(torch.stack(aux),
                               torch.from_numpy(ref["scout_drops.aux"]),
                               **MODEL_TOL)


def test_maverick_alternates_dense_and_moe_layers():
    """(dense, MoE) groups: layer 2g is dense (``mlp``), 2g + 1 MoE
    (``moe`` with a shared expert), and the converter puts them at the
    reference's ``groups.0`` and ``groups.1``."""
    cfg = C.reduced_config(MAVERICK)
    params = build_model(cfg, device="cpu").init()
    assert [blk.moe_layer for blk in params.layers] == [False, True] * 2
    names = dict(params.named_parameters())
    assert "layers.0.mlp.wi_gate" in names
    assert "layers.0.moe.router" not in names
    assert names["layers.1.moe.wi_gate"].shape == (4, 64, 128)
    assert names["layers.1.moe.router"].dtype == torch.float32
    assert names["layers.3.moe.shared.wo"].shape == (128, 64)
    stacks = convert._stacks(params)
    assert stacks["groups.1.moe.wo"][:3:2] == ((2,), (4, 128, 64))
    assert stacks["groups.0.mlp.wo"][1] == {(0,): "layers.0.mlp.wo",
                                            (1,): "layers.2.mlp.wo"}


def bf16_logits(ref, dtype):
    cfg, model, params, toks = model_case(ref, "scout_bf16", dtype)
    with torch.no_grad():
        fwd, _, _ = model.forward(params, {"tokens": toks})
        dec, _ = decode_all(model, params, toks)
    return fwd, dec


def want(ref, name):
    return torch.from_numpy(ref[name])


def rel_err(got, want):
    return float((got.float() - want).norm() / want.norm())


def test_bfloat16_logits_match_jax(ref):
    fwd, dec = bf16_logits(ref, "bfloat16")
    assert fwd.dtype == dec.dtype == torch.bfloat16
    assert rel_err(fwd, want(ref, "scout_bf16.forward")) < BF16_REL
    assert rel_err(dec, want(ref, "scout_bf16.decode")) < BF16_REL


def test_bfloat16_limit_rejects_the_float32_path(ref):
    """The control of BF16_REL: the same parameters run in float32 in
    bfloat16's place miss it."""
    fwd, dec = bf16_logits(ref, "float32")
    assert rel_err(fwd, want(ref, "scout_bf16.forward")) > 1.5 * BF16_REL
    assert rel_err(dec, want(ref, "scout_bf16.decode")) > 1.5 * BF16_REL
