"""The port's optimizers (``repro_torch/optim/optimizer.py``) and int8-EF
gradient compression (``repro_torch/runtime/compression.py``) against the
reference's ``repro.optim.optimizer`` and ``repro.runtime.compression``
(one JAX subprocess for the module, started in the background, op by op
as the reference's own tests run them). The leaves are a small tree of
the reference's kinds, keyed by leaf path as the port keys them: a 1-D
leaf of 37 (not whole blocks of 256), a 2-D leaf, a stacked (3, 16, 24)
leaf and a stacked (3, 16) one (factored across its stack, as the
reference's stacked norm scales are), and parameters and gradients from
numpy seeds.

- ``q8_encode``'s ``q`` and ``scale`` are bitwise, half-way values
  rounded to even; ``q8_decode`` equal;
- three steps each of AdamW, 8-bit AdamW and adafactor: parameters and
  every state leaf within :data:`STEP_TOL` relative of the leaf's
  largest magnitude (8-bit ``q`` bitwise), ``grad_norm`` and ``lr``
  too;
- ``global_norm``, ``clip_by_global_norm`` and ``lr_schedule`` over the
  warmup, the cosine and past its end;
- ``compress_grads`` / ``decompress_grads`` over two steps, the residual
  carried: ``q`` bitwise, scale and residual equal.

Port only: the low-memory adafactor branch (bfloat16 leaves past
``LOWMEM_ELEMENTS``, lowered here) against the plain branch."""
import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.optim import optimizer as O
from repro_torch.runtime import compression as GC


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SHAPES = {"b": (37,), "w": (64, 32), "groups.0.wq": (3, 16, 24),
          "groups.0.scale": (3, 16)}
KINDS = ("adamw", "adamw8bit", "adafactor")
STEPS = 3
LR_STEPS = (0, 1, 50, 99, 100, 101, 5000, 9999, 10000, 20000)
# parameters and states after each of STEPS steps, relative to the
# leaf's largest magnitude: readings 7.3e-8 for the parameters, 2.7e-7
# for AdamW's v (float32 and the 8-bit scales) and 4.7e-7 for
# adafactor's vc; the 8-bit q bitwise
STEP_TOL = 1e-6


def draws():
    """(params, [grads of each step], q8 input, EF gradients of two
    steps), numpy, keyed by leaf path."""
    rng = np.random.default_rng(7)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** -i).astype(np.float32)
              for k, s in SHAPES.items()} for i in range(STEPS)]
    # blocks of 256: zeros; half-way values at scale 1; a scale that
    # is no power of two; random; a partial block (1000 = 3 * 256 + 232)
    x = rng.standard_normal(1000).astype(np.float32)
    x[:256] = 0.0
    x[256:512] = np.arange(256) % 5 - 1.5
    x[256] = 127.0
    x[512:768] = np.arange(256) % 8 - 3.5
    x = x.reshape(8, 125)
    ef = [{k: rng.standard_normal(s).astype(np.float32) * 3
           for k, s in SHAPES.items()} for _ in range(2)]
    return params, grads, x, ef


JAX_OPTIM = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import TrainConfig
from repro.optim import optimizer as O
from repro.runtime import compression as GC
import sys
sys.path.insert(0, {tests!r})
from test_torch_optim import draws, KINDS, STEPS, LR_STEPS

def flat(tree, prefix=''):
    if isinstance(tree, O.Q8):
        return {{prefix + '.q': np.asarray(tree.q),
                 prefix + '.scale': np.asarray(tree.scale)}}
    if hasattr(tree, '_fields'):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {{prefix: np.asarray(tree)}}
    out = {{}}
    for k, v in items:
        out.update(flat(v, '%s.%s' % (prefix, k) if prefix else str(k)))
    return out

def nest(d):
    out = {{}}
    for path, x in d.items():
        node, keys = out, path.split('.')
        for k in keys[:-1]:
            node = node.setdefault(k, {{}})
        node[keys[-1]] = jnp.asarray(x)
    return out

params, grads, x, ef_grads = draws()
out = {{}}
for kind in KINDS:
    tcfg = TrainConfig(optimizer=kind, learning_rate=1e-2, warmup_steps=2)
    init, update = O.make_optimizer(tcfg)
    p = nest(params)
    state = init(p)
    for step in range(STEPS):
        p, state, m = update(nest(grads[step]), state, p, jnp.int32(step))
        out.update({{'%s.%d.p.%s' % (kind, step, k): v
                     for k, v in flat(p).items()}})
        out.update({{'%s.%d.s.%s' % (kind, step, k): v
                     for k, v in flat(state).items()}})
        out['%s.%d.grad_norm' % (kind, step)] = np.asarray(m['grad_norm'])
        out['%s.%d.lr' % (kind, step)] = np.asarray(m['lr'])
z = O.q8_encode(jnp.asarray(x))
out['q8.q'], out['q8.scale'] = np.asarray(z.q), np.asarray(z.scale)
out['q8.decoded'] = np.asarray(O.q8_decode(z))
g = nest(grads[0])
out['global_norm'] = np.asarray(O.global_norm(g))
for max_norm in (1.0, 0.25, 1e3):
    clipped, n = O.clip_by_global_norm(g, max_norm)
    out.update({{'clip.%g.%s' % (max_norm, k): v
                 for k, v in flat(clipped).items()}})
tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=100)
out['lr'] = np.array([np.asarray(O.lr_schedule(tcfg, jnp.int32(s)))
                      for s in LR_STEPS])
ef = GC.ef_init(nest(ef_grads[0]))
for step in range(2):
    gg = nest(ef_grads[step])
    q, ef = GC.compress_grads(gg, ef)
    back = GC.decompress_grads(q, gg)
    out.update({{'ef.%d.q.%s' % (step, k): v for k, v in flat(q).items()}})
    out.update({{'ef.%d.res.%s' % (step, k): v
                 for k, v in flat(ef.residual).items()}})
    out.update({{'ef.%d.back.%s' % (step, k): v
                 for k, v in flat(back).items()}})
np.savez({out!r}, **out)
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    import pathlib
    out = tmp_path_factory.mktemp("jax_optim") / "ref.npz"
    job = JaxInBackground(JAX_OPTIM.format(
        tests=str(pathlib.Path(__file__).parent), out=str(out)),
        n_devices=1, timeout=600)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def ref(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return dict(np.load(out))


def tensors(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def under(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def assert_leaf_close(name, got, want, tol=STEP_TOL):
    got = np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        name, got.shape, want.shape, got.dtype, want.dtype)
    if want.dtype == np.int8:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= tol, f"{name}: {err:.3e} of the leaf's largest value"


@pytest.mark.parametrize("kind", KINDS)
def test_three_steps_match_reference(ref, kind):
    params, grads, _, _ = draws()
    tcfg = TrainConfig(optimizer=kind, learning_rate=1e-2, warmup_steps=2)
    init, update = O.make_optimizer(tcfg)
    p = tensors(params)
    state = init(p)
    for step in range(STEPS):
        p, state, m = update(tensors(grads[step]), state, p, step)
        tag = f"{kind}.{step}"
        want_p = under(ref, f"{tag}.p.")
        assert sorted(want_p) == sorted(p)
        for k, v in want_p.items():
            assert_leaf_close(f"{tag} param {k}", p[k], v)
        want_s = under(ref, f"{tag}.s.")
        got_s = convert.lm_flatten(convert.lm_opt_to_numpy(state))
        assert sorted(got_s) == sorted(want_s)
        for k, v in want_s.items():
            assert_leaf_close(f"{tag} state {k}", got_s[k], v)
        for metric in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[metric]),
                                       ref[f"{tag}.{metric}"], rtol=1e-6,
                                       err_msg=f"{tag} {metric}")


def test_q8_encode_bitwise(ref):
    _, _, x, _ = draws()
    z = O.q8_encode(torch.from_numpy(x))
    np.testing.assert_array_equal(z.q.numpy(), ref["q8.q"])
    np.testing.assert_array_equal(z.scale.numpy(), ref["q8.scale"])
    assert z.shape == x.shape
    np.testing.assert_array_equal(O.q8_decode(z).numpy(), ref["q8.decoded"])
    assert not z.q[0].any()
    # half-way values round to even: -1.5 -> -2, -0.5 -> 0, 0.5 -> 0,
    # 1.5 -> 2, 2.5 -> 2
    assert z.q[1, 1:6].tolist() == [0, 0, 2, 2, -2]


def test_norm_clip_and_schedule(ref):
    _, grads, _, _ = draws()
    g = tensors(grads[0])
    # the float32 sums of squares in another order: reading 1.3e-7
    np.testing.assert_allclose(float(O.global_norm(g)), ref["global_norm"],
                               rtol=3e-7)
    for max_norm in (1.0, 0.25, 1e3):
        clipped, _ = O.clip_by_global_norm(g, max_norm)
        for k, v in under(ref, f"clip.{max_norm:g}.").items():
            assert_leaf_close(f"clip {max_norm} {k}", clipped[k], v, 3e-7)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=100)
    got = np.array([float(O.lr_schedule(tcfg, s)) for s in LR_STEPS],
                   np.float32)
    np.testing.assert_allclose(got, ref["lr"], rtol=1e-6)


def test_error_feedback_matches_reference(ref):
    _, _, _, ef_grads = draws()
    ef = GC.ef_init(tensors(ef_grads[0]))
    for step in range(2):
        g = tensors(ef_grads[step])
        q, ef = GC.compress_grads(g, ef)
        back = GC.decompress_grads(q, g)
        for k, (qq, s) in q.items():
            np.testing.assert_array_equal(qq.numpy(),
                                          ref[f"ef.{step}.q.{k}.0"])
            np.testing.assert_array_equal(s.numpy(),
                                          ref[f"ef.{step}.q.{k}.1"])
            np.testing.assert_array_equal(ef.residual[k].numpy(),
                                          ref[f"ef.{step}.res.{k}"])
            np.testing.assert_array_equal(back[k].numpy(),
                                          ref[f"ef.{step}.back.{k}"])


@pytest.mark.parametrize("shape", [(6, 40, 24), (300, 24)])
def test_adafactor_low_memory_branch(monkeypatch, shape):
    """bfloat16 leaves past a lowered LOWMEM_ELEMENTS (the 3-D leaf a
    float32 slice at a time, the 2-D one a block of rows at a time)
    against the plain branch on the same leaves: the float32 statistics
    within 1e-6, the parameters within 2 bfloat16 ulps of their
    magnitude and of the update's (the branch rounds ``lr * u``,
    ``p - lr * u`` and the decay term to bfloat16, the plain branch
    once)."""
    rng = np.random.default_rng(3)

    def bf16():
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
    p, grads = {"w": bf16()}, [{"w": bf16()} for _ in range(2)]
    tcfg = TrainConfig(optimizer="adafactor", learning_rate=0.5,
                       warmup_steps=0)
    runs = []
    for lowmem in (False, True):
        monkeypatch.setattr(O, "LOWMEM_ELEMENTS",
                            1000 if lowmem else 2 * 10 ** 8)
        monkeypatch.setattr(O, "LOWMEM_ROWS", 64)
        init, update = O.make_optimizer(tcfg)
        params, state = dict(p), init(p)
        for step, g in enumerate(grads):
            params, state, _ = update(g, state, params, step)
        runs.append((params["w"], state["v"]["w"]))
    (plain, sp), (low, sl) = runs
    assert low.dtype == torch.bfloat16
    for key in ("vr", "vc"):
        torch.testing.assert_close(sl[key], sp[key], rtol=1e-6, atol=0)
    step = (plain.float() - p["w"].float()).abs()
    bound = 2.0 ** -7 * 2 * (plain.float().abs() + step)
    assert bool(((low.float() - plain.float()).abs() <= bound).all())
    assert not torch.equal(plain, p["w"])      # the update moved them
