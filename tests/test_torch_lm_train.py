"""The port's LM training path against the reference (one JAX subprocess
for the module, started in the background; the reference under
``jax.jit`` as its own tests run it):

- ``Model.train_loss`` and its gradient for the reduced config of each of
  the ten archs in float32, on the reference's ``tests/test_models.py::
  _batch`` shapes (2 x 64 tokens; whisper 64 frames and 32 tokens,
  internvl2 8 patches and 56 tokens) drawn from numpy seeds, the
  reference's ``init`` parameters carried in: the loss and its metrics
  within :data:`LOSS_RTOL`, every gradient leaf (the reference's leaf
  paths, layers stacked) within :data:`GRAD_RTOL` of that leaf's largest
  magnitude;
- ``chunked_xent_head`` (4 chunks) against the reference's, with and
  without a soft-cap, in loss and in the gradients of the table and the
  hidden states;
- ``launch/train.py::make_train_step`` on reduced qwen3 against the
  reference's ``make_train_step(model, tcfg, None)`` for 3 steps under
  AdamW, ``microbatch=2``, ``int8_ef`` (the reference's EF slot added by
  hand, as its own test does), ``adamw8bit`` and ``adafactor``: each
  step's loss, ``grad_norm`` and ``lr``, and the final parameters.

Port only: ``remat="block"`` gradients bitwise equal to ``"none"`` for
the ten archs; ``chunked_xent_head`` against the direct
``cross_entropy`` over whole logits, and its peak of live
(B, c, V)-sized buffers the same at 1 and at 4 chunks; trained
parameters build no graph in the serving loops; the reference's
loss-decrease test; the launcher on the CPU and its refusal without a
card; a resumed ``examples/torch_train_lm.py`` run bitwise equal to an
uninterrupted one."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

import repro_torch.configs as C
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as TR
from repro_torch.models import model as MM
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.runtime.compression import ef_init

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCHS = tuple(C.ARCH_IDS)
# readings on these draws: the loss 1.9e-7 (mamba2), the gradients
# 8.0e-6 (mamba2; the others 7e-6 and below)
LOSS_RTOL = 1e-6
GRAD_RTOL = 3e-5
HEAD = dict(v=512, d=64, b=2, s=128, chunk=32)
# the live-buffer check: a (B, c, V) chunk of logits (1 MiB in float32)
# far larger than the table (256 KiB) and the hidden states
MEM = dict(v=4096, d=16, b=2, chunk=32)
SOFTCAPS = (0.0, 30.0)
VARIANTS = {
    "adamw": {},
    "microbatch": {"microbatch": 2},
    "int8_ef": {"grad_compression": "int8_ef"},
    "adamw8bit": {"optimizer": "adamw8bit"},
    "adafactor": {"optimizer": "adafactor"},
}
# the variants that quantize: a gradient 1e-7 off moves a value across
# a rounding boundary of its int8 code now and then, and an element
# whose 8-bit second moment rounded to 0 takes an update m / sqrt(v) of
# a v made of its tiny gradient alone, so a free run drifts apart (one
# such element of wi_up moved 6 % of the leaf's largest value in one
# step). Each of their steps starts from the reference's state instead
# (``convert.lm_opt_from_numpy``), and a share of elements may differ.
QUANTIZED = ("int8_ef", "adamw8bit")
TRAIN = dict(batch=4, seq=32, seed=5, steps=3)
# readings: loss, grad_norm and lr 2.9e-6 relative and below (int8_ef's
# grad_norm; the others 4.4e-7); the parameters 3.6e-6 of each leaf's
# largest magnitude after 3 free steps (AdamW normalises each gradient
# element, so the differences of tiny gradients show)
STEP_RTOL = 1e-5
PARAM_RTOL = 1e-5
# the quantized variants, each step from the reference's state: share of
# all parameter elements beyond PARAM_RTOL (readings: int8_ef 4, 8-bit
# AdamW 42 and 24 of 180,928) and of the 8-bit codes that differ (0 to 4)
QUANTIZED_PARAM_SHARE = 1e-3
QUANTIZED_CODE_SHARE = 1e-4


def tcfg_of(variant):
    return TrainConfig(learning_rate=1e-3, warmup_steps=2,
                       **VARIANTS[variant])


def batch_of(cfg, i):
    """The reference test's ``_batch`` shapes, drawn from numpy."""
    rng = np.random.default_rng(300 + i)
    b, s = 2, 64
    batch = {}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
        s = 32
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, 8, cfg.d_model)).astype(np.float32)
        s -= 8
    batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)
    return batch


def head_inputs():
    rng = np.random.default_rng(9)
    h = HEAD
    return (rng.standard_normal((h["v"], h["d"])).astype(np.float32) * 0.5,
            rng.standard_normal((h["b"], h["s"], h["d"])).astype(np.float32),
            rng.integers(0, h["v"], (h["b"], h["s"])).astype(np.int32))


JAX_TRAIN = """
import sys
import jax, jax.numpy as jnp, numpy as np
import repro.configs as C
from repro.configs.base import TrainConfig
from repro.data.pipeline import TokenPipeline
from repro.launch.train import init_state, make_train_step
from repro.models import model as MM
from repro.models.model import build_model
from repro.optim import optimizer as O
from repro.runtime.compression import ef_init
sys.path.insert(0, {tests!r})
from test_torch_lm_train import (ARCHS, HEAD, QUANTIZED, SOFTCAPS, TRAIN,
                                 VARIANTS, batch_of, head_inputs)

def flat(tree, prefix=''):
    if isinstance(tree, O.Q8):
        return {{prefix + '.q': np.asarray(tree.q),
                 prefix + '.scale': np.asarray(tree.scale)}}
    if tree is None:
        return {{}}
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

out = {{}}
for i, arch in enumerate(ARCHS):
    cfg = C.reduced_config(arch)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(i))
    batch = batch_of(cfg, i)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: model.train_loss(p, batch), has_aux=True))(params)
    out.update({{'%s.param.%s' % (arch, k): v
                 for k, v in flat(params).items()}})
    out.update({{'%s.grad.%s' % (arch, k): v
                 for k, v in flat(grads).items()}})
    out['%s.loss' % arch] = np.asarray(loss)
    out.update({{'%s.metric.%s' % (arch, k): np.asarray(v)
                 for k, v in metrics.items()}})

table, hidden, labels = head_inputs()
for cap in SOFTCAPS:
    loss, (gt, gh) = jax.value_and_grad(
        lambda t, h: MM.chunked_xent_head(t, h, labels, softcap_val=cap,
                                          chunk=HEAD['chunk']),
        argnums=(0, 1))(table, hidden)
    out['head.%g.loss' % cap] = np.asarray(loss)
    out['head.%g.table' % cap] = np.asarray(gt)
    out['head.%g.hidden' % cap] = np.asarray(gh)

cfg = C.reduced_config('qwen3-0.6b')
model = build_model(cfg)
init = init_state(model, TrainConfig(), jax.random.PRNGKey(0))
out.update({{'train.init.' + k: v for k, v in flat(init.params).items()}})
for name, kw in VARIANTS.items():
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, **kw)
    state = init_state(model, tcfg, jax.random.PRNGKey(0))
    if tcfg.grad_compression == 'int8_ef':
        state = state._replace(opt={{**state.opt,
                                     'ef': ef_init(state.params)}})
    step_fn = jax.jit(make_train_step(model, tcfg, None))
    pipe = TokenPipeline(cfg.vocab_size, TRAIN['batch'], TRAIN['seq'],
                         seed=TRAIN['seed'])
    for step in range(TRAIN['steps']):
        batch = {{k: jnp.asarray(v) for k, v in
                  pipe.make_batch(step).items()}}
        state, m = step_fn(state, batch)
        for k in ('loss', 'grad_norm', 'lr'):
            out['train.%s.%d.%s' % (name, step, k)] = np.asarray(m[k])
        if name in QUANTIZED:
            out.update({{'train.%s.%d.params.%s' % (name, step, k): v
                         for k, v in flat(state.params).items()}})
            out.update({{'train.%s.%d.opt.%s' % (name, step, k): v
                         for k, v in flat(state.opt).items()}})
    out.update({{'train.%s.final.%s' % (name, k): v
                 for k, v in flat(state.params).items()}})
np.savez({out!r}, **out)
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_lm_train") / "ref.npz"
    job = JaxInBackground(JAX_TRAIN.format(
        tests=str(pathlib.Path(__file__).parent), out=str(out)),
        n_devices=1, timeout=900)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def ref(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return dict(np.load(out))


def under(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def leaf_err(got, want) -> float:
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


def carried(cfg, tree, remat=None):
    """The port's model and the reference's parameters, grads on."""
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    model = build_model(cfg, device="cpu")
    params = convert.lm_params_from_numpy(cfg, tree, "cpu")
    return model, params.requires_grad_(True)


def loss_and_grads(model, params, batch):
    loss, metrics = model.train_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss.detach(), metrics, TR.Leaves(params).grads()


# ------------------------------------------------------------- port only
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_bitwise(arch):
    """``remat="block"`` (every block under ``torch.utils.checkpoint``)
    gives the gradients of ``"none"`` to the bit on the CPU."""
    cfg = C.reduced_config(arch)
    i = ARCHS.index(arch)
    tree = convert.lm_params_to_numpy(
        build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(i)))
    runs = [loss_and_grads(*carried(cfg, tree, remat), batch_of(cfg, i))
            for remat in ("none", "block")]
    (l0, m0, g0), (l1, m1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert sorted(g0) == sorted(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("cap", SOFTCAPS)
def test_chunked_head_equals_direct(cap):
    """The chunked head against ``cross_entropy`` over the whole soft-capped
    logits at the reference's ``tests/test_loss.py`` tolerances: the loss
    within 1e-5, the gradients of the table and the hidden states
    within rtol 2e-4, atol 2e-5."""
    from repro_torch.models import layers as L
    table, hidden, labels = (torch.from_numpy(x) for x in head_inputs())
    runs = []
    for chunked in (True, False):
        t = table.clone().requires_grad_(True)
        h = hidden.clone().requires_grad_(True)
        if chunked:
            loss = MM.chunked_xent_head(t, h, labels, softcap_val=cap,
                                        chunk=HEAD["chunk"])
        else:
            logits = L.softcap(torch.einsum("bsd,vd->bsv", h, t), cap)
            loss = MM.cross_entropy(logits, labels)
        loss.backward()
        runs.append((loss.detach(), t.grad, h.grad))
    (lc, tc, hc), (ld, td, hd) = runs
    torch.testing.assert_close(lc, ld, rtol=1e-5, atol=0)
    torch.testing.assert_close(tc, td, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(hc, hd, rtol=2e-4, atol=2e-5)


class LiveBuffers(torch.utils._python_dispatch.TorchDispatchMode):
    """The peak over every op (forward and backward) of the summed bytes
    of live storages at least ``floor`` bytes large (their weak
    references not yet expired)."""

    def __init__(self, floor: int):
        super().__init__()
        self.floor, self.live, self.peak = floor, {}, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.multiprocessing.reductions import StorageWeakRef
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if torch.is_tensor(t) and t.untyped_storage().nbytes() >= \
                    self.floor:
                ref = StorageWeakRef(t.untyped_storage())
                self.live[ref.cdata] = (ref, t.untyped_storage().nbytes())
        self.live = {k: v for k, v in self.live.items()
                     if not v[0].expired()}
        self.peak = max(self.peak, sum(n for _, n in self.live.values()))
        return out


def test_chunked_head_holds_one_chunk():
    """Over the forward and backward, the live (B, c, V)-sized buffers of
    the chunked head peak at the same bytes with 4 chunks as with 1 (one
    chunk's logits at a time); the direct head over the 4 chunks' length
    peaks at about 4 times that."""
    h = MEM
    table = torch.randn(h["v"], h["d"])
    chunk_bytes = h["b"] * h["chunk"] * h["v"] * 4
    floor = chunk_bytes // 2
    peaks = {}
    for name, s in (("one", h["chunk"]), ("four", 4 * h["chunk"]),
                    ("direct", 4 * h["chunk"])):
        t = table.clone().requires_grad_(True)
        hid = torch.randn(h["b"], s, h["d"], requires_grad=True)
        labels = torch.randint(0, h["v"], (h["b"], s))
        with LiveBuffers(floor) as mode:
            if name == "direct":
                loss = MM.cross_entropy(torch.einsum("bsd,vd->bsv", hid, t),
                                        labels)
            else:
                loss = MM.chunked_xent_head(t, hid, labels, softcap_val=30.0,
                                            chunk=h["chunk"])
            loss.backward()
        peaks[name] = mode.peak
    assert chunk_bytes <= peaks["one"] == peaks["four"], peaks
    assert peaks["direct"] >= 3 * peaks["four"], peaks


def test_serving_builds_no_graph_on_trained_params():
    """Parameters with gradients on (as training leaves them): the serving
    loops and ``prefill_logits`` give tensors with no graph, and the KV
    cache holds none."""
    cfg = C.reduced_config("qwen3-0.6b")
    model = build_model(cfg, device="cpu")
    params = model.init().requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 8))
    logits, caches = MM.decode_all(model, params, toks)
    gen, last = MM.greedy(model, params, toks[:, :4], 4)
    pre = model.prefill_logits(params, {"tokens": toks})
    for t in (logits, last, pre, *(c.k for c in caches)):
        assert not t.requires_grad and t.grad_fn is None
    # and a decode step outside no_grad still leaves no graph in the cache
    caches = model.cache_init(2, 8)
    out, caches = model.decode(params, caches, toks[:, :1], 0)
    assert out.requires_grad
    assert not caches[0].k.requires_grad and caches[0].k.grad_fn is None


def test_loss_decreases():
    """The reference's ``tests/test_system.py::test_lm_training_loss_
    decreases`` on the port: reduced qwen3 on the Markov stream, 30
    AdamW steps, the loss falls by more than 0.5."""
    cfg = C.reduced_config("qwen3-0.6b")
    model = build_model(cfg, device="cpu")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=5)
    step_fn = TR.make_train_step(model, tcfg)
    state = TR.init_state(model, tcfg)
    pipe = TokenPipeline(cfg.vocab_size, 8, 64, seed=11)
    losses = []
    for step in range(30):
        state, metrics = step_fn(state, pipe.make_batch(step))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, losses[::6]
    assert state.step == 30


def test_launcher_on_cpu(capsys):
    """``python -m repro_torch.launch.train --device cpu``: reduced qwen3
    trains, each step printed with a finite loss; under ``int8_ef`` the
    EF slot is there (the reference's CLI raises ``KeyError`` on it)."""
    for extra in ([], ["--grad-compression", "int8_ef", "--optimizer",
                       "adafactor"]):
        TR.main(["--device", "cpu", "--steps", "3", "--batch", "4",
                 "--seq", "32", *extra])
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("step")]
        assert len(lines) == 3
        assert all(np.isfinite(float(ln.split()[3])) for ln in lines)


def test_launcher_refuses_without_a_card():
    """Without ``--device cpu`` the launcher runs on the card, and without
    one it raises; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        TR.main(["--steps", "1"])


@pytest.mark.parametrize("variant", ["adamw", "every_option"])
def test_killed_and_resumed_run_is_bitwise(tmp_path, variant):
    """``examples/torch_train_lm.py``'s ``train`` on reduced qwen3, a
    checkpoint every 2 steps: a run that ends after step 4 (what a kill
    during step 5 leaves on disk), rerun to 6 steps, resumes from step 4
    and ends bitwise equal to an uninterrupted run of 6 (parameters,
    optimizer state, step); also with 8-bit moments, int8-EF and 2
    microbatches."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_train_lm as ex
    finally:
        sys.path.remove(str(ROOT / "examples"))
    cfg = C.reduced_config("qwen3-0.6b")
    tcfg = (TrainConfig(learning_rate=1e-3, warmup_steps=2)
            if variant == "adamw" else
            TrainConfig(learning_rate=1e-3, warmup_steps=2,
                        optimizer="adamw8bit", grad_compression="int8_ef",
                        microbatch=2))
    kw = dict(batch=4, seq=32, device="cpu", every=2)
    whole = ex.train(cfg, tcfg, steps=6, ckpt=str(tmp_path / "whole"), **kw)
    cut = ex.train(cfg, tcfg, steps=5, ckpt=str(tmp_path / "cut"), **kw)
    assert cut.step == 5
    resumed = ex.train(cfg, tcfg, steps=6, ckpt=str(tmp_path / "cut"), **kw)
    a = convert.lm_flatten(TR.state_to_numpy(whole)._asdict())
    b = convert.lm_flatten(TR.state_to_numpy(resumed)._asdict())
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------ against the JAX
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(ref, arch):
    cfg = C.reduced_config(arch)
    i = ARCHS.index(arch)
    tree = convert.lm_unflatten(under(ref, f"{arch}.param."))
    loss, metrics, grads = loss_and_grads(*carried(cfg, tree),
                                          batch_of(cfg, i))
    np.testing.assert_allclose(float(loss), ref[f"{arch}.loss"],
                               rtol=LOSS_RTOL)
    want_m = under(ref, f"{arch}.metric.")
    assert sorted(want_m) == sorted(metrics)
    for k, v in want_m.items():
        np.testing.assert_allclose(float(metrics[k].detach()), v,
                                   rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    want = under(ref, f"{arch}.grad.")
    assert sorted(want) == sorted(grads)
    for k, v in want.items():
        assert grads[k].shape == v.shape, k
        assert leaf_err(grads[k], v) <= GRAD_RTOL, (k, leaf_err(grads[k], v))
    # the reference's gradient tree comes across by leaf path and back
    tree = convert.lm_unflatten(want)
    carried_in = convert.lm_grads_from_numpy(tree, "cpu")
    assert sorted(carried_in) == sorted(grads)
    back = convert.lm_flatten(convert.lm_grads_to_numpy(carried_in))
    assert all(np.array_equal(back[k], v) for k, v in want.items())


@pytest.mark.parametrize("cap", SOFTCAPS)
def test_chunked_head_matches_reference(ref, cap):
    table, hidden, labels = (torch.from_numpy(x) for x in head_inputs())
    t = table.clone().requires_grad_(True)
    h = hidden.clone().requires_grad_(True)
    loss = MM.chunked_xent_head(t, h, labels, softcap_val=cap,
                                chunk=HEAD["chunk"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()),
                               ref[f"head.{cap:g}.loss"], rtol=LOSS_RTOL)
    assert leaf_err(t.grad, ref[f"head.{cap:g}.table"]) <= GRAD_RTOL
    assert leaf_err(h.grad, ref[f"head.{cap:g}.hidden"]) <= GRAD_RTOL


def port_state(ref, variant, step, tcfg):
    """(model, the port's state before ``step``): the reference's initial
    parameters and a fresh optimizer state at step 0, else the reference's
    state after ``step - 1`` carried in."""
    cfg = C.reduced_config("qwen3-0.6b")
    prefix = "train.init." if step == 0 else f"train.{variant}.{step - 1}."
    model, params = carried(cfg, convert.lm_unflatten(
        under(ref, prefix if step == 0 else prefix + "params.")))
    leaves = TR.Leaves(params)
    if step:
        opt = convert.lm_opt_from_numpy(under(ref, prefix + "opt."),
                                        leaves.shapes(), "cpu")
    else:
        opt = make_optimizer(tcfg)[0](leaves.params())
        if tcfg.grad_compression == "int8_ef":
            opt["ef"] = ef_init(leaves.params())
    return model, TR.TrainState(params=params, opt=opt, step=step)


def hold_metrics(ref, variant, step, m):
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(
            float(m[k]), ref[f"train.{variant}.{step}.{k}"],
            rtol=STEP_RTOL, err_msg=f"{variant} step {step} {k}")


@pytest.mark.parametrize("variant", [v for v in VARIANTS
                                     if v not in QUANTIZED])
def test_train_steps_match_reference(ref, variant):
    """3 free steps of each variant that does not quantize: every step's
    metrics and the final parameters."""
    cfg = C.reduced_config("qwen3-0.6b")
    tcfg = tcfg_of(variant)
    model, state = port_state(ref, variant, 0, tcfg)
    step_fn = TR.make_train_step(model, tcfg)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN["batch"], TRAIN["seq"],
                         seed=TRAIN["seed"])
    for step in range(TRAIN["steps"]):
        state, m = step_fn(state, pipe.make_batch(step))
        hold_metrics(ref, variant, step, m)
    got = convert.lm_flatten(convert.lm_params_to_numpy(state.params))
    want = under(ref, f"train.{variant}.final.")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert leaf_err(got[k], v) <= PARAM_RTOL, (k, leaf_err(got[k], v))


@pytest.mark.parametrize("variant", QUANTIZED)
def test_quantized_steps_match_reference(ref, variant):
    """int8-EF and 8-bit AdamW, each of 3 steps from the reference's
    state before it: the step's metrics within STEP_RTOL; the new
    parameters within PARAM_RTOL but for QUANTIZED_PARAM_SHARE of their
    elements; the new state's leaves present, the 8-bit codes equal but
    for QUANTIZED_CODE_SHARE; the last step's parameters are the final
    ones."""
    cfg = C.reduced_config("qwen3-0.6b")
    tcfg = tcfg_of(variant)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN["batch"], TRAIN["seq"],
                         seed=TRAIN["seed"])
    for step in range(TRAIN["steps"]):
        model, state = port_state(ref, variant, step, tcfg)
        state, m = TR.make_train_step(model, tcfg)(state,
                                                   pipe.make_batch(step))
        hold_metrics(ref, variant, step, m)
        got = convert.lm_flatten(convert.lm_params_to_numpy(state.params))
        want = under(ref, f"train.{variant}.{step}.params.")
        assert sorted(got) == sorted(want)
        beyond = sum(int((np.abs(got[k] - v)
                          > PARAM_RTOL * np.abs(v).max()).sum())
                     for k, v in want.items())
        total = sum(v.size for v in want.values())
        assert beyond <= QUANTIZED_PARAM_SHARE * total, (step, beyond)
        got_o = convert.lm_flatten(convert.lm_opt_to_numpy(state.opt))
        want_o = under(ref, f"train.{variant}.{step}.opt.")
        assert sorted(got_o) == sorted(want_o)
        codes = [k for k, v in want_o.items() if v.dtype == np.int8]
        assert bool(codes) == (variant == "adamw8bit")
        differ = sum(int((got_o[k] != want_o[k]).sum()) for k in codes)
        assert differ <= QUANTIZED_CODE_SHARE * total, (step, differ)
    final = under(ref, f"train.{variant}.final.")
    assert all(np.array_equal(final[k], v) for k, v in want.items())
