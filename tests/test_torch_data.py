"""The port's data pipeline (``repro_torch/data/pipeline.py``) against the
reference's ``repro.data.pipeline`` (one JAX subprocess for the module,
started in the background): ``TokenPipeline`` batches bitwise for
several (vocab, batch, seq, seed, step, shard, shard count), through
``make_pipeline`` with and without the prefetcher too, and
``spike_stimulus`` within 1e-6. Port only: the shift of labels, disjoint
shards, the Markov structure, the prefetcher's order, a batch that is
not whole shards refused."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline as P


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (vocab, batch, seq, seed, step, shard, shard count); the last is the
# full qwen3 vocabulary
CASES = ((1000, 8, 32, 3, 0, 0, 1), (1000, 8, 32, 3, 5, 0, 1),
         (500, 8, 16, 1, 3, 2, 4), (200, 4, 64, 0, 1234567, 1, 2),
         (151936, 2, 48, 1, 7, 0, 1))
STIMULUS = ((576, 1240, 50, 5.0, 1.0), (16, 64, 200, 9.5, 0.5))
SHAPE = ShapeConfig("tiny", 32, 4, "train")

JAX_DATA = """
import jax, numpy as np
import repro.configs as C
from repro.configs.base import ShapeConfig
from repro.data import pipeline as P
out = {{}}
for i, (v, b, s, seed, step, shard, count) in enumerate({cases!r}):
    pipe = P.TokenPipeline(v, b, s, seed=seed, shard_index=shard,
                           shard_count=count)
    batch = pipe.make_batch(step)
    out['%d.tokens' % i], out['%d.labels' % i] = (batch['tokens'],
                                                  batch['labels'])
cfg = C.reduced_config('qwen3-0.6b')
shape = ShapeConfig('tiny', {shape.seq_len}, {shape.global_batch}, 'train')
for prefetch in (False, True):
    it = P.make_pipeline(cfg, shape, seed=4, shard_index=1, shard_count=2,
                         prefetch=prefetch)
    for step in range(3):
        out['pipe.%d.%d' % (prefetch, step)] = next(it)['tokens']
for i, (c, n, t, rate, dt) in enumerate({stimulus!r}):
    out['stim.%d' % i] = np.asarray(P.spike_stimulus(
        jax.random.PRNGKey(0), c, n, t, rate, dt))
np.savez({out!r}, **out)
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_data") / "ref.npz"
    job = JaxInBackground(JAX_DATA.format(
        cases=CASES, stimulus=STIMULUS, shape=SHAPE, out=str(out)),
        n_devices=1, timeout=300)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def ref(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return dict(np.load(out))


@pytest.mark.parametrize("i", range(len(CASES)))
def test_token_batches_bitwise(ref, i):
    v, b, s, seed, step, shard, count = CASES[i]
    batch = P.TokenPipeline(v, b, s, seed=seed, shard_index=shard,
                            shard_count=count).make_batch(step)
    for k in ("tokens", "labels"):
        assert batch[k].dtype == np.int32
        np.testing.assert_array_equal(batch[k], ref[f"{i}.{k}"])


@pytest.mark.parametrize("prefetch", [False, True])
def test_make_pipeline_bitwise(ref, prefetch):
    it = P.make_pipeline(reduced_config("qwen3-0.6b"), SHAPE, seed=4,
                         shard_index=1, shard_count=2, prefetch=prefetch)
    assert isinstance(it, P.Prefetcher) == prefetch
    for step in range(3):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      ref[f"pipe.{int(prefetch)}.{step}"])


@pytest.mark.parametrize("i", range(len(STIMULUS)))
def test_spike_stimulus_matches_reference(ref, i):
    c, n, t, rate, dt = STIMULUS[i]
    got = P.spike_stimulus(c, n, t, rate, dt, device="cpu")
    assert got.shape == (t, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref[f"stim.{i}"], rtol=1e-6,
                               atol=1e-9)


def test_labels_are_shifted_tokens():
    b = P.TokenPipeline(vocab_size=100, batch=2, seq_len=16).make_batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_shards_are_distinct_rows():
    rows = [P.TokenPipeline(500, 8, 16, seed=1, shard_index=i,
                            shard_count=4).make_batch(3)["tokens"]
            for i in range(4)]
    assert all(r.shape == (2, 16) for r in rows)
    for a, b in itertools.combinations(rows, 2):
        assert not np.array_equal(a, b)


def test_markov_structure_learnable():
    p = P.TokenPipeline(vocab_size=200, batch=8, seq_len=256, seed=2)
    b = p.make_batch(0)
    toks = np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1)
    hits = (p._succ[toks[:, :-1]] == toks[:, 1:]).mean()
    assert hits > 0.4            # markov_strength 0.7 less collisions


def test_prefetcher_in_order_and_not_whole_shards_refused():
    p = P.TokenPipeline(vocab_size=50, batch=2, seq_len=8, seed=4)
    pf = P.Prefetcher(iter(p), depth=2)
    for step in range(4):
        np.testing.assert_array_equal(next(pf)["tokens"],
                                      p.make_batch(step)["tokens"])
    with pytest.raises(ValueError, match="whole shards"):
        dataclasses.replace(p, shard_count=3).make_batch(0)
