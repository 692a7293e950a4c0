"""The port's checkpointer (``repro_torch/checkpoint/checkpointer.py``) and
checkpoint policy (``runtime/fault_tolerance.py``): every case of the
reference's ``tests/test_checkpoint.py`` on torch trees, the policy and
watchdog cases of ``tests/test_fault_tolerance.py``, and the format
across packages: stacked distributed states the JAX checkpointer wrote
(static, plastic, guarded and pipelined, from a forced 2-device
subprocess) restore in the port with the same paths, shapes, dtypes,
digest and bytes, a checkpoint the port writes restores in JAX's
``restore``, and the batched runner's (S, b, ...) layout round-trips."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

from repro_torch.checkpoint import checkpointer as CK
from repro_torch.configs import dpsnn
from repro_torch.configs.base import ExchangeConfig, GuardConfig
from repro_torch.core import exchange as ex
from repro_torch.runtime.fault_tolerance import (CheckpointPolicy,
                                                 SimulatedFailure,
                                                 StragglerWatchdog,
                                                 train_with_recovery)
from repro_torch.runtime.transport import LocalMesh


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(16, 8, generator=g)},
            "step": torch.tensor(7, dtype=torch.int32),
            "nested": [torch.arange(5, dtype=torch.int32),
                       {"x": torch.tensor(3.5)}]}


def _assert_tree_equal(got, want):
    g = CK._flatten_with_paths(got)
    w = CK._flatten_with_paths(want)
    assert g[0] == w[0]
    for a, b in zip(g[1], w[1]):
        np.testing.assert_array_equal(np.asarray(a), CK._host(b))


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, on torch trees
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    t = _tree()
    CK.save(str(tmp_path), 3, t)
    got, step = CK.restore(str(tmp_path), t)
    assert step == 3
    _assert_tree_equal(got, t)
    assert isinstance(got["nested"][1]["x"], np.ndarray)


def test_latest_pointer_and_multiple_steps(tmp_path):
    t = _tree()
    CK.save(str(tmp_path), 1, t)
    CK.save(str(tmp_path), 5, t)
    assert CK.latest_step(str(tmp_path)) == 5
    _, step = CK.restore(str(tmp_path), t)
    assert step == 5
    _, step = CK.restore(str(tmp_path), t, step=1)
    assert step == 1


def test_corruption_detected(tmp_path):
    t = _tree()
    CK.save(str(tmp_path), 2, t)
    f = os.path.join(str(tmp_path), "step_000000002", "arr_00000.npy")
    np.save(f, np.load(f) + 1)
    with pytest.raises(ValueError, match="digest"):
        CK.restore(str(tmp_path), t)


def test_structure_mismatch_detected(tmp_path):
    CK.save(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="mismatch"):
        CK.restore(str(tmp_path), {"different": torch.zeros(3)})


def test_shape_mismatch_names_leaf_and_both_shapes(tmp_path):
    CK.save(str(tmp_path), 1, _tree())
    wrong = _tree()
    wrong["params"]["w"] = torch.zeros(16, 4)   # saved as (16, 8)
    with pytest.raises(ValueError) as e:
        CK.restore(str(tmp_path), wrong)
    msg = str(e.value)
    assert "params" in msg and "w" in msg
    assert "(16, 8)" in msg and "(16, 4)" in msg


def test_dtype_mismatch_names_leaf(tmp_path):
    CK.save(str(tmp_path), 1, _tree())
    wrong = _tree()
    wrong["step"] = torch.tensor(7.0)           # saved as int32
    with pytest.raises(ValueError, match="dtype mismatch.*step"):
        CK.restore(str(tmp_path), wrong)


def test_placeholder_leaves_skip_shape_check(tmp_path):
    t = _tree()
    CK.save(str(tmp_path), 1, t)
    like = dict(t)
    like["step"] = 0                            # placeholder int leaf
    got, step = CK.restore(str(tmp_path), like)
    assert step == 1
    np.testing.assert_array_equal(got["step"], 7)


def test_async_save_then_restore(tmp_path):
    t = _tree(4)
    thread = CK.save(str(tmp_path), 9, t, blocking=False)
    assert not thread.daemon
    thread.join()
    got, step = CK.restore(str(tmp_path), t)
    assert step == 9
    _assert_tree_equal(got, t)


def test_policy_gc_keeps_last_k(tmp_path):
    pol = CheckpointPolicy(str(tmp_path), every_steps=1, keep_last=2,
                           async_save=False)
    t = _tree()
    for s in range(5):
        pol.maybe_save(s, t)
    kept = sorted(d for d in os.listdir(str(tmp_path))
                  if d.startswith("step_"))
    assert len(kept) == 2
    assert CK.latest_step(str(tmp_path)) == 4


def test_torn_save_leaves_previous_intact(tmp_path):
    t = _tree()
    CK.save(str(tmp_path), 1, t)
    os.makedirs(os.path.join(str(tmp_path), "_tmp_step_000000002"))
    _, step = CK.restore(str(tmp_path), t)
    assert step == 1


def test_gc_stale_stages_sweeps_orphans_only(tmp_path):
    t = _tree()
    CK.save(str(tmp_path), 1, t)
    os.makedirs(os.path.join(str(tmp_path), "_tmp_step_000000002.4242.0"))
    os.makedirs(os.path.join(str(tmp_path), "_tmp_step_000000003"))
    assert CK.gc_stale_stages(str(tmp_path)) == 2
    left = sorted(os.listdir(str(tmp_path)))
    assert not any(d.startswith("_tmp_") for d in left)
    _, step = CK.restore(str(tmp_path), t)
    assert step == 1
    assert CK.gc_stale_stages(str(tmp_path)) == 0
    assert CK.gc_stale_stages(str(tmp_path / "nowhere")) == 0


def test_gc_stale_stages_skip_pid_protects_live_saves(tmp_path):
    mine = os.path.join(str(tmp_path), "_tmp_step_000000005.31337.2")
    dead = os.path.join(str(tmp_path), "_tmp_step_000000005.40001.0")
    os.makedirs(mine)
    os.makedirs(dead)
    assert CK.gc_stale_stages(str(tmp_path), skip_pid=31337) == 1
    assert os.path.isdir(mine)
    assert not os.path.isdir(dead)


def test_save_retries_over_orphaned_stage(tmp_path):
    t = _tree()
    os.makedirs(os.path.join(str(tmp_path), "_tmp_step_000000003.40001.0"))
    CK.save(str(tmp_path), 3, t)
    names = sorted(os.listdir(str(tmp_path)))
    assert "step_000000003" in names
    assert not any(n.startswith("_tmp_") for n in names)
    _, step = CK.restore(str(tmp_path), t)
    assert step == 3


def test_restore_rejects_mesh_mismatch_names_both_shapes(tmp_path):
    t = _tree()
    CK.save(str(tmp_path), 30, t, meta={"mesh": [2, 2], "n_ranks": 4})
    with pytest.raises(ValueError) as e:
        CK.restore(str(tmp_path), t, expect_mesh=(1, 2))
    msg = str(e.value)
    assert "2x2" in msg and "1x2" in msg and "reshard" in msg
    _, step = CK.restore(str(tmp_path), t, expect_mesh=(2, 2))
    assert step == 30
    CK.save(str(tmp_path), 31, t)
    _, step = CK.restore(str(tmp_path), t, expect_mesh=(1, 2))
    assert step == 31


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py: the policy and the watchdog
# ---------------------------------------------------------------------------

def _step_fn(state, step):
    # deterministic toy dynamics keyed on the step; a restored state
    # arrives as numpy
    g = torch.randn(8, 8, generator=torch.Generator().manual_seed(step))
    return {"w": torch.as_tensor(state["w"]) - 0.01 * g,
            "t": torch.as_tensor(state["t"]) + 1}


def test_crash_restore_bitwise(tmp_path):
    state0 = {"w": torch.ones(8, 8), "t": torch.tensor(0, dtype=torch.int32)}
    pol_a = CheckpointPolicy(str(tmp_path / "a"), every_steps=5,
                             async_save=False)
    ref = train_with_recovery(20, _step_fn, state0, pol_a)
    pol_b = CheckpointPolicy(str(tmp_path / "b"), every_steps=5,
                             async_save=False)
    with pytest.raises(SimulatedFailure):
        train_with_recovery(20, _step_fn, state0, pol_b, fail_at=13)
    got = train_with_recovery(20, _step_fn, state0, pol_b)
    assert torch.equal(ref["w"], got["w"])
    assert int(got["t"]) == 20


def test_gc_keeps_last_k(tmp_path):
    d = str(tmp_path / "c")
    pol = CheckpointPolicy(d, every_steps=1, keep_last=2, async_save=False)
    for step in range(1, 6):
        pol.maybe_save(step, {"w": torch.ones(4)})
    kept = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert kept == ["step_000000004", "step_000000005"]


def test_gc_keep_last_zero_deletes_everything(tmp_path):
    d = str(tmp_path / "c")
    os.makedirs(d)
    for step in (1, 2, 3):
        CK.save(d, step, {"w": torch.ones(4)})
    pol = CheckpointPolicy(d, every_steps=1, keep_last=0, async_save=False)
    pol._gc()
    assert not [n for n in os.listdir(d) if n.startswith("step_")]


def test_gc_tolerates_missing_dir(tmp_path):
    pol = CheckpointPolicy(str(tmp_path / "never-created"), every_steps=1,
                           keep_last=3)
    pol._gc()


def test_watchdog_flags_outliers():
    wd = StragglerWatchdog(threshold=2.0)
    flagged = []
    wd.on_straggler = lambda s, t, e: flagged.append(s)
    for s in range(10):
        wd.observe(s, 0.1)
    assert not wd.observe(10, 0.15)
    assert wd.observe(11, 0.5)
    assert flagged == [11]
    assert wd.ewma < 0.2


# ---------------------------------------------------------------------------
# Across packages: the stacked distributed state
# ---------------------------------------------------------------------------

def _cfg(form):
    cfg = dpsnn.reduced(4, 4, 16, seed=0)
    if form == "plastic":
        cfg = dataclasses.replace(cfg, stdp=True)
    if form == "guarded_pipelined":
        cfg = dataclasses.replace(cfg, guard=GuardConfig(enabled=True),
                                  exchange=ExchangeConfig(pipelined=True))
    return cfg


FORMS = ("static", "plastic", "guarded_pipelined")

JAX_SAVE = """
import dataclasses, jax, numpy as np
from repro.checkpoint import checkpointer as CK
from repro.configs import dpsnn
from repro.configs.base import ExchangeConfig, GuardConfig
from repro.core import exchange
mesh = jax.make_mesh((1, 2), ('data', 'model'))
for form in {forms!r}:
    cfg = dpsnn.reduced(4, 4, 16, seed=0)
    if form == 'plastic':
        cfg = dataclasses.replace(cfg, stdp=True)
    if form == 'guarded_pipelined':
        cfg = dataclasses.replace(cfg, guard=GuardConfig(enabled=True),
                                  exchange=ExchangeConfig(pipelined=True))
    run, _ = exchange.make_distributed_run(cfg, mesh, n_steps=10,
                                           with_state=True,
                                           replicate_state=True)
    _, st = run()
    st = jax.tree_util.tree_map(np.asarray, st)
    CK.save('{out}/' + form, 10, st, meta={{'mesh': [1, 2], 'n_ranks': 2}})
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    """The reference's stacked 1x2 states of 4x4x16 (seed 0) after 10
    steps, saved by its checkpointer, one directory per form: started in
    a forced 2-device subprocess when the module starts."""
    out = tmp_path_factory.mktemp("jax_ckpt")
    job = JaxInBackground(JAX_SAVE.format(out=out, forms=FORMS),
                          n_devices=2, timeout=300)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def jax_ckpts(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return out


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("form", FORMS)
def test_jax_restores_a_port_checkpoint(tmp_path, form):
    """The port's replicated 1x2 stack after 10 steps, saved by the port,
    restores in JAX's ``restore`` against JAX's own template, leaf for
    leaf."""
    from repro.checkpoint import checkpointer as JCK
    from repro.configs import dpsnn as jdpsnn
    from repro.configs.base import ExchangeConfig as JEx
    from repro.configs.base import GuardConfig as JGuard
    from repro.core import exchange as jex

    cfg = _cfg(form)
    run, _ = ex.make_distributed_run(cfg, LocalMesh(1, 2, "cpu"),
                                     n_steps=10, impl="ref",
                                     replicate_state=True)
    _, stack = run()
    CK.save(str(tmp_path), 10, stack, meta={"mesh": [1, 2], "n_ranks": 2})
    jcfg = jdpsnn.reduced(4, 4, 16, seed=0)
    if form == "plastic":
        jcfg = dataclasses.replace(jcfg, stdp=True)
    if form == "guarded_pipelined":
        jcfg = dataclasses.replace(jcfg, guard=JGuard(enabled=True),
                                   exchange=JEx(pipelined=True))
    jtpl, _, _ = jex.stacked_state_template(jcfg, 2)
    got, step = JCK.restore(str(tmp_path), jtpl, expect_mesh=(1, 2))
    assert step == 10
    import jax
    theirs = jax.tree_util.tree_leaves(got)
    _, mine = CK._flatten_with_paths(stack)
    assert len(theirs) == len(mine)
    for a, b in zip(theirs, mine):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_batched_layout_round_trips(tmp_path):
    """The batched runner's state, every leaf (S, b, ...), through a
    port checkpoint: restored by the port and by JAX leaf for leaf, and
    10 steps straight equal 5 + a resume of 5 from the restored state."""
    from repro.checkpoint import checkpointer as JCK

    cfg = dpsnn.reduced(4, 4, 16, seed=0)
    mesh = LocalMesh(1, 2, "cpu")

    def runner(n):
        return ex.make_batched_distributed_run(cfg, mesh, n_steps=n, batch=2,
                                               impl="ref",
                                               with_state=True)[0]

    seeds = [0, 1]
    ref, _ = runner(10)(seeds)
    _, st = runner(5)(seeds)
    assert st.lif.v.shape[:2] == (2, 2)
    CK.save(str(tmp_path), 5, st)
    like = ex.stack_to_host(st, mesh)
    got, _ = CK.restore(str(tmp_path), st)
    theirs, _ = JCK.restore(str(tmp_path), like)
    for a, b, c in zip(CK._flatten_with_paths(got)[1],
                       CK._flatten_with_paths(theirs)[1],
                       CK._flatten_with_paths(like)[1]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(np.asarray(b), c)
    res, _ = runner(5)(seeds, state=ex.stack_from_host(got, mesh))
    assert torch.equal(res.spikes, ref.spikes)
    assert torch.equal(res.events, ref.events)


@pytest.mark.parametrize("form", FORMS)
def test_port_restores_a_jax_checkpoint(jax_ckpts, tmp_path, form):
    """The port's restore reads the JAX checkpoint against its own
    template (paths, shapes, dtypes and digest checked), and the port's
    save of what it read writes the same manifest and the same bytes."""
    cfg = _cfg(form)
    tpl, _, _ = ex.stacked_state_template(cfg, 2)
    src = str(jax_ckpts / form)
    tree, step = CK.restore(src, tpl)
    assert step == 10
    paths, leaves = CK._flatten_with_paths(tree)
    theirs = _manifest(src, 10)
    assert theirs["paths"] == paths
    assert theirs["shapes"] == [list(x.shape) for x in leaves]
    assert theirs["dtypes"] == [str(x.dtype) for x in leaves]
    if form == "guarded_pipelined":
        assert ".guard/.checksum_fails" in paths and ".ext_pending" in paths
    CK.save(str(tmp_path), 10, tree, meta=theirs["meta"])
    mine = _manifest(str(tmp_path), 10)
    assert mine == theirs
    for i in range(len(paths)):
        name = f"step_{10:09d}/arr_{i:05d}.npy"
        assert (tmp_path / name).read_bytes() == (jax_ckpts / form
                                                  / name).read_bytes()
    # and it runs: the stack goes onto the mesh as a DistState
    state = ex.stack_from_host(tree, LocalMesh(1, 2, "cpu"))
    assert int(state.t[0]) == 10
    assert (state.guard is not None) == (form == "guarded_pipelined")
