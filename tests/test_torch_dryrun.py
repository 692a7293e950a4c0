"""The port's dry run (``repro_torch/launch/dryrun.py``) and its cost
count (``launch/cost.py``), against the reference's
``repro/launch/dryrun.py``, ``launch/hlo_cost.py`` and
``tests/test_hlo_cost.py``:

- ``cost.count`` gives exact product FLOPs for the programs of
  ``tests/test_hlo_cost.py`` written as torch loops (7 products in a
  loop of 7, one plain product, a loop of 5 around a loop of 3), the
  counterparts of its ``test_elementwise_counted`` and
  ``test_bytes_positive_and_bounded`` by the eager rule (exact, and
  inside the reference's bounds), the byte rules of a view and an
  in-place add, and the reference's byte rule (result bytes per device,
  all-reduce doubled) for one all-gather, one reduce-scatter and one
  all-reduce of known size on a fake 2 x 2 mesh; on the same fake group
  of 4 a ``send`` / ``recv`` pair counts as ``collective-permute`` and a
  ``c10d`` operation with no reference kind raises;
- the tracker gives the exact peak temporaries of a hand-reckoned
  program (on real tensors and on fake ones, the same number) and of a
  short backward with its saved tensors;
- ``params_total``, ``params_active`` and ``model_flops`` equal the
  reference's formula (``dryrun.py:234-249``, evaluated on its
  ``jax.eval_shape`` trees in the module's JAX subprocess) as integers,
  for the ten configs and four shapes;
- every cell of ``all_cells()`` is skipped, with the same ``reason``,
  exactly where the reference's ``run_lm_cell`` / ``run_dpsnn_cell``
  skip it (the reference's functions run until they would build);
- per-device parameter bytes of the placed parameters equal those of
  the reference's specs (``NamedSharding.shard_shape``) on both
  production meshes;
- an LM cell at full size on the fake 16 x 16 mesh and the dpsnn 48x48
  cell run through the CLI (one process each, as ``--all`` runs them);
  the 48x48 cell traces the interior rank's real step, whose argument
  and halo bytes equal the port's reckoning, and whose steps add up.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground
from _subproc import SRC

import repro_torch.configs as C
from repro_torch.launch import cost
from repro_torch.launch import dryrun as D
from repro_torch.models.model import build_model

ARCHS = tuple(C.ARCH_IDS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


JAX_DRYRUN = """
import json, math
import repro.launch.dryrun as RD      # sets XLA_FLAGS before jax starts
import jax
from jax.sharding import AbstractMesh, NamedSharding
import repro.configs as C
import repro.core.exchange as EX
import repro.models.model as MM
from repro.runtime import sharding as SH

class Builds(Exception):
    pass

def builds(*a, **k):
    raise Builds()

out = {'counts': {}, 'cells': {}, 'param_bytes': {}}
for arch in C.ARCH_IDS:
    cfg = C.get_config(arch)
    model = MM.build_model(cfg)
    params_tree = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    # dryrun.py:234-249, as the reference's run_lm_cell computes them
    leaves = jax.tree_util.tree_leaves(params_tree)
    n_total = sum(int(RD._np_prod(leaf.shape)) for leaf in leaves)
    n_experts = cfg.moe.num_experts if cfg.moe else 0
    routed = sum(int(RD._np_prod(leaf.shape)) for leaf in leaves
                 if n_experts > 1 and len(leaf.shape) >= 1
                 and leaf.shape[0] == n_experts)
    n_active = n_total - (routed * (n_experts - (cfg.moe.top_k if cfg.moe
                                                 else 0)) // max(n_experts, 1)
                          if n_experts else 0)
    for name, shape in C.SHAPES.items():
        tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
        factor = 6 if shape.kind == 'train' else 2
        out['counts'][arch + '@' + name] = [n_total, n_active,
                                            factor * n_active * tokens]
    flat, _ = jax.tree_util.tree_flatten_with_path(params_tree)
    for mesh_name, axes in (('16x16', {'data': 16, 'model': 16}),
                            ('2x16x16', {'pod': 2, 'data': 16,
                                         'model': 16})):
        mesh = AbstractMesh(tuple(axes.values()), tuple(axes))
        total = 0
        for path, leaf in flat:
            spec = SH.param_spec('/'.join(str(k) for k in path),
                                 leaf.shape, mesh, cfg)
            total += (math.prod(NamedSharding(mesh, spec).shard_shape(
                leaf.shape)) * leaf.dtype.itemsize)
        out['param_bytes'][arch + '@' + mesh_name] = total

MM.build_model = builds
EX.make_distributed_run = builds
for kind, a, s, mp in RD.all_cells():
    try:
        r = (RD.run_dpsnn_cell(a, mp) if kind == 'dpsnn'
             else RD.run_lm_cell(a, s, mp))
    except Builds:
        r = {'skipped': False}
    out['cells']['%s@%s@%s@%s' % (kind, a, s, mp)] = [
        bool(r.get('skipped')), r.get('reason')]
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started():
    job = JaxInBackground(JAX_DRYRUN, n_devices=512, timeout=600)
    yield job
    job.stop()


@pytest.fixture(scope="module")
def ref(jax_started):
    return json.loads(jax_started.result().strip().splitlines()[-1])


def _env() -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))


def _run(args: list, stdin: str = "", timeout: int = 600) -> str:
    r = subprocess.run([sys.executable, *args], input=stdin, env=_env(),
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


# tests/test_hlo_cost.py's programs as torch loops
def _loop(x, w, n):
    for _ in range(n):
        x = x @ w
    return x


def _nested(x, w):
    for _ in range(5):
        x = _loop(x, w, 3)
    return x


@pytest.mark.parametrize("program", ("loop_of_7", "plain", "nested"))
def test_count_gives_exact_product_flops(program):
    if program == "loop_of_7":
        x, w = torch.ones(128, 128), torch.ones(128, 128)
        _, c = cost.count(_loop, x, w, 7)
        assert c["matmul_flops"] == 7 * 2 * 128 ** 3
    elif program == "plain":
        _, c = cost.count(torch.matmul, torch.ones(256, 512),
                          torch.ones(512, 128))
        assert c["matmul_flops"] == 2 * 256 * 512 * 128
    else:
        _, c = cost.count(_nested, torch.ones(64, 64), torch.ones(64, 64))
        assert c["matmul_flops"] == 5 * 3 * 2 * 64 ** 3
    assert c["collectives"]["total_bytes"] == 0


def test_count_includes_the_backward():
    w = torch.ones(32, 32, requires_grad=True)
    _, c = cost.count(lambda: _loop(torch.ones(16, 32), w, 2).sum()
                      .backward())
    # forward 2, grad of w 2, grad of the inner activation 1
    assert c["matmul_flops"] == 5 * 2 * 16 * 32 * 32


def test_elementwise_counted():
    """tests/test_hlo_cost.py::test_elementwise_counted: tanh, multiply
    and add of 1000 elements, one FLOP per result element each."""
    _, c = cost.count(lambda x: torch.tanh(x) + x * 2.0, torch.ones(1000))
    assert c["flops"] == 3 * 1000
    assert 1000 <= c["flops"] <= 10000
    assert c["matmul_flops"] == 0


def test_bytes_positive_and_bounded():
    """tests/test_hlo_cost.py::test_bytes_positive_and_bounded: a product
    reads both operands and writes its result once."""
    _, c = cost.count(torch.matmul, torch.ones(256, 512),
                      torch.ones(512, 128))
    expect = (256 * 512 + 512 * 128 + 256 * 128) * 4
    assert c["bytes"] == expect
    assert expect * 0.5 <= c["bytes"] <= expect * 4


@pytest.mark.parametrize("rule", ("view", "inplace_add"))
def test_byte_rules(rule):
    a = torch.ones(64, 32)
    if rule == "view":
        _, c = cost.count(lambda: a.view(32, 64).t()[:8])
        assert c["bytes"] == 0 and c["flops"] == 0
        assert c["temp_bytes"] == 0
    else:
        _, c = cost.count(lambda: a.add_(1.0))
        assert c["bytes"] == 2 * 64 * 32 * 4      # read, then written
        assert c["flops"] == 64 * 32
        assert c["temp_bytes"] == 0               # no new storage


def _program(a, b):
    p = a @ b          # (64, 16) float32: 4096 bytes live
    v = p.view(-1)     # a view: the same storage, nothing more
    q = p * 2.0        # 4096 more: 8192, the peak
    del p, v           # p's storage freed: 4096
    return q.sum()     # 4 bytes; q freed on return: 4 bytes out


@pytest.mark.parametrize("tensors", ("real", "fake", "fake_active"))
def test_peak_of_a_hand_reckoned_program(tensors):
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode() if tensors != "real" else None
    if fake is None:
        a, b = torch.ones(64, 32), torch.ones(32, 16)
        _, c = cost.count(_program, a, b)
    else:
        with fake:
            a, b = torch.ones(64, 32), torch.ones(32, 16)
        if tensors == "fake":
            _, c = cost.count(_program, a, b, fake_mode=fake)
        else:
            with fake:
                _, c = cost.count(_program, a, b, fake_mode=fake)
    assert c["temp_bytes"] == 2 * 64 * 16 * 4
    assert c["output_bytes"] == 4
    assert c["temp_bytes_by_device"] == {"cpu": 2 * 64 * 16 * 4}
    assert c["flops"] == 2 * 64 * 32 * 16 + 64 * 16 + 1
    assert c["bytes"] == ((64 * 32 + 32 * 16 + 64 * 16) * 4
                          + 2 * 64 * 16 * 4 + 64 * 16 * 4 + 4)


def test_peak_of_a_backward():
    w = torch.ones(32, 16, requires_grad=True)

    def step(x):
        h = torch.tanh(x @ w)     # saved for the backward: h (4096 B)
        h.sum().backward()
    _, c = cost.count(step, torch.ones(64, 32))
    # at the product for w's gradient: h, the loss (4), its gradient
    # (4), h's gradient (4096) and w's (2048); w's gradient outlives
    # the step in w.grad
    assert c["temp_bytes"] == 4096 + 4 + 4 + 4096 + 2048
    assert c["output_bytes"] == 2048
    assert w.grad is not None


def test_fake_train_step_counts_as_the_real_one():
    """One reduced qwen3-0.6b training step (bfloat16, remat "block",
    AdamW) counts the same FLOPs, bytes and temporaries on fake tensors,
    built from the shapes alone, as on real ones: chip_smoke.py's phase
    12a predicts the card's peak so."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train as TR
    cfg = dataclasses.replace(C.reduced_config("qwen3-0.6b"),
                              dtype="bfloat16", remat="block")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1)
    batch = {k: torch.from_numpy(v) for k, v in
             TokenPipeline(cfg.vocab_size, 4, 64, seed=1).make_batch(0)
             .items()}
    model = build_model(cfg, device="cpu")
    state = TR.init_state(model, tcfg, torch.Generator().manual_seed(0))
    _, real = cost.count(TR.make_train_step(model, tcfg), state, batch)
    fake = FakeTensorMode()
    with fake:
        model = build_model(cfg, device="cpu")
        state = TR.init_state(model, tcfg)
        fbatch = {k: fake.from_tensor(v) for k, v in batch.items()}
        _, got = cost.count(TR.make_train_step(model, tcfg), state, fbatch,
                            fake_mode=fake)
    keys = ("flops", "matmul_flops", "bytes", "temp_bytes", "output_bytes")
    assert {k: got[k] for k in keys} == {k: real[k] for k in keys}
    assert real["temp_bytes"] > real["output_bytes"] > 0


FAKE_MESH = """
import json, sys
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch import convert
import repro_torch.configs as C
from repro_torch.launch import cost
from repro_torch.launch.dryrun import start_fake_group
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.runtime import sharding as SH

which = sys.argv[1]
if which == 'collectives':
    start_fake_group(4)
    mesh = make_host_mesh((2, 2), ('data', 'model'))
    x = SH.distribute(torch.empty(64, 32, device='meta'), mesh, ('data', None))
    p = DTensor.from_local(torch.empty(64, 32, device='meta'), mesh,
                           [Partial(), Replicate()], run_check=False)
    out = {}
    _, out['all-gather'] = cost.count(
        lambda: x.redistribute(mesh, [Replicate(), Replicate()]))
    _, out['reduce-scatter'] = cost.count(
        lambda: p.redistribute(mesh, [Shard(0), Replicate()]))
    _, out['all-reduce'] = cost.count(
        lambda: p.redistribute(mesh, [Replicate(), Replicate()]))
    import torch.distributed as dist

    def eager():
        x = torch.ones(5, 7)
        recv = torch.zeros(5, 7)
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1),
                                            dist.P2POp(dist.irecv, recv, 3)]):
            work.wait()
        dist.all_reduce(x)
        parts = [torch.empty(5, 7) for _ in range(4)]
        dist.all_gather(parts, x)
    _, out['c10d'] = cost.count(eager)
    try:
        cost.count(lambda: dist.broadcast(torch.ones(3), src=0))
        out['broadcast'] = 'counted'
    except ValueError as e:
        out['broadcast'] = str(e)
    print(json.dumps(out))
else:
    multi = which == '2x16x16'
    start_fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi)
    out = {}
    for arch in C.ARCH_IDS:
        cfg = C.get_config(arch)
        params = build_model(cfg, device='meta').init()
        SH.place_params(params, mesh, cfg)
        out[arch] = sum(p.to_local().numel() * p.element_size()
                        for p in params.parameters())
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake4():
    """The collectives of FAKE_MESH on a fake group of 4 (one process)."""
    return json.loads(_run(["-c", FAKE_MESH, "collectives"])
                      .splitlines()[-1])


def test_count_gives_the_reference_byte_rule(fake4):
    got = fake4
    # a (64, 32) float32 tensor over 'data' of 2: the gather's result is
    # the whole tensor; a pending sum scattered over 2 is half of it; an
    # all-reduce of the whole counts twice its result
    whole = 64 * 32 * 4
    for kind, nbytes in (("all-gather", whole),
                         ("reduce-scatter", whole // 2),
                         ("all-reduce", 2 * whole)):
        c = got[kind]["collectives"]
        assert c["bytes"] == {kind: nbytes}, got
        assert c["counts"] == {kind: 1}, got
        assert got[kind]["matmul_flops"] == 0


def test_c10d_send_recv_is_a_collective_permute(fake4):
    c = fake4["c10d"]["collectives"]
    whole = 5 * 7 * 4
    # the received strip; the all-reduce doubled; the gathered 4 parts
    assert c["bytes"] == {"collective-permute": whole,
                          "all-reduce": 2 * whole, "all-gather": 4 * whole}
    assert c["counts"] == {"collective-permute": 1, "all-reduce": 1,
                           "all-gather": 1}
    assert fake4["c10d"]["bytes"] >= whole + whole + 4 * whole


def test_unmapped_c10d_op_raises(fake4):
    assert "broadcast" in fake4["broadcast"]
    assert "no reference kind" in fake4["broadcast"]


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_equal_the_reference_formula(ref, arch):
    model = build_model(C.get_config(arch), device="meta")
    for name, shape in C.SHAPES.items():
        got = D.lm_counts(model, shape)
        assert [got["params_total"], got["params_active"],
                got["model_flops"]] == ref["counts"][f"{arch}@{name}"], name


def test_skipped_cells_and_reasons_equal_the_reference(ref):
    cells = D.all_cells()
    assert len(cells) == len(ref["cells"]) == 86
    for kind, a, s, mp in cells:
        key = f"{kind}@{a}@{s}@{mp}"
        skipped, reason = ref["cells"][key]
        if not skipped:
            continue
        got = (D.run_dpsnn_cell(a, mp) if kind == "dpsnn"
               else D.run_lm_cell(a, s, mp))
        assert got["skipped"] and got["reason"] == reason, key
        assert got["mesh"] == ("2x16x16" if mp else "16x16")
    # the port skips no cell the reference runs (those it runs below and
    # under --all; here the skip rules alone)
    for kind, a, s, mp in cells:
        skipped = ref["cells"][f"{kind}@{a}@{s}@{mp}"][0]
        if kind == "lm":
            assert (s in C.get_config(a).skip_shapes) == skipped
        else:
            from repro_torch.configs.dpsnn import GRIDS
            assert bool(GRIDS[a].grid_h % (32 if mp else 16)) == skipped


@pytest.mark.parametrize("mesh", ("16x16", "2x16x16"))
def test_param_bytes_equal_the_reference_specs(ref, mesh):
    got = json.loads(_run(["-c", FAKE_MESH, mesh]).splitlines()[-1])
    assert got == {a: ref["param_bytes"][f"{a}@{mesh}"] for a in ARCHS}


def test_lm_cell_runs_at_full_size(ref, tmp_path):
    _run(["-m", "repro_torch.launch.dryrun", "--arch", "qwen3-0.6b",
          "--shape", "decode_32k", "--out", str(tmp_path)])
    r = json.loads((tmp_path / "qwen3-0.6b_decode_32k_16x16.json")
                   .read_text())
    assert r["chips"] == 256 and r["kind"] == "decode"
    assert [r["params_total"], r["params_active"], r["model_flops"]] == \
        ref["counts"]["qwen3-0.6b@decode_32k"]
    assert r["memory"]["params_bytes"] == ref["param_bytes"][
        "qwen3-0.6b@16x16"]
    assert r["memory"]["caches_bytes"] > 0
    mem, c = r["memory"], r["cost"]
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
    assert isinstance(mem["output_bytes"], int) and mem["output_bytes"] > 0
    assert c["flops"] > c["matmul_flops"] > 0
    assert c["bytes"] > 0 and c["hbm_ms_at_rate"] > 0
    assert r["collectives"]["total_bytes"] > 0
    assert r["top_buffers"] and r["arguments_fit_hbm"]
    assert r["step_fits_hbm"] is (mem["argument_bytes"] + mem["temp_bytes"]
                                  <= D.HW["hbm_bytes"])


DPSNN_48 = """
import json, sys
import torch
from repro_torch.configs.dpsnn import GRIDS
from repro_torch.core import exchange
from repro_torch.core.connectivity import build_stencil
from repro_torch.core.partition import make_tile_spec
from repro_torch.launch import cost
from repro_torch.launch import dryrun as D

torch.set_num_threads(1)
D.main(['--dpsnn', '48x48', '--out', sys.argv[1]])   # starts the group
cfg = GRIDS['48x48']
mesh, params, state, fake = D.dpsnn_shard(cfg)
spec = make_tile_spec(cfg, *mesh.shape)
stencil = build_stencil(cfg)
col_ids = exchange.shard_col_ids(cfg, spec, mesh)
ex = exchange.make_exchange(cfg, spec, mesh)


def steps(s, k):
    for _ in range(k):
        s = exchange.dist_step(cfg, params, s, spec=spec, stencil=stencil,
                               mesh=mesh, col_ids=col_ids, impl='ref',
                               exchange=ex)
    return s


def counted(s, k, t=None):
    s = s._replace(hist_ext=s.hist_ext.clone())   # a step writes the ring
    if t is not None:
        s = s._replace(t=torch.full_like(s.t, t))
    out, c = cost.count(steps, s, k, fake_mode=fake)
    return out, {k: c[k] for k in ('flops', 'matmul_flops', 'bytes',
                                   'collectives')}


after_one, one = counted(state, 1)
_, second = counted(after_one, 1)
_, two = counted(state, 2)
_, sixth = counted(state, 1, t=6)
print('STEPS ' + json.dumps({'one': one, 'second': second, 'two': two,
                             'sixth': sixth}))
"""


@pytest.fixture(scope="module")
def dpsnn48(tmp_path_factory):
    """The dpsnn 48x48 cell through ``dryrun.main`` and its steps counted
    alone, in one process on one fake group of 256: (stdout's record,
    the written record, the step counts)."""
    out = tmp_path_factory.mktemp("dry")
    text = _run(["-c", DPSNN_48, str(out)])
    head, steps = text.split("STEPS ")
    r = json.loads((out / "dpsnn-48x48_50steps_16x16.json").read_text())
    return json.loads(head), r, json.loads(steps)


def test_dpsnn_cell_runs(dpsnn48):
    printed, r, _ = dpsnn48
    assert printed == r
    cfg = __import__("repro_torch.configs.dpsnn", fromlist=["GRIDS"]).GRIDS[
        "48x48"]
    n = cfg.neurons_per_column
    assert r["model_flops"] == 50 * 2 * cfg.n_columns * n * (
        n + cfg.remote_fanin)
    assert r["synapses_equiv"] == cfg.total_equivalent_synapses
    assert r["tile"] == [3, 3] and r["process_grid"] == [16, 16]
    assert r["rank"] == 8 * 16 + 8 and r["traced_steps"] == 50
    # nine columns of 1240 x 1240 float32 local weights and more
    mem, c = r["memory"], r["cost"]
    assert mem["params_bytes"] > 9 * n * n * 4
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
    assert isinstance(mem["output_bytes"], int) and mem["output_bytes"] > 0
    # the dense local products: 50 steps of nine (N x N) @ N
    assert c["matmul_flops"] == 50 * 9 * 2 * n * n
    assert c["flops"] > c["matmul_flops"] and c["bytes"] > 0
    assert r["arguments_fit_hbm"] and r["step_fits_hbm"]
    assert r["collectives"]["bytes"]["collective-permute"] == \
        50 * r["collectives"]["halo_bytes_per_step"] > 0
    assert r["collectives"]["counts"]["collective-permute"] == 50 * 4


def test_dpsnn_trace_equals_the_reckoning(dpsnn48):
    from repro_torch.configs.dpsnn import GRIDS
    from repro_torch.core import exchange
    from repro_torch.runtime.compression import halo_payload_bytes
    _, r, _ = dpsnn48
    cfg = GRIDS["48x48"]
    shapes, spec, _ = exchange.stacked_state_shapes(cfg, 256)
    names = D._names(exchange._state_structure(cfg, lambda name: name))
    state = sum(math.prod(shapes[k][0][1:]) * np.dtype(shapes[k][1]).itemsize
                for k in names)
    mem, rec = r["memory"], r["reckoned"]
    assert mem["state_bytes"] == rec["state_bytes"] == state
    assert mem["params_bytes"] == rec["params_bytes"]
    assert mem["argument_bytes"] == state + rec["params_bytes"]
    halo = halo_payload_bytes(cfg, spec)["bytes_per_step"]
    assert r["collectives"]["halo_bytes_per_step"] == \
        rec["halo_bytes_per_step"] == halo


def test_dpsnn_two_steps_count_twice_one(dpsnn48):
    """Two steps count what the two steps count alone, and here exactly
    twice the first: the products and the halo are the same every step,
    and the Poisson drive's loop runs as often at t = 0 as at t = 1.
    At t = 6 it runs once more (its draws decide when it ends), so that
    step counts more FLOPs and bytes: the dry run traces all 50 steps
    rather than scaling one."""
    _, _, st = dpsnn48
    one, second, two, sixth = st["one"], st["second"], st["two"], st["sixth"]
    for k in ("flops", "matmul_flops", "bytes"):
        assert two[k] == one[k] + second[k] == 2 * one[k], k
    for k in ("bytes", "counts"):
        assert two["collectives"][k] == {
            kind: 2 * v for kind, v in one["collectives"][k].items()}
    assert sixth["matmul_flops"] == one["matmul_flops"]
    assert sixth["collectives"] == one["collectives"]
    assert sixth["flops"] > one["flops"] and sixth["bytes"] > one["bytes"]
