"""The port's dry run (``repro_torch/launch/dryrun.py``) and its cost
count (``launch/cost.py``), against the reference's
``repro/launch/dryrun.py`` and ``tests/test_hlo_cost.py``:

- ``cost.count`` gives exact product FLOPs for the programs of
  ``tests/test_hlo_cost.py`` written as torch loops (7 products in a
  loop of 7, one plain product, a loop of 5 around a loop of 3) and the
  reference's byte rule (result bytes per device, all-reduce doubled)
  for one all-gather, one reduce-scatter and one all-reduce of known
  size on a fake 2 x 2 mesh;
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
  cell run through the CLI (one process each, as ``--all`` runs them).
"""
import json
import os
import subprocess
import sys

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


def test_count_gives_the_reference_byte_rule():
    got = json.loads(_run(["-c", FAKE_MESH, "collectives"]).splitlines()[-1])
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
    assert r["memory"]["temp_bytes"] == "not measured"
    assert r["cost"]["matmul_flops"] > 0
    assert r["collectives"]["total_bytes"] > 0
    assert r["top_buffers"] and r["arguments_fit_hbm"]


def test_dpsnn_cell_runs(tmp_path):
    out = _run(["-m", "repro_torch.launch.dryrun", "--dpsnn", "48x48",
                "--out", str(tmp_path)])
    r = json.loads((tmp_path / "dpsnn-48x48_50steps_16x16.json").read_text())
    assert json.loads(out) == r
    cfg = __import__("repro_torch.configs.dpsnn", fromlist=["GRIDS"]).GRIDS[
        "48x48"]
    n = cfg.neurons_per_column
    assert r["model_flops"] == 50 * 2 * cfg.n_columns * n * (
        n + cfg.remote_fanin)
    assert r["synapses_equiv"] == cfg.total_equivalent_synapses
    assert r["tile"] == [3, 3]
    # nine columns of 1240 x 1240 float32 local weights and more
    assert r["memory"]["params_bytes"] > 9 * n * n * 4
    assert r["collectives"]["bytes"]["collective-permute"] == \
        50 * r["collectives"]["bytes_per_step"] > 0
