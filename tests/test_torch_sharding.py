"""The port's LM sharding rules (``repro_torch/runtime/sharding.py``)
against the reference's (``repro/runtime/sharding.py``), which runs in
one JAX subprocess for the module on ``AbstractMesh`` (no devices):

- ``param_spec`` for every leaf of the ten configs at full size (the
  reference's ``jax.eval_shape`` of ``init``), on {data 16, model 16},
  {pod 2, data 16, model 16} and {data 2, model 2}, on the reference's
  own path strings (``"['groups']/[0]/['mlp']/['wo']"``) and on the
  plain ones (``"groups/0/mlp/wo"``), which differ (ROADMAP queue 3);
- the seven cases of ``tests/test_sharding.py``;
- ``cache_shardings`` and ``batch_shardings`` for every config x shape,
  and ``Model.input_specs`` / ``cache_specs`` shapes and dtypes;
- ``activation_spec`` against the sharding the reference's
  ``activation_constraint`` asks of ``with_sharding_constraint``, and
  ``activation_constraint`` (through the model's ``_sp``) on a fake mesh;
- the local shapes of the placements of each spec on a fake 16 x 16 and
  2 x 16 x 16 ``DeviceMesh`` (a subprocess of the port alone) against
  ``NamedSharding(AbstractMesh, spec).shard_shape``;
- every leaf whose spec shards a stack dim, and what the port does
  instead (``sharding.unstack_spec``);
- ``launch/train.state_shardings``: every optimizer leaf's path string,
  shape and spec equal the reference's (its ``functools`` import put
  in from outside), for two configs and the three optimizers."""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from _jax_background import JaxInBackground
from _subproc import SRC

import repro_torch.configs as C
from repro_torch import convert
from repro_torch.models.model import build_model
from repro_torch.runtime import sharding as SH

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}
ARCHS = tuple(C.ARCH_IDS)
SHAPES = tuple(C.SHAPES)
# state_shardings: a dense and a recurrent config, every optimizer
STATE_ARCHS = ("qwen3-0.6b", "mamba2-780m")
OPTIMIZERS = ("adamw", "adamw8bit", "adafactor")
# residual streams: a sequence, one position, and a leaf of another rank
ACT_SHAPES = ((8, 4096, 1024), (8, 1, 1024), (8, 4096))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


JAX_SPECS = """
import json
import jax
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
import repro.configs as C
from repro.models.model import build_model
from repro.runtime import sharding as SH

MESHES = {meshes!r}

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]

def plain(path):
    return '/'.join(str(getattr(k, 'key', getattr(k, 'idx', k))) for k in path)

out = {{'params': {{}}, 'caches': {{}}, 'batch': {{}}, 'inputs': {{}}}}
for arch in C.ARCH_IDS:
    cfg = C.get_config(arch)
    model = build_model(cfg)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for name, axes in MESHES.items():
        mesh = AbstractMesh(tuple(axes.values()), tuple(axes))
        rows = []
        for path, leaf in flat:
            real = '/'.join(str(k) for k in path)
            spec = SH.param_spec(real, leaf.shape, mesh, cfg)
            rows.append([plain(path).replace('/', '.'), list(leaf.shape),
                         enc(spec),
                         enc(SH.param_spec(plain(path), leaf.shape, mesh,
                                           cfg)),
                         list(NamedSharding(mesh, spec).shard_shape(
                             leaf.shape))])
        out['params'][arch + '@' + name] = rows
        for shape_name, shape in C.SHAPES.items():
            key = '%s@%s@%s' % (arch, shape_name, name)
            if name == '16x16' or shape_name == 'decode_32k':
                cs = model.cache_specs(shape)
                sh = SH.cache_shardings(cs, mesh)
                out['caches'][key] = [
                    [list(c.shape), str(c.dtype), enc(s.spec)]
                    for c, s in zip(jax.tree_util.tree_leaves(cs),
                                    jax.tree_util.tree_leaves(sh))]
                ins = model.input_specs(shape)
                bs = SH.batch_shardings(ins, mesh)
                out['inputs'][key] = {{
                    k: [list(v.shape), str(v.dtype), enc(bs[k].spec)]
                    for k, v in ins.items()}}
                out['batch'][key] = enc(SH.batch_spec(shape, mesh))

# the reference's activation_constraint, its sharding read off
# with_sharding_constraint (no devices, nothing traced)
import jax.numpy as jnp
wsc = jax.lax.with_sharding_constraint
jax.lax.with_sharding_constraint = lambda x, s: s
out['activation'] = {{}}
for name, axes in MESHES.items():
    mesh = AbstractMesh(tuple(axes.values()), tuple(axes))
    for shape in {act_shapes!r}:
        x = jax.ShapeDtypeStruct(shape, jnp.float32)
        r = SH.activation_constraint(x, mesh)
        out['activation']['%s@%s' % (name, shape)] = (
            None if r is x else enc(r.spec))
jax.lax.with_sharding_constraint = wsc

# the reference's state_shardings lacks its functools import
# (ROADMAP queue 3); put it into the module from outside
import functools
import repro.launch.train as RT
from repro.configs.base import TrainConfig
RT.functools = functools
out['state'] = {{}}
mesh = AbstractMesh((16, 16), ('data', 'model'))
for arch in {state_archs!r}:
    model = build_model(C.get_config(arch))
    for opt in {optimizers!r}:
        shapes, specs = RT.state_shardings(model, TrainConfig(optimizer=opt),
                                           mesh)
        flat, _ = jax.tree_util.tree_flatten_with_path(shapes.opt)
        sflat = jax.tree_util.tree_leaves(specs.opt)
        out['state'][arch + '@' + opt] = sorted(
            ['/'.join(str(k) for k in path), list(leaf.shape), enc(sh.spec)]
            for (path, leaf), sh in zip(flat, sflat))
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started():
    job = JaxInBackground(JAX_SPECS.format(
        meshes=MESHES, state_archs=STATE_ARCHS, optimizers=OPTIMIZERS,
        act_shapes=ACT_SHAPES),
        n_devices=1, timeout=600)
    yield job
    job.stop()


@pytest.fixture(scope="module")
def ref(jax_started):
    return json.loads(jax_started.result().strip().splitlines()[-1])


def dec(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def port_leaves(arch: str) -> dict:
    params = build_model(C.get_config(arch), device="meta").init()
    return {path: dims + shape for path, (dims, shape, _) in
            convert.lm_leaf_entries(params).items()}


@pytest.mark.parametrize("mesh", tuple(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_reference(ref, arch, mesh):
    cfg = C.get_config(arch)
    rows = ref["params"][f"{arch}@{mesh}"]
    leaves = port_leaves(arch)
    assert sorted(leaves) == sorted(r[0] for r in rows)
    for path, shape, real, plain, _ in rows:
        assert leaves[path] == tuple(shape), path
        assert SH.param_spec(SH.jax_path(path), leaves[path], MESHES[mesh],
                             cfg) == dec(real), path
        assert SH.param_spec(path.replace(".", "/"), leaves[path],
                             MESHES[mesh], cfg) == dec(plain), path
    # the DeviceMesh-free and the mapping forms agree on the port's table
    got = SH.param_shardings(
        build_model(cfg, device="meta").init(), MESHES[mesh], cfg)
    assert got == {r[0]: dec(r[2]) for r in rows}


def test_the_path_forms_differ_where_the_reference_says(ref):
    """The quirk of ROADMAP queue 3: on 16 x 16 the reference's own path
    form and the plain form give different specs for 16 leaves over nine
    configs (mamba2-780m none), every one an MLP's ``wo`` or ``wi`` or an
    MoE shared expert's ``wo``."""
    differ = {(arch, r[0]) for arch in ARCHS
              for r in ref["params"][f"{arch}@16x16"] if r[2] != r[3]}
    assert len(differ) == 16
    assert len({a for a, _ in differ}) == 9
    assert "mamba2-780m" not in {a for a, _ in differ}
    odd = {(a, p) for a, p in differ
           if p.split(".")[-2:] not in (["mlp", "wo"], ["mlp", "wi"],
                                        ["shared", "wo"])}
    assert not odd, odd
    assert ("qwen3-0.6b", "groups.0.mlp.wo") in differ


# tests/test_sharding.py, case by case: (arch, path, shape, mesh, checks)
REFERENCE_CASES = {
    "expert_stack_ep_rule": (
        "llama4-maverick-400b-a17b",
        [("groups/1/moe/wo", (24, 128, 8192, 5120)),
         ("groups/1/moe/wi_gate", (24, 128, 5120, 8192))], "16x16"),
    "attention_heads_rule": (
        "granite-3-2b", [("groups/0/attn/wq", (40, 2048, 32, 64))], "16x16"),
    "indivisible_heads_fall_back": (
        "internvl2-1b", [("groups/0/attn/wq", (24, 896, 14, 64))], "16x16"),
    "embedding_vocab_rule": (
        "qwen3-0.6b", [("embed/table", (151936, 1024))], "16x16"),
    "mlp_rules": (
        "gemma2-27b", [("groups/0/mlp/wi_gate", (23, 4608, 36864)),
                       ("groups/0/mlp/wo", (23, 36864, 4608))], "16x16"),
    "multipod_fsdp_uses_both_axes": (
        "qwen3-0.6b", [("embed/table", (151936, 1024))], "2x16x16"),
    "norm_scales_replicated": (
        "qwen3-0.6b", [("groups/0/ln_attn/scale", (28, 1024))], "16x16"),
}


@pytest.mark.parametrize("case", tuple(REFERENCE_CASES))
def test_reference_sharding_cases(case):
    arch, leaves, mesh = REFERENCE_CASES[case]
    cfg = C.get_config(arch)
    specs = [SH.param_spec(p, s, MESHES[mesh], cfg) for p, s in leaves]
    if case == "expert_stack_ep_rule":
        assert specs[0][1] == "model" and "data" in str(specs[0])
        assert specs[1][1] == "model"
    elif case == "attention_heads_rule":
        assert specs[0][2] == "model" and specs[0][1] == "data"
    elif case == "indivisible_heads_fall_back":
        assert "model" not in specs[0]
    elif case == "embedding_vocab_rule":
        assert specs[0][0] == "model" and specs[0][1] == "data"
    elif case == "mlp_rules":
        assert specs[0][2] == "model" and specs[1][1] == "model"
    elif case == "multipod_fsdp_uses_both_axes":
        assert specs[0][0] == "model" and specs[0][1] == ("pod", "data")
    else:
        assert "model" not in specs[0]


@pytest.mark.parametrize("mesh", tuple(MESHES))
def test_activation_spec_equals_reference(ref, mesh):
    for shape in ACT_SHAPES:
        want = ref["activation"][f"{mesh}@{shape}"]
        if len(shape) != 3:
            assert want is None
            continue
        assert SH.activation_spec(shape, MESHES[mesh]) == dec(want), shape


def _flat_caches(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_caches(tree[k])]
    return [x for v in tree for x in _flat_caches(v)]


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_and_input_specs_equal_reference(ref, arch, shape):
    model = build_model(C.get_config(arch), device="meta")
    cfg_shape = C.SHAPES[shape]
    for mesh in ("16x16", "2x16x16", "2x2"):
        key = f"{arch}@{shape}@{mesh}"
        if key not in ref["caches"]:
            continue
        cs = model.cache_specs(cfg_shape)
        leaves = _flat_caches(cs)
        specs = _flat_specs(SH.cache_shardings(cs, MESHES[mesh]))
        want = ref["caches"][key]
        assert len(leaves) == len(specs) == len(want)
        for t, spec, (w_shape, w_dtype, w_spec) in zip(leaves, specs, want):
            assert t.device.type == "meta"
            assert (list(t.shape), _dtype(t)) == (w_shape, w_dtype)
            assert spec == dec(w_spec)
        ins = model.input_specs(cfg_shape)
        bs = SH.batch_shardings(ins, MESHES[mesh])
        assert set(ins) == set(ref["inputs"][key])
        for k, (w_shape, w_dtype, w_spec) in ref["inputs"][key].items():
            assert (list(ins[k].shape), _dtype(ins[k])) == (w_shape, w_dtype)
            assert ins[k].device.type == "meta"
            assert bs[k] == dec(w_spec), k
        assert SH.batch_spec(cfg_shape, MESHES[mesh]) == dec(
            ref["batch"][key])


def _flat_specs(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_specs(tree[k])]
    if isinstance(tree, tuple) and not hasattr(tree, "_fields") and all(
            e is None or isinstance(e, (str, tuple)) for e in tree):
        return [tree]
    return [x for v in tree for x in _flat_specs(v)]


LOCAL_SHAPES = """
import json, sys
import torch
from repro_torch.launch.dryrun import start_fake_group
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.runtime import sharding as SH
multi = sys.argv[1] == '2x16x16'
start_fake_group(512 if multi else 256)
mesh = make_production_mesh(multi_pod=multi)
rows = json.loads(sys.stdin.read())
out = []
for shape, spec in rows:
    spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
    t = SH.distribute(torch.empty(shape, device='meta'), mesh, spec)
    out.append(list(t.to_local().shape))
# constrain: a no-op off a mesh, a redistribution on one, and a plain
# tensor on a mesh raises
x = torch.empty(32, 64, 8, device='meta')
assert SH.constrain(x, 'data', None, 'model') is x
d = SH.distribute(x, mesh, (None, None, None))
with SH.use_mesh(mesh):
    y = SH.constrain(d, SH.dp_axes_spec(), None, 'model')
    try:
        SH.constrain(x, 'data', None, None)
        raise AssertionError('a plain tensor passed')
    except TypeError:
        pass
    # the residual stream: sequence-parallel by activation_constraint,
    # which the model's _sp calls; one position is left as it is
    from repro_torch.models.transformer import _sp
    a = SH.activation_constraint(d, mesh)
    sp = _sp(d)
    one = SH.distribute(torch.empty(32, 1, 8, device='meta'), mesh,
                        (None, None, None))
    assert _sp(one) is one
dp = 32 if multi else 16
print(json.dumps({'local': out, 'constrained': list(y.to_local().shape),
                  'want': [32 // dp, 64, 8],
                  'activation': [list(a.to_local().shape),
                                 list(sp.to_local().shape)],
                  'want_activation': [[32 // dp, 64 // 16, 8]] * 2}))
"""


@pytest.mark.parametrize("mesh", ("16x16", "2x16x16"))
def test_placements_give_the_reference_local_shapes(ref, mesh):
    rows = [(shape, real, local) for arch in ARCHS
            for _, shape, real, _, local in ref["params"][f"{arch}@{mesh}"]]
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", LOCAL_SHAPES, mesh],
                       input=json.dumps([[s, p] for s, p, _ in rows]),
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["local"] == [local for _, _, local in rows]
    assert got["constrained"] == got["want"]
    assert got["activation"] == got["want_activation"]


# Every leaf whose reference spec shards a stack dim on a production
# mesh: {(arch, mesh): {leaf: (the reference's spec, the port's
# per-layer spec)}}. The axis moves to the leaf's largest free dim it
# divides (each of these keeps its per-device bytes).
STACK_DIM_LEAVES = {
    ("mamba2-780m", "16x16"): {
        "blocks.mixer.a_log": (("data", None), ("data",)),
        "blocks.mixer.d_skip": (("data", None), ("data",)),
        "blocks.mixer.dt_bias": (("data", None), ("data",)),
    },
}


def test_leaves_that_shard_a_stack_dim(ref):
    found = {}
    for arch in ARCHS:
        cfg = C.get_config(arch)
        params = build_model(cfg, device="meta").init()
        entries = convert.lm_leaf_entries(params)
        for mesh in ("16x16", "2x16x16"):
            layouts = SH.param_layouts(params, MESHES[mesh], cfg)
            for path, (dims, _, _) in entries.items():
                spec, layer = layouts[path]
                if any(e is not None for e in spec[:len(dims)]):
                    found.setdefault((arch, mesh), {})[path] = (spec, layer)
    assert found == STACK_DIM_LEAVES


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_state_shardings_equal_reference(ref, arch, opt):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train as TR
    model = build_model(C.get_config(arch), device="meta")
    shapes, specs = TR.state_shardings(model, TrainConfig(optimizer=opt),
                                       MESHES["16x16"])
    got = []
    TR._opt_map(shapes.opt, lambda x, p: got.append(
        [p, list(x.shape), SH.param_spec(p, tuple(x.shape), MESHES["16x16"],
                                         model.cfg)]))
    want = [[p, shape, dec(spec)] for p, shape, spec in
            ref["state"][f"{arch}@{opt}"]]
    assert sorted(got, key=lambda r: r[0]) == want
    # the specs tree holds the same specs in the optimizer's structure
    flat = []
    TR._opt_map(specs.opt, lambda x, p: flat.append(x))
    assert sorted(map(str, flat)) == sorted(str(r[2]) for r in want)
    assert specs.params == SH.param_shardings(
        shapes.params, MESHES["16x16"], model.cfg)
