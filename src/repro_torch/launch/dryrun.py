"""Multi-pod dry run of the PyTorch port: trace every (arch x shape x
mesh) cell on a fake process group of 256 or 512 ranks in one process,
and report per-device bytes, FLOPs and collective traffic. The
counterpart of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k [--multipod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --dpsnn 96x96
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 4]
        # one subprocess per cell; one JSON file a cell under --out

The reference lowers and compiles each cell with XLA on 512 forced host
devices. The port builds the model on the meta device, places its
parameters, optimizer state, caches and batch as DTensors by the
reference's rules (``runtime/sharding.py``) on a ``DeviceMesh`` over a
fake process group (``torch.distributed``'s ``fake`` backend: collectives
return at once, nothing moves, no device is touched), and runs the
cell's step once on meta DTensors under ``launch/cost.count``:

- train: ``launch/train.make_sharded_train_step`` with the reference's
  optimizer, microbatches and accumulator dtype;
- prefill: ``Model.prefill_logits`` and the greedy token;
- decode: one decode step against caches placed by ``cache_shardings``,
  the token batch replicated when the data axes do not divide it.

A cell's JSON holds the reference's ``params_total``, ``params_active``
and ``model_flops`` (its formula, ``dryrun.py:234-249``), per-device
argument bytes by role from the local shard shapes (``memory``), the
largest local shards (``top_buffers``), ``cost`` (``matmul_flops``:
products only, see ``launch/cost.py``) and ``collectives``. Peak
temporary memory is not measured (the reference's XLA
``temp_size_in_bytes`` has no counterpart here), so ``arguments_fit_hbm``
says only whether the arguments fit a card, not the step. The hardware
constants are the H100's (:data:`HW`); the reference's are a TPU's.

A DPSNN cell (``--dpsnn``) is not traced: per-shard state bytes come
from ``core/exchange.stacked_state_shapes`` (nothing allocated),
per-shard parameter bytes from one column built by
``core/network.build_params`` times the columns of a shard, and the halo
bytes from ``runtime/compression.halo_payload_bytes``.

Importing this module starts no process group; :func:`main` starts the
fake one before any mesh is built.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# The card the port runs on, from its specification (H100 SXM5 80GB
# HBM3): memory per device and dense bfloat16 tensor-core peak.
HW = {"device": "NVIDIA H100 80GB HBM3",
      "hbm_bytes": 80e9,
      "peak_flops_bf16_dense": 989e12}


def start_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process (this
    process is rank 0). The ``fake`` backend's store lives in PyTorch's
    internal testing package, ``torch.testing._internal.distributed.
    fake_pg``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _leaves(tree):
    """Every tensor of nested dicts, lists, tuples, NamedTuples and the
    optimizer's ``Q8`` records."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [x for v in vars(tree).values() for x in _leaves(v)]
    return []


def _bytes(tensors) -> int:
    return sum(_local(t).numel() * _local(t).element_size() for t in tensors)


_DT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
       torch.int32: "s32", torch.int64: "s64", torch.int8: "s8",
       torch.bool: "pred"}


def top_buffers(roles: dict, k: int = 8) -> list:
    """The ``k`` largest distinct local shards among the arguments, with
    their role."""
    best: dict = {}
    for role, tensors in roles.items():
        for t in tensors:
            loc = _local(t)
            key = (f"{_DT.get(loc.dtype, str(loc.dtype))}"
                   f"[{','.join(str(s) for s in loc.shape)}]")
            best.setdefault(key, (loc.numel() * loc.element_size(), role))
    top = sorted(best.items(), key=lambda kv: -kv[1][0])[:k]
    return [{"shape": s, "gib": round(b / 2 ** 30, 3), "role": r}
            for s, (b, r) in top]


def lm_counts(model, shape) -> dict:
    """``params_total``, ``params_active`` and ``model_flops`` by the
    reference's formula over its stacked leaves (``dryrun.py:234-249``):
    a leaf counts as routed when its first dim equals the expert count,
    which for the stacked (layers, experts, ...) leaves it never does,
    so ``params_active`` equals ``params_total`` for the MoE configs as
    it does in the reference."""
    from repro_torch import convert
    cfg = model.cfg
    shapes = [dims + shape_ for dims, shape_, _ in
              convert.lm_leaf_entries(model.init()).values()]
    n_total = sum(math.prod(s) for s in shapes)
    n_experts = cfg.moe.num_experts if cfg.moe else 0
    routed = sum(math.prod(s) for s in shapes
                 if n_experts > 1 and len(s) >= 1 and s[0] == n_experts)
    n_active = n_total - (routed * (n_experts - (cfg.moe.top_k if cfg.moe
                                                 else 0)) // max(n_experts, 1)
                          if n_experts else 0)
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    factor = 6 if shape.kind == "train" else 2
    return {"params_total": n_total, "params_active": n_active,
            "model_flops": factor * n_active * tokens}


def train_config(cfg, shape):
    """The reference's choice for a train cell (``dryrun.py:190-200``):
    adafactor past 3e10 parameters, microbatches for MoE and wide
    configs, a bfloat16 accumulator past 2e11."""
    from repro_torch.configs.base import TrainConfig
    opt = "adafactor" if cfg.param_count() > 3e10 else "adamw"
    mb = 1
    if shape.kind == "train":
        if cfg.moe and cfg.moe.num_experts >= 16:
            mb = 8
        elif cfg.d_ff >= 14336 or cfg.d_model >= 3584:
            mb = 4
    accum = "bfloat16" if cfg.param_count() > 2e11 else "float32"
    return TrainConfig(optimizer=opt, microbatch=mb, accum_dtype=accum)


def _greedy(logits):
    """The next token of each row: the last position's argmax over the
    whole vocabulary (the logits gathered first; DTensor's argmax over a
    vocabulary-sharded dim fails on a batch of one)."""
    from repro_torch.runtime import sharding as SH
    return SH.replicated(logits)[:, -1].argmax(-1)


def run_lm_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """One LM cell on the production mesh over the current (fake)
    process group."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import cost
    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import build_model
    from repro_torch.runtime import sharding as SH

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    head = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod)}
    if shape_name in cfg.skip_shapes:
        return {**head, "skipped": True,
                "reason": "see DESIGN.md §6 (full-attention long-context)"}
    model = build_model(cfg, device="meta")
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    roles: dict = {}
    extra: dict = {}
    if shape.kind == "train":
        tcfg = train_config(cfg, shape)
        state = TR.shard_state(TR.init_state(model, tcfg), model, mesh)
        batch = model.input_specs(shape)
        roles["params"] = list(state.params.parameters())
        roles["optimizer"] = _leaves(state.opt)
        roles["batch"] = _leaves(SH.place_batch(batch, mesh))
        if tcfg.microbatch > 1:
            # the accumulator: the stacked leaves in accum_dtype, placed
            # by the reference's rule (constrain_like_params)
            acc_dt = getattr(torch, tcfg.accum_dtype)
            roles["accumulator"] = [
                SH.distribute(torch.empty(dims + s, dtype=acc_dt,
                                          device="meta"), mesh,
                              SH.param_spec(SH.jax_path(path), dims + s,
                                            mesh, cfg))
                for path, (dims, s, _) in
                TR.Leaves(state.params).entries.items()]
        step = TR.make_sharded_train_step(model, tcfg, mesh)
        _, c = cost.count(step, state, batch)
        extra = {"optimizer": tcfg.optimizer, "microbatch": tcfg.microbatch,
                 "accum_dtype": tcfg.accum_dtype}
    else:
        params = model.init()
        SH.place_params(params, mesh, cfg)
        roles["params"] = list(params.parameters())
        if shape.kind == "prefill":
            batch = SH.place_batch(
                {k: v for k, v in model.input_specs(shape).items()
                 if k != "labels"}, mesh)
            roles["batch"] = _leaves(batch)

            def prefill():
                with SH.use_mesh(mesh):
                    return _greedy(model.prefill_logits(params, batch))
            _, c = cost.count(prefill)
        else:
            b = shape.global_batch
            caches = SH.place_caches(
                cfg, model.cache_init(b, shape.seq_len), mesh)
            dpa = SH.data_axes(mesh)
            dpa = dpa if len(dpa) > 1 else dpa[0]
            tok_spec = (dpa,) if b % SH._dp_size(mesh) == 0 else (None,)
            token = SH.distribute(model.input_specs(shape)["token"], mesh,
                                  tok_spec + (None,))
            roles["caches"] = _leaves(caches)
            roles["batch"] = [token]

            def decode():
                with SH.use_mesh(mesh), torch.no_grad():
                    logits, _ = model.decode(params, caches, token,
                                             shape.seq_len - 1)
                    return _greedy(logits)
            _, c = cost.count(decode)
    trace_s = time.time() - t0
    memory = {f"{role}_bytes": _bytes(ts) for role, ts in roles.items()}
    memory["argument_bytes"] = sum(memory.values())
    memory["temp_bytes"] = "not measured"
    return {
        **head, "chips": 512 if multi_pod else 256, "kind": shape.kind,
        **lm_counts(model, shape), **extra,
        "memory": memory,
        "arguments_fit_hbm": memory["argument_bytes"] <= HW["hbm_bytes"],
        "cost": {"matmul_flops": c["matmul_flops"],
                 "matmul_ms_at_peak": 1e3 * c["matmul_flops"]
                 / HW["peak_flops_bf16_dense"]},
        "collectives": c["collectives"],
        "top_buffers": top_buffers(roles),
        "trace_s": round(trace_s, 1), "hw": HW,
    }


def run_dpsnn_cell(grid: str, multi_pod: bool, n_steps: int = 50) -> dict:
    """One DPSNN cell: the reference's skip rule, ``synapses_equiv`` and
    ``model_flops``; per-shard state, parameter and halo bytes from the
    port's shapes and accounting."""
    from repro_torch.configs.dpsnn import GRIDS
    from repro_torch.core import exchange
    from repro_torch.core import network as net
    from repro_torch.runtime.compression import halo_payload_bytes

    cfg = GRIDS[grid]
    axes = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    head = {"arch": f"dpsnn-{grid}", "shape": f"{n_steps}steps",
            "mesh": _mesh_name(multi_pod)}
    row_shards = axes["data"] * axes.get("pod", 1)
    if cfg.grid_h % row_shards:
        return {**head, "skipped": True,
                "reason": f"grid {cfg.grid_h} rows not divisible by "
                          f"{row_shards} row shards (paper scales small "
                          f"grids only to small core counts)"}
    t0 = time.time()
    n_ranks = math.prod(axes.values())
    shapes, spec, _ = exchange.stacked_state_shapes(cfg, n_ranks)
    present = exchange._state_structure(cfg, lambda name: name)
    names = [x for x in _names(present)]
    state_bytes = sum(math.prod(shapes[k][0][1:]) * np.dtype(shapes[k][1]).itemsize
                      for k in names)
    one = net.build_params(cfg, torch.zeros(1, dtype=torch.int32))
    param_bytes = spec.columns_per_tile * sum(
        x.numel() * x.element_size() for x in one)
    halo = halo_payload_bytes(cfg, spec)["bytes_per_step"]
    n = cfg.neurons_per_column
    per_step = 2 * cfg.n_columns * n * (n + cfg.remote_fanin)
    return {
        **head, "chips": n_ranks, "kind": "simulate",
        "synapses_equiv": cfg.total_equivalent_synapses,
        "model_flops": per_step * n_steps, "n_steps": n_steps,
        "tile": [spec.tile_h, spec.tile_w],
        "memory": {"state_bytes": state_bytes, "params_bytes": param_bytes,
                   "argument_bytes": state_bytes + param_bytes,
                   "temp_bytes": "not measured"},
        "arguments_fit_hbm": state_bytes + param_bytes <= HW["hbm_bytes"],
        "collectives": {"bytes": {"collective-permute": halo * n_steps},
                        "bytes_per_step": halo,
                        "total_bytes": halo * n_steps},
        "trace_s": round(time.time() - t0, 1), "hw": HW,
    }


def _names(tree) -> list:
    """The leaf names a ``_state_structure`` of names holds."""
    if tree is None:
        return []
    if isinstance(tree, str):
        return [tree]
    return [x for v in tree for x in _names(v)]


def all_cells():
    """The reference's cells: every arch x shape on 16x16 then on
    2x16x16, then the three grids on each."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    cells = [("lm", a, s, mp) for mp in (False, True)
             for a in ARCH_IDS for s in SHAPES]
    for grid in ("24x24", "48x48", "96x96"):
        cells.append(("dpsnn", grid, "50steps", False))
        cells.append(("dpsnn", grid, "50steps", True))
    return cells


def _tag(kind, a, s, mp) -> str:
    name = f"dpsnn-{a}" if kind == "dpsnn" else a
    return f"{name}_{s}_{_mesh_name(mp)}"


def _run_cell_process(cell, out: str, timeout: int) -> tuple:
    kind, a, s, mp = cell
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", out]
    cmd += ["--dpsnn", a] if kind == "dpsnn" else ["--arch", a, "--shape", s]
    if mp:
        cmd.append("--multipod")
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
        rc, text = r.returncode, r.stdout + "\n" + r.stderr
    except subprocess.TimeoutExpired as e:
        rc, text = 124, f"timed out after {timeout} s\n{e.stderr or ''}"
    return cell, rc, time.time() - t0, text


def run_all(out: str, timeout: int, jobs: int) -> int:
    """Every cell of :func:`all_cells` in its own process, ``jobs`` at a
    time; a cell whose JSON exists is skipped. Returns the failures; a
    failed cell's output goes to ``<tag>.json.err``."""
    os.makedirs(out, exist_ok=True)
    todo = []
    for cell in all_cells():
        path = os.path.join(out, _tag(*cell) + ".json")
        if os.path.exists(path):
            print(f"[skip cached] {_tag(*cell)}")
        else:
            todo.append(cell)
    failures = 0
    with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        for cell, rc, dt, text in pool.map(
                lambda c: _run_cell_process(c, out, timeout), todo):
            tag = _tag(*cell)
            if rc:
                failures += 1
                print(f"[dryrun] {tag} FAILED ({dt:.0f}s):\n{text[-2000:]}",
                      flush=True)
                with open(os.path.join(out, tag + ".json.err"), "w") as f:
                    f.write(text)
            else:
                print(f"[dryrun] {tag} ok ({dt:.0f}s)", flush=True)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--dpsnn")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once under --all")
    args = ap.parse_args(argv)

    if args.all:
        sys.exit(1 if run_all(args.out, args.timeout, args.jobs) else 0)
    t0 = time.perf_counter()
    torch.set_num_threads(1)
    if args.dpsnn:
        res = run_dpsnn_cell(args.dpsnn, args.multipod)
    else:
        start_fake_group(512 if args.multipod else 256)
        res = run_lm_cell(args.arch, args.shape, args.multipod)
    res["cell_s"] = round(time.perf_counter() - t0, 1)
    os.makedirs(args.out, exist_ok=True)
    name = f"{res['arch']}_{res.get('shape', '-')}_{res['mesh']}"
    with open(os.path.join(args.out, name + ".json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
