"""Training step and the end-to-end training launcher of the PyTorch port:
the counterpart of ``repro/launch/train.py``.

``make_train_step(model, tcfg)`` returns ``step(state, batch) ->
(state, metrics)``: the loss and its gradient (autograd through
``Model.train_loss``, remat per ``cfg.remat``), microbatch accumulation,
the optional int8 + error-feedback round trip, and the optimizer. The
gradients and the optimizer work on the reference's leaves (each
reference leaf path's stacked layers, :class:`Leaves`), so every
optimizer and the compression see what the reference's pytree holds;
the new values are copied back into the model's parameters.

On a ``(data, model)`` ``DeviceMesh`` (the reference's
``make_jitted_train_step``): :func:`state_shardings` gives the state's
specs by the reference's rule (``runtime/sharding.param_spec``),
:func:`shard_state` places a state on the mesh (each parameter a
DTensor of its per-layer spec, each optimizer leaf of its stacked
leaf's spec), and ``make_train_step(model, tcfg, mesh)`` (also under the
reference's name, :func:`make_sharded_train_step`) returns the step that
places the batch over the data axes (``batch_shardings``), runs under
``use_mesh`` (the model's constraint sites, the microbatch accumulator
placed like the parameters, the optimizer's new state placed as it was)
and returns the metrics replicated.

The launcher (``python -m repro_torch.launch.train --arch qwen3-0.6b
--steps 20 [--device cpu]``) trains a reduced config with checkpoints
(``runtime/fault_tolerance.py``), the straggler watchdog and optional
int8-EF compression. It runs on the card unless ``--device cpu``
(without a card ``cuda`` raises; there is no fallback). Started with
several ranks (``torchrun``, or any launcher that sets ``WORLD_SIZE``,
``RANK`` and ``MASTER_ADDR``) it trains on a (world / 2, 2) ``(data,
model)`` mesh, as the reference's ``main`` does with several devices
(gloo on the CPU, NCCL on cards); with one rank it runs as before.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.models import layers as L
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizer import Q8, make_optimizer
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.compression import (EFState, compress_grads,
                                             decompress_grads, ef_init)


class TrainState(NamedTuple):
    params: Any        # the model's parameters (an nn.Module), grads on
    opt: dict          # optimizer state over the reference's leaves
    step: int          # host counter


class Leaves:
    """The reference's leaves of a port model (``convert.
    lm_leaf_entries``): :meth:`params` and :meth:`grads` stack each
    leaf path's layers into one tensor, :meth:`assign` copies stacked
    values back into the parameters."""

    def __init__(self, params):
        self.module = params
        self.entries = convert.lm_leaf_entries(params)

    def _gather(self, of) -> dict:
        out = {}
        for path, (dims, shape, ps) in self.entries.items():
            xs = [of(p) for p in ps]
            out[path] = (torch.stack(xs).reshape(dims + shape) if dims
                         else xs[0])
        return out

    def params(self) -> dict:
        return self._gather(lambda p: p.detach())

    def grads(self) -> dict:
        """Each parameter's ``.grad`` (zeros for one the loss did not
        reach, as JAX's gradient has)."""
        return self._gather(lambda p: p.grad if p.grad is not None
                            else torch.zeros_like(p))

    def shapes(self) -> dict:
        return {path: dims + shape
                for path, (dims, shape, _) in self.entries.items()}

    @torch.no_grad()
    def assign(self, tree: dict) -> None:
        """On a mesh a stacked leaf is first brought to its parameters'
        placements, its stack dims replicated."""
        for path, (dims, shape, ps) in self.entries.items():
            x = tree[path]
            if isinstance(ps[0], DTensor):
                x = x.redistribute(ps[0].device_mesh, [
                    Shard(q.dim + len(dims)) if q.is_shard() else Replicate()
                    for q in ps[0].placements])
            for p, xi in zip(ps, x.reshape((len(ps),) + shape)):
                p.copy_(xi)


def init_state(model: Model, tcfg: TrainConfig, generator=None
               ) -> TrainState:
    """Parameters from ``model.init(generator)`` with gradients on, the
    optimizer's state, step 0; under ``int8_ef`` compression the EF
    residual in the ``"ef"`` slot (the reference's ``init_state`` leaves
    it out and its own test adds it by hand)."""
    opt_init, _ = make_optimizer(tcfg)
    params = model.init(generator).requires_grad_(True)
    leaves = Leaves(params).params()
    opt = opt_init(leaves)
    if tcfg.grad_compression == "int8_ef":
        opt["ef"] = ef_init(leaves)
    return TrainState(params=params, opt=opt, step=0)


def _on(batch: dict, device) -> dict:
    return {k: v if isinstance(v, DTensor) else
            (torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v)
             else v).to(device) for k, v in batch.items()}


def _microbatches(batch: dict, mb: int, mesh) -> list[dict]:
    """The batch's rows split into ``mb`` microbatches in order. On a
    mesh each leaf is gathered, split, and each microbatch placed over
    the data axes again (a split of the sharded row dim would put whole
    microbatches on single ranks)."""
    if mesh is not None:
        batch = {k: SH.settle(x).redistribute(
                     mesh, SH.placements((None,) * x.ndim, mesh))
                 for k, x in batch.items()}
    split = {k: x.reshape(mb, x.shape[0] // mb, *x.shape[1:])
             for k, x in batch.items()}
    out = [{k: x[i] for k, x in split.items()} for i in range(mb)]
    if mesh is not None:
        specs = SH.batch_shardings(out[0], mesh)
        out = [{k: x.redistribute(mesh, SH.placements(specs[k], mesh))
                for k, x in m.items()} for m in out]
    return out


def make_train_step(model: Model, tcfg: TrainConfig, mesh=None):
    """``step(state, batch) -> (state, metrics)``; ``batch`` holds
    tensors or numpy arrays (moved to the model's device). The model's
    parameters are updated in place and the state's ``params`` is the
    same module. Metrics (0-d tensors): ``loss``, ``xent``,
    ``load_balance``, ``router_z`` (each the mean over microbatches),
    ``grad_norm`` and ``lr``.

    With a ``mesh``, the counterpart of the reference's
    ``make_jitted_train_step``: the step takes a state placed by
    :func:`shard_state` and the full batch on every rank (or meta
    tensors), places the batch by ``batch_shardings``, runs under
    ``use_mesh(mesh)`` (the accumulator placed like the parameters, the
    optimizer's new state placed as it was) and returns the metrics as
    plain tensors, the same on every rank."""
    _, opt_update = make_optimizer(tcfg)
    cache: dict = {}

    def leaves_of(params) -> Leaves:
        if cache.get("leaves") is None or cache["leaves"].module is not params:
            cache["leaves"] = Leaves(params)
        return cache["leaves"]

    def grads_of(params, leaves, batch):
        for p in params.parameters():
            p.grad = None
        with torch.enable_grad():
            loss, metrics = model.train_loss(params, batch)
            loss.backward()
        grads = leaves.grads()
        for p in params.parameters():
            p.grad = None
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(state: TrainState, batch):
        params = state.params
        leaves = leaves_of(params)
        batch = _on(batch, model.device)
        mb = max(tcfg.microbatch, 1)
        if mb > 1:
            # gradient accumulation: the batch's rows split into mb
            # microbatches in order, gradients summed in accum_dtype;
            # on a mesh the accumulator is placed like the parameters
            acc_dt = L.torch_dtype(tcfg.accum_dtype)
            gsum = SH.constrain_like_params(
                {k: torch.zeros_like(x, dtype=acc_dt)
                 for k, x in leaves.params().items()}, model.cfg)
            losses, metricses = [], []
            for part in _microbatches(batch, mb, mesh):
                loss, metrics, g = grads_of(params, leaves, part)
                gsum = {k: a + g[k].to(acc_dt) for k, a in gsum.items()}
                losses.append(loss)
                metricses.append(metrics)
            grads = {k: g / mb for k, g in gsum.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        else:
            loss, metrics, grads = grads_of(params, leaves, batch)
        opt_core = {k: v for k, v in state.opt.items() if k != "ef"}
        if tcfg.grad_compression == "int8_ef":
            # int8 + error feedback; the residual rides in the "ef" slot
            if "ef" not in state.opt:
                raise KeyError("grad_compression='int8_ef' needs the EF "
                               "residual in opt['ef'] (init_state adds it)")
            q, ef = compress_grads(grads, state.opt["ef"])
            grads = decompress_grads(q, grads)
        new_params, opt, om = opt_update(grads, opt_core, leaves.params(),
                                         state.step)
        leaves.assign(new_params)
        if tcfg.grad_compression == "int8_ef":
            opt["ef"] = ef
        if mesh is not None:
            opt = place_opt(opt, mesh, model.cfg)
        return (TrainState(params=params, opt=opt, step=state.step + 1),
                {"loss": loss, **metrics, **om})

    if mesh is None:
        return train_step

    def sharded_step(state: TrainState, batch):
        batch = _on(batch, model.device)
        with SH.use_mesh(mesh):
            state, metrics = train_step(state, SH.place_batch(batch, mesh))
            metrics = {k: _full(v) for k, v in metrics.items()}
        return state, metrics

    return sharded_step


# ---------------------------------------------------------------------------
# On a DeviceMesh
# ---------------------------------------------------------------------------

def _opt_map(opt: dict, fn) -> dict:
    """``fn(x, the reference's path string of x)`` over every optimizer
    leaf, the same structure back: ``"['m']/['groups']/[0]/['attn']/
    ['wq']"``, a ``Q8``'s ``q`` and ``scale`` as JAX flattens a
    registered node (``/[<flat index 0>]``, ``/[<flat index 1>]``),
    adafactor's slots by key, the EF residual under ``.residual``."""
    out = {}
    for slot, leaves in opt.items():
        if isinstance(leaves, EFState):
            out[slot] = EFState(residual={
                path: fn(x, f"['ef']/.residual/{SH.jax_path(path)}")
                for path, x in leaves.residual.items()})
            continue
        new = {}
        for path, x in leaves.items():
            base = f"['{slot}']/{SH.jax_path(path)}"
            if isinstance(x, Q8):
                new[path] = Q8(fn(x.q, base + "/[<flat index 0>]"),
                               fn(x.scale, base + "/[<flat index 1>]"),
                               x.shape)
            elif isinstance(x, dict):
                new[path] = {k: fn(v, f"{base}/['{k}']")
                             for k, v in x.items()}
            else:
                new[path] = fn(x, base)
        out[slot] = new
    return out


def state_shardings(model: Model, tcfg: TrainConfig, mesh):
    """(the ``TrainState`` of meta tensors, the ``TrainState`` of specs):
    parameters {leaf path: the reference's spec of the stacked leaf}
    (``sharding.param_shardings``), the optimizer's leaves each by the
    reference's rule on its own path string and shape (as the
    reference's ``spec_tree`` over ``shapes.opt``), the step ()."""
    shapes = init_state(model if model.device.type == "meta"
                        else Model(model.cfg, torch.device("meta")), tcfg)
    cfg = model.cfg
    specs = TrainState(
        params=SH.param_shardings(shapes.params, mesh, cfg),
        opt=_opt_map(shapes.opt, lambda x, p: SH.param_spec(
            p, tuple(x.shape), mesh, cfg)),
        step=())
    return shapes, specs


def place_opt(opt: dict, mesh, cfg) -> dict:
    """Every optimizer leaf as a DTensor of its reference spec (a plain
    tensor distributed, a DTensor redistributed)."""
    def one(x, path):
        spec = SH.param_spec(path, tuple(x.shape), mesh, cfg)
        if isinstance(x, DTensor):
            return x.redistribute(mesh, SH.placements(spec, mesh))
        return SH.distribute(x, mesh, spec)
    return _opt_map(opt, one)


def shard_state(state: TrainState, model: Model, mesh) -> TrainState:
    """The state on ``mesh``: every parameter of the module replaced by a
    DTensor of its per-layer spec (``sharding.place_params``; the same
    full values on every rank, each keeping its shard), the optimizer's
    leaves placed by :func:`place_opt`. The module is changed in place."""
    SH.place_params(state.params, mesh, model.cfg)
    return TrainState(params=state.params,
                      opt=place_opt(state.opt, mesh, model.cfg),
                      step=state.step)


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_sharded_train_step(model: Model, tcfg: TrainConfig, mesh):
    """The reference's name for :func:`make_train_step` on a mesh."""
    return make_train_step(model, tcfg, mesh)


def state_to_numpy(state: TrainState) -> TrainState:
    """The state as numpy trees in the reference's layout (parameters
    stacked, ``convert.lm_params_to_numpy``; the optimizer by leaf path,
    ``convert.lm_opt_to_numpy``), what a checkpoint holds."""
    return TrainState(params=convert.lm_params_to_numpy(state.params),
                      opt=convert.lm_opt_to_numpy(state.opt),
                      step=np.int32(state.step))


def state_from_numpy(model: Model, tree) -> TrainState:
    """The inverse of :func:`state_to_numpy`, on the model's device,
    gradients on."""
    params = convert.lm_params_from_numpy(model.cfg, tree.params,
                                          model.device).requires_grad_(True)
    opt = convert.lm_opt_from_numpy(tree.opt, Leaves(params).shapes(),
                                    model.device)
    return TrainState(params=params, opt=opt, step=int(tree.step))


# ---------------------------------------------------------------------------
# CLI (reduced configs)
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.runtime.fault_tolerance import (CheckpointPolicy,
                                                     StragglerWatchdog)

    cfg = reduced_config(args.arch)
    tcfg = TrainConfig(grad_compression=args.grad_compression,
                       optimizer=args.optimizer)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = 0
    if world > 1:
        # several ranks: a (world / 2, 2) (data, model) mesh, as the
        # reference's main makes of several devices
        mesh, device, rank = _rank_mesh(args.device, world)
        model = build_model(cfg, device=device)
        state = shard_state(init_state(model, tcfg), model, mesh)
        step_fn = make_sharded_train_step(model, tcfg, mesh)
    else:
        model = build_model(cfg, device=args.device)
        step_fn = make_train_step(model, tcfg)
        state = init_state(model, tcfg)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=1)
    watchdog = StragglerWatchdog()
    policy = (CheckpointPolicy(args.ckpt_dir, every_steps=10)
              if args.ckpt_dir and rank == 0 else None)
    for step in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, pipe.make_batch(step))
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        watchdog.observe(step, dt)
        if args.ckpt_dir:
            # every rank gathers (a collective on a mesh), rank 0 writes
            tree = state_to_numpy(state)
            if policy:
                policy.maybe_save(step, tree)
        if rank == 0:
            print(f"step {step:4d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f} ms",
                  flush=True)
    if policy:
        policy.wait()
    if world > 1:
        torch.distributed.destroy_process_group()


def _rank_mesh(device: str, world: int):
    """(the (world / 2, 2) mesh, this rank's device, its rank) of a run
    started with several ranks (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT`` set by the launcher): gloo on the
    CPU, NCCL with one card a rank on ``cuda``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    if world % 2:
        raise ValueError(f"{world} ranks do not make a (data, 2) mesh")
    on_cpu = torch.device(device).type == "cpu"
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    if not on_cpu:
        torch.cuda.set_device(local)
    dist.init_process_group("gloo" if on_cpu else "nccl")
    dev = "cpu" if on_cpu else f"cuda:{local}"
    return (make_host_mesh((world // 2, 2), ("data", "model")), dev,
            dist.get_rank())


if __name__ == "__main__":
    main()
