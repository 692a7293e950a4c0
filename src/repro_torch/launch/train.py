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

The launcher (``python -m repro_torch.launch.train --arch qwen3-0.6b
--steps 20 [--device cpu]``) trains a reduced config with checkpoints
(``runtime/fault_tolerance.py``), the straggler watchdog and optional
int8-EF compression. It runs on the card unless ``--device cpu``
(without a card ``cuda`` raises; there is no fallback). The mesh half
of the reference (``state_shardings``, ``make_jitted_train_step``)
waits for ROADMAP queue 1 item 8e.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.models import layers as L
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.runtime.compression import (compress_grads,
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
        for path, (_, shape, ps) in self.entries.items():
            for p, x in zip(ps, tree[path].reshape((len(ps),) + shape)):
                p.copy_(x)


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
    return {k: (torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v)
                else v).to(device) for k, v in batch.items()}


def make_train_step(model: Model, tcfg: TrainConfig):
    """``step(state, batch) -> (state, metrics)``; ``batch`` holds
    tensors or numpy arrays (moved to the model's device). The model's
    parameters are updated in place and the state's ``params`` is the
    same module. Metrics (0-d tensors): ``loss``, ``xent``,
    ``load_balance``, ``router_z`` (each the mean over microbatches),
    ``grad_norm`` and ``lr``."""
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
            # microbatches in order, gradients summed in accum_dtype
            acc_dt = L.torch_dtype(tcfg.accum_dtype)
            split = {k: x.reshape(mb, x.shape[0] // mb, *x.shape[1:])
                     for k, x in batch.items()}
            gsum = {k: torch.zeros(x.shape, dtype=acc_dt, device=x.device)
                    for k, x in leaves.params().items()}
            losses, metricses = [], []
            for i in range(mb):
                loss, metrics, g = grads_of(
                    params, leaves, {k: x[i] for k, x in split.items()})
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
        return (TrainState(params=params, opt=opt, step=state.step + 1),
                {"loss": loss, **metrics, **om})

    return train_step


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
    model = build_model(cfg, device=args.device)
    tcfg = TrainConfig(grad_compression=args.grad_compression,
                       optimizer=args.optimizer)
    step_fn = make_train_step(model, tcfg)
    state = init_state(model, tcfg)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=1)
    watchdog = StragglerWatchdog()
    policy = (CheckpointPolicy(args.ckpt_dir, every_steps=10)
              if args.ckpt_dir else None)
    for step in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, pipe.make_batch(step))
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        watchdog.observe(step, dt)
        if policy:
            policy.maybe_save(step, state_to_numpy(state))
        print(f"step {step:4d} loss {loss:.4f} "
              f"gnorm {float(metrics['grad_norm']):.3f} "
              f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f} ms", flush=True)
    if policy:
        policy.wait()


if __name__ == "__main__":
    main()
