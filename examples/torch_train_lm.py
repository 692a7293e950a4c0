"""End-to-end training script of the PyTorch port: train a ~100M-param
qwen3-family model for a few hundred steps on the synthetic Markov
stream, with checkpoints, the straggler watchdog, and resume on restart
(the counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    (rerun the same command after a kill -> resumes from the snapshot)

On the card by default; ``--device cpu`` runs it on the CPU (slowly at
this size).
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.configs as C
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.train import (init_state, make_train_step,
                                      state_from_numpy, state_to_numpy)
from repro_torch.models.model import build_model
from repro_torch.runtime.fault_tolerance import (CheckpointPolicy,
                                                 StragglerWatchdog)


def hundred_m_config():
    """~100M params in the qwen3 family (12L x 512, vocab 32k)."""
    base = C.get_config("qwen3-0.6b")
    return dataclasses.replace(
        base, name="qwen3-100m", num_layers=12, d_model=512, d_ff=2048,
        vocab_size=32768,
        attn=dataclasses.replace(base.attn, num_heads=8, num_kv_heads=4,
                                 head_dim=64),
        dtype="float32", remat="none")


def train(cfg, tcfg, *, steps, batch, seq, ckpt, device="cuda", every=50):
    """Train ``cfg`` up to step ``steps`` from the latest checkpoint
    under ``ckpt`` (if any), saving every ``every`` steps (async).
    Returns the final state."""
    model = build_model(cfg, device=device)
    step_fn = make_train_step(model, tcfg)
    pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=17)
    policy = CheckpointPolicy(ckpt, every_steps=every, async_save=True)
    watchdog = StragglerWatchdog(
        on_straggler=lambda s, t, e: print(
            f"  [watchdog] step {s} took {t:.2f}s vs EWMA {e:.2f}s"))

    state = init_state(model, tcfg)
    start = 0
    try:
        tree, start = policy.restore_latest(state_to_numpy(state))
        state = state_from_numpy(model, tree)
        start += 1
        print(f"resumed from checkpoint at step {start - 1}")
    except (FileNotFoundError, ValueError):
        pass

    try:
        for step in range(start, steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, pipe.make_batch(step))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            watchdog.observe(step, dt)
            policy.maybe_save(step, state_to_numpy(state))
            if step % 10 == 0:
                print(f"step {step:4d}  loss {loss:7.4f}  "
                      f"gnorm {float(metrics['grad_norm']):7.3f}  "
                      f"{batch * seq / dt / 1e3:.1f}k tok/s", flush=True)
    finally:
        policy.wait()
    return state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = hundred_m_config()
    print(f"{cfg.name}: {cfg.param_count()/1e6:.0f}M params")
    train(cfg, TrainConfig(learning_rate=6e-4, warmup_steps=30),
          steps=args.steps, batch=args.batch, seq=args.seq, ckpt=args.ckpt,
          device=args.device)
    print("done.")


if __name__ == "__main__":
    main()
