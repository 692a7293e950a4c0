"""Serve a small model with batched requests on the PyTorch/H100 port:
prefill via teacher-forced decode, then batched greedy generation.

    PYTHONPATH=src python examples/torch_serve_decode.py --arch granite-3-2b [--device cpu]

The counterpart of ``examples/serve_decode.py``, with its flags and its
loop, plus ``--device`` (the card by default; ``cpu`` for the plain
run, and without a card the default raises). Every arch of
``repro_torch.configs.ARCH_IDS`` serves: the dense, MoE, VLM, Mamba2
and Zamba2 stacks from their empty caches, whisper, as the reference's
example does, over ``cache_init``'s zeroed cross caches. The reduced
config of the arch is built on the device with parameters drawn from a
generator seeded with 0, and the prompts are
``jax.random.randint(PRNGKey(1), ...)``'s own draws
(``repro_torch.core.prng``), so that the reference's parameters carried
in give the reference's tokens.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

import repro_torch.configs as C  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models.model import build_model, greedy  # noqa: E402


def main(argv=None, params=None):
    """Runs the loop and returns the generated tokens (batch, gen);
    ``params`` replaces the drawn parameters (the tests carry the
    reference's in with ``convert.lm_params_from_numpy``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = C.reduced_config(args.arch)
    model = build_model(cfg, device=args.device)
    if params is None:
        params = model.init()
    b = args.batch
    prompts = prng.randint(prng.prng_key(1, model.device),
                           (b, args.prompt_len), 0, cfg.vocab_size)
    t0 = time.perf_counter()
    with torch.no_grad():
        gen, _ = greedy(model, params, prompts, args.gen)
    gen = gen.cpu()
    dt = time.perf_counter() - t0
    total_steps = args.prompt_len + args.gen - 1
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "this host's CPU")
    print(f"{args.arch} (reduced): batch {b}, "
          f"{total_steps} decode steps in {dt:.2f}s "
          f"-> {b * total_steps / dt:.0f} tok/s on {where}")
    print(f"request 0 tokens: {gen[0, :12].tolist()} ...")
    return gen


if __name__ == "__main__":
    main()
