"""One gloo rank of ``tests/test_torch_lm_sharded.py``:

    python _lm_sharded_ranks.py REF_NPZ OUT_JSON ARCH[,ARCH...] TOL

with ``WORLD_SIZE`` = 4, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
set. Every rank builds the (2, 2) ``("data", "model")`` mesh and, for
each reduced arch from the reference's parameters (``REF_NPZ``, keys
``<arch>.<leaf path>``), runs in float32 the port's unsharded and
sharded paths on the same inputs: 2 train steps
(``make_train_step`` / ``make_sharded_train_step``), ``prefill_logits``,
and 4 decode steps from empty caches (placed by ``cache_shardings`` on
the mesh); for the first arch also the train steps under each of
:data:`CASES` (8-bit AdamW, whose ``Q8`` moments are also read against
the unsharded ones and their specs, and the parameters counted that
lie more than TOL of their leaf's scale away; adafactor; 2
microbatches). Rank 0 writes the readings to ``OUT_JSON``."""
import dataclasses
import json
import sys

import numpy as np
import torch

TRAIN = dict(batch=4, seq=32, steps=2)
DECODE = dict(batch=4, s_cache=8, steps=4)
# the first arch's train steps again under other TrainConfig fields
CASES = {"adamw8bit": dict(optimizer="adamw8bit"),
         "adafactor": dict(optimizer="adafactor"),
         "microbatch2": dict(microbatch=2)}


def batch_of(cfg, i: int, b: int, s: int) -> dict:
    rng = np.random.default_rng(700 + i)
    batch = {}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, 2 * s, cfg.d_model)).astype(np.float32)
    batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def leaf_diff(plain, sharded) -> float:
    """max |plain - sharded| / max(1, max |plain|)."""
    from torch.distributed.tensor import DTensor
    if isinstance(sharded, DTensor):
        sharded = sharded.full_tensor()
    plain, sharded = plain.detach().double(), sharded.detach().double()
    return float((plain - sharded).abs().max()
                 / max(1.0, float(plain.abs().max())))


def beyond(plain, sharded, tol: float) -> int:
    """The elements of ``sharded`` more than ``tol * max(1, max
    |plain|)`` from ``plain``."""
    from torch.distributed.tensor import DTensor
    if isinstance(sharded, DTensor):
        sharded = sharded.full_tensor()
    plain, sharded = plain.detach().double(), sharded.detach().double()
    limit = tol * max(1.0, float(plain.abs().max()))
    return int(((plain - sharded).abs() > limit).sum())


def run_arch(arch: str, tree: dict, mesh, tol: float, cases=None) -> dict:
    import repro_torch.configs as C
    from repro_torch import convert
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train as TR
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.runtime import sharding as SH

    cfg = C.reduced_config(arch)
    model = build_model(cfg, device="cpu")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2)

    def carried():
        return convert.lm_params_from_numpy(cfg, tree, "cpu")

    def train(tcfg) -> dict:
        opt_init, _ = make_optimizer(tcfg)

        def fresh_state():
            params = carried().requires_grad_(True)
            return TR.TrainState(params, opt_init(TR.Leaves(params).params()),
                                 0)

        out = {"loss": [], "loss_sharded": []}
        plain = fresh_state()
        sharded = TR.shard_state(fresh_state(), model, mesh)
        step_plain = TR.make_train_step(model, tcfg)
        step_sharded = TR.make_sharded_train_step(model, tcfg, mesh)
        for i in range(TRAIN["steps"]):
            batch = batch_of(cfg, i, TRAIN["batch"], TRAIN["seq"])
            plain, m1 = step_plain(plain, batch)
            sharded, m2 = step_sharded(sharded, batch)
            out["loss"].append(float(m1["loss"]))
            out["loss_sharded"].append(float(m2["loss"]))
        out["params"] = max(leaf_diff(a, b) for a, b in zip(
            plain.params.parameters(), sharded.params.parameters()))
        out["placed"] = sorted({str(tuple(p.placements))
                                for p in sharded.params.parameters()})
        if tcfg.optimizer == "adamw8bit":
            pairs = list(zip(plain.params.parameters(),
                             sharded.params.parameters()))
            out["params_beyond"] = (
                sum(beyond(a, b, tol) for a, b in pairs)
                / sum(a.numel() for a, _ in pairs))
            out.update(q8_readings(plain.opt, sharded, tcfg))
        return out

    def q8_readings(plain, state, tcfg) -> dict:
        """The sharded Q8 moments: each q and scale against the
        unsharded one (the share of q's int8 entries that differ, the
        largest scale difference) and whether every one is placed by
        ``state_shardings``'s spec, as are the zeros ``init`` makes of
        the sharded parameters once ``place_opt`` has placed them."""
        _, specs = TR.state_shardings(model, tcfg, mesh)

        def placed(opt) -> bool:
            return all(
                list(z.q.placements)
                == SH.placements(specs.opt[slot][path].q, mesh)
                and list(z.scale.placements)
                == SH.placements(specs.opt[slot][path].scale, mesh)
                for slot in ("m", "v") for path, z in opt[slot].items())
        sharded = state.opt
        q_off, q_all, scale = 0, 0, 0.0
        for slot in ("m", "v"):
            for path, z in sharded[slot].items():
                want = plain[slot][path]
                q = z.q.full_tensor()
                q_off += int((q != want.q).sum())
                q_all += q.numel()
                scale = max(scale, leaf_diff(want.scale, z.scale))
        opt_init, _ = make_optimizer(tcfg)
        zeros = TR.place_opt(opt_init(TR.Leaves(state.params).params()),
                             mesh, cfg)
        return {"q8_flipped": q_off / q_all, "q8_scale": scale,
                "q8_placed": placed(sharded),
                "q8_init_placed": placed(zeros) and not any(
                    bool(z.q.full_tensor().any())
                    for slot in ("m", "v") for z in zeros[slot].values())}

    out = train(tcfg)

    # serving from the reference's parameters
    p_plain, p_sharded = carried(), carried()
    SH.place_params(p_sharded, mesh, cfg)
    batch = batch_of(cfg, 9, TRAIN["batch"], TRAIN["seq"])
    batch.pop("labels")
    want = model.prefill_logits(p_plain, batch)
    with SH.use_mesh(mesh):
        got = model.prefill_logits(p_sharded, SH.place_batch(batch, mesh))
    out["prefill"] = leaf_diff(want, got)

    b, s = DECODE["batch"], DECODE["s_cache"]
    c_plain = model.cache_init(b, s)
    c_sharded = SH.place_caches(cfg, model.cache_init(b, s), mesh)
    toks = batch_of(cfg, 11, b, DECODE["steps"])["tokens"]
    out["decode"] = []
    for pos in range(DECODE["steps"]):
        tok = toks[:, pos:pos + 1]
        want, c_plain = model.decode(p_plain, c_plain, tok, pos)
        with SH.use_mesh(mesh), torch.no_grad():
            got, c_sharded = model.decode(
                p_sharded, c_sharded, SH.place_batch({"t": tok}, mesh)["t"],
                pos)
        out["decode"].append(leaf_diff(want, got))
    # the other optimizers and microbatches, on the first arch only
    out["cases"] = {name: train(dataclasses.replace(tcfg, **kw))
                    for name, kw in (cases or {}).items()}
    return out


def main(ref_npz: str, out_json: str, archs: list, tol: float) -> None:
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo")
    mesh = make_host_mesh((2, 2), ("data", "model"))
    ref = dict(np.load(ref_npz))
    results = {}
    for arch in archs:
        tree = convert.lm_unflatten({k[len(arch) + 1:]: v
                                     for k, v in ref.items()
                                     if k.startswith(arch + ".")})
        results[arch] = run_arch(arch, tree, mesh, tol,
                                 CASES if arch == archs[0] else None)
    if dist.get_rank() == 0:
        with open(out_json, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3].split(","),
         float(sys.argv[4]))
