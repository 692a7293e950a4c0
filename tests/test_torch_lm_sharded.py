"""The port's sharded LM path on 4 gloo CPU ranks, a (2, 2) ``("data",
"model")`` ``DeviceMesh``, against its unsharded path on the same
inputs (``tests/_lm_sharded_ranks.py``): reduced qwen3-0.6b, gemma2-9b,
llama4-scout, mamba2-780m and whisper-medium in float32 with TF32 off,
from the reference's ``init`` parameters (one JAX subprocess for the
module; ``convert.lm_params_from_numpy``):

- 2 steps of ``launch/train.make_sharded_train_step`` against
  ``make_train_step``: each step's loss within :data:`LOSS_RTOL`
  relative, every gathered parameter within :data:`PARAM_TOL`; for
  qwen3 also under 8-bit AdamW (its ``Q8`` moments placed by
  ``state_shardings``), adafactor and 2 microbatches;
- ``prefill_logits`` and 4 decode steps (caches placed by
  ``cache_shardings``) within :data:`SERVE_TOL`;
- the launcher's several-rank path: 2 steps of reduced qwen3 on 4 ranks
  print the losses its one-rank run prints (4 decimals, within one unit
  of the last), with AdamW and with 8-bit AdamW.

The unsharded port is held to JAX by ``tests/test_torch_lm_*.py``."""
import json
import os
import pathlib
import re
import socket
import subprocess
import sys

import pytest
import torch
from _jax_background import JaxInBackground
from _subproc import SRC

HERE = pathlib.Path(__file__).resolve().parent
ARCHS = ("qwen3-0.6b", "gemma2-9b", "llama4-scout-17b-a16e", "mamba2-780m",
         "whisper-medium")
# readings on these draws: loss 1.1e-7 relative and below; parameters
# 1.3e-8 (the zero-initialised norm scales after one update of 5e-4);
# prefill and decode logits 2e-6 and below
LOSS_RTOL = 1e-6
PARAM_TOL = 1e-5
SERVE_TOL = 1e-5
# 8-bit AdamW: a last-bit gradient difference rounds an int8 code of
# the moments the other way now and then, and an element whose 8-bit
# second moment rounded to 0 then takes an update m / sqrt(v) far from
# the other's (tests/test_torch_lm_train.py, whose limits these are):
# the share of the codes that differ, and of the parameter elements
# beyond PARAM_TOL (readings: 1.4e-5 and 1.7e-4)
Q8_CODE_SHARE = 1e-4
Q8_PARAM_SHARE = 1e-3
RANKS = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


JAX_PARAMS = """
import jax, numpy as np
import repro.configs as C
from repro.models.model import build_model

def flat(tree, prefix):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return {{}}
    else:
        return {{prefix: np.asarray(tree)}}
    out = {{}}
    for k, v in items:
        out.update(flat(v, '%s.%s' % (prefix, k)))
    return out

out = {{}}
for i, arch in enumerate({archs!r}):
    cfg = C.reduced_config(arch)
    out.update(flat(build_model(cfg).init(jax.random.PRNGKey(40 + i)), arch))
np.savez({out!r}, **out)
print('OK')
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(WORLD_SIZE=str(RANKS), RANK=str(rank), LOCAL_RANK=str(rank),
               MASTER_ADDR="localhost", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def run_ranks(args: list, timeout: int = 900) -> list:
    """``python args`` on 4 ranks of one gloo group; their outputs, all
    exited 0."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, *args], env=rank_env(r, port),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_sharded")
    ref = tmp / "ref.npz"
    job = JaxInBackground(JAX_PARAMS.format(archs=ARCHS, out=str(ref)),
                          n_devices=1, timeout=600)
    try:
        assert "OK" in job.result()
    finally:
        job.stop()
    out = tmp / "readings.json"
    run_ranks([str(HERE / "_lm_sharded_ranks.py"), str(ref), str(out),
               ",".join(ARCHS), str(PARAM_TOL)])
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_unsharded(readings, arch):
    r = readings[arch]
    assert len(r["loss"]) == 2
    for plain, sharded in zip(r["loss"], r["loss_sharded"]):
        assert abs(sharded - plain) <= LOSS_RTOL * abs(plain), r
    assert r["params"] <= PARAM_TOL, r
    # the mesh was used: some parameter is sharded on each mesh dim
    assert any("Shard" in p.split(",")[0] for p in r["placed"]), r
    assert any("Shard" in p.split(",")[1] for p in r["placed"]), r


@pytest.mark.parametrize("case", ("adamw8bit", "adafactor", "microbatch2"))
def test_sharded_train_cases_match_unsharded(readings, case):
    """Reduced qwen3's sharded steps under 8-bit AdamW, adafactor and 2
    microbatches. 8-bit AdamW: the moments' q and scale placed by
    ``state_shardings`` (also ``init``'s zeros of the sharded parameters,
    once placed), the scales within PARAM_TOL, the codes and the
    parameters within PARAM_TOL but for :data:`Q8_CODE_SHARE` and
    :data:`Q8_PARAM_SHARE` of their elements."""
    r = readings[ARCHS[0]]["cases"][case]
    assert len(r["loss"]) == 2
    for plain, sharded in zip(r["loss"], r["loss_sharded"]):
        assert abs(sharded - plain) <= LOSS_RTOL * abs(plain), r
    if case != "adamw8bit":
        assert r["params"] <= PARAM_TOL, r
        return
    assert r["q8_placed"] and r["q8_init_placed"], r
    assert r["q8_scale"] <= PARAM_TOL, r
    assert r["q8_flipped"] <= Q8_CODE_SHARE, r
    assert r["params_beyond"] <= Q8_PARAM_SHARE, r


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches_unsharded(readings, arch):
    r = readings[arch]
    assert r["prefill"] <= SERVE_TOL, r
    assert len(r["decode"]) == 4 and max(r["decode"]) <= SERVE_TOL, r


def _losses(text: str) -> list:
    return [float(x) for x in re.findall(r"step +\d+ loss ([-\d.]+)", text)]


def test_launcher_trains_on_four_ranks():
    launcher_on_four_ranks()


def test_launcher_trains_adamw8bit_on_four_ranks():
    launcher_on_four_ranks("--optimizer", "adamw8bit")


def launcher_on_four_ranks(*extra):
    args = ["-m", "repro_torch.launch.train", "--device", "cpu",
            "--steps", "2", "--batch", "4", "--seq", "32", *extra]
    outs = run_ranks(args)
    sharded = _losses(outs[0])
    assert len(sharded) == 2 and not any(_losses(o) for o in outs[1:])
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    one = subprocess.run([sys.executable, *args], env=env, text=True,
                         capture_output=True, timeout=300)
    assert one.returncode == 0, one.stderr[-4000:]
    plain = _losses(one.stdout)
    assert len(plain) == 2
    for a, b in zip(plain, sharded):
        assert abs(a - b) <= 1e-4, (plain, sharded)
