"""The port imports neither JAX nor the JAX package: every module of
``repro_torch`` (the checkpointer and the fault-tolerance runtime of the
durability slice, the LM zoo's configs, models, optimizers, data
pipeline and trainer, the mesh rules, the cost count and the dry run
among them), ``chip_smoke.py`` and the port's example
scripts ``examples/torch_*.py`` (imported, not run) in a fresh
interpreter leave no ``jax`` or ``repro`` module behind, and start no
process group."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pathlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
import runpy
for script in sorted(pathlib.Path('examples').glob('torch_*.py')):
    runpy.run_path(str(script), run_name='example')
    names.append(str(script))
bad = sorted(m for m in sys.modules
             if m in ('jax', 'repro', 'jaxlib')
             or m.startswith(('jax.', 'repro.', 'jaxlib.')))
import torch.distributed as dist
print('GROUP', dist.is_initialized())
print('IMPORTED', len(names))
print('NAMES', ' '.join(names))
print('BAD', bad)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + env.get("PYTHONPATH", "").split(
            os.pathsep))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "GROUP False" in out.stdout, out.stdout
    n = int(out.stdout.split("IMPORTED ")[1].split()[0])
    assert n >= 15, out.stdout
    names = out.stdout.split("NAMES ")[1].split("\n")[0].split()
    for module in ("repro_torch.checkpoint", "repro_torch.checkpoint."
                   "checkpointer", "repro_torch.runtime.fault_tolerance",
                   "repro_torch.runtime.multiprocess",
                   "repro_torch.launch.launch_distributed",
                   "examples/torch_quickstart.py",
                   "examples/torch_simulate_cortex.py",
                   "repro_torch.configs.gemma2_9b",
                   "repro_torch.configs.zamba2_7b",
                   "repro_torch.models.layers",
                   "repro_torch.models.attention",
                   "repro_torch.models.transformer",
                   "repro_torch.models.moe",
                   "repro_torch.models.ssm",
                   "repro_torch.models.frontends",
                   "repro_torch.models.model",
                   "examples/torch_serve_decode.py",
                   "repro_torch.optim.optimizer",
                   "repro_torch.data.pipeline",
                   "repro_torch.launch.train",
                   "examples/torch_train_lm.py",
                   "repro_torch.runtime.sharding",
                   "repro_torch.launch.mesh",
                   "repro_torch.launch.cost",
                   "repro_torch.launch.dryrun"):
        assert module in names, module
