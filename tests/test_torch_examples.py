"""The port's example scripts (``examples/torch_quickstart.py``,
``examples/torch_simulate_cortex.py``, ``examples/torch_serve_decode.py``)
run with ``--device cpu`` at a small size, and their numbers are the
reference's: the quickstart's static run equals the JAX quickstart's
``simulation.run`` of the same sheet, the distributed example's 2x2
shards equal its single shard and the JAX package's 2x2 mesh (one forced
4-device subprocess for the module, started in the background), and the
serving example's request-0 tokens equal those that
``examples/serve_decode.py`` prints, with its parameters carried in, for
granite-3-2b and mamba2-780m (a second background subprocess);
without ``--device cpu`` they need a card and raise. Also
``launch/sim.py --mesh --no-compress``, the reference's flag."""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch
from _jax_background import JaxInBackground

from repro_torch.configs.base import DPSNNConfig
from repro_torch.core.partition import make_tile_spec
from repro_torch.runtime.compression import halo_payload_bytes

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


QUICK = ["--grid", "4x4", "--neurons", "32", "--steps", "100",
         "--stdp-steps", "20", "--device", "cpu"]
CORTEX = ["--grid", "4x4", "--neurons", "32", "--steps", "60",
          "--device", "cpu"]

JAX_EXAMPLES = """
import jax, numpy as np
from repro.configs.base import DPSNNConfig
from repro.core import exchange, simulation as sim
cfg = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=32, seed=7)
params, state = sim.build(cfg)
res = sim.run(cfg, params, state, 100)
cfg3 = DPSNNConfig(grid_h=4, grid_w=4, neurons_per_column=32, seed=3)
run, _ = exchange.make_distributed_run(
    cfg3, jax.make_mesh((2, 2), ('data', 'model')), n_steps=60,
    compress=True)
mesh = run()
np.savez('{out}/examples', quick_spikes=np.asarray(res.spikes),
         quick_events=np.asarray(res.events),
         quick_rate=np.asarray(res.rate_hz),
         cortex_spikes=np.asarray(mesh.spikes),
         cortex_events=np.asarray(mesh.events))
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_started(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_examples")
    job = JaxInBackground(JAX_EXAMPLES.format(out=out), timeout=600)
    yield out, job
    job.stop()


@pytest.fixture(scope="module")
def jax_examples(jax_started):
    out, job = jax_started
    assert "OK" in job.result()
    return dict(np.load(out / "examples.npz"))


SERVE = ["--batch", "2", "--prompt-len", "8", "--gen", "16"]
SERVE_ARCHS = ("granite-3-2b", "mamba2-780m")

JAX_SERVE = """
import contextlib, io, runpy, sys
import jax, numpy as np
import repro.configs as C
from repro.models.model import build_model

def flat(tree, prefix=''):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {{prefix: np.asarray(tree)}}
    out = {{}}
    for k, v in items:
        out.update(flat(v, '%s.%s' % (prefix, k) if prefix else str(k)))
    return out

for arch in {archs!r}:
    sys.argv = ['serve_decode.py', '--arch', arch] + {argv!r}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path('{root}/examples/serve_decode.py', run_name='__main__')
    params = build_model(C.reduced_config(arch)).init(jax.random.PRNGKey(0))
    np.savez('{out}/serve-%s' % arch, **flat(params))
    print('ARCH', arch)
    print(buf.getvalue())
print('OK')
"""


@pytest.fixture(autouse=True, scope="module")
def jax_serve_started(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_serve")
    job = JaxInBackground(JAX_SERVE.format(argv=SERVE, archs=SERVE_ARCHS,
                                           root=ROOT, out=out),
                          n_devices=1, timeout=600)
    yield out, job
    job.stop()


def example(name):
    """The script as a module (its ``main`` runs only when called)."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_every_metric_and_equals_jax(capsys,
                                                       jax_examples):
    res, pres = example("torch_quickstart").main(QUICK)
    out = capsys.readouterr().out
    for metric in ("mean firing rate", "synaptic events",
                   "time per synaptic evt", "realtime factor",
                   "memory per synapse", "population synchrony",
                   "STDP (20 ms)"):
        assert metric in out, metric
    assert "on cpu" in out
    assert float(res.spikes) == float(jax_examples["quick_spikes"]) > 0
    assert float(res.events) == float(jax_examples["quick_events"])
    assert float(res.rate_hz) == float(jax_examples["quick_rate"])
    assert float(pres.rate_hz) > 0
    drift = float(re.search(r"mean \|dw\| (\S+),", out)[1])
    assert drift > 0


def test_simulate_cortex_matches_single_shard_and_jax(capsys, jax_examples):
    assert example("torch_simulate_cortex").main(CORTEX) == 0
    out = capsys.readouterr().out
    assert "2x2 shards on cpu" in out and "bit-packed spikes" in out
    assert "bitwise MATCH" in out
    spikes = float(re.search(r"spikes (\d+) vs", out)[1])
    assert spikes == float(jax_examples["cortex_spikes"]) > 0
    events = float(re.search(r"events (\S+)\n", out)[1])
    assert events == pytest.approx(float(jax_examples["cortex_events"]),
                                   rel=1e-3)   # printed to 4 digits


def serve_as_the_reference(jax_serve_started, arch):
    """``examples/torch_serve_decode.py --arch arch --device cpu`` with
    the parameters of ``examples/serve_decode.py --arch arch``
    (``init(PRNGKey(0))`` of the reduced config) carried in: (its tokens,
    what it printed, what the reference printed)."""
    from repro_torch import configs as C
    from repro_torch import convert
    out, job = jax_serve_started
    printed = job.result()
    assert "OK" in printed
    printed = printed.split(f"ARCH {arch}\n")[1].split("ARCH ")[0]
    tree = convert.lm_unflatten(dict(np.load(out / f"serve-{arch}.npz")))
    params = convert.lm_params_from_numpy(C.reduced_config(arch), tree, "cpu")
    gen = example("torch_serve_decode").main(
        ["--arch", arch] + SERVE + ["--device", "cpu"], params=params)
    return gen, printed


def test_serve_decode_prints_the_reference_s_tokens(capsys,
                                                   jax_serve_started):
    """The prompts are the same ``randint(PRNGKey(1))`` draws as
    ``examples/serve_decode.py``'s, and the request-0 line of the reduced
    granite-3-2b is the reference's."""
    gen, printed = serve_as_the_reference(jax_serve_started, "granite-3-2b")
    mine = capsys.readouterr().out
    assert gen.shape == (2, 16) and gen.dtype == torch.int32
    want = re.search(r"request 0 tokens: .*", printed)[0]
    assert re.search(r"request 0 tokens: .*", mine)[0] == want
    assert "granite-3-2b (reduced): batch 2, 23 decode steps" in mine
    assert "on this host's CPU" in mine


def test_serve_decode_serves_mamba2_as_the_reference(capsys,
                                                    jax_serve_started):
    """``--arch mamba2-780m``: the SSM family through the same loop, and
    its request-0 line is that of ``examples/serve_decode.py --arch
    mamba2-780m``."""
    gen, printed = serve_as_the_reference(jax_serve_started, "mamba2-780m")
    mine = capsys.readouterr().out
    assert gen.shape == (2, 16)
    want = re.search(r"request 0 tokens: .*", printed)[0]
    assert re.search(r"request 0 tokens: .*", mine)[0] == want
    assert "mamba2-780m (reduced): batch 2, 23 decode steps" in mine


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_simulate_cortex",
                                  "torch_serve_decode"])
def test_examples_default_to_the_card(name):
    """Without ``--device cpu`` an example runs on the card: with none it
    raises, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run on it")
    argv = (["--batch", "1", "--gen", "2"] if name == "torch_serve_decode"
            else ["--grid", "4x4", "--neurons", "32"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        example(name).main(argv)


def test_sim_cli_no_compress_moves_float_strips(capsys):
    """``launch/sim.py --mesh 2x2`` packs the strips by default and moves
    float32 strips with ``--no-compress``: the same run, and the halo
    bytes of each wire."""
    from repro_torch.launch import sim as cli
    argv = ["--grid", "8x8", "--neurons", "48", "--steps", "20",
            "--impl", "ref", "--device", "cpu", "--seed", "5", "--mesh",
            "2x2"]
    packed = cli.main(argv)
    raw = cli.main(argv + ["--no-compress"])
    out = capsys.readouterr().out
    assert "packed strips" in out and "float32 strips" in out
    sizes = [int(b) for b in re.findall(r"(\d+) halo bytes per step", out)]
    cfg = DPSNNConfig(grid_h=8, grid_w=8, neurons_per_column=48, seed=5)
    spec = make_tile_spec(cfg, 2, 2)
    assert sizes == [halo_payload_bytes(cfg, spec, compress=c)[
        "bytes_per_step"] for c in (True, False)]
    assert sizes[1] > sizes[0]
    assert torch.equal(raw.rate_trace, packed.rate_trace)
    assert float(raw.events) == float(packed.events)
