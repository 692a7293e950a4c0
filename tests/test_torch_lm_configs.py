"""The port's copy of the LM zoo's configs (``repro_torch.configs``)
against the reference's (``repro.configs``, which imports no JAX, so it
is read in this process): the LM dataclasses field by field, and all
ten arch configs, full and reduced, by ``dataclasses.asdict``,
``head_dim``, ``param_count`` and ``active_param_count``; the shape
table and the default ``TrainConfig``; and the DPSNN imports beside
them."""
import dataclasses

import pytest
import torch

import repro.configs as J
import repro.configs.base as jbase
import repro_torch.configs as C
from repro_torch.configs import base, dpsnn


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, as test_torch_distributed.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


LM_CLASSES = ("MoEConfig", "SSMConfig", "AttnConfig", "ModelConfig",
              "ShapeConfig", "TrainConfig")


def test_arch_ids_are_the_reference_s():
    assert C.ARCH_IDS == J.ARCH_IDS
    assert len(C.ARCH_IDS) == 10


@pytest.mark.parametrize("name", LM_CLASSES)
def test_lm_classes_have_the_same_fields(name):
    mine = [(f.name, f.type, f.default) for f in
            dataclasses.fields(getattr(base, name))]
    theirs = [(f.name, f.type, f.default) for f in
              dataclasses.fields(getattr(jbase, name))]
    assert mine == theirs
    assert getattr(base, name).__dataclass_params__.frozen


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", J.ARCH_IDS)
def test_arch_config_equals_the_reference_s(arch, reduced):
    get = "reduced_config" if reduced else "get_config"
    mine, theirs = getattr(C, get)(arch), getattr(J, get)(arch)
    assert type(mine).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.head_dim == theirs.head_dim
    assert mine.param_count() == theirs.param_count()
    assert mine.active_param_count() == theirs.active_param_count()


def test_shapes_and_train_defaults_equal_the_reference_s():
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert [s.is_decode for s in base.SHAPES.values()] == [
        s.is_decode for s in jbase.SHAPES.values()]
    assert dataclasses.asdict(base.TrainConfig()) == dataclasses.asdict(
        jbase.TrainConfig())


def test_dpsnn_configs_still_import_beside_the_lm_ones():
    assert C.DPSNNConfig is base.DPSNNConfig
    assert dpsnn.GRID_24.n_columns == 576
    assert C.get_config("gemma2-9b").attn.sliding_window == 4096
