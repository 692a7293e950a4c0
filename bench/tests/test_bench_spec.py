"""``BENCHMARK.json`` against the benchmark's contract, and every file
it names found by name."""
from __future__ import annotations

import dataclasses
import re

import pytest

from _tiny import ROOT, common

SP = common.spec(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys_and_command():
    assert set(SP) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert SP["paths"] == ["bench"]
    assert len(SP["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w.split("/")
               for w in SP["command"])
    assert (ROOT / SP["command"][1]).is_file()


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = SP["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in SP[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_names_are_unique_across_kinds():
    names = [m["name"] for m in SP["end_to_end"] + SP["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", SP["end_to_end"] + SP["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = E2E_KEYS if "bound" in metric else LAYER_KEYS
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SP["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    assert (ROOT / "bench" / "metrics" / f"{metric['name']}.py").is_file()
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200
        assert "\n" not in metric["layer"] and "\t" not in metric["layer"]
    if metric["unit"] == "%" and "roofline" in metric["name"]:
        assert metric["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("metric", SP["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_by_each_cell_of_the_metric(metric):
    e2e = {m["name"]: m for m in SP["end_to_end"]}
    moved = e2e[metric["moves"]]
    all_cells = [w["name"] for w in SP["workloads"]]
    assert set(metric["workloads"]) <= set(moved.get("workloads", all_cells))


@pytest.mark.parametrize("wl", SP["workloads"], ids=lambda w: w["name"])
def test_workload_entry(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert wl["chips"] == 1
    assert 1 <= len(wl["why"]) <= 200 and "\n" not in wl["why"]
    assert NAME.match(wl["traffic"])
    assert common.config_file(SP, wl["config"]).is_file()
    mix = common.load_json(common.traffic_file(wl["traffic"]))
    assert (ROOT / "bench" / "drivers" / f"{mix['driver']}.py").is_file()
    e2e = [m for m in SP["end_to_end"]
           if wl["name"] in m.get("workloads", [wl["name"]])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(wl["name"] in m["workloads"] for m in SP["per_layer"])


def test_cells_are_unique_pairs():
    pairs = [(w["config"], w["traffic"]) for w in SP["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("entry", SP["configs"], ids=lambda c: c["name"])
def test_config_files_are_the_programs_published_grids(entry):
    """Each file holds the program's configuration of that name, every
    field, uncut (``reduced`` empty)."""
    from repro_torch.configs import dpsnn
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["reduced"] == []
    cfg = common.load_json(ROOT / entry["file"])
    assert cfg["name"] == entry["name"]
    published = {c.name: c for c in dpsnn.GRIDS.values()}[entry["name"]]
    built = common.program_config(cfg, published.seed, published.stdp)
    assert dataclasses.asdict(built) == dataclasses.asdict(published)
    assert (common.total_synapses(cfg)
            == published.total_equivalent_synapses)


def test_every_config_is_used_and_every_file_named_is_there():
    used = {w["config"] for w in SP["workloads"]}
    assert used == {c["name"] for c in SP["configs"]}
    assert (ROOT / "bench" / "peaks.json").is_file()
