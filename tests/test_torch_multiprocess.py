"""The port's ranks as OS processes: ``repro_torch.launch.launch_distributed``
spawns N workers on gloo (``--device cpu``, the plain versions) and holds
their totals and final potentials bitwise against its own
``single_process_reference``, on the packed wire and with float32
strips, pipelined, with chained rings across processes, and in node
groups under the hierarchical exchange on both wire formats. Every
launch runs under a timeout, and a failed rank is named."""
import json

import pytest

from repro_torch.core.partition import make_node_spec, process_grid
from repro_torch.launch import launch_distributed as ld

TIMEOUT = "120"


@pytest.mark.parametrize("ranks,grid,neurons", [(2, "4x4", 32),
                                                (4, "8x8", 48)])
def test_ranks_equal_single_process(tmp_path, capsys, ranks, grid, neurons):
    row_file = tmp_path / "row.jsonl"
    status = ld.main(["--ranks", str(ranks), "--grid", grid,
                      "--neurons", str(neurons), "--steps", "40",
                      "--seed", "1", "--impl", "ref", "--device", "cpu",
                      "--timeout", TIMEOUT, "--state-dir",
                      str(tmp_path / "states"), "--json", str(row_file)])
    out = capsys.readouterr().out
    assert status == 0, out
    assert "BITWISE-EQUAL" in out and ", v)" in out
    row = json.loads(row_file.read_text())
    assert row["single_process_match"] is True
    assert row["rank_count"] == ranks
    assert row["process_grid"] == list(process_grid(ranks))
    assert row["device"] == "cpu" and row["aer_saturated_steps"] == 0
    assert row["halo_payload_bytes_per_step"] > 0


@pytest.mark.parametrize("ranks,grid,flags", [
    (2, "4x4", ["--no-compress"]),
    (4, "8x8", ["--pipelined"]),
    # radius 6 over 4x4 tiles: two chained rings per direction
    (4, "8x8", ["--family", "exp"])])
def test_wire_options_equal_single_process(tmp_path, capsys, ranks, grid,
                                           flags):
    status = ld.main(["--ranks", str(ranks), "--grid", grid,
                      "--neurons", "32", "--steps", "30", "--seed", "2",
                      "--impl", "ref", "--device", "cpu",
                      "--timeout", TIMEOUT, "--state-dir",
                      str(tmp_path / "states"), "--json", "-", *flags])
    out = capsys.readouterr().out
    assert status == 0, out
    assert "BITWISE-EQUAL" in out and ", v)" in out
    row = json.loads(out.strip().splitlines()[-1])
    assert row["compress"] == ("--no-compress" not in flags)
    assert row["pipelined"] == ("--pipelined" in flags)


@pytest.mark.parametrize("flags,item", [(["--batch", "2"], "item 5"),
                                        (["--checkpoint-every", "2"], "item 6"),
                                        (["--supervise"], "item 6")])
def test_unported_flags_are_refused(flags, item):
    with pytest.raises(SystemExit, match=item):
        ld.main(["--ranks", "2", *flags, "--device", "cpu"])


@pytest.mark.parametrize("wire", ["dense_packed", "aer_sparse"])
def test_ranks_in_nodes_equal_single_process(tmp_path, capsys, wire):
    """4 ranks in nodes of 2 (the hierarchical exchange over gloo: the
    node's ranks all-gather, corner ranks exchange the node strips and
    broadcast them) equal the single process, v included, with no event
    list overflowing at a 100 Hz bound, and the row carries the node
    level's bytes."""
    status = ld.main(["--ranks", "4", "--ranks-per-node", "2",
                      "--exchange-mode", wire, "--aer-rate-bound", "100",
                      "--grid", "8x8",
                      "--neurons", "32", "--steps", "16", "--seed", "2",
                      "--impl", "ref", "--device", "cpu",
                      "--timeout", TIMEOUT, "--state-dir",
                      str(tmp_path / "states"), "--json", "-"])
    out = capsys.readouterr().out
    assert status == 0, out
    assert "BITWISE-EQUAL" in out and ", v)" in out
    row = json.loads(out.strip().splitlines()[-1])
    assert row["exchange_mode"] == wire
    assert row["ranks_per_node"] == 2 and row["node_grid"] == [2, 1]
    assert row["inter_node_bytes_per_node"] > 0
    assert row["intra_node_bytes_per_rank"] > 0
    assert row["aer_saturated_steps"] == 0
    assert row["aer_saturated_per_step"] == [0] * 16


@pytest.mark.parametrize("flags,text", [
    (["--ranks-per-node", "3"], "exceeds the process-grid row width rx=2"),
    (["--ranks-per-node", "2", "--batch", "2"],
     "applies to the plain distributed run only")])
def test_bad_node_groups_are_refused_before_spawn(flags, text):
    """A group shape ``make_node_spec`` rejects fails with its text, and
    nodes with --batch as the reference's worker says, before any rank
    starts."""
    with pytest.raises(SystemExit, match=text) as err:
        ld.main(["--ranks", "4", *flags, "--device", "cpu"])
    if "--batch" not in flags:
        with pytest.raises(ValueError) as want:
            make_node_spec(2, 2, 3)
        assert str(err.value) == str(want.value)


def test_a_failed_rank_is_named():
    """A 5x5 grid cannot be tiled over the 1x2 process grid: every rank
    raises, and the launcher names the first that exited."""
    args = ld.make_parser().parse_args(
        ["--ranks", "2", "--grid", "5x5", "--neurons", "16", "--steps", "2",
         "--device", "cpu", "--timeout", TIMEOUT])
    with pytest.raises(RuntimeError, match=r"rank \d/2 exited") as err:
        ld.launch(args)
    assert "cannot be tiled" in str(err.value)


def test_ranks_past_the_timeout_are_killed_and_named():
    """Half a second cannot hold two ranks' start-up: the launcher
    kills them and names the ranks that were still running."""
    args = ld.make_parser().parse_args(
        ["--ranks", "2", "--grid", "4x4", "--neurons", "16", "--steps", "2",
         "--device", "cpu", "--timeout", "0.5"])
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] of 2 timed out"):
        ld.launch(args)
