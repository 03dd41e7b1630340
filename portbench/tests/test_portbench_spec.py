"""BENCHMARK.json and the files the harness finds by name."""

import json
import os
import shutil

import pytest

from portbench import harness

ROOT = harness.ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


CELLS = [w["name"] for w in _bench()["workloads"]]
METRICS = [m["name"] for m in _bench()["end_to_end"] + _bench()["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_with_its_files(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    assert os.path.exists(os.path.join(
        ROOT, "portbench", "drivers", f"{cell.traffic['driver']}.py"))
    for key in ("canvas", "flow_alg", "check", "reduced", "assumed",
                "roofline_planes"):
        assert key in cell.config
    assert cell.config["check"]["footprint_px"] == 0
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    assert callable(harness.load_reader(name))


def test_config_files_are_the_benchmark_configs():
    bench = _bench()
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]


def test_a_new_cell_is_new_files_alone(tmp_path):
    """A cell added by a traffic file and an entry, with a new per-layer
    metric added by its reader file and an entry: the harness finds both
    without a change to its code."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    bench["workloads"].append({"name": "four_low.repeat16",
                               "config": "four_wide_9000x4000_low",
                               "traffic": "four_repeat16", "chips": 1,
                               "why": "a pool of 16 rig frames"})
    for m in bench["end_to_end"]:
        if m["name"] == "stitch_s":
            m["workloads"].append("four_low.repeat16")
    bench["per_layer"].append({"name": "window_calls", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "entry and planning",
                               "moves": "stitch_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "four_repeat.json")) as f:
        traffic = json.load(f)
    traffic["pool"] = 16
    (tmp_path / "portbench" / "traffic" / "four_repeat16.json"
     ).write_text(json.dumps(traffic))
    (tmp_path / "portbench" / "metrics" / "window_calls.py").write_text(
        "def read(run):\n    return run.window.calls\n")

    cell = harness.load_cell("four_low.repeat16", str(tmp_path))
    assert cell.traffic["pool"] == 16
    assert cell.config["canvas"] == [4000, 9000]
    assert "window_calls" in [m["name"] for m in cell.per_layer]
    # an existing cell that reports stitch_s gets the new metric too
    other = harness.load_cell("six_low.repeat", str(tmp_path))
    assert "window_calls" in [m["name"] for m in other.per_layer]
    assert "window_calls" not in [
        m["name"] for m in harness.load_cell("four_low.batch4",
                                             str(tmp_path)).per_layer]

    class Win:
        calls = 7

    read = harness.load_reader("window_calls", str(tmp_path))
    assert read(harness.Run(Win(), 0.0, None, {}, {}, 0, None)) == 7


def test_every_entry_names_files_that_exist():
    """Each cell's traffic and configuration are files of their own."""
    bench = _bench()
    files = {c["name"]: c["file"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(ROOT, files[w["config"]]))
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", f"{w['traffic']}.json"))


def test_set_up_parts_are_read_by_name():
    run = harness.Run(None, 9.0, None, {}, {}, 0, None,
                      {"imports": 6.0, "first call": 1.5, "capture": 1.5})
    assert harness.load_reader("first_call_s")(run) == 1.5
    assert harness.load_reader("capture_s")(run) == 1.5
    assert harness.load_reader("setup_s")(run) == 9.0
