"""``BENCHMARK.json`` against the rules of its format, and every file it
names found by name."""
import json
import re

import pytest

from perfbench.harness import manifest

BENCH = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    texts = ([c["why"] for c in BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]]
             + [w["why"] for w in BENCH["workloads"]]
             + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"])
    assert all(TEXT.match(t) for t in texts)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_configuration_has_a_cell_and_no_cell_takes_four_chips():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = manifest.cell(cell)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names, (m["name"], m["moves"])
        manifest.reader(m["name"])
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())


def test_every_per_layer_metric_lists_cells_that_report_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"]


def test_bounds_and_run_length():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    seconds = BENCH["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    runs = 2 + 14 * 24
    assert runs * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_files_found_by_name_lie_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        conf = json.loads((manifest.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
    files = [manifest.ROOT / c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)

