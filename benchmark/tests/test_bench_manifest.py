"""BENCHMARK.json keeps to the benchmark's contract: names, units, keys,
references between entries, and a file for everything it names."""

import json
import re

import pytest

from benchmark import harness

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert 1 <= len(MANIFEST["configs"]) <= 24
    assert 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (harness.ROOT / p).is_dir()
    for word in cmd[1:]:  # a file the command names lies under paths
        if (harness.ROOT / word).exists():
            assert any(word == p or word.startswith(p + "/") for p in paths)


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_allowed_keys(section):
    for entry in MANIFEST[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry


@pytest.mark.parametrize("section", sorted(KEYS))
def test_names_units_and_text(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for e in MANIFEST[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
        for key in ("why", "layer"):
            assert key not in e or _line(e[key]), (e["name"], key)


def test_configs():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert _line(c["source"])
        assert c["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert (harness.BENCH / "reference" / f"{cfg['reference']}.py").is_file()


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MANIFEST["workloads"]) // 4)
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        mix = json.loads((harness.BENCH / "mixes" / f"{w['traffic']}.json").read_text())
        assert (harness.BENCH / "content" / f"{mix['content']}.py").is_file()
        assert mix["prefetch"] >= 1 and mix["workers"] >= 1


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in E2E


def test_every_metric_has_a_reader():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read), m["name"]


def test_per_layer_moves_an_end_to_end_metric_its_cells_report():
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in E2E
        moved = E2E[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    c = harness.load_cell(cell)
    e2e = {m["name"] for m in c.metrics("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.metrics("per_layer")


def test_a_full_check_fits_its_time():
    """2 + 14 runs a cell at run_seconds + 60 each, 2 x 90 s a cell to
    compile and 1,200 s spare fit 43,200 s with the full 24 cells."""
    cells = 24
    total = (2 + 14 * cells) * (MANIFEST["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200
