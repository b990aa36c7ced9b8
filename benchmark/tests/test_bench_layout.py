"""The harness is driven by data: a throwaway configuration, mix, cell and
metric, added to a copy of the benchmark as new files and new manifest
entries only, resolve and run; no file already there changes."""

import filecmp
import json

import torch

from benchmark import harness
from benchmark.tests import tiny

PROBE = '''"""tiny_probe: the window's batch count (a test's metric)."""


def read(ctx):
    return float(len(ctx.win.asks))
'''


def test_new_files_resolve_and_run(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "benchmark" / "metrics" / "tiny_probe.py").write_text(PROBE)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({"name": "tiny_probe", "unit": "batches", "better": "higher",
                                  "source": "host_clock", "layer": "test",
                                  "moves": "host_cpu_ms_per_mpix",
                                  "workloads": ["tiny.tiny_native"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for name in tiny.MIXES:
        cell = harness.load_cell(f"tiny.{name}", root)
        assert cell.config["name"].startswith("tiny-") and cell.batch == 4
    result = harness.measure("tiny.tiny_native", seed=2**31 + 9, seconds=0.3, trace=True,
                             device=torch.device("cpu"), t_start=0.0, root=root,
                             log=lambda line: None)
    assert result["correct"]
    assert result["metrics"]["tiny_probe"]["value"] >= 1
    assert "prep_ms.jpeg_native" in result["metrics"]  # read by prep_ms.py
    # nothing the benchmark had was edited
    cmp = filecmp.dircmp(harness.BENCH, root / "benchmark",
                         ignore=[".cache", "__pycache__"])

    def changed(d):
        return d.diff_files + [f for sub in d.subdirs.values() for f in changed(sub)]

    assert changed(cmp) == []
    assert not cmp.left_only


def test_measure_reports_the_cells_metrics_on_the_cpu(tmp_path):
    """End to end on the CPU path: the tiny QOI cell's end-to-end metrics,
    then its per-layer ones with the trace (device metrics read nothing
    there: no card ran)."""
    root = tiny.make_root(tmp_path)
    kw = dict(seed=2**31 + 11, seconds=0.3, device=torch.device("cpu"), t_start=0.0,
              root=root, log=lambda line: None)
    e2e = harness.measure("tiny.tiny_screen", trace=False, **kw)
    assert set(e2e["metrics"]) == {"mpix_s", "delivery_p95_ms", "setup_s"}
    assert list(e2e)[-1] == "checks" and e2e["correct"] and e2e["failed"] == 0
    per = harness.measure("tiny.tiny_screen", trace=True, **kw)
    assert {"prep_ms.qoi", "k23_passes"} <= set(per["metrics"])
    assert "k23_roofline" not in per["metrics"]  # no device time to divide by
    assert per["breakdown"]["device_ops"] == []



def test_a_metric_is_read_by_the_file_of_its_name_up_to_the_first_dot(tmp_path):
    """A new cell's ``prep_ms.<cell>`` needs no new reader; a new measurement
    is one new file, read under its name and under its name with a suffix."""
    root = tiny.make_root(tmp_path)
    assert harness.metric_reader("prep_ms.tiny_new", root).__file__.endswith("/prep_ms.py")
    (root / "benchmark" / "metrics" / "tiny_probe.py").write_text(PROBE)
    for name in ("tiny_probe", "tiny_probe.tiny_native"):
        assert harness.metric_reader(name, root).__file__.endswith("/tiny_probe.py")
