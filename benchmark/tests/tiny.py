"""A copy of the benchmark with small cells added by new files only: the
test's throwaway configurations, mixes and cells, at sizes the plain
PyTorch versions of the program's kernels decode in a moment on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import harness

TINY_JPEG = {"name": "tiny-jpeg", "codec": "jpeg", "width": 96, "height": 64,
             "components": 3, "subsampling": "4:2:0", "quality": 90,
             "restart_interval_mcus": 0, "reference": "jpeg_baseline", "reduced": []}
TINY_QOI = {"name": "tiny-qoi", "codec": "qoi", "width": 64, "height": 48, "channels": 3,
            "colorspace": 0, "decoded_channels": 4, "reference": "qoi", "reduced": []}
MIXES = {  # new mix -> (configuration, the benchmark's mix it shrinks, that mix's cell)
    "tiny_sync": ("tiny-jpeg", "jpeg_sync", "cam_jpeg.sync"),
    "tiny_native": ("tiny-jpeg", "jpeg_native", "cam_jpeg.native"),
    "tiny_screen": ("tiny-qoi", "qoi_screen", "qoi.screen"),
    "tiny_photo": ("tiny-qoi", "qoi_photo", "qoi.photo"),
}


def make_root(tmp: Path) -> Path:
    """``tmp`` holding BENCHMARK.json and benchmark/ with the tiny cells
    ``tiny.<mix>`` added: new files, and new entries in the manifest."""
    shutil.copytree(harness.BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for cfg in (TINY_JPEG, TINY_QOI):
        (tmp / "benchmark" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        manifest["configs"].append({"name": cfg["name"], "source": "a test",
                                    "file": f"benchmark/configs/{cfg['name']}.json",
                                    "reduced": [], "why": "a test"})
    for mix, (cfg, base, _) in MIXES.items():
        m = json.loads((harness.BENCH / "mixes" / f"{base}.json").read_text())
        m.update(batch=4, corpus=8, warmup_batches=2,
                 check={"batches": 2, "images_per_batch": 2})
        (tmp / "benchmark" / "mixes" / f"{mix}.json").write_text(json.dumps(m))
        manifest["workloads"].append({"name": f"tiny.{mix}", "config": cfg, "traffic": mix,
                                      "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:  # a tiny cell reports what the cell it shrinks reports
            m["workloads"] += [f"tiny.{x}" for x, (_, _, cell) in MIXES.items()
                               if cell in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return tmp
