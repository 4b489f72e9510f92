"""A tiny training cell for the benchmark's CPU tests, written into a
temporary directory laid out as benchmark/ is (workloads/, configs/,
traffic/)."""
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path.insert(0, str(BENCH.parent))

TRAIN = dict(ht=64, wd=96, n_frames=5, iters=3, ppi=4, grow_after=2,
             dim_inet=32, dim_fnet=16, dim=8)


def _read(kind, name):
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def write_tiny(root: Path) -> Path:
    """The train cell of BENCHMARK.json cut to a test's size: the same
    files, with the configuration's sizes made small."""
    for d in ("workloads", "configs", "traffic"):
        (root / d).mkdir(parents=True, exist_ok=True)
    cfg = _read("configs", "devo-train-tartan")
    cfg["train"].update(TRAIN)
    (root / "configs" / "tiny-train.json").write_text(json.dumps(cfg))
    (root / "traffic" / "tartan-clips.json").write_text(
        json.dumps(_read("traffic", "tartan-clips")))
    wl = _read("workloads", "train-tartan-remat")
    wl["config"] = "tiny-train"
    (root / "workloads" / "tiny-train-tartan-remat.json").write_text(
        json.dumps(wl))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_tiny(tmp_path_factory.mktemp("bench"))
