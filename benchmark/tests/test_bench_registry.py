"""A cell, a configuration, a traffic mix and a per-layer metric are found
by name from files alone; and nothing the benchmark runs loads JAX or the
JAX package."""
import json
import os
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = Path(harness.__file__).resolve().parent


def test_every_declared_cell_loads():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for wl in spec["workloads"]:
        cell = harness.load_cell(wl["name"])
        assert cell["workload"]["config"] == wl["config"]
        assert cell["workload"]["traffic"] == wl["traffic"]
        harness.module("runners", cell["traffic"]["runner"])
        harness.module("traffic", cell["traffic"]["generator"])


def test_a_new_cell_and_metric_are_found_without_an_edit(tmp_path):
    root = tmp_path / "benchmark"
    for d in ("workloads", "configs", "traffic", "metrics"):
        (root / d).mkdir(parents=True)
    (root / "configs" / "cfg-x.json").write_text(json.dumps({"a": 1}))
    (root / "traffic" / "mix-x.json").write_text(
        json.dumps({"generator": "clips", "runner": "train"}))
    (root / "workloads" / "cell-x.json").write_text(
        json.dumps({"config": "cfg-x", "traffic": "mix-x", "chips": 1}))
    for name in ("thing.train", "other.train"):
        (root / "metrics" / f"{name}.py").write_text(
            "UNIT, BETTER, SOURCE = 'ms', 'lower', 'program_span'\n"
            "LAYER, MOVES = 'x', 'train_clips_per_s'\n"
            "def read(trace):\n"
            f"    return trace.get({name!r})\n")
    # the entries a later PR adds to BENCHMARK.json: other.train is
    # another cell's, so this cell's traced run leaves it out
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({"per_layer": [
        {"name": "thing.train", "workloads": ["cell-x"]},
        {"name": "other.train", "workloads": ["cell-y"]}]}))
    cell = harness.load_cell("cell-x", root=root)
    assert cell["config"] == {"a": 1}
    assert cell["traffic"]["runner"] == "train"
    harness.module("runners", cell["traffic"]["runner"])
    harness.module("traffic", cell["traffic"]["generator"])
    assert list(harness.metric_readers(root)) == ["other.train", "thing.train"]
    got = harness.per_layer("cell-x", {"thing.train": 2.5, "other.train": 1.0},
                            root=root)
    assert got == {"thing.train": {"value": 2.5, "unit": "ms"}}


def test_reader_with_nothing_to_read_is_left_out():
    trace = {"kind": "train", "n_kernels": 1000, "steps_profiled": 1,
             "busy_s": 4.0, "window_s": 5.0, "step_flops": 1e12,
             "steps_per_s": 0.2}
    got = harness.per_layer("train-tartan-remat", trace)
    assert set(got) == {"launches_per_step.train", "device_idle.train",
                        "mfu.train"}
    assert abs(got["device_idle.train"]["value"] - 20.0) < 1e-9


def test_every_metric_reader_names_its_layer_and_moves():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in spec["end_to_end"]}
    readers = harness.metric_readers()
    for m in spec["per_layer"]:
        r = readers[m["name"]]
        assert (r.UNIT, r.LAYER, r.MOVES, r.BETTER, r.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["better"], m["source"])
        assert r.MOVES in e2e


def test_forbidden_modules_compare_top_level_names_whole():
    mods = {"devo_tpu_torch": 1, "devo_tpu_torch.ops": 1, "jaxtyping": 1,
            "benchmark": 1}
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(dict(mods, **{"devo_tpu.ops": 1})) == ["devo_tpu"]
    assert harness.forbidden_modules(dict(mods, **{"jax.numpy": 1})) == ["jax"]


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    names = []
    for path in sorted(BENCH.rglob("*.py")):
        rel = path.relative_to(BENCH.parent)
        if "tests" in rel.parts or path.parent == BENCH / "metrics":
            continue
        names.append(".".join(rel.with_suffix("").parts).removesuffix(".__init__"))
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "from benchmark import harness\n"
        "harness.metric_readers()\n"
        "from devo_tpu_torch.train import trainer\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'devo_tpu'})\n"
        "print('LOADED', len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED" in res.stdout and "[]" in res.stdout
    assert "benchmark.runners.train" in names and "benchmark.run" in names
