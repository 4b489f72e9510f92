"""What every cell shares: finding a cell's files by name, the metric
readers, the checks on the device and on the modules loaded, and the
result line.

A cell is `workloads/<name>.json`: {"config", "traffic", ...runner keys,
"limits"}. The configuration `configs/<config>.json` and the traffic mix
`traffic/<traffic>.json` are data; the mix names its generator
(`traffic/<generator>.py`) and its runner (`runners/<runner>.py`). A
per-layer metric is `metrics/<name>.py` with UNIT, LAYER, MOVES, BETTER,
SOURCE and `read(trace) -> float | None`. Adding any of them adds files
and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "devo_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = HERE) -> dict:
    """The workload `name` with its configuration and traffic mix:
    {"name", "workload", "config", "traffic"}."""
    path = root / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no workload {name!r}: {path} is missing")
    wl = read_json(path)
    cfg = read_json(root / "configs" / f"{wl['config']}.json")
    tr = read_json(root / "traffic" / f"{wl['traffic']}.json")
    return {"name": name, "workload": wl, "config": cfg, "traffic": tr}


def module(kind: str, name: str):
    """`benchmark.<kind>.<name>` (a runner or a traffic generator)."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


def metric_readers(root: Path = HERE) -> Dict[str, object]:
    """Every per-layer metric reader under metrics/, by metric name."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        name = path.name[:-3]
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def declared(cell: str, kind: str, bench_json: Path = ROOT / "BENCHMARK.json"
             ) -> Optional[List[str]]:
    """The `kind` ("end_to_end" or "per_layer") metrics BENCHMARK.json gives
    this cell (those without a `workloads` key and those that list it), or
    None without the file."""
    if not bench_json.is_file():
        return None
    spec = read_json(bench_json)
    return [m["name"] for m in spec.get(kind, [])
            if "workloads" not in m or cell in m["workloads"]]


def end_to_end(cell: str, metrics: Dict[str, dict]) -> Dict[str, dict]:
    """The runner's end-to-end metrics that BENCHMARK.json gives this
    cell."""
    names = declared(cell, "end_to_end")
    return {k: v for k, v in metrics.items() if names is None or k in names}


def per_layer(cell: str, trace: dict, root: Path = HERE) -> Dict[str, dict]:
    """The per-layer metrics of a traced run: each reader given `trace`;
    one that finds nothing to read returns None and is left out."""
    readers = metric_readers(root)
    names = declared(cell, "per_layer", root.parent / "BENCHMARK.json")
    if names is None:
        names = list(readers)
    out = {}
    for name in names:
        if name not in readers:
            raise SystemExit(f"metric {name!r} has no reader metrics/{name}.py")
        value = readers[name].read(trace)
        if value is not None:
            if not math.isfinite(value):
                raise SystemExit(f"metric {name!r} read {value}")
            out[name] = {"value": float(value), "unit": readers[name].UNIT}
    return out


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole (devo_tpu_torch is not devo_tpu)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(modules)}
                  & set(FORBIDDEN))


def require_cards(n: int):
    """Exit non-zero, with no result, without `n` CUDA devices."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell asks for {n} cards and "
                         f"{torch.cuda.device_count()} are here")


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def cache_dirs():
    """Every build cache of the program inside the checkout, at fixed
    paths: the port builds its kernels into devo_tpu_torch/_build/ beside
    its sources; Triton's and torch's extension caches go under
    .bench_cache/ should anything use them."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("USE_FLAX", "0")


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, compared: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    """The result line: the numbers compared come last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return json.dumps(out)


def report_compared(compared: Dict[str, dict]):
    """The numbers compared, each beside its limit, as the last lines of
    standard error."""
    for name, c in compared.items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """Each number against its limit: correct where every number is finite
    and at most its limit. A number that is missing or not finite (a stage
    the run did not produce) fails and is reported as null."""
    compared = {}
    ok = True
    for name, limit in limits.items():
        v = values.get(name)
        finite = v is not None and math.isfinite(v)
        ok &= finite and v <= limit
        compared[name] = {"value": float(v) if finite else None,
                          "limit": float(limit)}
    return ok, compared
