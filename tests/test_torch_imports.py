"""The port stands alone: no module of devo_tpu_torch, and not chip_smoke.py,
imports jax (or a library built on it) or the JAX package devo_tpu. The
machine with the GPU has no jax.

An AST walk over the sources, not a subprocess import: the interpreter of
the test environment may import jax at start-up on its own.
"""
import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "devo_tpu")
SOURCES = sorted((ROOT / "devo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported(tree) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_names_are_caught():
    tree = ast.parse("import jax.numpy as jnp\nfrom devo_tpu.lie import se3\n"
                     "from devo_tpu_torch.lie import se3\nimport flax\n")
    assert [n for n in _imported(tree) if _forbidden(n)] == [
        "jax.numpy", "devo_tpu.lie", "flax"]


def _module_names():
    for path in SOURCES[:-1]:
        mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        yield mod.removesuffix(".__init__")


def test_every_port_module_imports_on_cpu():
    """Importing a module builds no kernel and needs no CUDA."""
    for mod in _module_names():
        importlib.import_module(mod)


def test_new_modules_are_covered():
    names = set(_module_names())
    assert {"devo_tpu_torch.eval.harness", "devo_tpu_torch.eval.cli",
            "devo_tpu_torch.eval.ate", "devo_tpu_torch.eval.ate_check",
            "devo_tpu_torch.utils.pose_utils",
            "devo_tpu_torch.data.event_utils", "devo_tpu_torch.data.loaders",
            "devo_tpu_torch.data.benchmarks", "devo_tpu_torch.bench",
            "devo_tpu_torch.ops.segment", "devo_tpu_torch.ops.probe",
            "devo_tpu_torch.ops.probe_cuda", "devo_tpu_torch.scripts",
            "devo_tpu_torch.scripts.common",
            "devo_tpu_torch.scripts.bench_banded_ablate",
            "devo_tpu_torch.scripts.probe_desc_wall",
            "devo_tpu_torch.scripts.bench_gather",
            "devo_tpu_torch.scripts.bench_banded_tune",
            "devo_tpu_torch.scripts.bench_pallas",
            "devo_tpu_torch.scripts.bench_pallas2",
            "devo_tpu_torch.scripts.probe_level_split",
            "devo_tpu_torch.scripts.probe_l4_resident",
            "devo_tpu_torch.scripts.profile_step",
            "devo_tpu_torch.scripts.bench_eval_path",
            "devo_tpu_torch.lie.sim3", "devo_tpu_torch.lie.rxso3",
            "devo_tpu_torch.geom.projective",
            "devo_tpu_torch.eval.frames",
            "devo_tpu_torch.data.tartan", "devo_tpu_torch.data.randaug",
            "devo_tpu_torch.train", "devo_tpu_torch.train.forward",
            "devo_tpu_torch.train.loss", "devo_tpu_torch.train.trainer",
            "devo_tpu_torch.train.validate", "devo_tpu_torch.train.synthetic",
            "devo_tpu_torch.train.__main__", "devo_tpu_torch.utils.logger",
            "devo_tpu_torch.scripts.train_step",
            "devo_tpu_torch.scripts.train_stability",
            "devo_tpu_torch.runtime.viewer", "devo_tpu_torch.utils.viz",
            "devo_tpu_torch.utils.timing", "devo_tpu_torch.data.calibs",
            "devo_tpu_torch.data.preprocess", "devo_tpu_torch.data.esim",
            "devo_tpu_torch.data.rgbd", "devo_tpu_torch.data.stream",
            "devo_tpu_torch.native"} | {
                f"devo_tpu_torch.scripts.{s}" for s in (
                    "pp_ecd", "pp_eds", "pp_fpv", "pp_hku", "pp_mvsec",
                    "pp_rpg", "pp_tumvie", "pp_vector", "convert_tartan",
                    "e2v_undist", "evaluate_rpe",
                    "compute_median_from_restxt", "orb3_eval",
                    "orb3_pp_eds", "plot_h5")} <= names


OPTIONAL = ("h5py", "cv2", "yaml", "matplotlib")


def test_port_modules_import_without_the_optional_libraries():
    """The machine with the GPU has numpy, scipy and torch, and none of
    h5py, cv2, yaml and matplotlib: every module of the port imports in an
    interpreter that refuses those four (they are needed only once a
    function reads a dataset, a yaml file or draws a plot)."""
    code = (
        "import importlib, importlib.abc, sys\n"
        f"BLOCKED = {OPTIONAL!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(name + ' is blocked')\n"
        "for m in BLOCKED:\n"
        "    sys.modules.pop(m, None)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {sorted(_module_names())!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not set(BLOCKED) & set(sys.modules)\n"
        "print('imported')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "imported" in res.stdout, res.stderr[-2000:]
