"""The port runs where JAX is not installed: no module of
``ba_path_planning_torch`` (nor ``chip_smoke.py``, nor the soak / N-sweep
twin it drives) may import it, nor flax or optax.  Nor does that machine have matplotlib, and importing a module
builds no kernel and starts no ``g++``."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "ba_path_planning_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import ba_path_planning_torch as p
for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "optax")
             or m.startswith(("jax.", "jaxlib", "flax.", "optax.",
                              "ba_path_planning_tpu")))
print("LOADED", bad)
from ba_path_planning_torch import native
from ba_path_planning_torch.ops import cuda_build
print("MATPLOTLIB", "matplotlib" in sys.modules)
print("BUILT", cuda_build._lib is not None or bool(cuda_build.build_info)
      or native._lib is not None)
"""


def test_importing_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_importing_every_module_loads_no_matplotlib_and_builds_nothing():
    """The package, its bench twin and every CLI import without matplotlib
    and without a CUDA build: both come only when a function needs them."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for module in ("bench", "cli.compute_trajectories_batch",
                   "cli.compute_trajectories", "cli.position_generator",
                   "cli.boxplot", "viz.plots", "viz.boxplot",
                   "cli.train_collision_network", "viz.plot_collisions",
                   "models.collision_net", "utils.debug", "utils.profiling",
                   "ops.blocked_chol", "native.__init__"):
        assert (PKG / (module.replace(".", "/") + ".py")).is_file(), module
    assert "MATPLOTLIB False" in out.stdout, out.stdout
    assert "BUILT False" in out.stdout, out.stdout


def test_sources_do_not_import_jax():
    pattern = re.compile(r"^\s*(import\s+(jax|flax|optax)|"
                         r"from\s+(jax|flax|optax)|"
                         r"import\s+ba_path_planning_tpu|"
                         r"from\s+ba_path_planning_tpu)", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "scripts/torch_soak_nsweep.py"]
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
