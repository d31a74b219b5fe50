"""The port runs where JAX is not installed: no module of
``ba_path_planning_torch`` (nor ``chip_smoke.py``) may import it."""

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
             if m == "jax" or m.startswith(("jax.", "jaxlib",
                                            "ba_path_planning_tpu")))
print("LOADED", bad)
"""


def test_importing_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_sources_do_not_import_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax|"
                         r"import\s+ba_path_planning_tpu|"
                         r"from\s+ba_path_planning_tpu)", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
