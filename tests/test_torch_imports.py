"""The port never imports the JAX package, JAX or flax: not in
``obs_rvc_tpu_torch/``, not in ``chip_smoke.py``, not in the port's scripts
(``scripts/torch_*.py``). The source check walks each file's syntax tree for
import statements; a fresh interpreter then imports every module of the
package and loads the bench and ``chip_smoke.py``, and none of the three
may be in ``sys.modules``. Only the tests import both packages.
"""

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "obs_rvc_tpu")


def port_files() -> list:
    return sorted([*(ROOT / "obs_rvc_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py",
                   *(ROOT / "scripts").glob("torch_*.py")])


def forbidden_imports(source: str) -> list:
    """The modules named by ``source``'s absolute imports whose top-level package is forbidden."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return found


def test_the_check_finds_each_forbidden_form():
    src = ("import jax\nimport flax.linen as nn\nfrom obs_rvc_tpu.dsp import mel\nimport obs_rvc_tpu_torch\n"
           "from obs_rvc_tpu_torch.utils import flops\nfrom . import sibling\n"
           "def f():\n    from jax import numpy\n")
    assert forbidden_imports(src) == ["jax", "flax.linen", "obs_rvc_tpu.dsp", "jax"]


def test_no_port_file_imports_the_jax_package():
    files = port_files()
    assert ROOT / "scripts" / "torch_bench.py" in files and len(files) > 40
    bad = {str(p.relative_to(ROOT)): found for p in files if (found := forbidden_imports(p.read_text()))}
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = """
import importlib, importlib.util, pkgutil, sys
import obs_rvc_tpu_torch
for m in pkgutil.walk_packages(obs_rvc_tpu_torch.__path__, "obs_rvc_tpu_torch."):
    importlib.import_module(m.name)
for name, path in (("torch_bench", "scripts/torch_bench.py"), ("chip_smoke", "chip_smoke.py")):
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "obs_rvc_tpu")))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
