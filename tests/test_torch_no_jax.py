"""The port stands alone: ``deepspeed_tpu_torch`` and ``chip_smoke.py``
import neither ``jax`` nor anything of the JAX package ``deepspeed_tpu``,
and chip_smoke.py gives no result where it cannot run the port on a card.
"""

import ast
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "deepspeed_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import deepspeed_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    deepspeed_tpu_torch.__path__, "deepspeed_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "deepspeed_tpu" or k.startswith("deepspeed_tpu."))
print(len(names), bad)
"""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "deepspeed_tpu")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_every_port_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n) >= 20 and bad == "[]", out.stdout


def test_no_source_file_names_jax():
    """Catches imports inside functions too, which an import run skips."""
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [(f.relative_to(ROOT), m) for f in files
                 for m in _imports(f) if _forbidden(m)]
    assert not offenders


def test_chip_smoke_refuses_without_card_or_port(tmp_path):
    """No CUDA here: exit non-zero and print no result; the same alone in
    a directory without the port."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_sequence_modules_stand_alone():
    """Ulysses, ALST and FPDT (``sequence/{layer,alst,fpdt}.py``) are
    among the files scanned above and import neither JAX nor the JAX
    package, not even inside a function."""
    files = {f.relative_to(ROOT).as_posix() for f in PACKAGE.rglob("*.py")}
    for name in ("layer", "alst", "fpdt", "ring"):
        path = f"deepspeed_tpu_torch/sequence/{name}.py"
        assert path in files, path
        assert not [m for m in _imports(ROOT / path) if _forbidden(m)], path
