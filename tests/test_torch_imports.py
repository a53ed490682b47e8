"""The port stands alone: no module of `lss2_multimodal_nu_tpu_torch`, and
not `chip_smoke.py`, imports JAX, flax, Orbax or the JAX package, nor the
image libraries the JAX package's data pipeline uses (PIL, OpenCV,
torchvision), so that the port runs where none is installed; the port
imports with all of those, and matplotlib and wandb (which the card's
machine lacks; only the figures and the wandb logger import them, inside
the functions that use them), made unimportable; and `chip_smoke.py`
refuses to run without a CUDA card or outside a checkout."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "lss2_multimodal_nu_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "lss2_multimodal_nu_tpu"}
IMAGE_LIBRARIES = {"PIL", "cv2", "torchvision"}
# imported only inside the functions that need them
OPTIONAL = {"matplotlib", "wandb"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not set(_imported_roots(path)) & FORBIDDEN


_BLOCKED_IMPORT = """
import importlib.abc, pkgutil, sys
BLOCK = {blocked!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import lss2_multimodal_nu_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    __import__(m.name)
import chip_smoke
assert not BLOCK & {{n.split(".")[0] for n in sys.modules}}
print("imported", len([n for n in sys.modules if n.startswith(pkg.__name__)]))
"""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_image_library_imports(path):
    assert not set(_imported_roots(path)) & IMAGE_LIBRARIES


def test_port_imports_without_image_libraries():
    """Every module, the data pipeline's and the CLI's included, with PIL,
    OpenCV, torchvision, matplotlib and wandb made unimportable as well as
    JAX."""
    code = _BLOCKED_IMPORT.format(blocked=FORBIDDEN | IMAGE_LIBRARIES | OPTIONAL)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 54


def test_port_imports_without_jax():
    code = _BLOCKED_IMPORT.format(blocked=FORBIDDEN | OPTIONAL)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    # every module of the port, the CLI and its utilities included
    assert int(r.stdout.split()[-1]) >= 54


def _run_chip_smoke(script: Path):
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent, capture_output=True,
                       text=True, timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    return r.returncode, r.stdout


def test_chip_smoke_refuses_without_a_card():
    rc, out = _run_chip_smoke(ROOT / "chip_smoke.py")
    assert rc != 0 and '"ok"' not in out


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    rc, out = _run_chip_smoke(tmp_path / "chip_smoke.py")
    assert rc != 0 and '"ok"' not in out
