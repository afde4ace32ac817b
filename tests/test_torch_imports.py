"""fos_tpu_torch and chip_smoke.py import neither jax, jaxlib nor fos_tpu.

A static scan of every import statement (a runtime ``sys.modules`` check
cannot work: jax is imported when the interpreter starts in this image).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "fos_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "fos_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [name for name in _imported(ast.parse(path.read_text()))
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_package():
    assert len(FILES) > 20
    tree = ast.parse("import jax.numpy\nfrom fos_tpu.cones import x\n"
                     "import fos_tpu_torch\n")
    names = [n for n in _imported(tree) if n.split(".")[0] in FORBIDDEN]
    assert names == ["jax.numpy", "fos_tpu.cones"]
