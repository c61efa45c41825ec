"""The PyTorch port imports neither JAX nor the JAX package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|"
    r"from\s+repro(\.|\s))", re.MULTILINE)


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_and_repro_blocked():
    modules = list(_modules())
    assert "repro_torch.serving.engine" in modules
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        "import importlib",
        f"for name in {modules!r}:",
        "    importlib.import_module(name)",
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))",
        "               for m in sys.modules if sys.modules[m] is not None)",
        "print('imported', len(" + repr(modules) + "))",
    ])
    res = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(modules)}" in res.stdout


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_names_no_jax_or_repro_import(path):
    src = (ROOT / path).read_text()
    assert not FORBIDDEN.findall(src), path


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import x",
                "  from repro.core import model", "import repro",
                "from repro import core"):
        assert FORBIDDEN.search(bad), bad
    for good in ("import repro_torch", "from repro_torch.core import x",
                 "# jax.nn.one_hot semantics", "import jaxlib_free"):
        assert not FORBIDDEN.search(good), good
