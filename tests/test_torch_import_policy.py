"""The PyTorch/CUDA port stands alone: nothing in ``src/repro_torch/`` or
``chip_smoke.py`` imports JAX or the JAX package ``repro`` (the port runs
on a machine that has neither), in the manner of test_compat_policy.py;
stdlib-only modules it needs, such as the fault registry, are its own
copies."""
from __future__ import annotations

import re
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# `repro` followed by `.`, a space or the end of the line: repro_torch passes
FORBIDDEN = [
    ("jax import", re.compile(r"^\s*(import\s+jax|from\s+jax)\b")),
    ("repro import",
     re.compile(r"^\s*(import|from)\s+repro(\.|\s|$)")),
]


def _port_files():
    yield from sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    yield REPO / "chip_smoke.py"


def test_port_imports_neither_jax_nor_repro():
    # the patterns catch what they should
    bad = ["import jax", "from jax import numpy", "  import jax.numpy as jnp",
           "from repro.core import x", "import repro", "from repro import y",
           "import repro.kernels"]
    good = ["import repro_torch", "from repro_torch.core import x",
            "from .ops import jax_free", "# import jax in a comment? no: ok"]
    for line in bad:
        assert any(p.search(line) for _, p in FORBIDDEN), line
    for line in good:
        assert not any(p.search(line) for _, p in FORBIDDEN), line
    files = list(_port_files())
    assert len(files) > 10
    assert all(p.exists() for p in files)
    offenders = []
    for path in files:
        for lineno, line in enumerate(
                path.read_text(encoding="utf-8").splitlines(), 1):
            for name, pat in FORBIDDEN:
                if pat.search(line):
                    offenders.append(f"{path.relative_to(REPO)}:{lineno} "
                                     f"[{name}] {line.strip()}")
    assert not offenders, "\n".join(offenders)
    # the streaming engine's fault registry is the port's own copy of the
    # stdlib-only module, not the JAX package's
    faults = REPO / "src" / "repro_torch" / "core" / "faults.py"
    assert "def faultpoint(" in faults.read_text(encoding="utf-8")
    stream = (REPO / "src" / "repro_torch" / "core" / "stream.py").read_text(
        encoding="utf-8")
    assert "from .faults import" in stream
