"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` loads neither JAX nor the JAX package, and no source file
of the port imports them."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path
import torch_threads  # noqa: F401  (one PyTorch thread a worker)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
# "import jax", "from jax...", "import repro", "from repro.x import" -- but
# not repro_torch
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?![\w])")
_DYNAMIC = re.compile(r"""(?:import_module|__import__)\(\s*["'](?:jax|repro[."'])""")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax_or_the_reference():
    code = textwrap.dedent(f"""
        import importlib.util, sys
        for name in {_modules()!r}:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {str(REPO / "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", len([m for m in sys.modules
                             if m.startswith("repro_torch")]))
        print("BAD", bad)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    loaded = int(proc.stdout.split("LOADED")[1].split()[0])
    assert loaded >= len(_modules())


def test_no_port_source_imports_jax_or_the_reference():
    offenders = []
    for path in _port_sources():
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if _FORBIDDEN.search(line) or _DYNAMIC.search(line):
                offenders.append(f"{path.relative_to(REPO)}:{i}: {line}")
    assert not offenders, "\n".join(offenders)
    assert len(_port_sources()) > 15


def test_the_scan_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import jax.numpy",
                 "from repro.models import layers", "import repro",
                 "    from repro.kernels import ops"):
        assert _FORBIDDEN.search(line), line
    for line in ("from repro_torch.models import layers",
                 "import repro_torch", "# see repro/models/layers.py"):
        assert not _FORBIDDEN.search(line), line
    assert _DYNAMIC.search('importlib.import_module("repro.models")')
