"""Build the CUDA sources in ``src/repro_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -I src/repro_torch/csrc \
         -o build/repro_torch_kernels/<name>-<hash>.so

and loaded with ``ctypes``.  The headers they share (``csrc/*.cuh``) are
found through ``-I`` of the package's own ``csrc/`` (``INCLUDE``), also when
``CSRC`` points elsewhere, as ``launch/mutation_check.py`` has it for a
mutated copy of one source.  The build directory is ``build/`` at the root
of the checkout (listed in ``.gitignore``); the file name carries a hash of
the source and of every header, so an edited kernel or header is rebuilt
and a stale library never loads.
``build_all`` starts one ``nvcc`` per source at once and waits for all of
them; ``load(name)`` builds everything on first use.  Nothing here runs at
import time: the CPU tests import every module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
INCLUDE = CSRC      # the shared headers: always the package's own csrc/
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def headers() -> list:
    return sorted(INCLUDE.glob("*.cuh"))


def lib_path(name: str) -> Path:
    h = hashlib.sha256(sources()[name].read_bytes())
    for header in headers():
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def nvcc_command(src: Path, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(INCLUDE), "-o", str(out),
            str(src)]


def build_all() -> Dict[str, dict]:
    """Compile every source that has no up-to-date library, all in
    parallel.  Returns {name: {"seconds", "log"}} for the sources built now
    (the log holds ptxas's register and shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources().items():
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            nvcc_command(src, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
