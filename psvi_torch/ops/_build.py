"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by nvcc for
Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so``, then loaded with
``ctypes``. The hash is of the source, of every header under ``csrc/`` that
it includes (``#include "..."``, followed through the headers) and of the
flags, so an edited source or header rebuilds; the build directory is
listed in ``.gitignore``. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _local_headers(path: Path) -> list[Path]:
    """The headers of ``csrc/`` that ``path`` includes, directly or through
    another such header, sorted by name."""
    found, todo = set(), [path]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_bytes()):
            dep = (_CSRC / inc.decode()).resolve()
            if dep.is_file() and dep not in found:
                found.add(dep)
                todo.append(dep)
    return sorted(found)


def library_path(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in _local_headers(src):
        h.update(dep.name.encode() + b"\0" + dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns the
    library path and nvcc's output (register and spill report included)."""
    so = library_path(name)
    if so.exists():
        return so, ""
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    return so, proc.stdout + proc.stderr


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s shared library, once
    per process."""
    lib = _LOADED.get(name)
    if lib is None:
        so, _ = build(name)
        lib = _LOADED[name] = ctypes.CDLL(str(so))
    return lib
