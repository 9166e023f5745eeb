"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a
-std=c++17 -O3 -shared -Xcompiler -fPIC``) and is loaded with ``ctypes`` —
no PyTorch headers, so a build takes seconds.  The library name carries a
hash of its source and of the headers it includes, so an edited kernel
rebuilds and a stale build is never loaded.  Builds land in
``build/repro_torch_kernels/`` at the repository root (git-ignored);
:func:`build_all` compiles every source in parallel, one ``nvcc`` per file.

Nothing here runs at import time: the CPU test suite imports every module
of the package and never builds a kernel.

Every wrapper that launches a kernel calls :func:`count_launch` right after
a successful launch, and nowhere else; :func:`launch_counts` and
:func:`reset_launch_counts` let a caller prove a code path went through the
kernels.  A wrapper whose kernel runs at several shapes on the main path
also names the shape, and :func:`launch_shapes` counts launches by it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_counts: Dict[str, int] = {}
_shapes: Dict[str, Dict[tuple, int]] = {}


def sources() -> List[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source and of every
    ``csrc/`` header the source includes with quotes."""
    text = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha1(text)
    for header in re.findall(rb'^\s*#include\s+"([^"]+)"', text, flags=re.M):
        h.update((CSRC / header.decode()).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _compile(names: List[str]) -> None:
    """Compile the named sources concurrently; raise on the first failure."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def build_all() -> None:
    """Compile every kernel source (in parallel) and load the libraries."""
    with _lock:
        _compile(sources())
    for name in sources():
        load(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _compile([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def count_launch(name: str, shape: Optional[tuple] = None) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + 1
        if shape is not None:
            by_shape = _shapes.setdefault(name, {})
            by_shape[shape] = by_shape.get(shape, 0) + 1


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def launch_shapes() -> Dict[str, Dict[tuple, int]]:
    """Launches by shape, for the wrappers that name one."""
    with _lock:
        return {name: dict(by_shape) for name, by_shape in _shapes.items()}


def reset_launch_counts() -> None:
    with _lock:
        _counts.clear()
        _shapes.clear()
