"""Build the port's CUDA kernels from ``csrc/`` at first use.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``arrow_matrix_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by the hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads at once.
The build writes to a temporary name and renames, so processes that
build at the same time do not see a half-written library.

Nothing here falls back: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

from arrow_matrix_tpu_torch.utils.buildstats import bump

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel sources of the port, by library name.
SOURCES = {"sell_tier_spmm": "sell_tier_spmm.cu",
           "arrow_blocks_spmm": "arrow_blocks_spmm.cu",
           "granule_gather": "granule_gather.cu"}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: The compiler's report (``-Xptxas -v``: registers, spills) and build
#: seconds of each library built by this process.
BUILD_LOG: Dict[str, dict] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "csrc/ at first use and need the CUDA toolkit")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, SOURCES[name])
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile library ``name`` unless its hashed build exists; returns
    the library's path."""
    path = _lib_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, SOURCES[name])]
    tic = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - tic,
                       "ptxas": proc.stderr}
    return path


def build_all(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Build every kernel library at once, one ``nvcc`` per source."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        paths = list(pool.map(build, names))
    return dict(zip(names, paths))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        bump("library_loads")
        lib = ctypes.CDLL(build(name))
        _LIBS[name] = lib
    return lib
