"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source in ``mvtb_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds). Libraries go to ``build/mvtb_tpu_torch/``
at the root of the checkout, named by a hash of the source, the headers
under ``csrc/`` and the flags, so an edited source or header is rebuilt and
an unchanged one is reused. Several sources build in parallel, one ``nvcc``
each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mvtb_tpu_torch"
SOURCES = {"fused_plane": "fused_plane.cu", "axis_dft": "axis_dft.cu",
           "pointwise": "pointwise.cu", "selective_scan": "selective_scan.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install prefix; None when there is no CUDA compiler."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.is_file() else None


def lib_path(name: str) -> Path:
    """The library of kernel ``name``, named by a hash of its source, every
    header under ``csrc/`` (a source may include any of them) and the
    flags, so an edited source or header is rebuilt."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Returns seconds per kernel
    built; the compiler's report (``-Xptxas -v``) is kept beside each
    library as ``<name>.log``. Raises RuntimeError without a CUDA compiler
    or when a build fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not lib_path(n).is_file()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "no CUDA compiler (nvcc) found: the port's kernels build only "
            "where the CUDA toolkit is installed; set CUDA_HOME")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = BUILD_DIR / f".{n}-{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(lib_path(name)))
    return _LOADED[name]
