"""Build the package's CUDA sources (csrc/*.cu) with nvcc and load them.

Each source becomes a shared library with a plain C interface, loaded with
ctypes. Libraries go to build/kernels/ at the checkout root, named by a hash
of the source and the flags, so an edited source is rebuilt and an unchanged
one is reused. `build_all` starts one nvcc per source, all at once. A failed
build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of the last build of each source
PTXAS_REPORT: Dict[str, str] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.is_file() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                           "the CUDA kernels can be built only where the toolkit is")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; None if built."""
    out = _lib_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{stderr}{stdout}")
    PTXAS_REPORT[name] = stderr.strip()
    os.replace(tmp, out)


def build_all() -> None:
    """Build every csrc/*.cu that is not built yet, one nvcc each, in parallel."""
    started = {n: _start(n) for n in sources()}
    errors = []
    for name, s in started.items():
        if s is None:
            continue
        try:
            _finish(name, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
