"""Build the package's CUDA sources (csrc/*.cu) with nvcc, load them, bind
their entry points and launch them; and the record each op is declared by.

Each source becomes a shared library with a plain C interface, loaded with
ctypes. Libraries go to build/kernels/ at the checkout root, named by a hash
of the source, the headers beside it (csrc/*.cuh, which every source may
include) and the flags, so an edited source or header is rebuilt and an
unchanged one is reused. The kernels that use TMA take cuTensorMapEncodeTiled
from the driver at run time (cudaGetDriverEntryPoint), so nothing links
against libcuda. `build_all` starts one nvcc per source, all at once. A failed
build raises with nvcc's stderr.

Each `extern "C"` function the port calls is declared once, as an `Entry`
(a kernel's launch entry point as a `Kernel`), with its C argument and
return types: bound at first use, then kept. `Kernel.launch` runs on the
tensors' device and current stream and counts its launches, read as
`launches(name)`. An op of the `yololp_torch` namespace is declared once,
as an `Op` record in its ops/cuda_*.py, and registered from it by
ops/library.py.
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
from typing import Callable, Dict, List, NamedTuple

import torch

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


def _lib_path(name: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


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


def _kernel_entry(mangled: str) -> str:
    """kernel<template arguments> of a mangled entry name (the name is the
    length-prefixed identifier ending in _kernel), else the name itself."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):  # the length prefix may end a longer digit run
            name = mangled[m.end():m.end() + int(m.group()[i:])]
            if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
                rest = mangled[m.end() + len(name):]
                if not rest.startswith("I"):
                    return name
                args = re.findall(r"N2hg\d+(S8|Bf16)E|L[ib](\d+)E", rest)
                return f"{name}<{','.join(a or b for a, b in args)}>"
    return mangled


def ptxas_usage(name: str) -> List[dict]:
    """Per kernel instance of csrc/<name>.cu's last build here: its entry
    (kernel name and template arguments, read from the mangled name),
    registers, static shared memory and spill bytes, from ptxas -v."""
    rows: List[dict] = []
    for line in PTXAS_REPORT.get(name, "").splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            rows.append(dict(entry=_kernel_entry(entry.group(1)), registers=None, smem_bytes=0,
                             spill_bytes=0))
        elif rows and "spill stores" in line:
            rows[-1]["spill_bytes"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif rows and "Used" in line:
            rows[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return rows


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


# every declared entry point, by symbol; every kernel's launch entry, by source
ENTRIES: Dict[str, "Entry"] = {}
KERNELS: Dict[str, "Kernel"] = {}


class Entry:
    """The `extern "C"` function `symbol` of csrc/<lib>.cu with its C types,
    bound at its first call (the library built then if need be) and kept.
    ctypes passes an unbound Python int as a 32-bit C int, which cuts a
    pointer: every pointer is declared c_void_p."""

    def __init__(self, lib: str, symbol: str, argtypes: list, restype=ctypes.c_int):
        self.lib, self.symbol = lib, symbol
        self.argtypes, self.restype = list(argtypes), restype
        self.fn = None
        ENTRIES[symbol] = self

    def bind(self):
        if self.fn is None:
            fn = getattr(load(self.lib), self.symbol)
            fn.argtypes, fn.restype = self.argtypes, self.restype
            self.fn = fn
        return self.fn

    def __call__(self, *args):
        return (self.fn or self.bind())(*args)


class Kernel(Entry):
    """A kernel's launch entry point: `argtypes`, then (int device,
    cudaStream_t stream), returning 0 or an error code that `failure`
    formats."""

    def __init__(self, lib: str, symbol: str, argtypes: list, failure: str = "cudaError {}"):
        super().__init__(lib, symbol, [*argtypes, ctypes.c_int, ctypes.c_void_p])
        self.failure, self.count = failure, 0
        KERNELS[lib] = self

    def launch(self, device: torch.device, *args) -> None:
        """Launch on `device`'s current stream; raise on a nonzero return."""
        fn = self.fn or self.bind()
        stream = torch.cuda.current_stream(device).cuda_stream
        # the entry point sets its device: the guard puts the caller's back after
        with torch.cuda.device(device):
            err = fn(*args, device.index or 0, stream)
        if err != 0:
            raise RuntimeError(f"{self.lib} kernel launch failed: " + self.failure.format(err))
        self.count += 1


def launches(name: str) -> int:
    """How often csrc/<name>.cu's kernel has been launched in this process."""
    return KERNELS[name].count


class Op(NamedTuple):
    """One op of the `yololp_torch` namespace. `check`, `plain`, `cuda` and
    `fake` each take the op's arguments: `check` raises on what no
    implementation takes; `plain` is the kernel's plain version (the op's
    CPU kernel); `cuda` launches csrc/<kernel>.cu's kernel, or raises on
    anything it does not take; `fake` gives the outputs' shapes, dtypes and
    strides without data. With `decompose`, export.inductor_program writes
    the op as `plain` for Inductor to fuse."""

    schema: str
    kernel: str
    check: Callable
    plain: Callable
    cuda: Callable
    fake: Callable
    decompose: bool = False

    @property
    def name(self) -> str:
        return self.schema.split("(", 1)[0]
