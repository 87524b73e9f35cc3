"""The native runner of an exported model (counterpart of the JAX package's
deploy/pjrt_cpp/): `yololp_runner.cpp`, a C++ client of the AOTInductor
package that yololp_tpu_torch.export writes with aoti=True, and `ops.cpp`,
the `yololp_torch` custom ops it needs in a process without Python.

`build_runner()` compiles both with the system's C++ compiler ($CXX, else
g++) against the installed torch (`torch.utils.cpp_extension`'s include and
library paths, its C++ ABI) and links the kernels' libraries that
ops/_build.py builds with nvcc, into build/runner/ at the checkout root,
named by a hash of the sources, the flags and the libraries: a build is
reused until one of them changes. A failed build raises with the compiler's
output. `python -m yololp_tpu_torch.deploy.aoti_cpp` builds it and prints
its path.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

import torch

from yololp_tpu_torch.ops import _build

SRC = Path(__file__).resolve().parent
SOURCES = ("ops.cpp", "yololp_runner.cpp")
BUILD_DIR = _build.BUILD_DIR.parent / "runner"
KERNELS = ("greedy_nms", "int8_conv", "bias_act")  # the kernels an exported program calls
OPENCV_INCLUDE = Path("/usr/include/opencv4")
OPENCV_LIBS = ["-lopencv_core", "-lopencv_imgcodecs", "-lopencv_imgproc"]


def _torch_flags() -> tuple:
    """(compile flags, link flags) against the installed torch. The CUDA
    libraries are linked whole (--no-as-needed): libtorch_cuda registers the
    CUDA runner of AOTInductor packages when it is loaded."""
    from torch.utils import cpp_extension

    cflags = ["-std=c++17", "-O2", "-fPIC",
              f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    cflags += [f"-I{p}" for p in cpp_extension.include_paths()]
    lib_dirs = cpp_extension.library_paths()
    libs = ["-lc10", "-ltorch_cpu", "-ltorch"]
    if any((Path(d) / "libtorch_cuda.so").is_file() for d in lib_dirs):
        libs += ["-lc10_cuda", "-ltorch_cuda"]
    if (OPENCV_INCLUDE / "opencv2" / "core.hpp").is_file():
        cflags.append(f"-I{OPENCV_INCLUDE}")
        libs += OPENCV_LIBS
    ldflags = [f"-L{d}" for d in lib_dirs] + [f"-Wl,-rpath,{d}" for d in lib_dirs]
    return cflags, ldflags + ["-Wl,--no-as-needed"] + libs + ["-Wl,--as-needed"]


def _run(cmd: List[str], what: str) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}{proc.stdout}")


def build_runner() -> Path:
    """The runner's binary, built at first use (the two sources compiled
    in parallel, then linked with the kernels' libraries)."""
    for name in KERNELS:
        _build.load(name)  # built with nvcc at first use
    libs = [_build._lib_path(name) for name in KERNELS]
    cflags, ldflags = _torch_flags()
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.encode() + b"\0" + (SRC / src).read_bytes())
    h.update("\0".join([cxx, torch.__version__, *cflags, *ldflags, *map(str, libs)]).encode())
    out = BUILD_DIR / f"yololp_runner_{h.hexdigest()[:16]}"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(src).stem + ".o") for src in SOURCES]
        procs = [subprocess.Popen([cxx, *cflags, "-c", str(SRC / src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(SOURCES, objs)]
        errors = []
        for src, p in zip(SOURCES, procs):
            stdout, stderr = p.communicate()
            if p.returncode != 0:
                errors.append(f"{cxx} failed for {src} (exit {p.returncode}):\n{stderr}{stdout}")
        if errors:
            raise RuntimeError("\n".join(errors))
        binary = Path(tmp) / "yololp_runner"
        rpaths = sorted({f"-Wl,-rpath,{lib.parent}" for lib in libs})
        _run([cxx, *map(str, objs), *map(str, libs), *rpaths, *ldflags, "-o", str(binary)],
             "linking the runner")
        os.replace(binary, out)
    return out


def bench(binary: Path, package: str, iters: int, batch: int, size: int,
          timeout: float = 600) -> dict:
    """Run `binary --bench iters --batch batch --size size` on `package`
    and return its `native_bench` record; raise if the runner fails."""
    cmd = [str(binary), "--model", package, "--bench", str(iters), "--batch", str(batch),
           "--size", str(size)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the runner failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}{proc.stdout}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith('{"native_bench"'))
    return json.loads(line)["native_bench"]
