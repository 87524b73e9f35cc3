"""The native batch decoder: decode + letterbox + BGR->RGB of a whole batch of
encoded images across C++ threads in one ctypes call (mirrors
yololp_tpu/data/native.py).

The library is built at first use from the repository's own
native/preproc/preproc.cpp, with that directory's Makefile flags, into
build/preproc/ at the checkout root, named by a hash of the source and the
flags (an edited source is rebuilt). Which route decodes:

  * OpenCV's headers and libraries present: the library. A build that fails
    raises with the compiler's output.
  * OpenCV absent and `cv2` importable: `_cv2_fallback`, one image at a time
    in Python (the JAX package's route when its library is unbuilt).
  * neither: `decode_letterbox_batch` raises a RuntimeError that names both.

`native_available()` says whether the library is the route in use.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import subprocess
import tempfile
import warnings
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "preproc" / "preproc.cpp"
BUILD_DIR = _ROOT / "build" / "preproc"
OPENCV_INCLUDE = os.environ.get("OPENCV_INCLUDE", "/usr/include/opencv4")
OPENCV_LIBS = ("opencv_core", "opencv_imgproc", "opencv_imgcodecs")
CXX_FLAGS = ["-O3", "-std=c++17", "-Wall", "-fPIC", "-pthread", "-shared"]

_lib: Optional[ctypes.CDLL] = None


def opencv_present() -> bool:
    """OpenCV's headers (OPENCV_INCLUDE) and its core, imgproc and imgcodecs
    libraries are installed, so the library can be built."""
    return ((Path(OPENCV_INCLUDE) / "opencv2" / "core.hpp").is_file()
            and all(ctypes.util.find_library(name) for name in OPENCV_LIBS))


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + [OPENCV_INCLUDE]).encode())
    return BUILD_DIR / f"libyololp_preproc_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library unless it is built; returns its path. A failed
    build raises with the compiler's output."""
    out = _lib_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, f"-I{OPENCV_INCLUDE}", "-o", tmp,
           str(SOURCE), *(f"-l{name}" for name in OPENCV_LIBS)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the native batch decoder failed (exit "
                           f"{proc.returncode}): {' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    return out


def load_native() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; None where OpenCV is absent."""
    global _lib
    if _lib is None and opencv_present():
        lib = ctypes.CDLL(str(build()))
        lib.yololp_decode_letterbox_batch.restype = ctypes.c_int
        lib.yololp_decode_letterbox_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
    return _lib


def native_available() -> bool:
    """True where the library decodes, False where `_cv2_fallback` does (or
    where neither can, and decode_letterbox_batch raises)."""
    return load_native() is not None


def require_cv2():
    """The cv2 module; a RuntimeError naming both missing routes where it
    does not import."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            "the encoded-image path needs OpenCV: neither the native batch decoder "
            f"(native/preproc/preproc.cpp needs OpenCV's headers in {OPENCV_INCLUDE} and "
            f"the libraries {', '.join(OPENCV_LIBS)}) nor the cv2 module is available on "
            "this machine; decode the images elsewhere and pass decoded frames "
            "(Inferer.detect_batch)") from None
    return cv2


def decode_letterbox_batch(jpeg_buffers: List[bytes], size: int, num_threads: int = 0,
                           scaleup: bool = True
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode + letterbox a batch of encoded images to (n, size, size, 3) RGB
    uint8 with a 114 border; returns (images, ratios, pads_w, pads_h).
    scaleup=False caps the resize ratio at 1 (small images are padded, never
    upscaled); True fills the square. An undecodable buffer gives a 114
    frame, ratio 1 and pads 0, with a warning."""
    n = len(jpeg_buffers)
    lib = load_native()
    if lib is None:
        return _cv2_fallback(jpeg_buffers, size, scaleup)

    blob = b"".join(jpeg_buffers)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in jpeg_buffers], out=offsets[1:])
    blob_arr = np.frombuffer(blob, np.uint8)
    out = np.empty((n, size, size, 3), np.uint8)
    ratios = np.empty(n, np.float32)
    pads_w = np.empty(n, np.float32)
    pads_h = np.empty(n, np.float32)
    n_ok = lib.yololp_decode_letterbox_batch(
        blob_arr.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, size, int(scaleup), num_threads,
        out.ctypes.data_as(ctypes.c_void_p),
        ratios.ctypes.data_as(ctypes.c_void_p),
        pads_w.ctypes.data_as(ctypes.c_void_p),
        pads_h.ctypes.data_as(ctypes.c_void_p))
    if n_ok < n:
        warnings.warn(f"native preproc: {n - n_ok}/{n} images failed to decode")
    return out, ratios, pads_w, pads_h


def _cv2_fallback(jpeg_buffers, size, scaleup=True):
    """decode_letterbox_batch one image at a time with cv2 and the host
    letterbox (auto=False)."""
    cv2 = require_cv2()

    from yololp_tpu_torch.data.images import letterbox

    n = len(jpeg_buffers)
    out = np.full((n, size, size, 3), 114, np.uint8)
    ratios = np.ones(n, np.float32)
    pads_w = np.zeros(n, np.float32)
    pads_h = np.zeros(n, np.float32)
    for i, buf in enumerate(jpeg_buffers):
        bgr = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        if bgr is None:
            continue
        boxed, r, (dw, dh) = letterbox(bgr, size, auto=False, scaleup=scaleup)
        out[i] = boxed[..., ::-1]
        ratios[i], pads_w[i], pads_h[i] = r, dw, dh
    return out, ratios, pads_w, pads_h
