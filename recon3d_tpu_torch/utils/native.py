"""ctypes bridge to the repository's native frame-IO library (twin of
recon3d_tpu/utils/native.py over native/frameio.cc: a zlib PNG codec for
8-bit gray / RGB / RGBA and 16-bit gray, non-interlaced, and a thread pool
that decodes RGB-D frame pairs in parallel).

`native/frameio.cc` is compiled unchanged at first use, by one
``g++ -O3 -shared -fPIC ... -lz`` call, into ``build/native/`` at the
repository root, and rebuilt only when the source's hash changes. There is
no fallback codec: a missing compiler, a failed build, or a file the codec
refuses raises with the cause.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "frameio.cc"
BUILD_DIR = ROOT / "build" / "native"
LIB_NAME = "libframeio.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lz", "-lpthread")
# the codec's negative return codes
ERRORS = {-1: "not a readable PNG file", -2: "truncated PNG chunk",
          -3: "unsupported PNG flavour (interlaced, palette or another bit depth)",
          -4: "corrupt or unsupported compressed image data", -5: "bad PNG row filter",
          -6: "image larger than the output buffer"}

_lock = threading.Lock()
_lib = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile native/frameio.cc into BUILD_DIR/LIB_NAME unless it is up to
    date; raise with the compiler's output when it cannot."""
    digest = _digest()
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build native/frameio.cc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the PNG codec failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build (once) and dlopen libframeio."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.frameio_png_info.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 4
            lib.frameio_png_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long]
            write = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            for name in ("rgb8", "gray8", "gray16"):
                getattr(lib, f"frameio_png_write_{name}").argtypes = write
            lib.frameio_load_rgbd_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            for name in ("info", "read", "write_rgb8", "write_gray8", "write_gray16"):
                getattr(lib, f"frameio_png_{name}").restype = ctypes.c_int
            lib.frameio_load_rgbd_batch.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"{what}: {ERRORS.get(rc, 'PNG codec error')} (code {rc})")


def png_read(path: str) -> np.ndarray:
    """Decode a PNG: (H, W) or (H, W, C) uint8, or (H, W) uint16 for 16-bit
    gray."""
    lib = load_library()
    w, h, ch, bd = (ctypes.c_int() for _ in range(4))
    _check(lib.frameio_png_info(os.fsencode(path), ctypes.byref(w), ctypes.byref(h),
                                ctypes.byref(ch), ctypes.byref(bd)), path)
    dtype = np.uint16 if bd.value == 16 else np.uint8
    shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, ch.value)
    out = np.empty(shape, dtype)
    _check(lib.frameio_png_read(os.fsencode(path), out.ctypes.data_as(ctypes.c_void_p),
                                out.nbytes), path)
    return out


def png_write(path: str, img: np.ndarray) -> None:
    """Encode uint8 gray / RGB or uint16 gray."""
    lib = load_library()
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    p = img.ctypes.data_as(ctypes.c_void_p)
    if img.dtype == np.uint16 and img.ndim == 2:
        rc = lib.frameio_png_write_gray16(os.fsencode(path), p, w, h)
    elif img.dtype == np.uint8 and img.ndim == 2:
        rc = lib.frameio_png_write_gray8(os.fsencode(path), p, w, h)
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        rc = lib.frameio_png_write_rgb8(os.fsencode(path), p, w, h)
    else:
        raise ValueError(f"{path}: the PNG codec writes uint8 gray / RGB or uint16 gray, "
                         f"not {img.dtype} {img.shape}")
    if rc != 0:
        raise OSError(f"{path}: writing the PNG failed (code {rc})")


def load_rgbd_batch(color_paths: List[str], depth_paths: List[str], width: int, height: int,
                    threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Thread-pool decode of n (color RGB8, depth GRAY16) PNG pairs:
    (colors (n, H, W, 3) u8, depths (n, H, W) u16)."""
    lib = load_library()
    n = len(color_paths)
    if len(depth_paths) != n:
        raise ValueError(f"{n} color and {len(depth_paths)} depth paths")
    if threads <= 0:
        threads = min(max(os.cpu_count() or 1, 1), 16)
    colors = np.empty((n, height, width, 3), np.uint8)
    depths = np.empty((n, height, width), np.uint16)
    if not n:
        return colors, depths
    status = (ctypes.c_int * n)()
    cp = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in color_paths])
    dp = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in depth_paths])
    lib.frameio_load_rgbd_batch(cp, dp, n, width, height,
                                colors.ctypes.data_as(ctypes.c_void_p),
                                depths.ctypes.data_as(ctypes.c_void_p), status, threads)
    for i in range(n):
        _check(status[i], f"{color_paths[i]} / {depth_paths[i]}")
    return colors, depths
