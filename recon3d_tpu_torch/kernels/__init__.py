"""Builds and loads the port's CUDA kernels.

All of ``csrc/*.cu`` is compiled at first use by ONE plain ``nvcc`` call
into a shared library with a C interface (no PyTorch headers, so the cold
build takes seconds), which is loaded with ``ctypes``. The library goes to
``build/kernels/`` at the repository root and is rebuilt only when the hash
of the sources or the flags changes. A missing ``nvcc`` or a failed build
raises with the compiler's output: there is no fallback.

Each launcher takes device pointers, sizes and the CUDA stream, launches on
that stream, checks ``cudaGetLastError()`` and returns its code; `launch`
raises when the code is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "librecon3d_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signature of every launcher; the last argument is the cudaStream_t
SIGNATURES = {
    "r3d_cost_fwd_down": [_P] * 8 + [_I] * 8 + [_F, _F, _I, _P],
    "r3d_cost_walk": [_P] * 8 + [_I] * 8 + [_F, _F, _I, _P],
    "r3d_cost_fwd": [_P, _P, _I, _I, _I, _F, _F, _I, _P],
    "r3d_bwd_accumulate": [_P, _P, _I, _I, _I, _F, _F, _P],
    "r3d_vfinalize": [_P] * 5 + [_I] * 5 + [_F, _F] + [_I] * 4 + [_P],
    "r3d_tridiag": [_P] * 7 + [_I, _I, _I, _P],
    "r3d_resample": [_P] * 5 + [_I] * 4 + [_P],
    "r3d_remap_two_pass": [_P] * 7 + [_I] * 4 + [_P],
    "r3d_diag_accumulate": [_P, _P, _I, _I, _I, _F, _F, _I, _P],
    "r3d_fwd_scan": [_P, _P, _I, _I, _I, _F, _F, _P],
    "r3d_down_accumulate": [_P, _P, _I, _I, _I, _F, _F, _P],
    "r3d_grid_pack": [_P, _P, _P, _I, _I, _P],
    "r3d_grid_moments": [_P, _P, _I, _I, _F, _I, _I, _I, _I, _P],
    "r3d_project_sample": [_P] * 4 + [_L, _I, _I, _I, _P],
    "r3d_vscan_carry": [_P] * 4 + [_I] * 3 + [_F, _F, _I, _I, _P],
    "r3d_diag_carry": [_P] * 4 + [_I] * 3 + [_F, _F, _I, _I, _P],
    "r3d_wta_finalize": [_P] * 4 + [_I] * 8 + [_P],
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of recon3d_tpu_torch need the "
                           "CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile csrc/*.cu into BUILD_DIR/LIB_NAME unless it is up to date."""
    digest = _digest()
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.r3d_error_string.argtypes = [ctypes.c_int]
            lib.r3d_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call launcher `name` on `device`'s current stream; raise on error."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(*args, stream)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}: "
                           f"{lib.r3d_error_string(code).decode()}")


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); raises for mixed or other devices."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def ptr(t: torch.Tensor) -> int:
    """Device pointer of a contiguous CUDA tensor."""
    if not t.is_contiguous():
        raise ValueError("kernel arguments must be contiguous")
    return t.data_ptr()
