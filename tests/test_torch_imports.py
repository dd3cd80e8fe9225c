"""Static guards of the port: recon3d_tpu_torch and chip_smoke.py import no
JAX, nothing of recon3d_tpu and no OpenCV; no CUDA source includes a
PyTorch header; the kernel loader builds with one plain nvcc call and raises
(never falls back) when it cannot."""
import ast
import importlib
import os
import pkgutil
import stat
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "recon3d_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "recon3d_tpu", "cv2")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax_reference_or_opencv(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_cuda_sources_include_no_pytorch_header():
    csrc = os.path.join(PKG, "csrc")
    sources = [f for f in os.listdir(csrc) if f.endswith((".cu", ".cuh"))]
    assert sum(f.endswith(".cu") for f in sources) >= 4
    for f in sources:
        text = open(os.path.join(csrc, f)).read()
        for header in ("torch/", "ATen/", "c10/", "pybind11"):
            assert f"#include <{header}" not in text and f'#include "{header}' not in text, f


def test_every_module_imports_without_a_card():
    import recon3d_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(recon3d_tpu_torch.__path__,
                                                   "recon3d_tpu_torch.")]
    assert "recon3d_tpu_torch.depth.sgm_cuda" in names
    for name in names:
        importlib.import_module(name)


def test_loader_builds_with_one_nvcc_call(tmp_path, monkeypatch):
    from recon3d_tpu_torch import kernels

    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    # a stand-in compiler: records its arguments, writes the -o target
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(kernels, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build" / "kernels")

    lib = kernels.build()
    assert lib == tmp_path / "build" / "kernels" / kernels.LIB_NAME and lib.exists()
    calls = log.read_text().splitlines()
    assert len(calls) == 1
    args = calls[0].split()
    assert "arch=compute_90a,code=sm_90a" in args and "-shared" in args
    assert "--use_fast_math" not in args
    assert sorted(a for a in args if a.endswith(".cu")) == sorted(
        str(p) for p in kernels._sources())
    kernels.build()  # sources unchanged: no second compile
    assert len(log.read_text().splitlines()) == 1


def test_loader_raises_without_nvcc_or_on_compile_error(tmp_path, monkeypatch):
    from recon3d_tpu_torch import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
    monkeypatch.undo()
    broken = tmp_path / "nvcc"
    broken.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 2\n")
    broken.chmod(broken.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(kernels, "find_nvcc", lambda: str(broken))
    with pytest.raises(RuntimeError, match="bad kernel"):
        kernels.build()
