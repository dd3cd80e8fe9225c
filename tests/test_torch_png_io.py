"""Port parity for the PNG half of utils/io.py and for utils/native.py
against the JAX package on the CPU. Both packages use the repository's
native/frameio.cc (the port builds it into build/native/, the JAX package
through native/Makefile). Bars: files the port writes, the JAX package
reads bitwise, and the other way round, for RGB8, gray8 and gray16; the
batch loader returns the JAX package's arrays; the port raises where the
codec refuses a file or an array (the JAX package falls back to PIL there).
"""
import os

import numpy as np
import pytest

from recon3d_tpu.utils import io as jio
from recon3d_tpu_torch.utils import io, native


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"rgb8": rng.randint(0, 256, (37, 53, 3)).astype(np.uint8),
            "gray8": rng.randint(0, 256, (37, 53)).astype(np.uint8),
            "gray16": rng.randint(0, 65536, (37, 53)).astype(np.uint16)}


def test_library_builds_into_the_port_build_dir():
    lib = native.load_library()
    assert lib is native.load_library()
    path = native.build()
    assert path == native.BUILD_DIR / native.LIB_NAME and path.exists()
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")


@pytest.mark.parametrize("kind", ["rgb8", "gray8", "gray16"])
def test_port_writes_jax_reads(tmp_path, kind):
    a = _arrays()[kind]
    p = str(tmp_path / f"{kind}.png")
    native.png_write(p, a)
    from recon3d_tpu.utils import native as jnative

    back = jnative.png_read(p)
    assert back is not None and back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(native.png_read(p), a)


@pytest.mark.parametrize("kind", ["rgb8", "gray8", "gray16"])
def test_jax_writes_port_reads(tmp_path, kind):
    a = _arrays(1)[kind]
    p = str(tmp_path / f"{kind}.png")
    from recon3d_tpu.utils import native as jnative

    assert jnative.png_write(p, a)
    np.testing.assert_array_equal(native.png_read(p), a)
    if kind != "gray16":
        np.testing.assert_array_equal(io.read_color(p), jio.read_color(p))
    else:
        np.testing.assert_array_equal(io.read_depth_raw(p), jio.read_depth_raw(p))
        np.testing.assert_array_equal(io.read_depth(p), jio.read_depth(p))


def test_color_and_depth_writers_match(tmp_path):
    rng = np.random.RandomState(2)
    color = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    depth = rng.uniform(0.0, 70.0, (24, 32)).astype(np.float32)  # past 65.535 m clips
    io.write_color(str(tmp_path / "port" / "c.png"), color)
    io.write_depth(str(tmp_path / "port" / "d.png"), depth)
    jio.write_color(str(tmp_path / "jax" / "c.png"), color)
    jio.write_depth(str(tmp_path / "jax" / "d.png"), depth)
    for name in ("c.png", "d.png"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    np.testing.assert_array_equal(io.read_color(str(tmp_path / "jax" / "c.png")), color)
    np.testing.assert_array_equal(io.read_depth(str(tmp_path / "port" / "d.png"), 500.0),
                                  jio.read_depth(str(tmp_path / "jax" / "d.png"), 500.0))


def test_load_rgbd_frames_batch_matches(tmp_path):
    rng = np.random.RandomState(3)
    for k in range(5):
        jio.write_color(str(tmp_path / f"color_{k:05d}.png"),
                        rng.randint(0, 256, (30, 40, 3)).astype(np.uint8))
        jio.write_depth(str(tmp_path / f"depth_{k:05d}.png"), rng.uniform(0.3, 3.0, (30, 40)))
    for max_frames in (None, 3):
        ref = jio.load_rgbd_frames_batch(str(tmp_path), max_frames=max_frames)
        out = io.load_rgbd_frames_batch(str(tmp_path), max_frames=max_frames)
        assert len(out) == len(ref) == (5 if max_frames is None else 3)
        for (c, d), (rc, rd) in zip(out, ref):
            assert c.dtype == rc.dtype and d.dtype == rd.dtype
            np.testing.assert_array_equal(c, rc)
            np.testing.assert_array_equal(d, rd)
    assert io.load_rgbd_frames_batch(str(tmp_path / "missing")) == []


def test_refused_files_and_arrays_raise(tmp_path):
    from PIL import Image

    pal = tmp_path / "palette.png"
    Image.fromarray(np.arange(64, dtype=np.uint8).reshape(8, 8)).convert("P").save(pal)
    with pytest.raises(ValueError, match="unsupported PNG flavour"):
        native.png_read(str(pal))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    with pytest.raises(ValueError, match="not a readable PNG"):
        io.read_color(str(bad))
    with pytest.raises(ValueError, match="uint8 gray / RGB or uint16 gray"):
        native.png_write(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="uint8 gray / RGB or uint16 gray"):
        io.write_color(str(tmp_path / "rgba.png"), np.zeros((4, 4, 4), np.uint8))
    native.png_write(str(tmp_path / "d16.png"), np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="16-bit"):
        io.read_color(str(tmp_path / "d16.png"))
    native.png_write(str(tmp_path / "rgb.png"), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="one channel"):
        io.read_depth_raw(str(tmp_path / "rgb.png"))
    assert not os.path.exists(tmp_path / "f.png")
