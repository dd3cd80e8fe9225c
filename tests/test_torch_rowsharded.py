"""Port parity: the row-sharded SGM (depth/sgm_sharded.py) on a 4-shard
in-process CPU mesh against the JAX package's sgm_disparity_pallas_rowsharded
on a 4-device row mesh of the 8 virtual CPU devices (conftest), exactly.

The JAX side runs its Pallas kernels in interpret mode; the port runs each
wrapper's plain PyTorch version (CPU tensors). The gray levels are integers
(a FakeStereoCamera render, or integer noise): sgm_pallas.cost_fwd_down
scans its cost before the 16-bit store truncates it, and the port scans the
stored cost, so on non-integer gray the two packages differ for that
reason alone. Heights 104 and 1080 pad internally (to 128 and 1088): the
last shard then holds dead rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import FakeStereoCamera
from recon3d_tpu.depth.sgm_sharded import sgm_disparity_pallas_rowsharded
from recon3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from recon3d_tpu_torch.depth import sgm_cuda, sgm_sharded
from recon3d_tpu_torch.parallel.mesh import make_mesh

W, D, SHARDS = 128, 128, 4


def _gray(H, scene):
    if scene == "render":
        gl, gr, _, _ = FakeStereoCamera(width=W, height=H, focal=90.0, baseline=0.06).render(0)
        return gl.astype(np.float32), gr.astype(np.float32)
    gl = np.random.RandomState(7).randint(0, 256, (H, W)).astype(np.float32)
    return gl, np.roll(gl, -5, axis=1)


def _port(gl, gr, **kw):
    mesh = make_mesh(SHARDS, ("row",), device="cpu")
    return sgm_sharded.sgm_disparity_cuda_rowsharded(torch.tensor(gl), torch.tensor(gr), mesh,
                                                     num_disparities=D, block_size=5, **kw)


@pytest.mark.parametrize("ndir,H,scene", [(3, 128, "render"), (4, 128, "render"),
                                          (8, 128, "noise"), (4, 104, "noise"),
                                          (8, 104, "render")])
def test_rowsharded_matches_pallas_rowsharded(ndir, H, scene):
    if len(jax.devices()) < SHARDS:
        pytest.skip("needs the virtual CPU devices of the default conftest run")
    gl, gr = _gray(H, scene)
    d_j, v_j = sgm_disparity_pallas_rowsharded(jnp.asarray(gl), jnp.asarray(gr),
                                               jax_make_mesh(SHARDS, ("row",)),
                                               num_disparities=D, block_size=5,
                                               num_directions=ndir, interpret=True)
    d_t, v_t = _port(gl, gr, num_directions=ndir)
    v_j = np.asarray(v_j)
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert v_j.mean() > 0.5


def test_rowsharded_production_height_matches_single_device():
    """1080 rows pad to 1088: 272 rows a shard, the last one's final 8 dead."""
    gl, gr = _gray(1080, "render")
    d_s, v_s = _port(gl, gr, num_directions=4)
    d_1, v_1 = sgm_cuda.sgm_disparity_cuda(torch.tensor(gl), torch.tensor(gr),
                                           num_disparities=D, block_size=5, num_directions=4)
    assert torch.equal(v_s, v_1) and torch.equal(d_s, d_1)
    assert float(v_1.float().mean()) > 0.5


def test_rowsharded_rejects_too_few_real_rows():
    # 100 -> 128 rows: the last of 4 shards keeps 4 real rows < the 8-row halo
    img = np.zeros((100, W), np.float32)
    with pytest.raises(ValueError, match="real rows"):
        _port(img, img)
