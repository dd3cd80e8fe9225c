#!/usr/bin/env python3
"""The JAX package's calibration on chip_smoke.py's calibration phase, on
the host CPU: the same 15 rendered 1920x1080 pairs of pipeline_rig()'s
cameras and the same stand-in corners, through the JAX package's
corner_subpix, stereo_calibrate_camera (detection replaced by those
corners) and DepthPipeline.from_npz; each against the truth, as the phase
holds the port on the card. The phase's truth bars that the JAX package
itself misses are set from this script's numbers (x 1.5).

    JAX_PLATFORMS=cpu python3 tools/calib_reference_truth.py  # from the repo's root

Prints one JSON line: the refined corners' median / max error (px), the
port's corner_subpix on the host against the JAX package's (px), the
intrinsics' errors (fx, fy relative; cx, cy px), |T| relative, R (rad), the
rms values, and the median / max |delta| of the rectification maps against
the true rig's (px). ~15 minutes on 8 CPU cores (the renders ~9).
"""
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from recon3d_tpu.calib import api as japi  # noqa: E402
from recon3d_tpu.calib import chessboard as jcb  # noqa: E402
from recon3d_tpu.depth import pipeline as jpipe  # noqa: E402
from recon3d_tpu_torch.calib import chessboard as tcb  # noqa: E402


def main():
    rig, poses, imgs, truth, init = cs.board_views("cpu")
    V = len(poses)
    ref = {side: np.stack([np.asarray(jcb.corner_subpix(
        jnp.asarray(imgs[side][v].numpy(), jnp.float32), jnp.asarray(init[side][v])
    )).astype(np.float64) for v in range(V)]) for side in ("left", "right")}
    err = np.linalg.norm(np.concatenate([ref[s] - truth[s] for s in ("left", "right")]), axis=-1)
    port = np.stack([tcb.corner_subpix(imgs["left"][v].float(),
                                       torch.as_tensor(init["left"][v])).numpy()
                     for v in range(V)])
    out = {"corners_median_px": float(np.median(err)), "corners_max_px": float(err.max()),
           "port_vs_jax_subpix_max_px": float(np.abs(port - ref["left"]).max())}
    japi.detect_corner_pairs = lambda il, ir, ps, detector="opencv": (
        [ref["left"][v] for v in range(V)], [ref["right"][v] for v in range(V)], list(range(V)))
    c = cs.CALIBRATION
    params, info = japi.stereo_calibrate_camera(
        [i.numpy() for i in imgs["left"]], [i.numpy() for i in imgs["right"]],
        pattern_size=c["pattern"], square_size=c["square"])
    for cam, K, Kt in (("left", params.mtx1, rig.mtx1), ("right", params.mtx2, rig.mtx2)):
        out[cam] = {"fx_rel": abs(K[0, 0] / Kt[0, 0] - 1), "fy_rel": abs(K[1, 1] / Kt[1, 1] - 1),
                    "cx_px": abs(K[0, 2] - Kt[0, 2]), "cy_px": abs(K[1, 2] - Kt[1, 2])}
    cos = (np.trace(params.R @ rig.R.T) - 1) / 2
    out.update(T_norm_rel=abs(np.linalg.norm(params.T) / np.linalg.norm(rig.T) - 1),
               R_rad=float(np.arccos(np.clip(cos, -1, 1))),
               rms=[info["rms_left"], info["rms_right"], info["rms_stereo"]])
    maps = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, p in (("calibrated", params), ("true", rig)):
            path = os.path.join(tmp, f"{name}.npz")
            np.savez(path, k1=p.mtx1, d1=np.ravel(p.dist1), k2=p.mtx2, d2=np.ravel(p.dist2),
                     R=p.R, T=np.ravel(p.T))
            maps.append(jpipe.DepthPipeline.from_npz(path, (cs.W, cs.H)).maps)
    d = np.concatenate([np.abs(np.asarray(a) - np.asarray(b)).ravel() for a, b in zip(*maps)])
    out.update(maps_median_px=float(np.median(d)), maps_max_px=float(d.max()))
    print(json.dumps(out, default=float))


if __name__ == "__main__":
    main()
