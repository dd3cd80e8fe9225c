"""File I/O (twin of recon3d_tpu/utils/io.py): PLY point clouds and
triangle meshes, and the PNG color / depth frames of a scan directory.

Replaces the reference's Open3D I/O: o3d.io.write_point_cloud /
read_point_cloud (main.py:76, pointcloud_processing.py:24) and
o3d.io.write_triangle_mesh (mesh_saving.py:14-21). The codec reads the
flavor Open3D writes (binary little endian, double precision, uchar colors)
and writes the JAX package's files byte for byte, header comment included.
PNG frames go through the native codec of utils/native.py (8-bit color,
16-bit depth in raw sensor units); a file it refuses raises. Everything
here runs on the host in numpy; readers of clouds put the result on
`device`.
"""
from __future__ import annotations

import glob
import io as _io
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from recon3d_tpu_torch.utils import native
from recon3d_tpu_torch.utils.types import PointCloud, TriangleMesh

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_PLY_DTYPES = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int", "u4": "uint"}


def _parse_ply_header(f) -> Tuple[str, list, int]:
    """Returns (fmt, elements, header_len). elements = [(name, count, [(prop, dtype, is_list)])]."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tok = line.decode("ascii", "replace").strip().split()
        if not tok or tok[0] == "comment":
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append((tok[4], (_PLY_DTYPES[tok[2]], _PLY_DTYPES[tok[3]]), True))
            else:
                elements[-1][2].append((tok[2], _PLY_DTYPES[tok[1]], False))
        elif tok[0] == "end_header":
            break
    return fmt, elements, f.tell()


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY file into a dict of named arrays.

    Keys: 'points' (N,3) f64, optionally 'normals' (N,3), 'colors' (N,3) f64
    in [0,1], 'triangles' (F,3) i32, plus any extra scalar vertex properties.
    """
    with open(path, "rb") as f:
        fmt, elements, _ = _parse_ply_header(f)
        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if fmt == "ascii":
                data = _read_ascii_element(f, count, props)
            else:
                endian = "<" if "little" in fmt else ">"
                data = _read_binary_element(f, count, props, endian)
            if name == "vertex":
                _collect_vertex(out, data)
            elif name == "face":
                key = "vertex_indices" if "vertex_indices" in data else "vertex_index"
                out["triangles"] = np.asarray(data[key], np.int32)
            else:
                for k, v in data.items():
                    out[f"{name}.{k}"] = v
    return out


def _read_ascii_element(f, count, props):
    names = [p[0] for p in props]
    has_list = any(p[2] for p in props)
    rows = {n: [] for n in names}
    for _ in range(count):
        tok = f.readline().split()
        i = 0
        for pname, pdt, is_list in props:
            if is_list:
                n = int(tok[i]); i += 1
                rows[pname].append([float(x) for x in tok[i:i + n]]); i += n
            else:
                rows[pname].append(float(tok[i])); i += 1
    data = {}
    for pname, pdt, is_list in props:
        if is_list:
            data[pname] = np.asarray(rows[pname], np.dtype(pdt[1]))
        else:
            data[pname] = np.asarray(rows[pname], np.dtype(pdt))
    return data


def _read_binary_element(f, count, props, endian):
    if not any(p[2] for p in props):
        dt = np.dtype([(p[0], endian + p[1]) for p in props])
        raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
        return {p[0]: raw[p[0]] for p in props}
    # list properties (faces): assume homogeneous list length (triangles)
    data = {p[0]: [] for p in props}
    # Peek the first list count to vectorize the common all-triangles case.
    pos = f.tell()
    cnt_dt = np.dtype(endian + props[0][1][0])
    first = np.frombuffer(f.read(cnt_dt.itemsize), dtype=cnt_dt)[0]
    f.seek(pos)
    if len(props) == 1:
        idx_dt = np.dtype(endian + props[0][1][1])
        row = np.dtype([("n", cnt_dt), ("v", idx_dt, (int(first),))])
        raw = np.frombuffer(f.read(row.itemsize * count), dtype=row)
        if not (raw["n"] == first).all():
            raise ValueError("mixed polygon sizes not supported")
        return {props[0][0]: raw["v"].copy()}
    raise ValueError("unsupported PLY layout (multiple list properties)")


def _collect_vertex(out, data):
    if all(k in data for k in ("x", "y", "z")):
        out["points"] = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float64)
    if all(k in data for k in ("nx", "ny", "nz")):
        out["normals"] = np.stack([data["nx"], data["ny"], data["nz"]], -1).astype(np.float64)
    if all(k in data for k in ("red", "green", "blue")):
        cols = np.stack([data["red"], data["green"], data["blue"]], -1)
        if cols.dtype == np.uint8:
            cols = cols.astype(np.float64) / 255.0
        out["colors"] = cols
    known = {"x", "y", "z", "nx", "ny", "nz", "red", "green", "blue"}
    for k, v in data.items():
        if k not in known:
            out[k] = v


def read_point_cloud(path: str, capacity: Optional[int] = None, device="cuda") -> PointCloud:
    """Load a PLY as a masked PointCloud on `device` (reference:
    pointcloud_processing.py:24)."""
    d = read_ply(path)
    return PointCloud.from_numpy(
        d["points"].astype(np.float32),
        colors=None if "colors" not in d else d["colors"].astype(np.float32),
        normals=None if "normals" not in d else d["normals"].astype(np.float32),
        capacity=capacity,
        device=device,
    )


def write_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    triangles: Optional[np.ndarray] = None,
    binary: bool = True,
    double: bool = False,
    comment: str = "Created by recon3d_tpu",
) -> None:
    """Write a PLY. colors are float [0,1] or uint8; stored as uchar."""
    points = np.asarray(points)
    n = len(points)
    fdt = "f8" if double else "f4"
    fields = [("x", fdt), ("y", fdt), ("z", fdt)]
    if normals is not None:
        fields += [("nx", fdt), ("ny", fdt), ("nz", fdt)]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    dt = np.dtype([(k, ("<" if binary else "") + v) for k, v in fields])
    rec = np.empty(n, dt)
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        normals = np.asarray(normals)
        rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(np.round(colors * 255.0), 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]

    hdr = _io.StringIO()
    hdr.write("ply\n")
    hdr.write(f"format {'binary_little_endian' if binary else 'ascii'} 1.0\n")
    hdr.write(f"comment {comment}\n")
    hdr.write(f"element vertex {n}\n")
    for k, v in fields:
        hdr.write(f"property {_INV_PLY_DTYPES[v]} {k}\n")
    if triangles is not None:
        triangles = np.asarray(triangles, np.int32)
        hdr.write(f"element face {len(triangles)}\n")
        hdr.write("property list uchar int vertex_indices\n")
    hdr.write("end_header\n")

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(hdr.getvalue().encode("ascii"))
        if binary:
            f.write(rec.tobytes())
            if triangles is not None:
                face_dt = np.dtype([("n", "u1"), ("v", "<i4", (3,))])
                faces = np.empty(len(triangles), face_dt)
                faces["n"] = 3
                faces["v"] = triangles
                f.write(faces.tobytes())
        else:
            for row in rec:
                f.write((" ".join(
                    str(int(x)) if np.issubdtype(type(x), np.integer) else f"{float(x):.9g}"
                    for x in row) + "\n").encode())
            if triangles is not None:
                for t in triangles:
                    f.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())


def write_point_cloud(path: str, pc: PointCloud, binary: bool = True, double: bool = False) -> int:
    """Write valid points of a PointCloud to PLY (reference: main.py:76). Returns count."""
    pts, cols, nrm = pc.to_numpy()
    write_ply(path, pts, colors=cols, normals=nrm, binary=binary, double=double)
    return len(pts)


def write_triangle_mesh(path: str, mesh: TriangleMesh, binary: bool = True) -> int:
    """Write a TriangleMesh to PLY (reference: mesh_saving.py:14). Returns #vertices."""
    verts, tris, cols, nrm = mesh.to_numpy()
    write_ply(path, verts, colors=cols, normals=nrm, triangles=tris, binary=binary)
    return len(verts)


def read_triangle_mesh(path: str) -> Dict[str, np.ndarray]:
    """Read a mesh PLY into raw arrays (points/triangles/colors/normals)."""
    return read_ply(path)


# ---------------------------------------------------------------- PNG images

def read_color(path: str) -> np.ndarray:
    """Read an 8-bit PNG -> (H, W, 3) uint8 (gray repeated, alpha dropped)."""
    img = native.png_read(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit PNG is not a color image")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_depth_raw(path: str) -> np.ndarray:
    """Read a gray depth PNG -> (H, W) uint16 in raw sensor units
    (millimeters for the reference's captures): the wire format the
    streaming producer ships to the device."""
    raw = native.png_read(path)
    if raw.ndim != 2:
        raise ValueError(f"{path}: a depth PNG has one channel, not {raw.shape[2]}")
    return np.asarray(raw, np.uint16)


def read_depth(path: str, depth_scale: float = 1000.0) -> np.ndarray:
    """Read a 16-bit depth PNG -> (H, W) float32 meters (raw / depth_scale)."""
    return read_depth_raw(path).astype(np.float32) / float(depth_scale)


def load_rgbd_frames_batch(directory: str, depth_scale: float = 1000.0,
                           max_frames: Optional[int] = None
                           ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Load the color_*.png / depth_*.png pairs of a scan directory, decoded
    in parallel by the native thread pool: a list of (color (H, W, 3) u8,
    depth (H, W) f32 meters)."""
    cp = sorted(glob.glob(os.path.join(directory, "color_*.png")))
    dp = sorted(glob.glob(os.path.join(directory, "depth_*.png")))
    n = min(len(cp), len(dp))
    if max_frames is not None:
        n = min(n, max_frames)
    cp, dp = cp[:n], dp[:n]
    if not n:
        return []
    h, w = read_color(cp[0]).shape[:2]
    colors, depths = native.load_rgbd_batch(cp, dp, w, h)
    return [(colors[i], depths[i].astype(np.float32) / float(depth_scale)) for i in range(n)]


def write_color(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) or (H, W) uint8 as an 8-bit PNG."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    native.png_write(path, np.asarray(img, np.uint8))


def write_depth(path: str, depth_m: np.ndarray, depth_scale: float = 1000.0) -> None:
    """Write float meters as a uint16 PNG of raw units (meters x depth_scale,
    clipped to 0..65535)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    raw = np.clip(np.asarray(depth_m, np.float64) * depth_scale, 0, 65535).astype(np.uint16)
    native.png_write(path, raw)
