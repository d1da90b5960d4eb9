"""Mesh extraction and export (`eval/mesh.py`).

The field is evaluated over a resolution^3 lattice in chunks of
(64, 64, resolution) points by a caller-supplied query (the evaluator's
runs on the port's device); the isosurface is triangulated on the host
by the native marching-tetrahedra library (``csrc/marching_tet.cpp``,
a copy of ``native/marching_tet.cpp``), compiled with ``g++`` at first
use into ``fgs_nerf_tpu_torch/_build/`` (named by the hash of its
source) and loaded with ``ctypes``.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Tuple

import numpy as np

_PKG_DIR = Path(__file__).resolve().parents[1]
_SRC = _PKG_DIR / "csrc" / "marching_tet.cpp"
_BUILD_DIR = _PKG_DIR / "_build"
_LIB = None


def _native() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    so = _BUILD_DIR / f"libmarching_tet_{digest}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        out = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
             "-o", str(tmp)], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC}:\n{out.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.mt_extract.restype = ctypes.c_int
    lib.mt_extract.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mt_free.restype = None
    lib.mt_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def marching_tetrahedra(field: np.ndarray,
                        iso: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """field [X, Y, Z] -> (verts [V, 3] in index space, tris [T, 3])
    (`eval/mesh.py:62-85`)."""
    field = np.ascontiguousarray(field, np.float32)
    lib = _native()
    pv = ctypes.POINTER(ctypes.c_float)()
    pt = ctypes.POINTER(ctypes.c_int64)()
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    rc = lib.mt_extract(
        field.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        field.shape[0], field.shape[1], field.shape[2], iso,
        ctypes.byref(pv), ctypes.byref(nv), ctypes.byref(pt), ctypes.byref(nt))
    if rc != 0:
        raise MemoryError("mt_extract failed")
    try:
        verts = (np.ctypeslib.as_array(pv, shape=(nv.value, 3)).copy()
                 if nv.value else np.zeros((0, 3), np.float32))
        tris = (np.ctypeslib.as_array(pt, shape=(nt.value, 3)).copy()
                if nt.value else np.zeros((0, 3), np.int64))
    finally:
        lib.mt_free(pv)
        lib.mt_free(pt)
    return verts, tris


def extract_fields(bound_min, bound_max, resolution: int, query_fn: Callable,
                   chunk: int = 64) -> np.ndarray:
    """Chunked dense field evaluation (`eval/mesh.py:174-191`):
    ``query_fn(pts [n, 3] numpy) -> [n]`` over a resolution^3 lattice."""
    xs = np.linspace(bound_min[0], bound_max[0], resolution, dtype=np.float32)
    ys = np.linspace(bound_min[1], bound_max[1], resolution, dtype=np.float32)
    zs = np.linspace(bound_min[2], bound_max[2], resolution, dtype=np.float32)
    u = np.zeros((resolution,) * 3, np.float32)
    for xi in range(0, resolution, chunk):
        for yi in range(0, resolution, chunk):
            xx = xs[xi:xi + chunk]
            yy = ys[yi:yi + chunk]
            gx, gy, gz = np.meshgrid(xx, yy, zs, indexing="ij")
            pts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
            val = np.asarray(query_fn(pts)).reshape(len(xx), len(yy), resolution)
            u[xi:xi + len(xx), yi:yi + len(yy), :] = val
    return u


def extract_geometry(bound_min, bound_max, resolution: int, threshold: float,
                     query_fn: Callable) -> Tuple[np.ndarray, np.ndarray]:
    """Field -> mesh with world-space vertices (`eval/mesh.py:194-204`)."""
    u = extract_fields(bound_min, bound_max, resolution, query_fn)
    verts, tris = marching_tetrahedra(u, threshold)
    b_min = np.asarray(bound_min, np.float32)
    b_max = np.asarray(bound_max, np.float32)
    verts = verts / (resolution - 1.0) * (b_max - b_min)[None] + b_min[None]
    return verts, tris


def write_ply(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    """Binary little-endian PLY, the bytes of `eval/mesh.py:207-232`
    without vertex colours, written in two array copies."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(verts)}",
              "property float x", "property float y", "property float z",
              f"element face {len(tris)}",
              "property list uchar int vertex_indices", "end_header"]
    faces = np.empty(len(tris), dtype=[("n", "u1"), ("v", "<i4", (3,))])
    faces["n"] = 3
    faces["v"] = tris
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        f.write(faces.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The binary PLY files of ``write_ply`` (and of the JAX package's,
    with or without uchar vertex colours) -> (verts f32 [V, 3], tris
    int64 [F, 3]): ``fgs_nerf_tpu/eval/mesh.py:235-258``, read as whole
    arrays instead of one record at a time.  Faces must be triangles."""
    with open(path, "rb") as f:
        n_verts = n_tris = 0
        colours = False
        line = f.readline().strip()
        while line != b"end_header":
            if line.startswith(b"element vertex"):
                n_verts = int(line.split()[-1])
            elif line.startswith(b"element face"):
                n_tris = int(line.split()[-1])
            elif line.startswith(b"property uchar red"):
                colours = True
            line = f.readline().strip()
        vtype = [("p", "<f4", (3,))] + ([("c", "u1", (3,))] if colours else [])
        v = np.fromfile(f, dtype=vtype, count=n_verts)
        faces = np.fromfile(f, dtype=[("n", "u1"), ("v", "<i4", (3,))],
                            count=n_tris)
    if len(v) != n_verts or len(faces) != n_tris:
        raise ValueError(f"{path}: truncated PLY body")
    if n_tris and not (faces["n"] == 3).all():
        raise ValueError(f"{path}: faces other than triangles")
    return (np.ascontiguousarray(v["p"], np.float32),
            faces["v"].astype(np.int64))
