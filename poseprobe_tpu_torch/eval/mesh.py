"""Mesh extraction and chamfer evaluation, backed by a native C++ library.

Port of `poseprobe_tpu/eval/mesh.py`. The C++ core
(`poseprobe_tpu_torch/native/mesh_native.cpp`, the port's own copy of the
JAX package's) is compiled with ``g++ -O3 -fopenmp`` at first use into
`poseprobe_tpu_torch/build/` and loaded with ctypes: marching tetrahedra.
Where it cannot be built or loaded, as in the reference, meshing falls back to
the reference's numpy marching tetrahedra; `native_path()` says which path
runs. The chamfer's nearest-neighbour search is a KD-tree on both paths, its
distances rounded as the reference's path of the same name rounds them
(`nearest_sqdist`). Each path gives the vertices and triangles of the JAX
package's same path; the two paths do not give the same mesh (on a random
volume the numpy path emits fewer triangles, in both packages).
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "mesh_native.cpp"
_SO = Path(__file__).resolve().parents[1] / "build" / "libmesh_native.so"


@functools.lru_cache(maxsize=1)
def _load_native() -> ctypes.CDLL | None:
    """The native library, built first if it is missing or older than its
    source; None where g++ or the load fails."""
    try:
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            _SO.parent.mkdir(parents=True, exist_ok=True)
            tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                           check=True, capture_output=True)
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(str(_SO))
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"[mesh] native library unavailable ({e}): numpy marching tetrahedra and scipy cKDTree")
        return None
    lib.marching_tetrahedra.restype = ctypes.c_int
    lib.marching_tetrahedra.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    return lib


def native_path() -> str:
    """"native" where the C++ library is built and loaded, else "numpy"."""
    return "native" if _load_native() is not None else "numpy"


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def marching_cubes(volume: np.ndarray, iso: float = 0.0):
    """The iso-surface of volume [X, Y, Z]: (verts [V, 3] in index space,
    tris [T, 3] int32), by marching tetrahedra (six per cube). Unwelded: each
    triangle has its own three vertices."""
    volume = np.ascontiguousarray(volume, np.float32)
    lib = _load_native()
    if lib is None:
        return _marching_tetrahedra_numpy(volume, iso)
    nx, ny, nz = volume.shape
    max_tris = int(nx * ny * nz * 12)
    verts = np.empty((max_tris * 3, 3), np.float32)
    tris = np.empty((max_tris, 3), np.int32)
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    lib.marching_tetrahedra(_fptr(volume), nx, ny, nz, ctypes.c_float(iso), _fptr(verts),
                            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), verts.shape[0], max_tris,
                            ctypes.byref(nv), ctypes.byref(nt))
    return verts[:nv.value].copy(), tris[:nt.value].copy()


def extract_mesh_world(volume: np.ndarray, xyz_min, xyz_max, iso: float = 0.0,
                       scale_mat: np.ndarray | None = None):
    """Marching cubes and the index -> world map over [xyz_min, xyz_max]
    (then DTU's `scale_mat`, where given). Returns (verts [V, 3], tris [T, 3])."""
    verts, tris = marching_cubes(volume, iso)
    res = np.asarray(volume.shape, np.float32) - 1.0
    xyz_min = np.asarray(xyz_min, np.float32)
    xyz_max = np.asarray(xyz_max, np.float32)
    verts_w = xyz_min + verts / np.maximum(res, 1) * (xyz_max - xyz_min)
    if scale_mat is not None:
        verts_w = verts_w * scale_mat[0, 0] + scale_mat[:3, 3][None]
    return verts_w, tris


def filter_small_components(verts: np.ndarray, tris: np.ndarray, min_area_frac: float = 0.05):
    """Drop mesh components whose surface area is under `min_area_frac` of
    the largest component's: the salt-noise shells a noisy far-field SDF
    leaves over the box. The vertices are welded first (the extractor emits
    unshared ones), quantised to 1e-6 of the bbox diagonal. Returns (verts,
    tris, info) with the vertices re-indexed; info reports the components and
    the kept area fraction."""
    if len(tris) == 0:
        return verts, tris, {"components": 0, "kept_area_frac": 1.0}
    diag = float(np.linalg.norm(verts.max(0) - verts.min(0))) or 1.0
    q = np.round(verts / (diag * 1e-6)).astype(np.int64)
    _, first_idx, inv = np.unique(q, axis=0, return_index=True, return_inverse=True)
    inv = inv.reshape(-1)
    verts = verts[first_idx]
    tris = inv[tris]
    ok = (tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2]) & (tris[:, 0] != tris[:, 2])
    tris = tris[ok]
    if len(tris) == 0:
        return verts, tris, {"components": 0, "kept_area_frac": 1.0}
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    rows = np.concatenate([tris[:, 0], tris[:, 1], tris[:, 2]])
    cols = np.concatenate([tris[:, 1], tris[:, 2], tris[:, 0]])
    adj = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(len(verts), len(verts)))
    _, roots = connected_components(adj, directed=False)
    e1 = verts[tris[:, 1]] - verts[tris[:, 0]]
    e2 = verts[tris[:, 2]] - verts[tris[:, 0]]
    tri_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    comp_ids, comp_idx = np.unique(roots[tris[:, 0]], return_inverse=True)
    comp_area = np.zeros(len(comp_ids))
    np.add.at(comp_area, comp_idx, tri_area)
    keep_comp = comp_area >= min_area_frac * comp_area.max()
    new_tris = tris[keep_comp[comp_idx]]
    used = np.unique(new_tris)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    info = {"components": int(len(comp_ids)), "components_kept": int(keep_comp.sum()),
            "kept_area_frac": float(comp_area[keep_comp].sum() / comp_area.sum())}
    return verts[used], remap[new_tris], info


def save_ply(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    """An ASCII PLY of the mesh."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(tris)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in tris:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def nearest_sqdist(query: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per-query squared distance to the nearest ref point [Q] float32.

    The nearest point comes from a KD-tree (queried on every core). Where the
    native library is built, its squared distance is taken in float32 as the
    reference's native grid search takes it, so the two agree bit for bit but
    where two points tie; elsewhere it is the KD-tree's, as the reference's
    fallback has it. The native search itself is not used: it walks shells of
    grid cells outward from the query's cell at a cost that grows with the
    fourth power of the distance in cells, so a mesh far from the GT (an early
    run's poses put it there through the sim3) took minutes to hours."""
    query = np.ascontiguousarray(query, np.float32)
    ref = np.ascontiguousarray(ref, np.float32)
    if len(ref) == 0:
        return np.full(len(query), np.inf, np.float32)
    from scipy.spatial import cKDTree

    dist, idx = cKDTree(ref).query(query, k=1, workers=-1)
    if _load_native() is None:
        return (dist ** 2).astype(np.float32)
    d = query - ref[idx]
    return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]


def chamfer_distance(pts_a: np.ndarray, pts_b: np.ndarray, max_dist: float | None = None):
    """Symmetric chamfer: the mean nearest-neighbour distance each way,
    clipped at `max_dist` where given. Returns (a2b, b2a, overall)."""
    d_ab = np.sqrt(nearest_sqdist(pts_a, pts_b))
    d_ba = np.sqrt(nearest_sqdist(pts_b, pts_a))
    if max_dist is not None:
        d_ab = np.minimum(d_ab, max_dist)
        d_ba = np.minimum(d_ba, max_dist)
    return float(d_ab.mean()), float(d_ba.mean()), float((d_ab.mean() + d_ba.mean()) / 2)


def sample_mesh_surface(verts: np.ndarray, tris: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """`n` area-weighted uniform samples of the mesh surface; [0, 3] for an
    empty mesh, so that a caller can score it as a failure."""
    if len(verts) == 0 or len(tris) == 0:
        return np.zeros((0, 3), dtype=np.float64)
    rng = np.random.default_rng(seed)
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    if area.sum() <= 0:
        return verts[rng.integers(0, max(len(verts), 1), n)]
    idx = rng.choice(len(tris), size=n, p=area / area.sum())
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return v0[idx] + u * (v1[idx] - v0[idx]) + v * (v2[idx] - v0[idx])


def _marching_tetrahedra_numpy(volume: np.ndarray, iso: float):
    """The reference's numpy marching tetrahedra (the fallback where the
    native library is not available)."""
    inside = volume >= iso
    shape = tuple(s - 1 for s in volume.shape)
    acc = np.zeros(shape, np.int32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                acc += inside[dx:dx + shape[0], dy:dy + shape[1], dz:dz + shape[2]]
    cross = (acc > 0) & (acc < 8)
    verts_out, tris_out = [], []
    tets = [(0, 5, 1, 3), (0, 5, 3, 6), (0, 6, 3, 2), (0, 6, 2, 4), (5, 6, 0, 4), (5, 6, 4, 7)]
    corners = [(c & 1, (c >> 1) & 1, (c >> 2) & 1) for c in range(8)]
    edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    for x, y, z in zip(*np.where(cross)):
        cp = [np.array([x + c[0], y + c[1], z + c[2]], np.float32) for c in corners]
        cv = [volume[x + c[0], y + c[1], z + c[2]] for c in corners]
        for tet in tets:
            pts = []
            for a, b in edges:
                ia, ib = tet[a], tet[b]
                if (cv[ia] >= iso) != (cv[ib] >= iso):
                    t = (iso - cv[ia]) / (cv[ib] - cv[ia] + 1e-12)
                    pts.append(cp[ia] + np.clip(t, 0, 1) * (cp[ib] - cp[ia]))
            base = len(verts_out)
            if len(pts) == 3:
                verts_out += pts
                tris_out.append([base, base + 1, base + 2])
            elif len(pts) == 4:
                verts_out += pts
                tris_out.append([base, base + 1, base + 2])
                tris_out.append([base + 1, base + 3, base + 2])
    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    return np.asarray(verts_out, np.float32), np.asarray(tris_out, np.int32)
