"""Isosurface extraction without scikit-image (the port's copy of the JAX
package's ``utils/mesh.py``: the smooth surface area the reports use,
the smooth mesh the 3D picture draws, and the blocky voxel-face mesher
with its triangle-area sum).

The reference leans on ``skimage.measure.marching_cubes`` for 3D tumor
meshes and surface area (``utils/visualization.py:155-169``,
``main.py:427-463, 482-485``); that dependency is not in this stack's
budget, so surfaces are extracted natively. Units are voxel edges
(= mm for 1 mm isotropic BraTS grids).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


# the corners of each exposed voxel face, by (axis, direction), in the
# winding JAX's mesher emits
_FACE_CORNERS = {
    (0, +1): [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],
    (0, -1): [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)],
    (1, +1): [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)],
    (1, -1): [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
    (2, +1): [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
    (2, -1): [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)],
}


def voxel_surface_mesh(mask: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Binary mask -> (verts (V, 3) float32, faces (F, 3) int32): two
    triangles per exposed voxel face, the vertices deduplicated on the
    integer corner grid."""
    m = np.asarray(mask).astype(bool)
    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    if not m.any():
        return empty
    mp = np.pad(m, 1)
    chunks = []
    for (axis, d), corners in _FACE_CORNERS.items():
        exposed = mp & ~np.roll(mp, -d, axis=axis)
        pos = np.argwhere(exposed) - 1          # unpad
        if len(pos):
            chunks.append(pos[:, None, :] + np.asarray(corners)[None])
    quads = np.concatenate(chunks, axis=0)      # (Q, 4, 3)
    verts, inverse = np.unique(quads.reshape(-1, 3), axis=0,
                               return_inverse=True)
    qi = inverse.reshape(-1, 4)
    faces = np.concatenate([qi[:, [0, 1, 2]], qi[:, [0, 2, 3]]], axis=0)
    return verts.astype(np.float32), faces.astype(np.int32)


def mesh_surface_area(verts: np.ndarray, faces: np.ndarray) -> float:
    """Sum of the triangles' areas."""
    if len(faces) == 0:
        return 0.0
    a, b, c = (verts[faces[:, i]] for i in range(3))
    return float(0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1).sum())


def surface_area_voxel(mask: np.ndarray,
                       voxel_face_area: float = 1.0) -> float:
    """Exact exposed-face surface area of a binary voxel mask."""
    m = np.asarray(mask).astype(np.int8)
    if not m.any():
        return 0.0
    area = 0
    for ax in range(m.ndim):
        area += np.abs(np.diff(m, axis=ax)).sum()
        area += np.take(m, 0, axis=ax).sum()
        area += np.take(m, -1, axis=ax).sum()
    return float(area) * voxel_face_area


# ---------------------------------------------------------------------------
# Smooth isosurface extraction (marching tetrahedra)
# ---------------------------------------------------------------------------
# The reference derives surface area / 3D meshes from
# ``skimage.measure.marching_cubes`` (``main.py:427-463,487-490``,
# ``utils/visualization.py:153-209``). scikit-image is not in this
# stack; the same linear-interpolation isosurface family is implemented
# here as vectorized MARCHING TETRAHEDRA (6 tetrahedra per cube, tiny
# derivable case table instead of the 256-entry cube table). On binary
# masks at level 0.5 it produces the same class of smooth surface as
# marching cubes; sphere surface area agrees with the 4*pi*r^2 analytic
# value to ~2-3% where the exposed-voxel-face mesher overestimates by
# ~1.5x (which skewed compactness and thence risk_score).

_MT_CORNERS = np.array([
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.int64)
# 6-tet decomposition around the 0-6 main diagonal
_MT_TETS = np.array([
    (0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
    (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)], np.int64)
# tet edges by local vertex pair
_MT_EDGES = np.array([
    (0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], np.int64)
# triangles (as edge-index triples) per inside-bitmask (bit i = vert i)
_MT_TRIS = {
    1: [(0, 1, 2)], 2: [(0, 3, 4)],
    3: [(1, 2, 4), (1, 4, 3)],
    4: [(1, 3, 5)],
    5: [(0, 2, 5), (0, 5, 3)],
    6: [(0, 1, 5), (0, 5, 4)],
    7: [(2, 4, 5)], 8: [(2, 4, 5)],
    9: [(0, 1, 5), (0, 5, 4)],
    10: [(0, 3, 5), (0, 5, 2)],
    11: [(1, 3, 5)],
    12: [(1, 3, 4), (1, 4, 2)],
    13: [(0, 3, 4)], 14: [(0, 1, 2)],
}


def marching_tetrahedra(field: np.ndarray, level: float = 0.5,
                        spacing: Tuple[float, float, float] = (1., 1., 1.),
                        chunk: int = 1 << 19
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Smooth isosurface of a scalar field -> (verts (V,3), faces (F,3)).

    Vertices lie on cube edges at the linear-interpolation crossing of
    ``level`` (for a binary mask at level 0.5: edge midpoints), the same
    construction as marching cubes. Vertices are deduplicated.

    Active cubes are processed in ``chunk``-sized batches: the per-cube
    intermediates are ~50x the cube count in bytes, and a pathological
    (e.g. speckled) mask can activate nearly every cube of a 240^3 grid
    — unchunked that is gigabytes of transient allocation.
    """
    f = np.pad(np.asarray(field, np.float32), 1, constant_values=0.0)
    inside = f > level
    # active cubes: mixed corner signs in some 2x2x2 neighborhood
    core = inside[:-1, :-1, :-1]
    mixed = np.zeros(core.shape, bool)
    for dx, dy, dz in _MT_CORNERS:
        sl = inside[dx:dx + core.shape[0], dy:dy + core.shape[1],
                    dz:dz + core.shape[2]]
        mixed |= sl != core
    base_all = np.argwhere(mixed).astype(np.int32)  # (C, 3)
    if len(base_all) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    tri_pts = []
    for start in range(0, len(base_all), chunk):
        base = base_all[start:start + chunk]
        # per cube: corner coords + values
        corners = base[:, None, :] + _MT_CORNERS[None].astype(np.int32)
        vals = f[corners[..., 0], corners[..., 1], corners[..., 2]]

        # per tet (C*6): 4 corner ids + values
        tet_corner = corners[:, _MT_TETS, :].reshape(-1, 4, 3)
        tet_val = vals[:, _MT_TETS].reshape(-1, 4)          # (T, 4)
        bits = ((tet_val > level) << np.arange(4)).sum(axis=1)

        for case, tris in _MT_TRIS.items():
            sel = np.nonzero(bits == case)[0]
            if len(sel) == 0:
                continue
            c = tet_corner[sel]                              # (S, 4, 3)
            v = tet_val[sel]                                 # (S, 4)
            # interpolated point on each of the 6 tet edges
            a, b = _MT_EDGES[:, 0], _MT_EDGES[:, 1]
            va, vb = v[:, a], v[:, b]                        # (S, 6)
            t = np.clip((level - va) / np.where(
                vb - va == 0, 1e-12, vb - va), 0.0, 1.0)[..., None]
            pts = c[:, a].astype(np.float32) * (1 - t) + \
                c[:, b].astype(np.float32) * t               # (S, 6, 3)
            for e0, e1, e2 in tris:
                tri_pts.append(np.stack(
                    [pts[:, e0], pts[:, e1], pts[:, e2]], axis=1))
    tri = np.concatenate(tri_pts, axis=0)                    # (F, 3, 3)
    tri -= 1.0                                               # unpad
    tri *= np.asarray(spacing, np.float32)

    # dedupe vertices on the half-integer grid
    flat = np.round(tri.reshape(-1, 3) * 2.0).astype(np.int64)
    verts_i, inverse = np.unique(flat, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int32)
    verts = verts_i.astype(np.float32) / 2.0
    # drop degenerate triangles (duplicate vertices)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok]


def laplacian_smooth(verts: np.ndarray, faces: np.ndarray,
                     iters: int = 4, lam: float = 0.5) -> np.ndarray:
    """Uniform Laplacian mesh smoothing (removes the tetrahedral
    faceting of marching-tetrahedra surfaces for visualization)."""
    v = np.asarray(verts, np.float32).copy()
    if len(faces) == 0:
        return v
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    for _ in range(iters):
        acc = np.zeros_like(v)
        cnt = np.zeros(len(v), np.float32)
        np.add.at(acc, e[:, 0], v[e[:, 1]])
        np.add.at(acc, e[:, 1], v[e[:, 0]])
        np.add.at(cnt, e[:, 0], 1)
        np.add.at(cnt, e[:, 1], 1)
        mean = acc / np.maximum(cnt, 1)[:, None]
        v = v + lam * (mean - v)
    return v


def downsample_mask(mask: np.ndarray, k: int) -> np.ndarray:
    """Boolean max-pool by factor ``k`` along each axis (any-reduce, so
    thin structures survive). Pads the far edges to a multiple of k."""
    m = np.asarray(mask).astype(bool)
    if k <= 1:
        return m
    pads = [(0, (-s) % k) for s in m.shape]
    if any(p[1] for p in pads):
        m = np.pad(m, pads)
    d, h, w = (s // k for s in m.shape)
    return m.reshape(d, k, h, k, w, k).any(axis=(1, 3, 5))


def smooth_surface_mesh(mask: np.ndarray, sigma: float = 1.0,
                        smooth_iters: int = 4,
                        max_voxels: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Binary mask -> smooth (marching-cubes-quality) triangle mesh:
    Gaussian-smoothed field -> marching tetrahedra -> Laplacian
    smoothing. Replaces the blocky exposed-voxel-face mesh for 3D
    visualization (reference ``utils/visualization.py:153-209``).

    ``max_voxels`` > 0 bounds the meshing work: masks over the volume
    budget OR over the derived surface budget (``max_voxels // 8``
    exposed voxel faces — surface is what sets the triangle count, and
    a speckled mask has enormous surface at modest volume) are
    max-pool-downsampled until they fit, and the vertices scaled back.
    A pathological segmentation therefore cannot stall the caller for
    minutes of host meshing or emit a multi-10MB mesh — an
    upload-serving requirement. Realistic tumor masses sit far under
    both budgets and are meshed exactly. 0 = exact, no cap."""
    m0 = np.asarray(mask).astype(bool)
    if not m0.any():
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    m = m0
    scale = 1
    if max_voxels:
        surf_budget = max(1000, max_voxels // 8)
        while scale < 32 and (m.sum() > max_voxels or
                              surface_area_voxel(m) > surf_budget):
            scale *= 2
            m = downsample_mask(m0, scale)
    m = m.astype(np.float32)
    try:
        from scipy import ndimage
        f = ndimage.gaussian_filter(m, sigma)
    except Exception:
        f = m
    verts, faces = marching_tetrahedra(f, 0.5)
    if len(verts) == 0:   # tiny/thin masks can vanish under smoothing
        verts, faces = marching_tetrahedra(m, 0.5)
    verts = laplacian_smooth(verts, faces, smooth_iters)
    return verts * np.float32(scale), faces


def isosurface_area(mask: np.ndarray,
                    spacing: Tuple[float, float, float] = (1., 1., 1.),
                    sigma: float = 1.0) -> float:
    """Smooth surface area of a binary mask via the coarea formula:
    area(level set) ~= integral |grad f| over the Gaussian-smoothed
    indicator. Within ~1.5% of the analytic value on spheres, where the
    exposed-voxel-face count overestimates by ~1.5x (which skewed
    compactness -> risk_score vs the reference's marching-cubes values,
    ``main.py:487-490``)."""
    m = np.asarray(mask).astype(np.float32)
    if not (m > 0.5).any():
        return 0.0
    try:
        from scipy import ndimage
        f = ndimage.gaussian_filter(m, sigma)
    except Exception:
        f = m
    sp = np.asarray(spacing, np.float32)
    g = np.gradient(f, *sp)
    mag = np.sqrt(g[0] ** 2 + g[1] ** 2 + g[2] ** 2)
    return float(mag.sum() * sp.prod())
