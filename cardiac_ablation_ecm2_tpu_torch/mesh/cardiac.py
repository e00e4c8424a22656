"""Cardiac-like benchmark meshes (numpy copy of ``make_cardiac_tet_mesh``,
``make_cardiac_hex_mesh`` and ``make_cardiac_hex_lattice`` from
``cardiac_ablation_ecm2_tpu/mesh/cardiac.py``).

A tissue block with a hemispherical electrode notch carved at the top
centre, from jittered and smoothly warped lattice points, so every element
has its own Jacobian:

* tets: 3D Delaunay of the points (unstructured connectivity), slivers
  dropped and every tet oriented positive;
* hexes: the lattice itself, with boundary-preserving jitter and warp.

Elements are ordered along a Morton curve of their centroids, except in the
lattice form, which keeps the full lattice in x-fastest order with a
keep-mask of the carved elements.  Boundary
attributes: 1 = outer tissue surface, 2 = electrode surface, 3 = ground pad
(z=0).

Same seed, same arithmetic as the JAX package: the two makers return equal
arrays.
"""

from __future__ import annotations

import numpy as np

from .mesh import Geometry, Mesh, make_cartesian_3d

#: local faces of tet (v0,v1,v2,v3) with outward normals (positive volume)
_TET_FACES = ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1))


def _warp(pts: np.ndarray, L: np.ndarray) -> np.ndarray:
    """Smooth boundary-preserving non-affine warp: every interior point
    moves, boundary planes map to themselves (sin vanishes at 0 and L)."""
    u = pts / L
    s = np.sin(np.pi * u)
    w = np.empty_like(pts)
    w[:, 0] = pts[:, 0] + 0.06 * L[0] * s[:, 0] * np.sin(2.3 * u[:, 1] + 1.7 * u[:, 2])
    w[:, 1] = pts[:, 1] + 0.06 * L[1] * s[:, 1] * np.sin(1.9 * u[:, 2] + 2.1 * u[:, 0])
    w[:, 2] = pts[:, 2] + 0.05 * L[2] * s[:, 2] * np.sin(2.7 * u[:, 0] + 1.3 * u[:, 1])
    return w


def _jitter(pts: np.ndarray, h: np.ndarray, L: np.ndarray, amp: float,
            rng) -> np.ndarray:
    """Random per-point jitter, zeroed per-coordinate on boundary planes so
    faces stay planar (boundary attribution by plane test stays exact)."""
    d = rng.uniform(-amp, amp, size=pts.shape) * h
    for c in range(3):
        on_bdr = (np.abs(pts[:, c]) < 1e-12) | (np.abs(pts[:, c] - L[c]) < 1e-12)
        d[on_bdr, c] = 0.0
    return pts + d


def _electrode_center(L: np.ndarray) -> np.ndarray:
    return np.array([L[0] / 2, L[1] / 2, L[2]])


def _part1by2(x: np.ndarray) -> np.ndarray:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton_argsort(cent: np.ndarray, L: np.ndarray) -> np.ndarray:
    """Element order along a Morton (Z-order) curve of the centroids:
    consecutive elements then touch a compact dof neighbourhood, which keeps
    the restriction gathers' reads local."""
    q = np.clip((cent / L * 1024.0).astype(np.int64), 0, 1023)
    code = (
        (_part1by2(q[:, 2]) << 2)
        | (_part1by2(q[:, 1]) << 1)
        | _part1by2(q[:, 0])
    )
    return np.argsort(code, kind="stable")


def make_cardiac_tet_mesh(
    n: int = 24,
    lengths=(40.0, 40.0, 20.0),
    electrode_radius: float = 4.0,
    jitter: float = 0.28,
    seed: int = 0,
) -> Mesh:
    """Unstructured tet mesh of the block with the electrode notch; ``n``
    lattice cells along x (n=66 → 956,820 tets at the benchmark's lengths
    (0.04, 0.04, 0.02))."""
    from scipy.spatial import Delaunay

    L = np.asarray(lengths, dtype=np.float64)
    rng = np.random.default_rng(seed)
    nz = max(2, int(round(n * L[2] / L[0])))
    ns = np.array([n, max(2, int(round(n * L[1] / L[0]))), nz])
    h = L / ns
    axes = [np.linspace(0.0, L[c], ns[c] + 1) for c in range(3)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    pts = _jitter(pts, h, L, jitter, rng)
    pts = _warp(pts, L)

    tets = Delaunay(pts).simplices.astype(np.int64)
    v = pts[tets]
    vol6 = np.einsum(
        "ij,ij->i",
        np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]),
        v[:, 3] - v[:, 0],
    )
    # orient positive, drop Delaunay slivers (coplanar lattice degeneracies)
    neg = vol6 < 0
    tets[neg] = tets[neg][:, [0, 2, 1, 3]]
    keep = np.abs(vol6) > 1e-6 * float(h.min()) ** 3
    tets = tets[keep]

    ctr = _electrode_center(L)
    cent = pts[tets].mean(axis=1)
    outside = np.linalg.norm(cent - ctr, axis=1) > electrode_radius
    tets, cent = tets[outside], cent[outside]
    tets = tets[_morton_argsort(cent, L)]
    return _finish_tet_mesh(pts, tets, L, electrode_radius)


def _finish_tet_mesh(pts, tets, L, electrode_radius) -> Mesh:
    """Boundary triangles (faces seen once), unused vertices dropped,
    boundary attributes by position."""
    ctr = _electrode_center(L)
    faces = np.concatenate([tets[:, list(f)] for f in _TET_FACES], axis=0)
    key = np.sort(faces, axis=1)
    _u, inv, cnt = np.unique(key, axis=0, return_inverse=True,
                             return_counts=True)
    btris = faces[cnt[inv] == 1]

    used = np.zeros(len(pts), dtype=bool)
    used[tets.ravel()] = True
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(int(used.sum()))
    pts = pts[used]
    tets = remap[tets]
    btris = remap[btris]

    fc = pts[btris].mean(axis=1)
    battr = np.ones(len(btris), dtype=np.int64)
    battr[np.linalg.norm(fc - ctr, axis=1) <= 1.35 * electrode_radius] = 2
    battr[fc[:, 2] < 1e-9] = 3
    return Mesh(
        geom=Geometry.TETRAHEDRON,
        vertices=pts,
        elements=tets,
        attributes=np.ones(len(tets), dtype=np.int64),
        boundary=btris,
        bdr_attributes=battr,
    )


def make_cardiac_hex_mesh(
    n: int = 24,
    lengths=(40.0, 40.0, 20.0),
    electrode_radius: float = 4.0,
    jitter: float = 0.22,
    seed: int = 0,
) -> Mesh:
    """Hex mesh of the block with warped + jittered geometry and the
    electrode notch carved out; ``n`` elements along x (n=126 → 995,336
    hexes at the benchmark's lengths (0.04, 0.04, 0.02))."""
    rng = np.random.default_rng(seed)
    L = np.asarray(lengths, dtype=np.float64)
    ns = np.array(
        [n, max(2, int(round(n * L[1] / L[0]))),
         max(2, int(round(n * L[2] / L[0])))]
    )
    m = make_cartesian_3d(*map(int, ns), *map(float, L))
    pts = _jitter(m.vertices.copy(), L / ns, L, jitter, rng)
    pts = _warp(pts, L)

    ctr = _electrode_center(L)
    cent = pts[m.elements].mean(axis=1)
    keep = np.linalg.norm(cent - ctr, axis=1) > electrode_radius
    hexes, cent = m.elements[keep], cent[keep]
    hexes = hexes[_morton_argsort(cent, L)]

    # boundary quads of the carved mesh: faces appearing exactly once
    _HEX_FACES = (
        (3, 2, 1, 0), (0, 1, 5, 4), (1, 2, 6, 5),
        (2, 3, 7, 6), (3, 0, 4, 7), (4, 5, 6, 7),
    )
    faces = np.concatenate([hexes[:, list(f)] for f in _HEX_FACES], axis=0)
    key = np.sort(faces, axis=1)
    _u, inv, cnt = np.unique(key, axis=0, return_inverse=True,
                             return_counts=True)
    bquads = faces[cnt[inv] == 1]

    used = np.zeros(len(pts), dtype=bool)
    used[hexes.ravel()] = True
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(int(used.sum()))
    pts = pts[used]
    hexes = remap[hexes]
    bquads = remap[bquads]

    fc = pts[bquads].mean(axis=1)
    battr = np.ones(len(bquads), dtype=np.int64)
    battr[np.linalg.norm(fc - ctr, axis=1) <= 1.6 * electrode_radius] = 2
    battr[fc[:, 2] < 1e-9] = 3
    return Mesh(
        geom=Geometry.CUBE,
        vertices=pts,
        elements=hexes,
        attributes=np.ones(len(hexes), dtype=np.int64),
        boundary=bquads,
        bdr_attributes=battr,
    )


def make_cardiac_hex_lattice(
    n: int = 24,
    lengths=(40.0, 40.0, 20.0),
    electrode_radius: float = 4.0,
    jitter: float = 0.22,
    seed: int = 0,
):
    """Masked-lattice form of :func:`make_cardiac_hex_mesh`: the FULL
    warped and jittered hex lattice (same seed, same rng sequence, so the
    same vertices) with neither Morton reorder nor vertex remap, and the
    keep-mask of the elements the carved mesh retains.  Elements stay x
    fastest, so a ``CartesianFESpace`` over the lattice runs the carved
    problem with ``elem_mask`` and ``fem.masked_lattice``'s essential dofs.
    Returns ``(mesh_full, keep, ns)``, ``ns`` the elements per axis."""
    rng = np.random.default_rng(seed)
    L = np.asarray(lengths, dtype=np.float64)
    ns = np.array(
        [n, max(2, int(round(n * L[1] / L[0]))),
         max(2, int(round(n * L[2] / L[0])))]
    )
    m = make_cartesian_3d(*map(int, ns), *map(float, L))
    pts = _jitter(m.vertices.copy(), L / ns, L, jitter, rng)
    pts = _warp(pts, L)

    ctr = _electrode_center(L)
    cent = pts[m.elements].mean(axis=1)
    keep = np.linalg.norm(cent - ctr, axis=1) > electrode_radius
    mesh_full = Mesh(
        geom=Geometry.CUBE,
        vertices=pts,
        elements=m.elements,
        attributes=m.attributes,
        boundary=m.boundary,
        bdr_attributes=m.bdr_attributes,
    )
    return mesh_full, keep, tuple(int(v) for v in ns)


def rf_source_q(center, sigma: float = 3.0, power: float = 5e6):
    """Gaussian SAR-like volumetric source [W/m³] centred at the electrode
    tip, the benchmark's stand-in for the coupled RF Joule term: a callable
    of physical points, torch tensors (on their device and dtype) or numpy
    arrays, (..., sdim) → (...)."""
    c = np.asarray(center, dtype=np.float64)

    def q(x):
        if isinstance(x, np.ndarray):
            r2 = ((x - c) ** 2).sum(axis=-1)
            return power * np.exp(-r2 / (2.0 * sigma ** 2))
        import torch

        r2 = ((x - torch.as_tensor(c, dtype=x.dtype, device=x.device)) ** 2).sum(-1)
        return power * torch.exp(-r2 / (2.0 * sigma ** 2))

    return q
