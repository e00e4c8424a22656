"""H1 finite element space: global dof enumeration on a quad, triangle, hex,
tet, prism or pyramid mesh
(numpy copy of ``FESpace``, ``element_node_coords`` and ``essential_dofs``
from ``cardiac_ablation_ecm2_tpu/fem/fespace.py``, scalar or with ``vdim``
components ordered byNODES).

Every local node of every element gets an integer entity key that is
identical for coincident nodes of neighbouring elements; hash-uniquing the
keys (``utils/native.encode_rows``) yields the global numbering and the L↔E
gather map in one pass:

* vertex node  → ``(VERT, global_vertex)``
* edge node    → ``(EDGE, min_v, max_v, t)``, ``t`` measured from the smaller
  global endpoint
* face node    → ``(FACE, sorted_face_verts, a, b)``, (a, b) in the face's
  canonical frame: origin at the smallest global vertex, first axis toward
  its smaller cyclic neighbour (quads), or the barycentric indices at the
  corners next to it (triangles)
* interior node→ ``(CELL, element, i, j, k)``

Local dof ordering is lexicographic (i fastest), see ``fem/basis.py``;
the pyramid of order ≥ 2 has no lattice, and its keys follow its node
tables (``fem/pyramid2.py``, ``pyramid3.py``, ``pyramid_p.py``) with the
same edge and face codes, so mixed meshes share dofs across blocks.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np

from ..mesh.mesh import Mesh
from .basis import (
    DofToQuad,
    h1_nodes,
    lattice_multi_index,
    make_dof_to_quad,
    simplex_basis_matrices,
)
from .faces import _eval_volume_basis
from .geometry import (
    DIMENSION,
    EDGES,
    FACES,
    NUM_VERTS,
    REF_VERTS,
    Geometry,
)

_VERT, _EDGE, _FACE, _CELL = 0, 1, 2, 3
# packed key layout: [k0, k1, k2, k3, meta] with
# meta = etype<<48 | p0<<32 | p1<<16 | p2  (lattice params < 2^16)
_KEYLEN = 5


def _meta(etype, p0=0, p1=0, p2=0):
    return (etype << 48) | (int(p0) << 32) | (int(p1) << 16) | int(p2)


def _meta_arr(etype, p0=0, p1=0, p2=0):
    return (
        (np.int64(etype) << 48)
        + (np.asarray(p0, np.int64) << 32)
        + (np.asarray(p1, np.int64) << 16)
        + np.asarray(p2, np.int64)
    )


def _node_index_lookup(geom: Geometry, p: int) -> Dict[Tuple[int, ...], int]:
    mi = lattice_multi_index(geom, p)
    return {tuple(row): n for n, row in enumerate(mi)}


def _quad_frame(verts: np.ndarray, p: int):
    """Canonical (u, v) frame of quad faces with cyclic global vertices
    ``verts`` (n, 4): the corner holding the smallest global id, and unit
    lattice axes toward its smaller / larger cyclic neighbour."""
    n = len(verts)
    r = np.argmin(verts, axis=1)
    nxt = verts[np.arange(n), (r + 1) % 4]
    prv = verts[np.arange(n), (r - 1) % 4]
    d = np.where(nxt < prv, 1, -1)
    corner_uv = np.array([[0, 0], [p, 0], [p, p], [0, p]])
    cr = corner_uv[r]
    eu = (corner_uv[(r + d) % 4] - cr) // p
    ev = (corner_uv[(r - d) % 4] - cr) // p
    return cr, eu, ev


def _tri_frame(verts: np.ndarray):
    """Corner of triangle faces ``verts`` (n, 3) holding the smallest global
    id, and the direction (±1) toward its smaller cyclic neighbour."""
    n = len(verts)
    r = np.argmin(verts, axis=1)
    nxt = verts[np.arange(n), (r + 1) % 3]
    prv = verts[np.arange(n), (r - 1) % 3]
    return r, np.where(nxt < prv, 1, -1)


def _tri_face_code(r, d, b0, b1, b2):
    """Canonical (a, b) of the triangle-face node with barycentric indices
    (b0, b1, b2): the indices at the corners r+d and r−d."""
    n = len(r)
    bar = np.stack([np.full(n, b0), np.full(n, b1), np.full(n, b2)], axis=1)
    return bar[np.arange(n), (r + d) % 3], bar[np.arange(n), (r - d) % 3]


def _elem_node_keys(geom: Geometry, p: int, elem_verts: np.ndarray,
                    elem_ids: np.ndarray) -> np.ndarray:
    """Entity keys for all local nodes of a batch of elements:
    (ne, nd, _KEYLEN) int64."""
    if geom == Geometry.PYRAMID and p == 2:
        return _pyramid_p2_keys(elem_verts)
    if geom == Geometry.PYRAMID and p == 3:
        return _pyramid_p3_keys(elem_verts, elem_ids)
    if geom == Geometry.PYRAMID and p >= 4:
        return _pyramid_p_keys(elem_verts, elem_ids, p)
    dim = DIMENSION[geom]
    nd = len(lattice_multi_index(geom, p))
    ne = elem_verts.shape[0]
    # node-major build: every write targets a contiguous (ne, c) slab; one
    # transpose copy at return restores the (ne, nd, _KEYLEN) layout
    keys = np.full((nd, ne, _KEYLEN), -1, dtype=np.int64)
    lookup = _node_index_lookup(geom, p)
    latt_v = np.rint(REF_VERTS[geom] * p).astype(np.int64)  # (nv_el, dim)
    done = np.zeros(nd, dtype=bool)

    for lv in range(NUM_VERTS[geom]):
        n = lookup[tuple(latt_v[lv])]
        keys[n, :, 0] = elem_verts[:, lv]
        keys[n, :, 4] = _meta(_VERT)
        done[n] = True

    if p >= 2:
        for (la, lb) in EDGES[geom]:
            A, B = latt_v[la], latt_v[lb]
            ga, gb = elem_verts[:, la], elem_verts[:, lb]
            lo = np.minimum(ga, gb)
            hi = np.maximum(ga, gb)
            flip = ga > gb            # measure t from the smaller global id
            for t in range(1, p):
                latt = (A * (p - t) + B * t) // p
                n = lookup[tuple(latt)]
                tc = np.where(flip, p - t, t)
                keys[n, :, 0] = lo
                keys[n, :, 1] = hi
                keys[n, :, 4] = _meta_arr(_EDGE, tc)
                done[n] = True

    if dim == 3 and p >= 2:
        for fverts in FACES[geom]:
            gf = elem_verts[:, list(fverts)]          # (ne, k) global ids, cyclic
            gsort = np.sort(gf, axis=1)
            if len(fverts) == 3:
                # triangle face: node = barycentric (b0, b1, b2), all ≥ 1
                r, d = _tri_frame(gf)
                Lf = latt_v[list(fverts)]
                for b0 in range(1, p):
                    for b1 in range(1, p - b0):
                        b2 = p - b0 - b1
                        n = lookup[tuple((Lf[0] * b0 + Lf[1] * b1
                                          + Lf[2] * b2) // p)]
                        a, b = _tri_face_code(r, d, b0, b1, b2)
                        keys[n, :, 0:3] = gsort
                        keys[n, :, 4] = _meta_arr(_FACE, a, b)
                        done[n] = True
                continue
            cr, eu, ev = _quad_frame(gf, p)
            # face-local (u,v) lattice: u along fverts[0]→fverts[1],
            # v along fverts[0]→fverts[3]
            L0 = latt_v[fverts[0]]
            du = (latt_v[fverts[1]] - L0) // p
            dv = (latt_v[fverts[3]] - L0) // p
            for u in range(1, p):
                for v in range(1, p):
                    n = lookup[tuple(L0 + u * du + v * dv)]
                    rel = np.array([u, v]) - cr
                    a = (rel * eu).sum(axis=1)
                    b = (rel * ev).sum(axis=1)
                    keys[n, :, 0:4] = gsort
                    keys[n, :, 4] = _meta_arr(_FACE, a, b)
                    done[n] = True

    mi = lattice_multi_index(geom, p)
    for n in np.nonzero(~done)[0]:
        keys[n, :, 0] = elem_ids
        mi3 = list(mi[n]) + [0] * (3 - dim)
        keys[n, :, 4] = _meta(_CELL, *mi3)

    return np.ascontiguousarray(keys.transpose(1, 0, 2))


def _pyramid_p2_keys(elem_verts: np.ndarray) -> np.ndarray:
    """Entity keys for the 14-node order-2 pyramid (fem/pyramid2.py node
    order: 5 vertices, 8 edge midpoints, base-face center) — identical key
    conventions to the generic tensor/simplex path, so mixed meshes share
    dofs across hex/tet/pyramid blocks."""
    ne = elem_verts.shape[0]
    keys = np.empty((ne, 14, _KEYLEN), dtype=np.int64)
    keys[..., :4] = -1
    for lv in range(5):
        keys[:, lv, 0] = elem_verts[:, lv]
        keys[:, lv, 4] = _meta(_VERT)
    for k, (la, lb) in enumerate(EDGES[Geometry.PYRAMID]):
        ga, gb = elem_verts[:, la], elem_verts[:, lb]
        keys[:, 5 + k, 0] = np.minimum(ga, gb)
        keys[:, 5 + k, 1] = np.maximum(ga, gb)
        keys[:, 5 + k, 4] = _meta(_EDGE, 1)   # p=2 midpoint: frame-free
    base = FACES[Geometry.PYRAMID][0]
    gf = elem_verts[:, list(base)]
    keys[:, 13, 0:4] = np.sort(gf, axis=1)
    keys[:, 13, 4] = _meta(_FACE, 1, 1)       # quad center: frame-free
    return keys


def _pyramid_p3_keys(elem_verts: np.ndarray,
                     elem_ids: np.ndarray) -> np.ndarray:
    """Entity keys for the 30-node order-3 pyramid (fem/pyramid3.py node
    order: 5 vertices, 8 edges × 2 GLL nodes, 4 tri-face centroids, 4 quad-
    base GLL² nodes, 1 cell node) — same canonical edge/face code
    conventions as the generic lattice path, so mixed meshes share
    oriented dofs across hex/tet/pyramid blocks."""
    p = 3
    ne = elem_verts.shape[0]
    keys = np.empty((ne, 30, _KEYLEN), dtype=np.int64)
    keys[..., :4] = -1
    for lv in range(5):
        keys[:, lv, 0] = elem_verts[:, lv]
        keys[:, lv, 4] = _meta(_VERT)
    for k, (la, lb) in enumerate(EDGES[Geometry.PYRAMID]):
        ga, gb = elem_verts[:, la], elem_verts[:, lb]
        lo, hi = np.minimum(ga, gb), np.maximum(ga, gb)
        flip = ga > gb
        for t in (1, 2):                       # node at GLL t counted from la
            n = 5 + 2 * k + (t - 1)
            keys[:, n, 0] = lo
            keys[:, n, 1] = hi
            keys[:, n, 4] = _meta_arr(_EDGE, np.where(flip, p - t, t))
    for i, f in enumerate(FACES[Geometry.PYRAMID][1:]):
        n = 21 + i                             # centroid (1,1,1): frame-free
        keys[:, n, 0:3] = np.sort(elem_verts[:, list(f)], axis=1)
        keys[:, n, 4] = _meta(_FACE, 1, 1)
    fverts = FACES[Geometry.PYRAMID][0]
    gf = elem_verts[:, list(fverts)]
    gsort = np.sort(gf, axis=1)
    r = np.argmin(gf, axis=1)
    nxt = gf[np.arange(ne), (r + 1) % 4]
    prv = gf[np.arange(ne), (r - 1) % 4]
    d = np.where(nxt < prv, 1, -1)
    corner_uv = np.array([[0, 0], [p, 0], [p, p], [0, p]])
    cr = corner_uv[r]
    eu = (corner_uv[(r + d) % 4] - cr) // p
    ev = (corner_uv[(r - d) % 4] - cr) // p
    for v in (1, 2):                           # node order (1,1),(2,1),(1,2),(2,2)
        for u in (1, 2):
            n = 25 + (v - 1) * 2 + (u - 1)
            rel = np.array([u, v]) - cr
            a = (rel * eu).sum(axis=1)
            b = (rel * ev).sum(axis=1)
            keys[:, n, 0:4] = gsort
            keys[:, n, 4] = _meta_arr(_FACE, a, b)
    keys[:, 29, 0] = elem_ids
    keys[:, 29, 4] = _meta(_CELL, 1, 1, 1)
    return keys


def _pyramid_p_keys(elem_verts: np.ndarray, elem_ids: np.ndarray,
                    p: int) -> np.ndarray:
    """Entity keys for the order-p rational pyramid (fem/pyramid_p.py node
    order) — identical canonical edge/face code conventions to the generic
    lattice path, so mixed meshes share oriented dofs across hex/tet/
    pyramid blocks at any order."""
    from .pyramid_p import pyramid_num_dofs

    ne = elem_verts.shape[0]
    nd = pyramid_num_dofs(p)
    keys = np.empty((ne, nd, _KEYLEN), dtype=np.int64)
    keys[..., :4] = -1
    for lv in range(5):
        keys[:, lv, 0] = elem_verts[:, lv]
        keys[:, lv, 4] = _meta(_VERT)
    n = 5
    for (la, lb) in EDGES[Geometry.PYRAMID]:
        ga, gb = elem_verts[:, la], elem_verts[:, lb]
        lo, hi = np.minimum(ga, gb), np.maximum(ga, gb)
        flip = ga > gb
        for t in range(1, p):                  # node at GLL t counted from la
            keys[:, n, 0] = lo
            keys[:, n, 1] = hi
            keys[:, n, 4] = _meta_arr(_EDGE, np.where(flip, p - t, t))
            n += 1
    ar = np.arange(ne)
    for f in FACES[Geometry.PYRAMID][1:]:      # tri faces: barycentric codes
        gf = elem_verts[:, list(f)]
        gsort = np.sort(gf, axis=1)
        r = np.argmin(gf, axis=1)
        d = np.where(gf[ar, (r + 1) % 3] < gf[ar, (r - 1) % 3], 1, -1)
        for b0 in range(1, p):
            for b1 in range(1, p - b0):
                b2 = p - b0 - b1
                if b2 < 1:
                    continue
                bar = np.stack([np.full(ne, b0), np.full(ne, b1),
                                np.full(ne, b2)], axis=1)
                a = bar[ar, (r + d) % 3]
                bb = bar[ar, (r - d) % 3]
                keys[:, n, 0:3] = gsort
                keys[:, n, 4] = _meta_arr(_FACE, a, bb)
                n += 1
    fverts = FACES[Geometry.PYRAMID][0]        # quad base: (u, v) codes
    gf = elem_verts[:, list(fverts)]
    gsort = np.sort(gf, axis=1)
    r = np.argmin(gf, axis=1)
    d = np.where(gf[ar, (r + 1) % 4] < gf[ar, (r - 1) % 4], 1, -1)
    corner_uv = np.array([[0, 0], [p, 0], [p, p], [0, p]])
    cr = corner_uv[r]
    eu = (corner_uv[(r + d) % 4] - cr) // p
    ev = (corner_uv[(r - d) % 4] - cr) // p
    for u in range(1, p):
        for v in range(1, p):
            rel = np.array([u, v]) - cr
            a = (rel * eu).sum(axis=1)
            b = (rel * ev).sum(axis=1)
            keys[:, n, 0:4] = gsort
            keys[:, n, 4] = _meta_arr(_FACE, a, b)
            n += 1
    for ell in range(1, p - 1):                # interior: level/grid indices
        m = p - 1 - ell
        for j in range(m):
            for i in range(m):
                keys[:, n, 0] = elem_ids
                keys[:, n, 4] = _meta(_CELL, ell, i, j)
                n += 1
    assert n == nd
    return keys


def _bdr_cell_to_face_keys(bgeom: Geometry, p: int, bverts: np.ndarray,
                           bkeys: np.ndarray) -> np.ndarray:
    """Rewrite the CELL keys of boundary quads' or triangles' interior nodes
    as the canonical FACE keys the adjacent volume element gives them."""
    if p < 2 or DIMENSION[bgeom] != 2:
        return bkeys
    mi = lattice_multi_index(bgeom, p)
    gsort = np.sort(bverts, axis=1)
    cell_nodes = np.nonzero((bkeys[0, :, 4] >> 48) == _CELL)[0]
    if bgeom == Geometry.TRIANGLE:
        r, d = _tri_frame(bverts)
        for n in cell_nodes:
            i, j = mi[n]
            a, b = _tri_face_code(r, d, p - i - j, i, j)
            bkeys[:, n, 0:3] = gsort
            bkeys[:, n, 4] = _meta_arr(_FACE, a, b)
        return bkeys
    cr, eu, ev = _quad_frame(bverts, p)
    for n in cell_nodes:
        rel = mi[n] - cr
        a = (rel * eu).sum(axis=1)
        b = (rel * ev).sum(axis=1)
        bkeys[:, n, 0:4] = gsort
        bkeys[:, n, 4] = _meta_arr(_FACE, a, b)
    return bkeys


@dataclasses.dataclass(eq=False)
class FESpace:
    """H1 nodal space of order p on a single-geometry mesh.  ``vdim``
    components are ordered byNODES (component-major): global dof =
    scalar dof + ndof_scalar·c.  The gather maps and ``essential_dofs``
    stay scalar; a vector caller offsets them by c·ndof_scalar."""

    mesh: Mesh
    order: int
    vdim: int = 1

    # filled by __post_init__
    ndof_scalar: int = dataclasses.field(init=False)
    gather_map: np.ndarray = dataclasses.field(init=False)       # (ne, nd) int32
    bdr_gather_map: np.ndarray = dataclasses.field(init=False)   # (nbe, ndf) int32

    def __post_init__(self):
        from ..utils.native import encode_rows

        mesh, p = self.mesh, self.order
        keys = _elem_node_keys(
            mesh.geom, p, mesh.elements, np.arange(mesh.ne, dtype=np.int64)
        )
        ne, nd, _ = keys.shape
        flat = keys.reshape(ne * nd, _KEYLEN)

        bflat = None
        if mesh.nbe > 0 and mesh.dim > 1:
            bgeom = mesh.bdr_geom
            bkeys = _elem_node_keys(
                bgeom, p, mesh.boundary, np.arange(mesh.nbe, dtype=np.int64)
            )
            bkeys = _bdr_cell_to_face_keys(bgeom, p, mesh.boundary, bkeys)
            bflat = bkeys.reshape(-1, _KEYLEN)

        count, main_ids, qids = encode_rows(flat, bflat)
        self.ndof_scalar = count
        self.gather_map = main_ids.reshape(ne, nd).astype(np.int32)
        if bflat is not None:
            if np.any(qids < 0):
                raise ValueError("boundary face nodes not found in volume dofs")
            self.bdr_gather_map = qids.reshape(mesh.nbe, -1).astype(np.int32)
        else:
            self.bdr_gather_map = np.zeros((0, 0), dtype=np.int32)

    @property
    def ndof(self) -> int:
        return self.ndof_scalar * self.vdim

    @functools.cached_property
    def d2q(self) -> DofToQuad:
        from ..utils.config import config

        return make_dof_to_quad(self.mesh.geom, self.order,
                                self.order + 1 + config.quad_extra)

    def dof_to_quad(self, nq1d=None) -> DofToQuad:
        if nq1d is None:
            return self.d2q
        return make_dof_to_quad(self.mesh.geom, self.order, nq1d)

    @functools.cached_property
    def dof_coords(self) -> np.ndarray:
        """Nodal coordinates of every scalar L-dof, (ndof, sdim) float64:
        the scatter of the element node coordinates."""
        Xe = element_node_coords(self.mesh, self.order)
        coords = np.zeros((self.ndof_scalar, self.mesh.sdim))
        coords[self.gather_map.reshape(-1)] = Xe.reshape(-1, self.mesh.sdim)
        return coords

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        """Scalar L-dofs on the marked boundary attributes (sorted, unique);
        ``None`` marks every attribute."""
        if self.mesh.nbe == 0:
            return np.zeros(0, dtype=np.int32)
        if bdr_marker is None:
            sel = np.ones(self.mesh.nbe, dtype=bool)
        else:
            sel = np.isin(self.mesh.bdr_attributes, np.asarray(list(bdr_marker)))
        return np.unique(self.bdr_gather_map[sel].reshape(-1)).astype(np.int32)


def element_node_coords(mesh: Mesh, p: int) -> np.ndarray:
    """Physical coordinates of the order-p lattice nodes of every element,
    (ne, nd, sdim): the curved ``mesh.nodes`` (evaluated at the order-p
    lattice when their order differs), else the P1 (simplex) or
    multilinear Q1 vertex map (the wedge's barycentric times linear z map,
    the pyramid's rational vertex map).  Not memoised: every call reads the
    mesh's current arrays."""
    ref = h1_nodes(mesh.geom, p)                      # (nd, dim)
    if mesh.nodes is not None:
        if mesh.nodes_order == p:
            return mesh.nodes
        B = _eval_volume_basis(mesh.geom, mesh.nodes_order,
                               ref.astype(np.float64))
        return _batched_eval(B, mesh.nodes)
    if mesh.geom in (Geometry.TRIANGLE, Geometry.TETRAHEDRON):
        B, _ = simplex_basis_matrices(mesh.geom, 1, ref)   # (nd, nv)
    elif mesh.geom == Geometry.PRISM:
        lam = np.stack([1 - ref[:, 0] - ref[:, 1], ref[:, 0], ref[:, 1]], axis=1)
        z = ref[:, 2][:, None]
        B = np.concatenate([lam * (1 - z), lam * z], axis=1)   # (nd, 6)
    elif mesh.geom == Geometry.PYRAMID and p >= 2:
        from .basis import pyramid_basis_matrices
        from .pyramid2 import _nudge_apex

        B = pyramid_basis_matrices(1, _nudge_apex(ref))[0]
    elif mesh.geom == Geometry.PYRAMID:
        # order 1: the nodes are the vertices (the rational map divides by
        # zero at the apex; the identity is exact)
        B = np.eye(NUM_VERTS[mesh.geom])
    else:
        B = _q1_eval_matrix(mesh.geom, ref)
    return _batched_eval(B, mesh.vertices[mesh.elements])


def _batched_eval(B: np.ndarray, V: np.ndarray) -> np.ndarray:
    """(nd, k) eval matrix × (ne, k, s) batch → (ne, nd, s), as one GEMM."""
    ne, k, s = V.shape
    flat = np.ascontiguousarray(V.transpose(1, 0, 2)).reshape(k, ne * s)
    out = (B @ flat).reshape(B.shape[0], ne, s)
    return np.ascontiguousarray(out.transpose(1, 0, 2))


def _q1_eval_matrix(geom: Geometry, pts: np.ndarray) -> np.ndarray:
    """Multilinear Q1 shape functions of ``geom`` evaluated at ``pts`` (npts, nv)."""
    rv = REF_VERTS[geom]
    B = np.ones((len(pts), len(rv)))
    for d in range(DIMENSION[geom]):
        x = pts[:, d][:, None]
        v = rv[:, d][None, :]
        B *= np.where(v > 0.5, x, 1.0 - x)
    return B


@dataclasses.dataclass(eq=False)
class L2FESpace:
    """Discontinuous space (numpy copy of the JAX package's ``L2FESpace``;
    MFEM's ``L2ElementRestriction``): every dof belongs to one element, so
    the gather map is the identity reshape (ne, nd) and there are no
    essential dofs.  The nodes are the H1 lattice's, as the JAX package's
    (its ``d2q`` takes the default "h1" nodes)."""

    mesh: Mesh
    order: int
    vdim: int = 1

    ndof_scalar: int = dataclasses.field(init=False)
    gather_map: np.ndarray = dataclasses.field(init=False)

    def __post_init__(self):
        nd = len(lattice_multi_index(self.mesh.geom, self.order))
        self.ndof_scalar = self.mesh.ne * nd
        self.gather_map = np.arange(self.ndof_scalar, dtype=np.int32).reshape(
            self.mesh.ne, nd)

    @property
    def ndof(self) -> int:
        return self.ndof_scalar * self.vdim

    @property
    def nd_elem(self) -> int:
        return self.gather_map.shape[1]

    @functools.cached_property
    def d2q(self) -> DofToQuad:
        from ..utils.config import config

        return make_dof_to_quad(self.mesh.geom, self.order,
                                self.order + 1 + config.quad_extra)

    def dof_to_quad(self, nq1d=None) -> DofToQuad:
        if nq1d is None:
            return self.d2q
        return make_dof_to_quad(self.mesh.geom, self.order, nq1d)

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        return np.zeros(0, dtype=np.int32)
