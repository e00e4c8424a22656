"""Unstructured mesh as element-batched index arrays (numpy copy of ``Mesh``,
the Cartesian makers (hex, tet, prism, pyramid), ``curve_mesh``, the entity tables and uniform
refinement from ``cardiac_ablation_ecm2_tpu/mesh/mesh.py``; MFEM's
``MakeCartesian2D/3D``, ``SetCurvature`` and ``UniformRefinement``).

A mesh is a plain bag of numpy arrays, one geometry type per mesh, built on
the host; only dof-mapped arrays derived from it go to a device.  The
geometry is the multilinear map from ``vertices`` unless ``nodes`` holds a
curved one: an (ne, nd, sdim) E-vector of the order-``nodes_order``
geometry lattice, lexicographic.

Every array the makers and the refinement emit is bitwise the JAX
package's.  Refinement numbers child o of parent e as fine element
o·ne + e (``fem/transfer.HTransfer`` and ``parallel/refine`` rely on it);
the JAX package's per-row dict lookups of boundary edges and faces in the
volume tables are hash lookups over whole rows here
(``utils/native.encode_rows``), which give the same ids.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..fem.geometry import (
    DIMENSION,
    EDGES,
    FACE_GEOM,
    FACES,
    NUM_VERTS,
    REF_VERTS,
    Geometry,
)


@dataclasses.dataclass
class Mesh:
    geom: Geometry
    vertices: np.ndarray        # (nv, sdim) float64
    elements: np.ndarray        # (ne, nv_el) int64
    attributes: np.ndarray      # (ne,) int64
    boundary: np.ndarray        # (nbe, nv_face) int64
    bdr_attributes: np.ndarray  # (nbe,) int64
    nodes: Optional[np.ndarray] = None   # (ne, nd_el, sdim) curved geometry
    nodes_order: int = 1

    @property
    def dim(self) -> int:
        return DIMENSION[self.geom]

    @property
    def sdim(self) -> int:
        return self.vertices.shape[1]

    @property
    def ne(self) -> int:
        return self.elements.shape[0]

    @property
    def nv(self) -> int:
        return self.vertices.shape[0]

    @property
    def nbe(self) -> int:
        return self.boundary.shape[0]

    @property
    def bdr_geom(self) -> Geometry:
        return FACE_GEOM[self.geom]

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, dtype=np.float64)
        self.elements = np.asarray(self.elements, dtype=np.int64)
        self.attributes = np.asarray(self.attributes, dtype=np.int64)
        self.boundary = np.asarray(self.boundary, dtype=np.int64).reshape(
            -1, NUM_VERTS[self.bdr_geom] if self.dim > 0 else 0
        )
        self.bdr_attributes = np.asarray(self.bdr_attributes, dtype=np.int64)

    def uniform_refinement(self, iterations: int = 1) -> "Mesh":
        """Refine every element 2^dim ways (4 ways for triangles),
        ``iterations`` times; tets raise ``NotImplementedError``."""
        m = self
        for _ in range(iterations):
            m = _uniform_refine(m)
        return m


def make_cartesian_2d(nx: int, ny: int, sx: float = 1.0, sy: float = 1.0) -> Mesh:
    """Quadrilateral grid on [0,sx]×[0,sy].  Boundary attributes:
    1=bottom, 2=right, 3=top, 4=left."""
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X.ravel(order="F"), Y.ravel(order="F")], axis=1)

    def vid(i, j):
        return i + (nx + 1) * j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(order="F"), J.ravel(order="F")
    elems = np.stack(
        [vid(I, J), vid(I + 1, J), vid(I + 1, J + 1), vid(I, J + 1)], axis=1
    )
    # the JAX package's boundary order: per column bottom then top, then per
    # row right then left
    i, j = np.arange(nx), np.arange(ny)
    bt = np.stack([np.stack([vid(i, 0), vid(i + 1, 0)], axis=1),
                   np.stack([vid(i + 1, ny), vid(i, ny)], axis=1)], axis=1)
    rl = np.stack([np.stack([vid(nx, j), vid(nx, j + 1)], axis=1),
                   np.stack([vid(0, j + 1), vid(0, j)], axis=1)], axis=1)
    bdr = np.concatenate([bt.reshape(-1, 2), rl.reshape(-1, 2)])
    battr = np.concatenate([np.tile([1, 3], nx), np.tile([2, 4], ny)])
    return Mesh(
        geom=Geometry.SQUARE,
        vertices=verts,
        elements=elems,
        attributes=np.ones(len(elems), dtype=np.int64),
        boundary=bdr.astype(np.int64),
        bdr_attributes=battr.astype(np.int64),
    )


def make_periodic_cartesian_2d(nx: int, ny: int, sx: float = 1.0,
                               sy: float = 1.0, periodic=(True, True)) -> Mesh:
    """Periodic quad grid: vertices on periodic sides are identified
    (MFEM's ``MakePeriodic``), so the key-based dof numbering makes the
    space periodic; each cell's own corner coordinates go into order-1
    ``nodes`` (lex corner order v0, v1, v3, v2), so wrapped cells keep
    their geometry."""
    px, py = periodic
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)

    def vid(i, j):
        ii = i % nx if px else i
        jj = j % ny if py else j
        return ii + (nx + (0 if px else 1)) * jj

    nvx = nx if px else nx + 1
    nvy = ny if py else ny + 1
    X, Y = np.meshgrid(xs[:nvx], ys[:nvy], indexing="ij")
    verts = np.stack([X.ravel(order="F"), Y.ravel(order="F")], axis=1)

    J, I = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    I, J = I.ravel(), J.ravel()                  # rows j, i fastest
    elems = np.stack([vid(I, J), vid(I + 1, J), vid(I + 1, J + 1),
                      vid(I, J + 1)], axis=1).astype(np.int64)
    nodes = np.stack([
        np.stack([xs[I], ys[J]], axis=1), np.stack([xs[I + 1], ys[J]], axis=1),
        np.stack([xs[I], ys[J + 1]], axis=1),
        np.stack([xs[I + 1], ys[J + 1]], axis=1)], axis=1)

    bdr, battr = [], []
    if not py:
        i = np.arange(nx)
        bdr.append(np.stack([np.stack([vid(i, 0), vid(i + 1, 0)], axis=1),
                             np.stack([vid(i + 1, ny), vid(i, ny)], axis=1)],
                            axis=1).reshape(-1, 2))
        battr.append(np.tile([1, 3], nx))
    if not px:
        j = np.arange(ny)
        bdr.append(np.stack([np.stack([vid(nx, j), vid(nx, j + 1)], axis=1),
                             np.stack([vid(0, j + 1), vid(0, j)], axis=1)],
                            axis=1).reshape(-1, 2))
        battr.append(np.tile([2, 4], ny))
    return Mesh(
        geom=Geometry.SQUARE,
        vertices=verts,
        elements=elems,
        attributes=np.ones(len(elems), dtype=np.int64),
        boundary=(np.concatenate(bdr).astype(np.int64) if bdr
                  else np.zeros((0, 2), dtype=np.int64)),
        bdr_attributes=(np.concatenate(battr).astype(np.int64) if battr
                        else np.zeros(0, dtype=np.int64)),
        nodes=nodes,
        nodes_order=1,
    )


def make_cartesian_2d_tri(nx: int, ny: int, sx: float = 1.0,
                          sy: float = 1.0) -> Mesh:
    """Triangular grid: each quad of :func:`make_cartesian_2d` split along
    its (v0, v2) diagonal, all first halves before all second halves."""
    q = make_cartesian_2d(nx, ny, sx, sy)
    e = q.elements
    return Mesh(
        geom=Geometry.TRIANGLE,
        vertices=q.vertices,
        elements=np.concatenate([e[:, [0, 1, 2]], e[:, [0, 2, 3]]], axis=0),
        attributes=np.concatenate([q.attributes, q.attributes]),
        boundary=q.boundary,
        bdr_attributes=q.bdr_attributes,
    )


def make_cartesian_3d(
    nx: int, ny: int, nz: int, sx: float = 1.0, sy: float = 1.0, sz: float = 1.0
) -> Mesh:
    """Hexahedral grid on [0,sx]×[0,sy]×[0,sz].

    Boundary attributes: 1=z=0, 2=y=0, 3=x=sx, 4=y=sy, 5=x=0, 6=z=sz.
    """
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)
    zs = np.linspace(0.0, sz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    verts = np.stack(
        [X.ravel(order="F"), Y.ravel(order="F"), Z.ravel(order="F")], axis=1
    )

    def vid(i, j, k):
        return i + (nx + 1) * (j + (ny + 1) * k)

    I, J, K = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    I, J, K = I.ravel(order="F"), J.ravel(order="F"), K.ravel(order="F")
    elems = np.stack(
        [
            vid(I, J, K),
            vid(I + 1, J, K),
            vid(I + 1, J + 1, K),
            vid(I, J + 1, K),
            vid(I, J, K + 1),
            vid(I + 1, J, K + 1),
            vid(I + 1, J + 1, K + 1),
            vid(I, J + 1, K + 1),
        ],
        axis=1,
    )

    bdr, battr = [], []
    for j in range(ny):
        for i in range(nx):
            bdr.append((vid(i, j + 1, 0), vid(i + 1, j + 1, 0),
                        vid(i + 1, j, 0), vid(i, j, 0))); battr.append(1)
            bdr.append((vid(i, j, nz), vid(i + 1, j, nz),
                        vid(i + 1, j + 1, nz), vid(i, j + 1, nz))); battr.append(6)
    for k in range(nz):
        for i in range(nx):
            bdr.append((vid(i, 0, k), vid(i + 1, 0, k),
                        vid(i + 1, 0, k + 1), vid(i, 0, k + 1))); battr.append(2)
            bdr.append((vid(i + 1, ny, k), vid(i, ny, k),
                        vid(i, ny, k + 1), vid(i + 1, ny, k + 1))); battr.append(4)
    for k in range(nz):
        for j in range(ny):
            bdr.append((vid(nx, j, k), vid(nx, j + 1, k),
                        vid(nx, j + 1, k + 1), vid(nx, j, k + 1))); battr.append(3)
            bdr.append((vid(0, j + 1, k), vid(0, j, k),
                        vid(0, j, k + 1), vid(0, j + 1, k + 1))); battr.append(5)

    return Mesh(
        geom=Geometry.CUBE,
        vertices=verts,
        elements=elems,
        attributes=np.ones(len(elems), dtype=np.int64),
        boundary=np.array(bdr, dtype=np.int64),
        bdr_attributes=np.array(battr, dtype=np.int64),
    )


#: the six tets of a hex around its (v0, v6) diagonal
_TET_PATHS = ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
              (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6))


def make_cartesian_3d_tet(
    nx: int, ny: int, nz: int, sx: float = 1.0, sy: float = 1.0, sz: float = 1.0
) -> Mesh:
    """Tetrahedral grid: each hex of :func:`make_cartesian_3d` split into six
    tets around its (v0, v6) diagonal; each boundary quad becomes the two
    triangles along the diagonal its tet cut.  The face-membership test
    runs on sorted face rows encoded as int64 keys (``np.isin``), so a
    million tets take seconds; the arrays equal the JAX package's."""
    h = make_cartesian_3d(nx, ny, nz, sx, sy, sz)
    e = h.elements
    tets = np.concatenate([e[:, list(p)] for p in _TET_PATHS], axis=0)
    nv = np.int64(h.nv)
    if float(h.nv) ** 3 >= 2.0 ** 63:
        raise ValueError(f"{h.nv} vertices overflow the int64 face keys")

    def keys(rows):
        r = np.sort(rows, axis=1)
        return (r[:, 0] * nv + r[:, 1]) * nv + r[:, 2]

    faces = [(1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)]
    tet_keys = np.concatenate([keys(tets[:, list(f)]) for f in faces])
    q = h.boundary
    cut02 = np.isin(keys(q[:, [0, 1, 2]]), tet_keys)
    first = np.where(cut02[:, None], q[:, [0, 1, 2]], q[:, [0, 1, 3]])
    second = np.where(cut02[:, None], q[:, [0, 2, 3]], q[:, [1, 2, 3]])
    btris = np.stack([first, second], axis=1).reshape(-1, 3)
    return Mesh(
        geom=Geometry.TETRAHEDRON,
        vertices=h.vertices,
        elements=tets,
        attributes=np.tile(h.attributes, 6),
        boundary=btris,
        bdr_attributes=np.repeat(h.bdr_attributes, 2),
    )


def make_cartesian_3d_prism(
    nx: int, ny: int, nz: int, sx: float = 1.0, sy: float = 1.0, sz: float = 1.0
) -> Mesh:
    """Wedge (prism) grid: each hex split into 2 wedges by the v0–v2 bottom
    diagonal (the same in every column, so interior faces match).  The
    boundary lists the four side walls (quads); the z = 0 and z = 1 faces
    would be triangles and are left unlisted (natural), as the JAX
    package's maker leaves them.  Its per-quad ``np.allclose`` test of the
    z coordinates runs over whole arrays here."""
    h = make_cartesian_3d(nx, ny, nz, sx, sy, sz)
    e = h.elements
    wedges = np.concatenate([e[:, [0, 1, 2, 4, 5, 6]], e[:, [0, 2, 3, 4, 6, 7]]],
                            axis=0)
    z = h.vertices[h.boundary, 2]
    flat = np.all(np.abs(z - z[:, :1]) <= 1e-8 + 1e-5 * np.abs(z[:, :1]), axis=1)
    return Mesh(
        geom=Geometry.PRISM,
        vertices=h.vertices,
        elements=wedges,
        attributes=np.tile(h.attributes, 2),
        boundary=h.boundary[~flat].reshape(-1, 4),
        bdr_attributes=h.bdr_attributes[~flat],
    )


def make_cartesian_3d_pyramid(
    nx: int, ny: int, nz: int, sx: float = 1.0, sy: float = 1.0, sz: float = 1.0
) -> Mesh:
    """Pyramid grid: each hex split into 6 pyramids with the apex at its
    centre, one on each face (face-major within a hex, as the JAX
    package's loop); every boundary face stays a quad, a pyramid's base."""
    h = make_cartesian_3d(nx, ny, nz, sx, sy, sz)
    centers = h.vertices[h.elements].mean(axis=1)         # (ne, 3)
    apex = h.nv + np.arange(h.ne, dtype=np.int64)
    # FACES lists are outward-cyclic; seen from the apex (inside) that is
    # clockwise, so the base is reversed for a positive pyramid
    pyrs = np.stack([np.concatenate([h.elements[:, list(reversed(f))],
                                     apex[:, None]], axis=1)
                     for f in FACES[Geometry.CUBE]], axis=1).reshape(-1, 5)
    return Mesh(
        geom=Geometry.PYRAMID,
        vertices=np.concatenate([h.vertices, centers], axis=0),
        elements=pyrs,
        attributes=np.repeat(h.attributes, len(FACES[Geometry.CUBE])),
        boundary=h.boundary,
        bdr_attributes=h.bdr_attributes,
    )


def curve_mesh(mesh: Mesh, mapping, order: int) -> Mesh:
    """Isoparametric curved mesh (MFEM's ``SetCurvature`` then
    ``Transform``): ``mapping(x) -> x'`` on (..., sdim) numpy arrays,
    applied to the order-``order`` geometry lattice and to the vertices."""
    from ..fem.fespace import element_node_coords

    X = element_node_coords(mesh, order)
    return Mesh(
        geom=mesh.geom,
        vertices=np.asarray(mapping(mesh.vertices)),
        elements=mesh.elements,
        attributes=mesh.attributes,
        boundary=mesh.boundary,
        bdr_attributes=mesh.bdr_attributes,
        nodes=np.asarray(mapping(X)),
        nodes_order=order,
    )


# ----------------------------------------------------------------------------
# entity tables
# ----------------------------------------------------------------------------


def unique_edges(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """Unique mesh edges: (edges (nedge, 2) sorted pairs in lexicographic
    order, elem_edge (ne, n_loc_edges) edge ids).  The pairs are uniqued as
    int64 keys lo·nv + hi, whose numeric order is np.unique's row order."""
    loc = np.array(EDGES[mesh.geom], dtype=np.int64)
    ev = np.sort(mesh.elements[:, loc], axis=2).reshape(-1, 2)
    nv = np.int64(max(mesh.nv, int(ev.max(initial=0)) + 1))
    keys, inv = np.unique(ev[:, 0] * nv + ev[:, 1], return_inverse=True)
    uniq = np.stack([keys // nv, keys % nv], axis=1)
    return uniq, inv.reshape(mesh.ne, len(loc))


def unique_faces(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """Unique faces of a 3D mesh: (faces (nface, fv) sorted vertex tuples
    in lexicographic order, elem_face (ne, n_loc_faces)).  Mixed arities
    (the wedge's and the pyramid's triangles and quads) are left-padded
    with −1 to the widest face, so they share one table without
    colliding."""
    from ..utils.native import encode_rows

    loc_list = FACES[mesh.geom]
    w = max(len(f) for f in loc_list)
    ne = mesh.ne
    keys = np.stack([np.concatenate(
        [np.full((ne, w - len(f)), -1, dtype=np.int64),
         np.sort(mesh.elements[:, list(f)], axis=1)], axis=1)
        for f in loc_list], axis=1)
    flat = keys.reshape(-1, keys.shape[-1])
    # np.unique(flat, axis=0)'s result: hash-unique the rows, then order the
    # unique rows lexicographically
    count, ids, _ = encode_rows(flat)
    first = np.empty(count, dtype=np.int64)
    first[ids[::-1]] = np.arange(len(ids) - 1, -1, -1)
    rows = flat[first]
    order = np.lexsort(rows.T[::-1])
    rank = np.empty(count, dtype=np.int64)
    rank[order] = np.arange(count)
    return rows[order], rank[ids].reshape(mesh.ne, len(loc_list))


def _row_ids(table: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The index in ``table`` (unique rows) of each row of ``rows``;
    ``KeyError`` for a row the table lacks, as a dict lookup."""
    from ..utils.native import encode_rows

    count, _, q = encode_rows(table, rows)
    if count != len(table):
        raise ValueError("table rows are not unique")
    if np.any(q < 0):
        raise KeyError(tuple(rows[np.argmax(q < 0)]))
    return q            # first-seen ids of unique rows are their indices


# ----------------------------------------------------------------------------
# uniform refinement (tensor geometries and triangles)
# ----------------------------------------------------------------------------


def _uniform_refine(mesh: Mesh) -> Mesh:
    if mesh.nodes is not None:
        return _refine_curved(mesh)
    if mesh.geom == Geometry.TRIANGLE:
        return _refine_tri(mesh)
    if mesh.geom not in (Geometry.SQUARE, Geometry.CUBE, Geometry.SEGMENT):
        raise NotImplementedError(f"refinement for {mesh.geom}")
    dim = mesh.dim

    # every point of the 2x-refined reference lattice (coordinates in
    # {0, 1, 2}) is a parent corner, edge midpoint, face centre or cell
    # centre; each category gets its block of new vertex ids
    nv_old = mesh.nv
    new_verts = [mesh.vertices]
    vert_of: Dict[Tuple[int, ...], np.ndarray] = {}
    ref = (REF_VERTS[mesh.geom] * 2).astype(np.int64)
    for v_local, latt in enumerate(ref):
        vert_of[tuple(latt)] = mesh.elements[:, v_local]

    edges, elem_edge = unique_edges(mesh)
    new_verts.append(0.5 * (mesh.vertices[edges[:, 0]]
                            + mesh.vertices[edges[:, 1]]))
    for le, (a, b) in enumerate(EDGES[mesh.geom]):
        vert_of[tuple(((ref[a] + ref[b]) // 2).tolist())] = nv_old + elem_edge[:, le]
    nv_after_edges = nv_old + len(edges)

    if dim == 3:
        faces, elem_face = unique_faces(mesh)
        new_verts.append(mesh.vertices[faces].mean(axis=1))
        for lf, fverts in enumerate(FACES[mesh.geom]):
            latt = tuple((sum(ref[v] for v in fverts) // len(fverts)).tolist())
            vert_of[latt] = nv_after_edges + elem_face[:, lf]
        nv_after_faces = nv_after_edges + len(faces)
    else:
        faces, nv_after_faces = None, nv_after_edges

    new_verts.append(mesh.vertices[mesh.elements].mean(axis=1))
    vert_of[tuple([1] * dim)] = nv_after_faces + np.arange(mesh.ne)
    vertices = np.concatenate(new_verts, axis=0)

    # child at corner offset `off`: its vertex v sits at lattice point
    # off + corner(v); children are stacked offset-major
    corners = REF_VERTS[mesh.geom].astype(np.int64)
    elements = np.concatenate([
        np.stack([vert_of[tuple((off + corners[v]).tolist())]
                  for v in range(NUM_VERTS[mesh.geom])], axis=1)
        for off in corners], axis=0)
    attributes = np.tile(mesh.attributes, len(corners))

    if mesh.nbe > 0 and dim > 1:
        bgeom = mesh.bdr_geom
        bref = (REF_VERTS[bgeom] * 2).astype(np.int64)
        bvert_of: Dict[Tuple[int, ...], np.ndarray] = {}
        for v_local, latt in enumerate(bref):
            bvert_of[tuple(latt)] = mesh.boundary[:, v_local]
        for (a, b) in EDGES[bgeom]:
            pairs = np.sort(mesh.boundary[:, [a, b]], axis=1)
            bvert_of[tuple(((bref[a] + bref[b]) // 2).tolist())] = (
                nv_old + _row_ids(edges, pairs))
        if bgeom == Geometry.SQUARE:
            bvert_of[(1, 1)] = nv_after_edges + _row_ids(
                faces, np.sort(mesh.boundary, axis=1))
        bcorners = REF_VERTS[bgeom].astype(np.int64)
        boundary = np.concatenate([
            np.stack([bvert_of[tuple((off + bcorners[v]).tolist())]
                      for v in range(NUM_VERTS[bgeom])], axis=1)
            for off in bcorners], axis=0)
        bdr_attributes = np.tile(mesh.bdr_attributes, len(bcorners))
    else:
        boundary, bdr_attributes = mesh.boundary, mesh.bdr_attributes

    return Mesh(geom=mesh.geom, vertices=vertices, elements=elements,
                attributes=attributes, boundary=boundary,
                bdr_attributes=bdr_attributes)


def _refine_tri(mesh: Mesh) -> Mesh:
    """Red refinement of triangles: four children through the edge
    midpoints, the corner children first, the inverted centre one last."""
    edges, elem_edge = unique_edges(mesh)
    nv_old = mesh.nv
    mid = 0.5 * (mesh.vertices[edges[:, 0]] + mesh.vertices[edges[:, 1]])
    vertices = np.concatenate([mesh.vertices, mid], axis=0)
    v0, v1, v2 = (mesh.elements[:, i] for i in range(3))
    m01, m12, m20 = (nv_old + elem_edge[:, i] for i in range(3))
    elements = np.concatenate([
        np.stack([v0, m01, m20], axis=1),
        np.stack([m01, v1, m12], axis=1),
        np.stack([m20, m12, v2], axis=1),
        np.stack([m01, m12, m20], axis=1),
    ], axis=0)
    b = mesh.boundary
    mids = nv_old + _row_ids(edges, np.sort(b, axis=1))
    boundary = np.concatenate([np.stack([b[:, 0], mids], axis=1),
                               np.stack([mids, b[:, 1]], axis=1)], axis=0)
    return Mesh(geom=mesh.geom, vertices=vertices, elements=elements,
                attributes=np.tile(mesh.attributes, 4), boundary=boundary,
                bdr_attributes=np.tile(mesh.bdr_attributes, 2))


def _child_corner_coords(geom: Geometry) -> np.ndarray:
    """Parent-reference corner coordinates of each refinement child,
    (nchild, nv_el, dim), in the child order of the straight refiners."""
    if geom == Geometry.TRIANGLE:
        return np.array([
            [[0, 0], [0.5, 0], [0, 0.5]],
            [[0.5, 0], [1, 0], [0.5, 0.5]],
            [[0, 0.5], [0.5, 0.5], [0, 1]],
            [[0.5, 0], [0.5, 0.5], [0, 0.5]],
        ])
    corners = REF_VERTS[geom].astype(np.float64)
    return np.stack([(off + corners) / 2.0 for off in corners])


def _refine_curved(mesh: Mesh) -> Mesh:
    """Uniform refinement of a curved mesh: the straight refinement's
    topology, each child's geometry E-vector the parent's order-q map at the
    child's lattice (exact: the composition is still degree q), and the
    fine vertices moved onto the curved geometry."""
    from ..fem.basis import h1_nodes, simplex_basis_matrices
    from ..fem.faces import _eval_volume_basis
    from ..fem.fespace import _batched_eval, _node_index_lookup, _q1_eval_matrix

    geom, q = mesh.geom, mesh.nodes_order
    if geom not in (Geometry.SEGMENT, Geometry.SQUARE, Geometry.CUBE,
                    Geometry.TRIANGLE):
        raise NotImplementedError(f"curved refinement for {geom}")
    fine = _uniform_refine(Mesh(
        geom=geom, vertices=mesh.vertices, elements=mesh.elements,
        attributes=mesh.attributes, boundary=mesh.boundary,
        bdr_attributes=mesh.bdr_attributes))

    ref_q = h1_nodes(geom, q).astype(np.float64)
    if geom == Geometry.TRIANGLE:
        E, _ = simplex_basis_matrices(geom, 1, ref_q)
    else:
        E = _q1_eval_matrix(geom, ref_q)
    nodes = np.concatenate([
        _batched_eval(_eval_volume_basis(geom, q, E @ C), mesh.nodes)
        for C in _child_corner_coords(geom)], axis=0)

    lookup = _node_index_lookup(geom, q)
    latt_v = np.rint(REF_VERTS[geom] * q).astype(np.int64)
    vertices = fine.vertices.copy()
    for lv in range(NUM_VERTS[geom]):
        vertices[fine.elements[:, lv]] = nodes[:, lookup[tuple(latt_v[lv])]]
    return Mesh(geom=geom, vertices=vertices, elements=fine.elements,
                attributes=fine.attributes, boundary=fine.boundary,
                bdr_attributes=fine.bdr_attributes, nodes=nodes, nodes_order=q)
