"""Nonconforming (hanging-node) tet AMR: red 1:8 refinement + 2:1 balance.

Numpy copy of ``cardiac_ablation_ecm2_tpu/mesh/nctet.py``.

Reference analog: ``NCMesh`` on tetrahedra (``mesh/ncmesh.hpp``).  Same
array-encoded design as the quad/hex NC machinery (``mesh/ncmesh.py``):
refinement inserts bit-exact edge midpoints, hanging vertices are
recovered *geometrically* (a vertex v hangs on a neighbor's unrefined
edge (a,b) iff v sits at its midpoint and the half-edges are element
edges), and 2:1 balance forces refinement of any tet owning an edge with
both a midpoint and a quarter-point vertex.

Red split: 4 corner tets + 4 octahedron tets along the m02–m13 diagonal,
orientation fixed programmatically.  Order-1 NC spaces: the constraint
rows (v, a, b) are exactly the quad-NC format, so ``fem/ncfespace``'s
edge machinery applies unchanged.  Order 2 additionally interpolates the
medial-edge interior nodes from the master face's P₂ trace (the
``tri_face_constraints`` here + the tri-face branch in ``fem/ncfespace``
— the reference's triangular master/slave constraints,
mesh/ncmesh.cpp); order ≥ 3 (face-interior master dofs) is deferred."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..fem.geometry import EDGES, Geometry
from .mesh import Mesh

_TET_EDGES = EDGES[Geometry.TETRAHEDRON]


@dataclasses.dataclass(eq=False)
class NCTetMesh:
    """Tet mesh + hanging-node constraints.

    ``constraints`` (v, a, b): hanging vertex v = midpoint of the
    neighbor's unrefined edge (a, b) — drives edge-dof interpolation at
    any order (fem/ncfespace.py).
    ``tri_face_constraints`` (A, B, C): unrefined master tri faces whose
    neighbor side is refined 1:4 — at order ≥ 2 the interior nodes of the
    fine MEDIAL edges (mAB–mBC etc., interior to the face) must be
    interpolated from the master face's P_p trace (the reference's
    triangular master/slave face constraints, mesh/ncmesh.cpp)."""

    mesh: Mesh
    constraints: np.ndarray
    tri_face_constraints: np.ndarray = None

    def __post_init__(self):
        if self.tri_face_constraints is None:
            self.tri_face_constraints = np.zeros((0, 3), dtype=np.int64)

    @property
    def n_hanging(self) -> int:
        return len(self.constraints)


def _edge_set(elements) -> set:
    s = set()
    for t in elements:
        for (i, j) in _TET_EDGES:
            a, b = int(t[i]), int(t[j])
            s.add((a, b) if a < b else (b, a))
    return s


def _find_constraints(mesh: Mesh) -> np.ndarray:
    edges = _edge_set(mesh.elements)
    pos = {}
    for i, p in enumerate(mesh.vertices):
        pos.setdefault(tuple(p), i)
    rows = []
    for (a, b) in edges:
        mid = 0.5 * (mesh.vertices[a] + mesh.vertices[b])
        v = pos.get(tuple(mid))
        if v is None or v == a or v == b:
            continue
        e1 = (a, v) if a < v else (v, a)
        e2 = (v, b) if v < b else (b, v)
        if e1 in edges and e2 in edges:
            rows.append((v, a, b))
    return np.array(rows, dtype=np.int64).reshape(-1, 3)


def _find_tri_face_constraints(mesh: Mesh) -> np.ndarray:
    """Master tri faces (A, B, C): faces appearing once whose 3 edge
    midpoints exist and whose 4 child faces (3 corner + medial) also
    appear once — i.e. the neighbor side is red-refined (geometric
    recovery, same design as _find_constraints)."""
    from ..fem.geometry import FACES

    loc = np.array(FACES[Geometry.TETRAHEDRON], dtype=np.int64)
    fv = mesh.elements[:, loc].reshape(-1, 3)
    key = np.sort(fv, axis=1)
    uniq, cnt = np.unique(key, axis=0, return_counts=True)
    singles = set(map(tuple, uniq[cnt == 1]))
    pos = {}
    for i, p in enumerate(mesh.vertices):
        pos.setdefault(tuple(p), i)
    V = mesh.vertices
    rows = []
    for f in uniq[cnt == 1]:
        A, B, C = (int(x) for x in f)
        mAB = pos.get(tuple(0.5 * (V[A] + V[B])))
        mBC = pos.get(tuple(0.5 * (V[B] + V[C])))
        mCA = pos.get(tuple(0.5 * (V[C] + V[A])))
        if mAB is None or mBC is None or mCA is None:
            continue
        kids = [
            tuple(sorted((A, mAB, mCA))), tuple(sorted((mAB, B, mBC))),
            tuple(sorted((mCA, mBC, C))), tuple(sorted((mAB, mBC, mCA))),
        ]
        if all(k in singles for k in kids):
            rows.append((A, B, C))
    return np.array(rows, dtype=np.int64).reshape(-1, 3)


def _overrefined_edges(mesh: Mesh) -> set:
    pos = {tuple(p): i for i, p in enumerate(mesh.vertices)}
    bad = set()
    for t in mesh.elements:
        for (i, j) in _TET_EDGES:
            a, b = int(t[i]), int(t[j])
            pa, pb = mesh.vertices[a], mesh.vertices[b]
            pm = 0.5 * (pa + pb)
            if tuple(pm) not in pos:
                continue
            if (tuple(0.5 * (pa + pm)) in pos
                    or tuple(0.5 * (pm + pb)) in pos):
                bad.add((min(a, b), max(a, b)))
    return bad


def _refine_once(mesh: Mesh, marks: np.ndarray):
    verts: List[np.ndarray] = [v for v in mesh.vertices]
    vpos: Dict[Tuple, int] = {tuple(p): i for i, p in enumerate(verts)}

    def mid(a, b):
        p = 0.5 * (verts[a] + verts[b])
        key = tuple(p)
        if key not in vpos:
            vpos[key] = len(verts)
            verts.append(p)
        return vpos[key]

    def orient(tet):
        p = np.array([verts[v] for v in tet])
        if np.linalg.det(p[1:] - p[0]) < 0:
            tet = [tet[0], tet[2], tet[1], tet[3]]
        return tet

    elems, attrs, parent = [], [], []
    for e in range(mesh.ne):
        t = [int(v) for v in mesh.elements[e]]
        if not marks[e]:
            elems.append(t)
            attrs.append(mesh.attributes[e])
            parent.append(e)
            continue
        m = {}
        for (i, j) in _TET_EDGES:
            m[(i, j)] = m[(j, i)] = mid(t[i], t[j])
        children = [
            [t[0], m[(0, 1)], m[(0, 2)], m[(0, 3)]],
            [m[(0, 1)], t[1], m[(1, 2)], m[(1, 3)]],
            [m[(0, 2)], m[(1, 2)], t[2], m[(2, 3)]],
            [m[(0, 3)], m[(1, 3)], m[(2, 3)], t[3]],
            # octahedron split along the m02–m13 diagonal
            [m[(0, 1)], m[(0, 2)], m[(0, 3)], m[(1, 3)]],
            [m[(0, 1)], m[(0, 2)], m[(1, 3)], m[(1, 2)]],
            [m[(0, 2)], m[(2, 3)], m[(1, 3)], m[(1, 2)]],
            [m[(0, 2)], m[(2, 3)], m[(0, 3)], m[(1, 3)]],
        ]
        for ch in children:
            elems.append(orient(ch))
            attrs.append(mesh.attributes[e])
            parent.append(e)

    # boundary tris: split 1:4 where all edge midpoints exist, else pass
    bdr, battr = [], []
    for tri, a in zip(mesh.boundary, mesh.bdr_attributes):
        stack = [tuple(int(v) for v in tri)]
        while stack:
            f = stack.pop()
            ms = [vpos.get(tuple(0.5 * (verts[f[i]] + verts[f[(i + 1) % 3]])))
                  for i in range(3)]
            if all(mm is not None for mm in ms):
                stack += [(f[0], ms[0], ms[2]), (ms[0], f[1], ms[1]),
                          (ms[2], ms[1], f[2]), (ms[0], ms[1], ms[2])]
            else:
                bdr.append(list(f))
                battr.append(a)

    out = Mesh(
        geom=Geometry.TETRAHEDRON,
        vertices=np.array(verts),
        elements=np.array(elems, dtype=np.int64),
        attributes=np.array(attrs, dtype=np.int64),
        boundary=np.array(bdr, dtype=np.int64),
        bdr_attributes=np.array(battr, dtype=np.int64),
    )
    return out, np.array(parent, dtype=np.int64)


def refine_tets_nc(nc: NCTetMesh, marks: np.ndarray,
                   balance: bool = True) -> Tuple[NCTetMesh, np.ndarray]:
    """Red-refine marked tets; re-derive constraints; 2:1 balance by
    propagation (geometric over-refinement detection)."""
    mesh = nc.mesh
    marks = np.asarray(marks, dtype=bool).copy()
    for _ in range(64):
        new_mesh, parent = _refine_once(mesh, marks)
        cons = _find_constraints(new_mesh)
        if not balance:
            break
        bad = _overrefined_edges(new_mesh)
        if not bad:
            break
        extra = np.zeros(mesh.ne, dtype=bool)
        for e in range(mesh.ne):
            t = mesh.elements[e]
            for (i, j) in _TET_EDGES:
                key = (min(int(t[i]), int(t[j])),
                       max(int(t[i]), int(t[j])))
                if key in bad:
                    extra[e] = True
        if not (extra & ~marks).any():
            break
        marks |= extra
    return NCTetMesh(
        mesh=new_mesh, constraints=cons,
        tri_face_constraints=_find_tri_face_constraints(new_mesh),
    ), parent


def make_nc_tet(mesh: Mesh) -> NCTetMesh:
    assert mesh.geom == Geometry.TETRAHEDRON
    return NCTetMesh(
        mesh=mesh, constraints=_find_constraints(mesh),
        tri_face_constraints=_find_tri_face_constraints(mesh),
    )
