"""Nonconforming (hanging-node) quad/hex AMR with 2:1 balance (numpy copy
of ``cardiac_ablation_ecm2_tpu/mesh/ncmesh.py``; MFEM's ``NCMesh``,
``mesh/ncmesh.hpp:189``).

Array-encoded 2:1 refinement: isotropic or typed (X/Y/Z bitmask) quad and
hex refinement with hanging vertices.  Constraints are recovered
*geometrically*: a hanging vertex sits bit-exactly at the midpoint of a
neighbour's unrefined edge or the centre of an unrefined face, because
both sides compute it identically (edge midpoints as (va+vb)/2, face and
cell centres as sums in sorted global-id order).  2:1 balance is enforced
by propagating typed forced refinements.

Every output is bitwise the JAX package's on the same input: vertex
numbering, element, boundary and attribute arrays, ``parent_of``, and the
constraint rows in the same order.  The quad path is the JAX package's
code.  The hex path, which sets the host time on meshes of 10⁵–10⁶ hexes,
replaces the per-vertex dict lookups and per-element loops by whole-array
ones: positions are looked up by the bit patterns of their coordinates
(``_PointIndex``), face tables by hashed rows (``utils/native.encode_rows``,
ids in first-seen order, as the JAX package's dict insertion order), and
new vertices are numbered in the order of their first creation, as the
JAX package's ``point_id``.  The edge set keeps the JAX package's Python
``set``, filled in the same order, because its iteration order fixes the
order of the edge-constraint rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..fem.geometry import EDGES, FACES, REF_VERTS, Geometry
from ..utils.native import encode_rows
from .mesh import Mesh


@dataclasses.dataclass(eq=False)
class NCQuadMesh:
    """A quad mesh plus its hanging-vertex constraints.

    ``constraints``: (ns, 3) int array of rows (hanging_vertex, master_a,
    master_b) — the hanging vertex is the midpoint of master edge (a, b).
    """

    mesh: Mesh
    constraints: np.ndarray

    @property
    def n_hanging(self) -> int:
        return len(self.constraints)


def _edge_set(elements) -> set:
    s = set()
    for t in elements:
        for i in range(4):
            a, b = int(t[i]), int(t[(i + 1) % 4])
            s.add((a, b) if a < b else (b, a))
    return s


def _find_constraints(mesh: Mesh) -> np.ndarray:
    """Geometric hanging-vertex detection: vertex v is hanging on edge (a,b)
    iff (a,b) is an element edge of some element, (a,v) and (v,b) are element
    edges of others, and pos(v) == (pos(a)+pos(b))/2 bit-exactly."""
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


def refine_quads(nc: NCQuadMesh, marks: np.ndarray,
                 balance: bool = True) -> Tuple["NCQuadMesh", np.ndarray]:
    """Refine marked quads 4-ways; re-derive constraints; enforce 2:1
    balance by propagation.  Returns (new NCQuadMesh, parent_of)."""
    marks = np.asarray(marks, dtype=bool)
    return refine_quads_aniso(nc, np.where(marks, ISO, 0), balance=balance)


# refinement types (NCMesh ref_type bitmask, mesh/ncmesh.hpp:33:
# X = split normal to the local x axis, Y = normal to y, ISO = both)
X, Y, ISO = 1, 2, 3


def refine_quads_aniso(nc: NCQuadMesh, types: np.ndarray,
                       balance: bool = True
                       ) -> Tuple["NCQuadMesh", np.ndarray]:
    """Anisotropically refine quads (``NCMesh::Refine`` with ref_type):
    ``types[e]`` ∈ {0, X, Y, ISO}.

    X splits the element across its local first axis (2 children sharing
    the midpoints of local edges 0/2), Y across the second (edges 1/3),
    ISO 4-ways.  2:1 balance propagates *typed* forced refinements: the
    owner of an over-constrained master edge is split in exactly the
    direction that subdivides that edge."""
    mesh = nc.mesh
    if mesh.geom != Geometry.SQUARE:
        raise ValueError("refine_quads_aniso needs a quad mesh")
    types = np.asarray(types, dtype=np.int64).copy()

    for _ in range(64):
        new = _refine_once(mesh, types)
        cons = _find_constraints(new.mesh_out)
        if not balance:
            break
        # 2:1 violation, detected geometrically: an element edge (a,b)
        # whose midpoint vertex exists and a quarter-point vertex exists
        bad_edges = _overrefined_edges(new.mesh_out)
        if not bad_edges:
            break
        extra = np.zeros(mesh.ne, dtype=np.int64)
        for e in range(mesh.ne):
            t = mesh.elements[e]
            for i in range(4):
                a, b = int(t[i]), int(t[(i + 1) % 4])
                key = (min(a, b), max(a, b))
                if key in bad_edges:
                    extra[e] |= X if i in (0, 2) else Y
        grown = (types | extra) != types
        if not grown.any():
            break
        types |= extra
    return NCQuadMesh(mesh=new.mesh_out, constraints=cons), new.parent_of


def _overrefined_edges(mesh: Mesh) -> set:
    """Element edges with a level-≥2 jump: midpoint and at least one
    quarter-point vertex exist (keys in this mesh's vertex ids, which
    equal the pre-refinement ids of surviving vertices)."""
    pos = {tuple(p): i for i, p in enumerate(mesh.vertices)}
    bad = set()
    for t in mesh.elements:
        for i in range(4):
            a, b = int(t[i]), int(t[(i + 1) % 4])
            pa, pb = mesh.vertices[a], mesh.vertices[b]
            pm = 0.5 * (pa + pb)
            vm = pos.get(tuple(pm))
            if vm is None:
                continue
            if (tuple(0.5 * (pa + pm)) in pos
                    or tuple(0.5 * (pm + pb)) in pos):
                bad.add((min(a, b), max(a, b)))
    return bad


@dataclasses.dataclass
class _RefineResult:
    mesh_out: Mesh
    parent_of: np.ndarray


def _refine_once(mesh: Mesh, types: np.ndarray) -> _RefineResult:
    """Split each quad per its type (0 none / X / Y / ISO)."""
    verts: List[np.ndarray] = [v for v in mesh.vertices]
    vpos: Dict[Tuple[float, float], int] = {
        tuple(p): i for i, p in enumerate(mesh.vertices)
    }

    def point_id(p):
        key = tuple(p)
        if key not in vpos:
            vpos[key] = len(verts)
            verts.append(p)
        return vpos[key]

    elems, attrs, parent = [], [], []
    for e in range(mesh.ne):
        t = mesh.elements[e]
        ty = int(types[e])
        if ty == 0:
            elems.append(list(t))
            attrs.append(mesh.attributes[e])
            parent.append(e)
            continue
        p = mesh.vertices[t]
        if ty == 1:                       # X: split local edges 0 and 2
            m01 = point_id(0.5 * (p[0] + p[1]))
            m23 = point_id(0.5 * (p[2] + p[3]))
            children = [
                [t[0], m01, m23, t[3]],
                [m01, t[1], t[2], m23],
            ]
        elif ty == 2:                     # Y: split local edges 1 and 3
            m12 = point_id(0.5 * (p[1] + p[2]))
            m30 = point_id(0.5 * (p[3] + p[0]))
            children = [
                [t[0], t[1], m12, m30],
                [m30, m12, t[2], t[3]],
            ]
        else:                             # ISO
            m01 = point_id(0.5 * (p[0] + p[1]))
            m12 = point_id(0.5 * (p[1] + p[2]))
            m23 = point_id(0.5 * (p[2] + p[3]))
            m30 = point_id(0.5 * (p[3] + p[0]))
            c = point_id(0.25 * (p[0] + p[1] + p[2] + p[3]))
            children = [
                [t[0], m01, c, m30],
                [m01, t[1], m12, c],
                [c, m12, t[2], m23],
                [m30, c, m23, t[3]],
            ]
        for ch in children:
            elems.append([int(x) for x in ch])
            attrs.append(mesh.attributes[e])
            parent.append(e)

    # boundary: split segments whose midpoint vertex now exists
    bdr, battr = [], []
    for seg, a in zip(mesh.boundary, mesh.bdr_attributes):
        mid = 0.5 * (mesh.vertices[seg[0]] + mesh.vertices[seg[1]])
        v = vpos.get(tuple(mid))
        if v is not None:
            bdr += [(int(seg[0]), v), (v, int(seg[1]))]
            battr += [a, a]
        else:
            bdr.append((int(seg[0]), int(seg[1])))
            battr.append(a)

    out = Mesh(
        geom=Geometry.SQUARE,
        vertices=np.array(verts),
        elements=np.array(elems, dtype=np.int64),
        attributes=np.array(attrs, dtype=np.int64),
        boundary=np.array(bdr, dtype=np.int64),
        bdr_attributes=np.array(battr, dtype=np.int64),
    )
    return _RefineResult(mesh_out=out, parent_of=np.array(parent))


# ---------------------------------------------------------------------------
# whole-array position lookups
# ---------------------------------------------------------------------------

_H = np.array([0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9],
              dtype=np.uint64)


def _bits(P: np.ndarray) -> np.ndarray:
    """(n, s) float64 → (n, s) int64 bit patterns with −0.0 read as +0.0
    (``tuple(p)`` keys compare equal for the two zeros)."""
    return np.ascontiguousarray(np.asarray(P, dtype=np.float64) + 0.0).view(np.int64)


def _hash(K: np.ndarray) -> np.ndarray:
    h = np.zeros(len(K), dtype=np.uint64)
    with np.errstate(over="ignore"):
        for d in range(K.shape[1]):
            h ^= K[:, d].view(np.uint64) * _H[d % len(_H)]
            h = (h << np.uint64(29)) | (h >> np.uint64(35))
    return h


class _PointIndex:
    """Exact lookup of points among ``P``'s rows, the JAX package's
    ``{tuple(p): i}`` dicts over whole arrays.  ``first`` picks the
    smallest row index among equal rows (``dict.setdefault``), else the
    largest (a dict comprehension)."""

    def __init__(self, P: np.ndarray, first: bool = True):
        self.K = _bits(P)
        h = _hash(self.K)
        self.order = np.argsort(h, kind="stable")
        self.hs = h[self.order]
        self.first = first
        # equal hashes must be equal rows: then a hash hit decides the row
        same = self.hs[1:] == self.hs[:-1]
        if same.any():
            i = self.order[1:][same]
            j = self.order[:-1][same]
            if not (self.K[i] == self.K[j]).all():
                raise RuntimeError("position hash collision")

    def lookup(self, Q: np.ndarray) -> np.ndarray:
        """Row index of each point of ``Q`` (n, s), −1 where absent."""
        Q = np.asarray(Q, dtype=np.float64).reshape(-1, self.K.shape[1])
        if len(self.hs) == 0 or len(Q) == 0:
            return np.full(len(Q), -1, dtype=np.int64)
        kq = _bits(Q)
        hq = _hash(kq)
        side = "left" if self.first else "right"
        pos = np.searchsorted(self.hs, hq, side=side)
        if not self.first:
            pos = pos - 1
        pos = np.clip(pos, 0, len(self.hs) - 1)
        row = self.order[pos]
        ok = (self.hs[pos] == hq) & (self.K[row] == kq).all(axis=1)
        return np.where(ok, row, -1).astype(np.int64)


def _sorted_avg_rows(V: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Row-wise ``_sorted_avg``: (m, k) vertex ids → (m, sdim), each
    summed in ascending id order and divided by k."""
    ids = np.sort(ids, axis=1)
    s = V[ids[:, 0]].copy()
    for j in range(1, ids.shape[1]):
        s = s + V[ids[:, j]]
    return s / ids.shape[1]


def _first_index(ids: np.ndarray, n: int) -> np.ndarray:
    """The first position of each id 0..n−1 in ``ids``."""
    order = np.argsort(ids, kind="stable")
    return order[np.searchsorted(ids[order], np.arange(n))]


def _edge_codes(lo: np.ndarray, hi: np.ndarray, nv: int) -> np.ndarray:
    return np.asarray(lo, np.int64) * np.int64(nv) + np.asarray(hi, np.int64)


def _member(codes: np.ndarray, table_sorted: np.ndarray) -> np.ndarray:
    if len(table_sorted) == 0:
        return np.zeros(codes.shape, dtype=bool)
    pos = np.clip(np.searchsorted(table_sorted, codes), 0, len(table_sorted) - 1)
    return table_sorted[pos] == codes


# ---------------------------------------------------------------------------
# 3D: nonconforming hex AMR
# ---------------------------------------------------------------------------

_HEX_EDGES = np.array(EDGES[Geometry.CUBE], dtype=np.int64)
_HEX_FACES = np.array(FACES[Geometry.CUBE], dtype=np.int64)
_LATT = np.rint(REF_VERTS[Geometry.CUBE] * 2).astype(np.int64)


@dataclasses.dataclass(eq=False)
class NCHexMesh:
    """A hex mesh plus hanging-vertex constraints.

    ``constraints``: (ns, 3) rows (hanging_vertex, edge_a, edge_b) — edge
    hangers (shared with the 2D case).
    ``face_constraints``: (nf, 5) rows (center_vertex, A, B, C, D) — the
    center hangs on master face with *cyclic* corners (A, B, C, D) as seen
    from the unrefined element; the 4 edge midpoints and 4 child faces are
    implied (recoverable geometrically).
    ``half_face_constraints``: (nh, 6) rows (mE, mF, c1, c2, c3, c4) — an
    anisotropic neighbour split the master face (cyclic c1..c4, as seen
    from the unrefined owner) in two; mE = midpoint of edge (c1,c2), mF = of
    (c3,c4); the medial edge mE–mF hangs on the master face.
    """

    mesh: Mesh
    constraints: np.ndarray
    face_constraints: np.ndarray
    half_face_constraints: np.ndarray = None

    def __post_init__(self):
        if self.half_face_constraints is None:
            self.half_face_constraints = np.zeros((0, 6), dtype=np.int64)

    @property
    def n_hanging(self) -> int:
        return (len(self.constraints) + len(self.face_constraints)
                + len(self.half_face_constraints))


def _sorted_avg(verts0: np.ndarray, ids) -> np.ndarray:
    """Average of vertex positions summed in sorted-global-id order —
    deterministic across the elements sharing the entity (bit-exact)."""
    ids = sorted(int(i) for i in ids)
    s = verts0[ids[0]].copy()
    for i in ids[1:]:
        s = s + verts0[i]
    return s / len(ids)


def _hex_edge_arrays(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """(lo, hi) of every element edge, element-major, the JAX package's
    loop order."""
    a = mesh.elements[:, _HEX_EDGES[:, 0]].reshape(-1)
    b = mesh.elements[:, _HEX_EDGES[:, 1]].reshape(-1)
    return np.minimum(a, b), np.maximum(a, b)


def _hex_edge_set(mesh: Mesh) -> set:
    lo, hi = _hex_edge_arrays(mesh)
    return set(zip(lo.tolist(), hi.tolist()))


def _edge_constraints_from(edges: set, mesh: Mesh, index: _PointIndex) -> np.ndarray:
    """Rows (v, a, b) in the iteration order of ``edges``; ``index`` looks
    up the mesh's vertex positions (first of equal rows)."""
    V = mesh.vertices
    nv = len(V)
    ab = np.array(list(edges), dtype=np.int64).reshape(-1, 2)
    if not len(ab):
        return np.zeros((0, 3), dtype=np.int64)
    a, b = ab[:, 0], ab[:, 1]
    v = index.lookup(0.5 * (V[a] + V[b]))
    table = np.sort(_edge_codes(ab[:, 0], ab[:, 1], nv))
    ok = (v >= 0) & (v != a) & (v != b)
    vv = np.where(ok, v, 0)
    e1 = _member(_edge_codes(np.minimum(a, vv), np.maximum(a, vv), nv), table)
    e2 = _member(_edge_codes(np.minimum(vv, b), np.maximum(vv, b), nv), table)
    keep = ok & e1 & e2
    return np.stack([v[keep], a[keep], b[keep]], axis=1).astype(np.int64)


def _face_tables(mesh: Mesh):
    """Every element face (element-major): cyclic corners (nf, 4), sorted
    keys, key ids in first-seen order (the JAX package's ``_face_map``
    insertion order) and the count of each id."""
    cyc = mesh.elements[:, _HEX_FACES].reshape(-1, 4)
    keys = np.sort(cyc, axis=1)
    nkey, ids, _ = encode_rows(keys)
    counts = np.bincount(ids, minlength=nkey)
    return cyc, keys, ids, counts


def _find_constraints_3d(mesh: Mesh):
    """Geometric hanging-entity detection for hexes.

    Edge hangers: as in 2D.  Full-face hangers: face F (cyclic A,B,C,D) of
    exactly one element whose center exists as a vertex, whose 4 edge
    midpoints exist, and whose 4 child faces all exist as element faces.
    Half-face hangers (anisotropic neighbour): exactly one opposite
    edge-midpoint pair exists and both half children exist — the medial
    edge hangs on the master face.  Returns (edge_cons, face_cons,
    half_face_cons, bad_faces) where bad_faces lists
    (sorted_key, owner_elem, (need_u, need_v), (A, B, C, D)) for faces
    whose neighbour refined deeper/crosswise than a single 2:1 pattern —
    consumed by the typed balance propagation.
    """
    V = mesh.vertices
    index = _PointIndex(V, first=True)
    edge_cons = _edge_constraints_from(_hex_edge_set(mesh), mesh, index)

    cyc, keys, ids, counts = _face_tables(mesh)
    nkey = len(counts)
    # the single owner of a key that appears once is its first-seen row
    first_row = _first_index(ids, nkey)
    # boundary faces are never NC masters (no neighbour): skip them
    is_bdr = np.zeros(nkey, dtype=bool)
    if mesh.nbe:
        _, _, bq = encode_rows(keys, np.sort(mesh.boundary, axis=1))
        is_bdr[bq[bq >= 0]] = True
    cand = np.nonzero((counts == 1) & ~is_bdr)[0]         # dict order
    rows = first_row[cand]
    eid = rows // 6
    A, B, C, D = (cyc[rows, i] for i in range(4))

    c = index.lookup(_sorted_avg_rows(V, keys[rows]))
    mids = [index.lookup(0.5 * (V[x] + V[y]))
            for (x, y) in ((A, B), (B, C), (C, D), (D, A))]
    mAB, mBC, mCD, mDA = mids
    has = [m >= 0 for m in mids]

    # every child face the three patterns need, looked up in one pass
    children = ((A, mAB, c, mDA), (mAB, B, mBC, c), (c, mBC, C, mCD),
                (mDA, c, mCD, D),                       # full: 0-3
                (A, mAB, mCD, D), (mAB, B, C, mCD),     # u half: 4-5
                (A, B, mBC, mDA), (mDA, mBC, C, D))     # v half: 6-7
    q = np.sort(np.concatenate([np.stack(ch, axis=1) for ch in children]), axis=1)
    _, _, qid = encode_rows(keys, q)
    exists = (qid >= 0).reshape(len(children), len(rows))

    has_c = c >= 0
    all_mids = has[0] & has[1] & has[2] & has[3]
    full_ok = has_c & all_mids & exists[:4].all(axis=0)
    has_u = has[0] & has[2]
    has_v = has[1] & has[3]
    u_only = ~has_c & has_u & ~has_v
    v_only = ~has_c & has_v & ~has_u
    u_ok = u_only & exists[4:6].all(axis=0)
    v_ok = v_only & exists[6:8].all(axis=0)
    partial = ~has_c & ~u_only & ~v_only & (has[0] | has[1] | has[2] | has[3])

    face_cons = np.stack([c, A, B, C, D], axis=1)[full_ok]
    half = np.where(u_ok[:, None],
                    np.stack([mAB, mCD, A, B, C, D], axis=1),
                    np.stack([mBC, mDA, B, C, D, A], axis=1))[u_ok | v_ok]

    need_u = np.where(has_c, True, np.where(u_only, True, np.where(
        v_only, False, has[0] | has[2])))
    need_v = np.where(has_c, True, np.where(u_only, False, np.where(
        v_only, True, has[1] | has[3])))
    is_bad = ((has_c & ~full_ok) | (u_only & ~u_ok) | (v_only & ~v_ok)
              | partial)
    bad = [(tuple(keys[r].tolist()), int(e), (bool(nu), bool(nv)),
            (int(a), int(b), int(cc), int(d)))
           for r, e, nu, nv, a, b, cc, d in zip(
               rows[is_bad], eid[is_bad], need_u[is_bad], need_v[is_bad],
               A[is_bad], B[is_bad], C[is_bad], D[is_bad])]
    return (
        edge_cons,
        face_cons.astype(np.int64).reshape(-1, 5),
        half.astype(np.int64).reshape(-1, 6),
        bad,
    )


# 3D refinement type bitmask (NCMesh ref_type, mesh/ncmesh.hpp:662:
# bit k = split by a plane normal to the local k axis)
X3, Y3, Z3, ISO3 = 1, 2, 4, 7

_CORNER_OF = {tuple(_LATT[lv]): lv for lv in range(8)}


def _split_template(ty: int):
    """The JAX package's ``_refine_once_3d`` loops for split type ``ty``:
    the non-corner lattice points in the order of their first creation,
    each with its parent corners (local ids), and the children as (nch, 8)
    rows of lattice slots: slot < 8 is parent corner slot, slot ≥ 8 is
    new point slot − 8."""
    split = [bool(ty & (1 << d)) for d in range(3)]
    spans = [((0, 1), (1, 2)) if split[d] else ((0, 2),) for d in range(3)]
    slot_of: Dict[tuple, int] = {}
    points: List[List[int]] = []

    def lat(lx, ly, lz):
        key = (lx, ly, lz)
        if key not in slot_of:
            corners = []
            for cx in ((0, 2) if lx == 1 else (lx,)):
                for cy in ((0, 2) if ly == 1 else (ly,)):
                    for cz in ((0, 2) if lz == 1 else (lz,)):
                        corners.append(_CORNER_OF[(cx, cy, cz)])
            if len(corners) == 1:
                slot_of[key] = corners[0]
            else:
                slot_of[key] = 8 + len(points)
                points.append(corners)
        return slot_of[key]

    children = []
    for (z0, z1) in spans[2]:
        for (y0, y1) in spans[1]:
            for (x0, x1) in spans[0]:
                children.append([
                    lat(x0, y0, z0), lat(x1, y0, z0),
                    lat(x1, y1, z0), lat(x0, y1, z0),
                    lat(x0, y0, z1), lat(x1, y0, z1),
                    lat(x1, y1, z1), lat(x0, y1, z1),
                ])
    return points, np.array(children, dtype=np.int64)


_TEMPLATES = {ty: _split_template(ty) for ty in range(1, 8)}


def _refine_once_3d(mesh: Mesh, types: np.ndarray) -> _RefineResult:
    """Split each hex per its type bitmask (0 none … ISO3 8-way).

    Every new vertex is a 2/4/8-corner average (summed in sorted global-id
    order), placed on the {0,1,2}³ lattice of the parent: a lattice point
    with k coordinates equal to 1 averages the 2^k corners obtained by
    rounding those coordinates both ways.  New vertices are numbered in
    the order the JAX package's element loop first creates them."""
    V0 = mesh.vertices
    nv0 = len(V0)
    E = mesh.elements
    types = np.asarray(types, dtype=np.int64)

    # candidate new points of every refined element, in creation order
    npts = np.zeros(mesh.ne, dtype=np.int64)
    for ty, (points, _) in _TEMPLATES.items():
        npts[types == ty] = len(points)
    start = np.concatenate([[0], np.cumsum(npts)])
    ncand = int(start[-1])
    cand_xyz = np.zeros((ncand, V0.shape[1]))
    for ty, (points, _) in _TEMPLATES.items():
        els = np.nonzero(types == ty)[0]
        if not len(els):
            continue
        for k, corners in enumerate(points):
            slots = start[els] + k
            cand_xyz[slots] = _sorted_avg_rows(V0, E[els][:, corners])

    # existing vertices (a dict comprehension keeps the last of equal
    # positions), then new ones numbered by first occurrence
    cand_id = _PointIndex(V0, first=False).lookup(cand_xyz)
    new = cand_id < 0
    if new.any():
        nnew, uid, _ = encode_rows(_bits(cand_xyz[new]))
        cand_id[new] = nv0 + uid
        first = np.nonzero(new)[0][_first_index(uid, nnew)]
        verts = np.concatenate([V0, cand_xyz[first]])
    else:
        verts = np.array(V0)

    # elements: unrefined rows, else the template's children
    nch = np.ones(mesh.ne, dtype=np.int64)
    for ty, (_, children) in _TEMPLATES.items():
        nch[types == ty] = len(children)
    cstart = np.concatenate([[0], np.cumsum(nch)])
    elems = np.zeros((int(cstart[-1]), 8), dtype=np.int64)
    keep = types == 0
    elems[cstart[:-1][keep]] = E[keep]
    for ty, (points, children) in _TEMPLATES.items():
        els = np.nonzero(types == ty)[0]
        if not len(els):
            continue
        lut = np.concatenate([E[els], cand_id[start[els][:, None]
                                              + np.arange(len(points))]], axis=1)
        kids = lut[:, children]                      # (n, nch, 8)
        pos = cstart[els][:, None] + np.arange(len(children))
        elems[pos.reshape(-1)] = kids.reshape(-1, 8)
    parent = np.repeat(np.arange(mesh.ne), nch)
    attrs = np.repeat(np.asarray(mesh.attributes, dtype=np.int64), nch)

    # boundary quads: split full (center exists), half (one opposite-mid
    # pair exists), or keep
    index = _PointIndex(verts, first=False)
    Q = np.asarray(mesh.boundary, dtype=np.int64).reshape(-1, 4)
    A, B, C, D = Q[:, 0], Q[:, 1], Q[:, 2], Q[:, 3]
    c = index.lookup(_sorted_avg_rows(V0, Q))
    mAB = index.lookup(0.5 * (V0[A] + V0[B]))
    mBC = index.lookup(0.5 * (V0[B] + V0[C]))
    mCD = index.lookup(0.5 * (V0[C] + V0[D]))
    mDA = index.lookup(0.5 * (V0[D] + V0[A]))
    full = c >= 0
    hu = ~full & (mAB >= 0) & (mCD >= 0)
    hv = ~full & ~hu & (mBC >= 0) & (mDA >= 0)
    nb = np.where(full, 4, np.where(hu | hv, 2, 1))
    bstart = np.concatenate([[0], np.cumsum(nb)])
    bdr = np.zeros((int(bstart[-1]), 4), dtype=np.int64)
    s = bstart[:-1]
    for sel, quads in (
        (full, ((A, mAB, c, mDA), (mAB, B, mBC, c),
                (c, mBC, C, mCD), (mDA, c, mCD, D))),
        (hu, ((A, mAB, mCD, D), (mAB, B, C, mCD))),
        (hv, ((A, B, mBC, mDA), (mDA, mBC, C, D))),
        (nb == 1, ((A, B, C, D),)),
    ):
        for k, q in enumerate(quads):
            bdr[s[sel] + k] = np.stack([x[sel] for x in q], axis=1)
    battr = np.repeat(np.asarray(mesh.bdr_attributes, dtype=np.int64), nb)

    out = Mesh(
        geom=Geometry.CUBE,
        vertices=verts,
        elements=elems,
        attributes=attrs,
        boundary=bdr,
        bdr_attributes=battr,
    )
    return _RefineResult(mesh_out=out, parent_of=parent)


def refine_hexes(nc: NCHexMesh, marks: np.ndarray,
                 balance: bool = True) -> Tuple["NCHexMesh", np.ndarray]:
    """Refine marked hexes 8-ways; re-derive constraints; enforce 2:1 balance
    (both face- and edge-level) by marking propagation."""
    marks = np.asarray(marks, dtype=bool)
    return refine_hexes_aniso(nc, np.where(marks, ISO3, 0), balance=balance)


def _face_axis_bits(mesh: Mesh, eid: int, cyc, need_u: bool,
                    need_v: bool) -> int:
    """Element split bits that subdivide face ``cyc`` = (A,B,C,D) of element
    ``eid`` along its u (A→B) / v (A→D) directions.  Topological when the
    corners are element corners; geometric (max-|cos| axis match against
    the element's corner frame) for child faces of partially-refined
    parents."""
    t = mesh.elements[eid]
    lookup = {int(t[lv]): lv for lv in range(8)}
    A, B, _C, D = (int(x) for x in cyc)
    bits = 0

    def axis_of(p, q):
        if p in lookup and q in lookup:
            d = _LATT[lookup[q]] - _LATT[lookup[p]]
            ax = int(np.nonzero(d)[0][0])
        else:
            v = mesh.vertices[q] - mesh.vertices[p]
            frame = np.stack([
                mesh.vertices[t[1]] - mesh.vertices[t[0]],
                mesh.vertices[t[3]] - mesh.vertices[t[0]],
                mesh.vertices[t[4]] - mesh.vertices[t[0]],
            ])
            cos = np.abs(frame @ v) / (
                np.linalg.norm(frame, axis=1) * np.linalg.norm(v) + 1e-300)
            ax = int(np.argmax(cos))
        return 1 << ax

    if need_u:
        bits |= axis_of(A, B)
    if need_v:
        bits |= axis_of(A, D)
    return bits


def _bad_master_edge_codes(ec: np.ndarray, nv: int) -> np.ndarray:
    """Sorted codes of master edges (a, b) one of whose halves (a, v) or
    (v, b) is itself a constrained master edge (>2:1 along an edge)."""
    if not len(ec):
        return np.zeros(0, dtype=np.int64)
    v, a, b = ec[:, 0], ec[:, 1], ec[:, 2]
    masters = np.sort(np.concatenate([_edge_codes(a, b, nv), _edge_codes(b, a, nv)]))
    sub1 = _edge_codes(np.minimum(a, v), np.maximum(a, v), nv)
    sub2 = _edge_codes(np.minimum(v, b), np.maximum(v, b), nv)
    bad = _member(sub1, masters) | _member(sub2, masters)
    return np.unique(_edge_codes(np.minimum(a, b), np.maximum(a, b), nv)[bad])


def refine_hexes_aniso(nc: NCHexMesh, types: np.ndarray,
                       balance: bool = True
                       ) -> Tuple["NCHexMesh", np.ndarray]:
    """Anisotropically refine hexes (``NCMesh::Refine`` ref_type bitmask):
    ``types[e]`` ∈ {0..7}, bit k = split by a plane normal to local axis k
    (X3=1, Y3=2, Z3=4, ISO3=7).

    2:1 balance propagates typed forced refinements: the owner of an
    over-hung or cross-split face is split in exactly the directions that
    subdivide it; over-hung master edges force a split along the edge's
    axis."""
    mesh = nc.mesh
    if mesh.geom != Geometry.CUBE:
        raise ValueError("refine_hexes_aniso needs a hex mesh")
    types = np.asarray(types, dtype=np.int64).copy()
    edge_bit = np.array([1 << int(np.nonzero(_LATT[lb] - _LATT[la])[0][0])
                         for (la, lb) in _HEX_EDGES], dtype=np.int64)

    for _ in range(64):
        new = _refine_once_3d(mesh, types)
        ec, fc, hc, bad = _find_constraints_3d(new.mesh_out)
        if not balance:
            break
        extra = np.zeros(mesh.ne, dtype=np.int64)
        # face-level: typed bits on the coarse parent of the bad owner
        for (_key, eid, (nu, nv), cyc) in bad:
            par = int(new.parent_of[eid])
            extra[par] |= _face_axis_bits(new.mesh_out, eid, cyc, nu, nv)
        # edge-level >2:1: master edge with a constrained sub-edge forces a
        # split along that edge's axis (edge ids of the fine mesh: surviving
        # vertices keep their ids, and new ones are ≥ nv)
        bad_codes = _bad_master_edge_codes(ec, len(new.mesh_out.vertices))
        if len(bad_codes):
            a = mesh.elements[:, _HEX_EDGES[:, 0]]
            b = mesh.elements[:, _HEX_EDGES[:, 1]]
            hit = _member(_edge_codes(np.minimum(a, b), np.maximum(a, b),
                                      len(new.mesh_out.vertices)), bad_codes)
            extra |= np.bitwise_or.reduce(np.where(hit, edge_bit[None, :], 0),
                                          axis=1)
        grown = (types | extra) != types
        if not grown.any():
            break
        types |= extra
    return (
        NCHexMesh(mesh=new.mesh_out, constraints=ec, face_constraints=fc,
                  half_face_constraints=hc),
        new.parent_of,
    )


def make_nc(mesh: Mesh):
    """NC wrapper for a conforming quad or hex mesh."""
    if mesh.geom == Geometry.CUBE:
        ec, fc, hc, _bad = _find_constraints_3d(mesh)
        return NCHexMesh(mesh=mesh, constraints=ec, face_constraints=fc,
                         half_face_constraints=hc)
    return NCQuadMesh(mesh=mesh, constraints=_find_constraints(mesh))
