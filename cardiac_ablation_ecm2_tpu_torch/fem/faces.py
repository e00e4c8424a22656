"""Face data for DG methods (numpy copy of
``cardiac_ablation_ecm2_tpu/fem/faces.py``): interior and boundary face
quadrature, each side's volume basis at the face points, outward normals,
and with ``with_gradients`` the physical basis gradients and the element
sizes normal to each face.

The JAX package walks the faces in Python; here every step is over whole
arrays, with the same arithmetic per entry:

* the incidence of (element, local face) rows keyed by their sorted global
  vertices is one hash-uniquing pass (``utils/native.encode_rows``), whose
  first-seen ids are the JAX package's dict order (local face outer,
  element inner), so interior and boundary faces come in the same order;
* each face's canonical frame (origin at its smallest global vertex, first
  axis toward its smaller cyclic neighbour) is an argmin per row, and the
  reference points, physical points, normals and measures are broadcast
  expressions of the JAX package's per-face formulas;
* ``with_gradients``' Jacobians are the same central differences (step
  1e-6) of the linear geometry map, at every face point of every side at
  once, and the element volumes one central difference per element.

Faces are processed in chunks (:data:`CHUNK` faces), which bounds the
temporaries at full size, on :data:`THREADS` threads (every chunk does
the same arithmetic on its own rows, so the tables do not depend on
either).  All tables are float64 numpy arrays; the
operators move them to a device.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from .basis import h1_nodes_1d, lagrange_matrices, lattice_multi_index, simplex_basis_matrices
from .geometry import DIMENSION, FACE_GEOM, FACES, IS_TENSOR, REF_VERTS, Geometry
from .intrules import gauss_legendre_1d, simplex_rule, tensor_rule

#: faces per chunk of the table computations, and the threads that
#: compute chunks at once
CHUNK = 16384
THREADS = min(8, os.cpu_count() or 1)
#: central-difference step of the geometry Jacobians (the JAX package's)
FD_STEP = 1e-6


@dataclasses.dataclass(eq=False)
class FaceData:
    """Host-side numpy face tables."""

    # interior faces
    elem0: np.ndarray      # (nfi,)
    elem1: np.ndarray      # (nfi,)
    B0: np.ndarray         # (nfi, nq_f, nd) basis of elem0 at face qpts
    B1: np.ndarray         # (nfi, nq_f, nd)
    normal: np.ndarray     # (nfi, nq_f, dim) unit, outward from elem0
    wdet: np.ndarray       # (nfi, nq_f) surface measure × quad weight
    xq: np.ndarray         # (nfi, nq_f, dim) physical face quad points
    # boundary faces
    b_elem: np.ndarray     # (nfb,)
    b_B: np.ndarray        # (nfb, nq_f, nd)
    b_normal: np.ndarray   # (nfb, nq_f, dim) outward
    b_wdet: np.ndarray     # (nfb, nq_f)
    b_xq: np.ndarray       # (nfb, nq_f, dim)
    b_attr: np.ndarray     # (nfb,)
    # with_gradients: physical basis gradients at the face points and the
    # element sizes normal to each face (penalty scale)
    G0: np.ndarray = None  # (nfi, nq_f, nd, dim)
    G1: np.ndarray = None
    b_G: np.ndarray = None  # (nfb, nq_f, nd, dim)
    h0: np.ndarray = None   # (nfi,)
    h1: np.ndarray = None
    b_h: np.ndarray = None


def _face_quad(fgeom: Geometry, nq1d: int):
    if fgeom == Geometry.SEGMENT:
        x, w = gauss_legendre_1d(nq1d)
        return x[:, None].copy(), w.copy()
    if fgeom == Geometry.SQUARE:
        return tensor_rule(2, nq1d)
    if fgeom == Geometry.TRIANGLE:
        return simplex_rule(2, 2 * nq1d - 1)
    raise ValueError(fgeom)


def _eval_volume_basis(geom: Geometry, p: int, pts: np.ndarray) -> np.ndarray:
    """Volume nodal basis at arbitrary reference points → (npts, nd)."""
    if IS_TENSOR.get(geom, False):
        x1 = h1_nodes_1d(p)
        dim = DIMENSION[geom]
        per = [lagrange_matrices(x1, pts[:, d])[0] for d in range(dim)]
        B = per[0]
        if dim >= 2:
            B = np.einsum("qi,qj->qji", per[0], per[1]).reshape(len(pts), -1)
        if dim == 3:
            B = np.einsum("qi,qj,qk->qkji", per[0], per[1], per[2]).reshape(
                len(pts), -1)
        return B
    return simplex_basis_matrices(geom, p, pts)[0]


def _eval_volume_basis_grad(geom: Geometry, p: int, pts: np.ndarray) -> np.ndarray:
    """Reference gradients of the volume basis at points → (npts, nd, dim)."""
    dim = DIMENSION[geom]
    if IS_TENSOR.get(geom, False):
        x1 = h1_nodes_1d(p)
        vals = [lagrange_matrices(x1, pts[:, d]) for d in range(dim)]
        out = np.zeros((len(pts), (p + 1) ** dim, dim))
        for dd in range(dim):
            per = [vals[d][1] if d == dd else vals[d][0] for d in range(dim)]
            if dim == 1:
                out[:, :, dd] = per[0]
            elif dim == 2:
                out[:, :, dd] = np.einsum("qi,qj->qji", per[0], per[1]).reshape(
                    len(pts), -1)
            else:
                out[:, :, dd] = np.einsum(
                    "qi,qj,qk->qkji", per[0], per[1], per[2]).reshape(len(pts), -1)
        return out
    return simplex_basis_matrices(geom, p, pts)[1]


def _canonical_corners(elems: np.ndarray, faces: np.ndarray, e: np.ndarray,
                       lf: np.ndarray) -> np.ndarray:
    """Local vertex ids of each face's corners in its canonical cyclic
    order (nf, k): from the corner with the smallest global id, toward its
    smaller cyclic neighbour."""
    fv = faces[lf]                                     # (nf, k)
    k = fv.shape[1]
    gids = np.take_along_axis(elems[e], fv, axis=1)
    rows = np.arange(len(e))
    r = np.argmin(gids, axis=1)
    d = np.where(gids[rows, (r + 1) % k] < gids[rows, (r - 1) % k], 1, -1)
    cyc = (r[:, None] + d[:, None] * np.arange(k)[None, :]) % k
    return np.take_along_axis(fv, cyc, axis=1)


def _bilinear(C: np.ndarray, fq: np.ndarray) -> np.ndarray:
    """The face map of corners C (nf, k, s) at the canonical points fq
    (nq, 1|2): linear (segment, triangle) or bilinear (quad), the JAX
    package's expressions term by term → (nf, nq, s)."""
    k = C.shape[1]
    a = fq[:, 0:1]
    C0, C1 = C[:, None, 0], C[:, None, 1]
    if k == 2:
        return C0 * (1 - a) + C1 * a
    b = fq[:, 1:2]
    if k == 4:
        C2, C3 = C[:, None, 2], C[:, None, 3]
        return (C0 * (1 - a) * (1 - b) + C1 * a * (1 - b)
                + C2 * a * b + C3 * (1 - a) * b)
    return C0 * (1 - a - b) + C1 * a + C[:, None, 2] * b


def _face_phys(V: np.ndarray, fq: np.ndarray):
    """Physical points, unit normals and measures of faces with canonical
    corners V (nf, k, sdim)."""
    k = V.shape[1]
    a = fq[:, 0:1]
    x = _bilinear(V, fq)
    V0, V1 = V[:, None, 0], V[:, None, 1]
    if k == 2:
        t = np.broadcast_to(V1 - V0, x.shape)
        n = np.stack([t[..., 1], -t[..., 0]], axis=-1)
    elif k == 4:
        b = fq[:, 1:2]
        V2, V3 = V[:, None, 2], V[:, None, 3]
        ta = (V1 - V0) * (1 - b) + (V2 - V3) * b
        tb = (V3 - V0) * (1 - a) + (V2 - V1) * a
        n = np.cross(ta, tb)
    else:
        ta = np.broadcast_to(V1 - V0, x.shape)
        tb = np.broadcast_to(V[:, None, 2] - V0, x.shape)
        n = np.cross(ta, tb)
    mag = np.linalg.norm(n, axis=-1)
    return x, n / mag[..., None], mag


def _geom_shape(geom: Geometry, pts: np.ndarray) -> np.ndarray:
    """Linear geometry shape functions at points (..., dim) → (..., nv):
    affine for simplices, multilinear for tensor cells."""
    flat = pts.reshape(-1, pts.shape[-1])
    if geom in (Geometry.TRIANGLE, Geometry.TETRAHEDRON):
        S = simplex_basis_matrices(geom, 1, flat)[0]
    else:
        from .fespace import _q1_eval_matrix

        S = _q1_eval_matrix(geom, flat)
    return S.reshape(*pts.shape[:-1], -1)


def _fd_jacobian(geom: Geometry, V: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Jacobians J[..., s, d] of the linear map of corners V (n, nv, sdim)
    at reference points pts (n, m, dim) by central differences."""
    dim = pts.shape[-1]
    J = np.zeros(pts.shape[:-1] + (V.shape[-1], dim))
    for d in range(dim):
        xp = pts.copy()
        xp[..., d] += FD_STEP
        xm = pts.copy()
        xm[..., d] -= FD_STEP
        D = _geom_shape(geom, xp) - _geom_shape(geom, xm)      # (n, m, nv)
        J[..., d] = np.einsum("nmv,nvs->nms", D, V) / (2 * FD_STEP)
    return J


def _element_volumes(geom: Geometry, corner_coords: np.ndarray) -> np.ndarray:
    """|det J| at the reference centroid × the reference volume, per element
    (exact for parallelepipeds, the penalty scale otherwise)."""
    dim = DIMENSION[geom]
    tensor = geom in (Geometry.SQUARE, Geometry.CUBE)
    c = np.full((1, 1, dim), 0.5 if tensor else 1.0 / (dim + 1))
    refvol = 1.0 if tensor else (0.5 if geom == Geometry.TRIANGLE else 1.0 / 6.0)
    Jc = np.zeros((len(corner_coords), corner_coords.shape[-1], dim))
    for d in range(dim):
        xp = c.copy()
        xp[..., d] += FD_STEP
        xm = c.copy()
        xm[..., d] -= FD_STEP
        D = (_geom_shape(geom, xp) - _geom_shape(geom, xm))[0, 0]   # (nv,)
        Jc[:, :, d] = np.einsum("v,evs->es", D, corner_coords) / (2 * FD_STEP)
    return np.abs(np.linalg.det(Jc)) * refvol


def _corner_coords(mesh) -> np.ndarray:
    """Each element's own corner coordinates (ne, nv, sdim): the vertices,
    or for periodic meshes (identified vertices, order-1 nodes) the
    element's copy of each corner."""
    geom = mesh.geom
    if mesh.nodes is not None and mesh.nodes_order == 1:
        mi1 = lattice_multi_index(geom, 1)
        lex_of = {tuple(row): i for i, row in enumerate(mi1)}
        latt_i = np.rint(REF_VERTS[geom]).astype(np.int64)
        return np.stack([mesh.nodes[:, lex_of[tuple(v)]] for v in latt_i], axis=1)
    return mesh.vertices[mesh.elements]


def _incidence(mesh, faces: np.ndarray):
    """(element, local face) of each interior face's two sides and each
    boundary face's one side, and the boundary faces' attributes, in the
    JAX package's face order."""
    from ..utils.native import counting_argsort, encode_rows

    elems, ne = mesh.elements, mesh.ne
    nlf = len(faces)
    # rows in the JAX package's insertion order: local face outer, element inner
    keys = np.sort(elems[:, faces], axis=2).transpose(1, 0, 2).reshape(nlf * ne, -1)
    nkey, ids, _ = encode_rows(keys)
    counts = np.bincount(ids, minlength=nkey)
    if counts.max(initial=0) > 2:
        raise ValueError("nonmanifold face")
    order = counting_argsort(ids, nkey)
    start = np.zeros(nkey, dtype=np.int64)
    np.cumsum(counts[:-1], out=start[1:])
    first = order[start]
    inter = np.nonzero(counts == 2)[0]
    bdr = np.nonzero(counts == 1)[0]
    side0, side1 = first[inter], order[start[inter] + 1]
    bside = first[bdr]

    battr = np.zeros(len(bdr), dtype=np.int64)
    if mesh.nbe and len(bdr):
        # the last boundary element of each key, as the JAX package's dict
        nb, bids, q = encode_rows(np.sort(mesh.boundary, axis=1), keys[bside])
        last = np.zeros(nb, dtype=np.int64)
        last[bids] = np.arange(mesh.nbe)
        hit = q >= 0
        battr[hit] = mesh.bdr_attributes[last[q[hit]]]
    split = lambda rows: (rows % ne, rows // ne)          # (element, local face)
    return split(side0), split(side1), split(bside), battr


def build_face_data(mesh, p: int, nq1d: Optional[int] = None,
                    nodes: str = "l2", with_gradients: bool = False) -> FaceData:
    """All face tables of an order-p (L2) space on ``mesh``; with
    ``with_gradients`` also each side's physical basis gradients at the
    face points and its element size normal to the face (DG diffusion)."""
    geom, dim = mesh.geom, mesh.dim
    if nq1d is None:
        nq1d = p + 2
    fq, fw = _face_quad(FACE_GEOM[geom], nq1d)
    faces = np.asarray(FACES[geom], dtype=np.int64)      # (nlf, k)
    latt_v = REF_VERTS[geom]
    elems = mesh.elements
    corner = _corner_coords(mesh)
    cent = corner.mean(axis=1)
    vol = _element_volumes(geom, corner) if with_gradients else None
    (e0, lf0), (e1, lf1), (be, lfb), battr = _incidence(mesh, faces)

    def side(e, lf, phys_from=None):
        """One side's tables for faces (e, lf), chunked: B, and with
        gradients G and h; with ``phys_from`` None also the face's points,
        normals (oriented outward from e) and measures."""
        nf = len(e)
        nd = len(lattice_multi_index(geom, p))
        nq = len(fw)
        out = dict(B=np.zeros((nf, nq, nd)))
        if phys_from is None:
            out.update(x=np.zeros((nf, nq, dim)), n=np.zeros((nf, nq, dim)),
                       w=np.zeros((nf, nq)))
        if with_gradients:
            out.update(G=np.zeros((nf, nq, nd, dim)), h=np.zeros(nf))
        def chunk(s):
            c = slice(s, min(s + CHUNK, nf))
            ec = e[c]
            cv = _canonical_corners(elems, faces, ec, lf[c])
            ref = _bilinear(latt_v[cv], fq)                   # (f, q, dim)
            pts = ref.reshape(-1, dim)
            out["B"][c] = _eval_volume_basis(geom, p, pts).reshape(len(ec), nq, nd)
            if phys_from is None:
                V = np.take_along_axis(corner[ec], cv[..., None], axis=1)
                x, n, mag = _face_phys(V, fq)
                sgn = np.sign(((x.mean(axis=1) - cent[ec])
                               * n.mean(axis=1)).sum(axis=1))
                sgn[sgn == 0] = 1.0
                out["x"][c], out["n"][c] = x, n * sgn[:, None, None]
                out["w"][c] = fw * mag
                area = np.sum(fw * mag, axis=1)
            else:
                area = np.sum(phys_from[c], axis=1)
            if with_gradients:
                Gref = _eval_volume_basis_grad(geom, p, pts).reshape(
                    len(ec), nq, nd, dim)
                Jinv = np.linalg.inv(_fd_jacobian(geom, corner[ec], ref))
                out["G"][c] = Gref @ Jinv
                out["h"][c] = vol[ec] / area

        # chunks write disjoint rows; numpy releases the GIL in their loops
        with ThreadPoolExecutor(min(THREADS, max(1, -(-nf // CHUNK)))) as pool:
            list(pool.map(chunk, range(0, nf, CHUNK)))
        return out

    s0 = side(e0, lf0)
    s1 = side(e1, lf1, phys_from=s0["w"])
    sb = side(be, lfb)
    fd = FaceData(
        elem0=e0, elem1=e1, B0=s0["B"], B1=s1["B"], normal=s0["n"],
        wdet=s0["w"], xq=s0["x"], b_elem=be, b_B=sb["B"], b_normal=sb["n"],
        b_wdet=sb["w"], b_xq=sb["x"], b_attr=battr)
    if with_gradients:
        fd.G0, fd.G1, fd.h0, fd.h1 = s0["G"], s1["G"], s0["h"], s1["h"]
        fd.b_G, fd.b_h = sb["G"], sb["h"]
    return fd
