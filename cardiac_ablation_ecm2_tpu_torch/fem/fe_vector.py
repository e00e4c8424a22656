"""Lowest-order Nédélec H(curl) and Raviart–Thomas H(div) spaces on
triangles, quads, tets and hexes (counterpart of
``cardiac_ablation_ecm2_tpu/fem/fe_vector.py``; MFEM's ``ND_FECollection`` /
``RT_FECollection`` with their orientation signs).

Host numpy only, the JAX package's tables bitwise: every element gathers
its edge (ND) or face (RT) dofs through ``gather_map`` and multiplies them
by the per-(element, local dof) ``signs`` (lowest order reduces every
``DofTransformation`` to a sign).

* ND0: one dof per mesh edge = ∫_e E·t, the global tangent min → max id.
* RT0: one dof per mesh face = ∫_f u·n, the global normal that of the
  face's canonical frame.

The pullbacks (covariant for ND, Piola for RT) are applied in
``ops/vecfe.py``.  The prism and pyramid bases wait for the port's
``basis.prism_rule`` / ``pyramid_rule`` (ROADMAP Queue 1 item 6) and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

from ..mesh.mesh import Mesh, unique_edges, unique_faces
from ..utils.native import encode_rows
from .geometry import DIMENSION, EDGES, FACES, Geometry, REF_VERTS
from .intrules import simplex_rule, tensor_rule

#: the geometries with ported vector bases
VECTOR_GEOMS = (Geometry.TRIANGLE, Geometry.SQUARE, Geometry.TETRAHEDRON,
                Geometry.CUBE)


def require_vector_geom(geom: Geometry):
    """Raise for a geometry whose vector bases the port lacks."""
    if geom not in VECTOR_GEOMS:
        raise NotImplementedError(
            f"{geom!r}: the prism and pyramid vector bases need "
            "basis.prism_rule / pyramid_rule (ROADMAP Queue 1 item 6)")


# ----------------------------------------------------------------------------
# reference basis tables (lowest order)
# ----------------------------------------------------------------------------


def _simplex_barycentric(geom: Geometry, pts: np.ndarray):
    """λ values and (constant) gradients for tri/tet reference elements."""
    dim = DIMENSION[geom]
    lam = np.concatenate([1.0 - pts.sum(axis=1, keepdims=True), pts], axis=1)
    grad = np.concatenate([-np.ones((1, dim)), np.eye(dim)], axis=0)
    return lam, grad


@functools.lru_cache(maxsize=None)
def nd0_basis(geom: Geometry, nq1d: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ND0 reference basis: (points (nq, dim), B (nq, ne_loc, dim),
    CURL (nq, ne_loc, ncurl)), local edge functions along the local EDGES
    direction (la → lb); ncurl = 1 (2D) or 3 (3D)."""
    require_vector_geom(geom)
    dim = DIMENSION[geom]
    if geom in (Geometry.TRIANGLE, Geometry.TETRAHEDRON):
        # Whitney edge functions W_ab = λ_a ∇λ_b − λ_b ∇λ_a
        pts, _ = simplex_rule(dim, 2 * nq1d - 1)
        lam, grad = _simplex_barycentric(geom, pts)
        edges = EDGES[geom]
        ncurl = 1 if dim == 2 else 3
        B = np.zeros((len(pts), len(edges), dim))
        C = np.zeros((len(pts), len(edges), ncurl))
        for k, (a, b) in enumerate(edges):
            B[:, k] = lam[:, a, None] * grad[b] - lam[:, b, None] * grad[a]
            if dim == 2:
                C[:, k, 0] = 2.0 * (grad[a][0] * grad[b][1]
                                    - grad[a][1] * grad[b][0])
            else:
                C[:, k] = 2.0 * np.cross(grad[a], grad[b])
        return pts, B, C
    pts, _ = tensor_rule(dim, nq1d)
    B, C = _tensor_nd0_tables(geom, pts)
    return pts, B, C


def _tensor_nd0_tables(geom: Geometry, pts: np.ndarray):
    """Tensor-geometry ND0 basis/curl tables at arbitrary points."""
    dim = DIMENSION[geom]
    edges = EDGES[geom]
    rv = REF_VERTS[geom]
    B = np.zeros((len(pts), len(edges), dim))
    ncurl = 1 if dim == 2 else 3
    C = np.zeros((len(pts), len(edges), ncurl))
    for k, (a, b) in enumerate(edges):
        va, vb = rv[a], rv[b]
        d = int(np.argmax(np.abs(vb - va)))          # edge direction axis
        sgn = 1.0 if vb[d] > va[d] else -1.0
        # φ = sgn · ê_d · Π_{m≠d} λ_m, λ_m = x_m or 1 − x_m
        other = [m for m in range(dim) if m != d]
        lam = np.ones(len(pts))
        dlam = {m: np.ones(len(pts)) for m in other}
        for m in other:
            c = va[m]
            lam_m = pts[:, m] if c > 0.5 else 1.0 - pts[:, m]
            dl_m = 1.0 if c > 0.5 else -1.0
            lam = lam * lam_m
            for mm in other:
                if mm != m:
                    dlam[mm] = dlam[mm] * lam_m
            dlam[m] = dlam[m] * dl_m
        B[:, k, d] = sgn * lam
        if dim == 2:
            j = other[0]
            s = 1.0 if (j, d) == (0, 1) else -1.0
            C[:, k, 0] = s * sgn * dlam[j]
        else:
            for j in other:
                i = 3 - j - d
                C[:, k, i] += levi(i, j, d) * sgn * dlam[j]
    return B, C


def levi(i, j, k):
    """The Levi-Civita symbol ε_ijk."""
    if (i, j, k) in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        return 1.0
    if (i, j, k) in ((0, 2, 1), (2, 1, 0), (1, 0, 2)):
        return -1.0
    return 0.0


@functools.lru_cache(maxsize=None)
def rt0_basis(geom: Geometry, nq1d: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RT0 reference basis: (points, B (nq, nf_loc, dim), DIV (nq, nf_loc)),
    along each local face's outward normal (unit total flux)."""
    require_vector_geom(geom)
    dim = DIMENSION[geom]
    if geom in (Geometry.TRIANGLE, Geometry.TETRAHEDRON):
        # φ_f = (x − v_opp) / (dim · V_ref)
        pts, _ = simplex_rule(dim, 2 * nq1d - 1)
        rv = REF_VERTS[geom]
        faces = FACES[geom]
        vref = 0.5 if dim == 2 else 1.0 / 6.0
        c = 1.0 / (dim * vref)
        B = np.zeros((len(pts), len(faces), dim))
        D = np.zeros((len(pts), len(faces)))
        allv = set(range(dim + 1))
        for k, fverts in enumerate(faces):
            opp = (allv - set(fverts)).pop()
            B[:, k] = c * (pts - rv[opp])
            D[:, k] = c * dim
        return pts, B, D
    pts, _ = tensor_rule(dim, nq1d)
    B, D = _tensor_rt0_tables(geom, pts)
    return pts, B, D


def _tensor_rt0_tables(geom: Geometry, pts: np.ndarray):
    """Tensor-geometry RT0 basis/divergence tables at arbitrary points."""
    dim = DIMENSION[geom]
    faces = FACES[geom]
    rv = REF_VERTS[geom]
    B = np.zeros((len(pts), len(faces), dim))
    D = np.zeros((len(pts), len(faces)))
    for k, fverts in enumerate(faces):
        ctr = rv[list(fverts)].mean(axis=0)
        d = int(np.argmax(np.abs(ctr - 0.5)))        # face-normal axis
        B[:, k, d] = pts[:, d] if ctr[d] > 0.5 else pts[:, d] - 1.0
        D[:, k] = 1.0
    return B, D


# ----------------------------------------------------------------------------
# spaces
# ----------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class NDSpace:
    """Lowest-order Nédélec space: dofs on mesh edges."""

    mesh: Mesh
    order: int = 1

    def __post_init__(self):
        if self.order != 1:
            raise ValueError("NDSpace is lowest order; NDSpaceHO takes order > 1")
        require_vector_geom(self.mesh.geom)
        edges, elem_edge = unique_edges(self.mesh)
        self.edges = edges                                 # (nedge, 2) lo < hi
        self.ndof = len(edges)
        self.gather_map = elem_edge.astype(np.int32)       # (ne, n_loc_edges)
        loc = np.array(EDGES[self.mesh.geom])
        ev = self.mesh.elements[:, loc]                    # (ne, nle, 2)
        self.signs = np.where(ev[:, :, 0] < ev[:, :, 1], 1.0, -1.0)

    @property
    def nd_elem(self):
        return self.gather_map.shape[1]

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        """Edge dofs on the marked boundary (the n×E = 0 constraint);
        ``None`` marks every boundary attribute."""
        return _boundary_edge_dofs(self.mesh, bdr_marker, self.edges)


def _marked_boundary(mesh, bdr_marker):
    bdr = mesh.boundary
    if bdr_marker is not None:
        sel = np.isin(mesh.bdr_attributes, np.asarray(list(bdr_marker)))
        bdr = bdr[sel]
    return bdr


def boundary_edge_pairs(bdr: np.ndarray) -> np.ndarray:
    """The sorted (lo, hi) vertex pairs of the edges of boundary faces
    ``bdr`` (nbf, nfv), one row per (face, cyclic edge); in 2D a face is
    its own edge."""
    nfv = bdr.shape[1]
    if nfv == 2:
        return np.sort(bdr, axis=1)
    return np.concatenate([np.sort(bdr[:, [i, (i + 1) % nfv]], axis=1)
                           for i in range(nfv)], axis=0)


def _boundary_edge_dofs(mesh, bdr_marker=None, edges=None) -> np.ndarray:
    if edges is None:
        edges, _ = unique_edges(mesh)
    bedges = boundary_edge_pairs(_marked_boundary(mesh, bdr_marker))
    key = edges[:, 0] * (mesh.nv + 1) + edges[:, 1]
    bkey = np.unique(bedges[:, 0] * (mesh.nv + 1) + bedges[:, 1])
    return np.nonzero(np.isin(key, bkey))[0].astype(np.int32)


def _boundary_face_dofs(mesh, bdr_marker=None) -> np.ndarray:
    faces = unique_edges(mesh)[0] if mesh.dim == 2 else unique_faces(mesh)[0]
    bsort = np.sort(_marked_boundary(mesh, bdr_marker), axis=1)
    if len(bsort) == 0:
        return np.zeros(0, np.int32)
    _, _, found = encode_rows(bsort, np.sort(faces, axis=1))
    return np.nonzero(found >= 0)[0].astype(np.int32)


@dataclasses.dataclass(eq=False)
class RTSpace:
    """Lowest-order Raviart–Thomas space: dofs on mesh faces."""

    mesh: Mesh
    order: int = 1

    def __post_init__(self):
        if self.order != 1:
            raise ValueError("RTSpace is lowest order; RTSpaceHO takes order > 1")
        mesh = self.mesh
        require_vector_geom(mesh.geom)
        V = mesh.vertices
        cent = V[mesh.elements].mean(axis=1)
        if mesh.dim == 2:
            faces, elem_face = unique_edges(mesh)
            # canonical 2D face normal: the min→max tangent turned by −90°
            loc = np.array(FACES[mesh.geom])
            ev = mesh.elements[:, loc]                     # (ne, nlf, 2)
            t_canon = np.where(
                (ev[:, :, 0] < ev[:, :, 1])[..., None],
                V[ev[:, :, 1]] - V[ev[:, :, 0]],
                V[ev[:, :, 0]] - V[ev[:, :, 1]],
            )
            n_canon = np.stack([t_canon[..., 1], -t_canon[..., 0]], axis=-1)
            mid = 0.5 * (V[ev[:, :, 0]] + V[ev[:, :, 1]])
            outward = mid - cent[:, None, :]
            self.signs = np.where(np.sum(n_canon * outward, axis=-1) > 0, 1.0, -1.0)
        else:
            faces, elem_face = unique_faces(mesh)
            loc_faces = FACES[mesh.geom]
            ne = mesh.ne
            ar = np.arange(ne)
            signs = np.zeros((ne, len(loc_faces)))
            for lf, fverts in enumerate(loc_faces):
                gf = mesh.elements[:, list(fverts)]        # (ne, nfv) cyclic
                nfv = gf.shape[1]
                if nfv == 3:
                    s = np.sort(gf, axis=1)
                    n_canon = np.cross(V[s[:, 1]] - V[s[:, 0]],
                                       V[s[:, 2]] - V[s[:, 0]])
                else:
                    r = np.argmin(gf, axis=1)
                    nxt = gf[ar, (r + 1) % nfv]
                    prv = gf[ar, (r - 1) % nfv]
                    d = np.where(nxt < prv, 1, -1)
                    g0 = gf[ar, r]
                    g1 = gf[ar, (r + d) % nfv]
                    g3 = gf[ar, (r - d) % nfv]
                    n_canon = np.cross(V[g1] - V[g0], V[g3] - V[g0])
                outward = V[gf].mean(axis=1) - cent
                signs[:, lf] = np.where(np.sum(n_canon * outward, axis=-1) > 0,
                                        1.0, -1.0)
            self.signs = signs
        self.ndof = len(faces)
        self.gather_map = elem_face.astype(np.int32)

    @property
    def nd_elem(self):
        return self.gather_map.shape[1]

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        """Face dofs on the marked boundary (the u·n constraint)."""
        return _boundary_face_dofs(self.mesh, bdr_marker)
