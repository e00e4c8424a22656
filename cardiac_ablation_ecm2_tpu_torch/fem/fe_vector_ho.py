"""Arbitrary-order Nédélec H(curl) and Raviart–Thomas H(div) spaces on
quads and hexes (counterpart of ``cardiac_ablation_ecm2_tpu/fem/fe_vector_ho.py``;
MFEM's ``ND_FECollection`` / ``RT_FECollection`` at order > 1).

Host numpy, the JAX package's tables bitwise.  On tensor-product elements
every inter-element identification is a permutation and a sign: the
permutation is in the gather map (dofs keyed by entity, the scheme of
``fespace.py``), the sign in ``signs``.

* ND order k: component d on open Gauss points (k) along d and closed GLL
  points (k + 1) across; 3k(k + 1)² dofs per hex.
* RT order q = k + 1: closed GLL (k + 2) along d, open Gauss (k + 1)
  across; 3(k + 1)²(k + 2) dofs per hex.

``essential_dofs`` looks the dofs' entity keys up in the boundary's edge and
face sets on whole arrays (``utils/native.encode_rows``), with the JAX
package's result.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..mesh.mesh import Mesh
from ..utils.native import encode_rows
from .basis import h1_nodes_1d, lagrange_matrices
from .fe_vector import boundary_edge_pairs, levi as _levi
from .fespace import _CELL, _EDGE, _FACE, _KEYLEN, _meta
from .geometry import DIMENSION, EDGES, FACES, Geometry, REF_VERTS
from .intrules import gauss_legendre_1d, tensor_rule


def _open_nodes(n: int) -> np.ndarray:
    x, _ = gauss_legendre_1d(n)
    return x


# ---------------------------------------------------------------------------
# local dof descriptors
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _nd_local_dofs(dim: int, k: int):
    """List of (d, idx) for ND order k: idx[d] ∈ 0..k-1 (open), idx[a] ∈ 0..k
    (closed) for a ≠ d.  C-order within each family."""
    out = []
    for d in range(dim):
        ranges = [range(k) if a == d else range(k + 1) for a in range(dim)]
        if dim == 2:
            for i0 in ranges[0]:
                for i1 in ranges[1]:
                    out.append((d, (i0, i1)))
        else:
            for i0 in ranges[0]:
                for i1 in ranges[1]:
                    for i2 in ranges[2]:
                        out.append((d, (i0, i1, i2)))
    return out


@functools.lru_cache(maxsize=None)
def _rt_local_dofs(dim: int, k: int):
    """RT order k+1: idx[d] ∈ 0..k+1 (closed), idx[a] ∈ 0..k (open)."""
    out = []
    for d in range(dim):
        ranges = [range(k + 2) if a == d else range(k + 1)
                  for a in range(dim)]
        if dim == 2:
            for i0 in ranges[0]:
                for i1 in ranges[1]:
                    out.append((d, (i0, i1)))
        else:
            for i0 in ranges[0]:
                for i1 in ranges[1]:
                    for i2 in ranges[2]:
                        out.append((d, (i0, i1, i2)))
    return out


# ---------------------------------------------------------------------------
# reference bases at tensor quadrature points
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def nd_basis_ho(geom: Geometry, k: int, nq1d: int):
    """(pts, B (nq,ndl,dim), C (nq,ndl,ncurl)) for ND order k."""
    dim = DIMENSION[geom]
    pts, _ = tensor_rule(dim, nq1d)
    x1, _ = gauss_legendre_1d(nq1d)
    Bo, Go = lagrange_matrices(_open_nodes(k), x1)        # open: (nq1, k)
    Bc, Gc = lagrange_matrices(h1_nodes_1d(k), x1)        # closed: (nq1, k+1)
    dofs = _nd_local_dofs(dim, k)
    ndl = len(dofs)
    nq = len(pts)
    B = np.zeros((nq, ndl, dim))
    ncurl = 1 if dim == 2 else 3
    C = np.zeros((nq, ndl, ncurl))
    # tensor_rule is lexicographic with the FIRST axis fastest:
    # q = i0 + nq1d*(i1 + nq1d*i2)
    qidx = np.stack(
        [g.ravel(order="F") for g in
         np.meshgrid(*([np.arange(nq1d)] * dim), indexing="ij")], axis=1
    )
    for n, (d, idx) in enumerate(dofs):
        val = np.ones(nq)
        grads = [np.ones(nq) for _ in range(dim)]         # ∂_a (scalar factor)
        for a in range(dim):
            Ba, Ga = (Bo, Go) if a == d else (Bc, Gc)
            fa = Ba[qidx[:, a], idx[a]]
            ga = Ga[qidx[:, a], idx[a]]
            val = val * fa
            for b in range(dim):
                grads[b] = grads[b] * (ga if b == a else fa)
        B[:, n, d] = val
        if dim == 2:
            # scalar curl of f ê_d: d=0 → −∂_y f ; d=1 → +∂_x f
            C[:, n, 0] = grads[0] if d == 1 else -grads[1]
        else:
            # ∇×(f ê_d) = Σ_i ε_{i j d} ∂_j f ê_i
            for j in range(3):
                if j == d:
                    continue
                i = 3 - j - d
                C[:, n, i] += _levi(i, j, d) * grads[j]
    return pts, B, C


@functools.lru_cache(maxsize=None)
def rt_basis_ho(geom: Geometry, k: int, nq1d: int):
    """(pts, B (nq,ndl,dim), D (nq,ndl)) for RT order k+1 (k ≥ 0)."""
    dim = DIMENSION[geom]
    pts, _ = tensor_rule(dim, nq1d)
    x1, _ = gauss_legendre_1d(nq1d)
    Bc, Gc = lagrange_matrices(h1_nodes_1d(k + 1), x1)    # closed k+2
    Bo, Go = lagrange_matrices(_open_nodes(k + 1), x1)    # open k+1
    dofs = _rt_local_dofs(dim, k)
    ndl = len(dofs)
    nq = len(pts)
    B = np.zeros((nq, ndl, dim))
    D = np.zeros((nq, ndl))
    qidx = np.stack(
        [g.ravel(order="F") for g in
         np.meshgrid(*([np.arange(nq1d)] * dim), indexing="ij")], axis=1
    )
    for n, (d, idx) in enumerate(dofs):
        val = np.ones(nq)
        dd = np.ones(nq)
        for a in range(dim):
            Ba, Ga = (Bc, Gc) if a == d else (Bo, Go)
            fa = Ba[qidx[:, a], idx[a]]
            val = val * fa
            dd = dd * (Ga[qidx[:, a], idx[a]] if a == d else fa)
        B[:, n, d] = val
        D[:, n] = dd                                       # ∂_d f
    return pts, B, D


# ---------------------------------------------------------------------------
# orientation-canonical global enumeration
# ---------------------------------------------------------------------------


def _edge_lookup(geom):
    """(dir_axis, transverse coords tuple) → (v_neg, v_pos) local vertices."""
    rv = REF_VERTS[geom]
    out = {}
    for (la, lb) in EDGES[geom]:
        d = int(np.argmax(np.abs(rv[lb] - rv[la])))
        if rv[lb][d] > rv[la][d]:
            vneg, vpos = la, lb
        else:
            vneg, vpos = lb, la
        trans = tuple(
            int(round(rv[la][a])) for a in range(len(rv[la])) if a != d
        )
        out[(d, trans)] = (vneg, vpos)
    return out


def _face_lookup(geom):
    """(normal_axis, side) → (fverts, in-plane axes/signs).

    Returns dict: (axis, side) → (fverts tuple, au, su, av, sv, nout)
    where the face-local u axis is ±ê_au (sign su; u measured from
    fverts[0]), v is ±ê_av, and nout = ê_axis·outward ∈ {+1,−1}."""
    rv = REF_VERTS[geom]
    out = {}
    for fverts in FACES[geom]:
        pc = rv[list(fverts)]
        ctr = pc.mean(axis=0)
        axis = int(np.argmax(np.abs(ctr - 0.5)))
        side = 1 if ctr[axis] > 0.5 else 0
        U = pc[1] - pc[0]
        V = pc[3] - pc[0]
        au = int(np.argmax(np.abs(U)))
        av = int(np.argmax(np.abs(V)))
        su = 1 if U[au] > 0 else -1
        sv = 1 if V[av] > 0 else -1
        # outward normal of the cyclic frame = U × V (FACES convention)
        n = np.cross(U, V)
        nout = 1 if n[axis] > 0 else -1
        # FACES lists are outward-oriented; nout relates ê_axis to U×V
        out[(axis, side)] = (tuple(fverts), au, su, av, sv, nout)
    return out


@dataclasses.dataclass(eq=False)
class VectorFESpaceHO:
    """Shared machinery: gather_map + signs from entity keys."""

    mesh: Mesh
    order: int
    kind: str                    # "nd" | "rt"

    def __post_init__(self):
        mesh, p, kind = self.mesh, self.order, self.kind
        geom = mesh.geom
        dim = DIMENSION[geom]
        if geom not in (Geometry.SQUARE, Geometry.CUBE):
            raise NotImplementedError(
                f"{geom!r}: higher-order ND/RT here are for quads and hexes "
                "(NDSimplexSpace / RTSimplexSpace take triangles and tets)")
        k = p if kind == "nd" else p - 1
        dofs = _nd_local_dofs(dim, k) if kind == "nd" else \
            _rt_local_dofs(dim, k)
        ndl = len(dofs)
        ne = mesh.ne
        E = _edge_lookup(geom)
        F = _face_lookup(geom) if dim == 3 else None
        elems = mesh.elements

        keys = np.full((ne, ndl, _KEYLEN), -1, dtype=np.int64)
        signs = np.ones((ne, ndl))

        n_open = k if kind == "nd" else k + 1
        n_closed = k + 1 if kind == "nd" else k + 2
        hi_closed = n_closed - 1

        def rev_o(i):
            return n_open - 1 - i

        def rev_c(i):
            return hi_closed - i

        for n, (d, idx) in enumerate(dofs):
            trans_axes = [a for a in range(dim) if a != d]
            if kind == "nd":
                on_b = [idx[a] in (0, k) for a in trans_axes]
                if all(on_b):
                    # --- edge dof (direction d) ---
                    tc = tuple(1 if idx[a] == k else 0 for a in trans_axes)
                    vneg, vpos = E[(d, tc)]
                    gneg, gpos = elems[:, vneg], elems[:, vpos]
                    fwd = gneg < gpos
                    lo = np.minimum(gneg, gpos)
                    hi = np.maximum(gneg, gpos)
                    t = np.where(fwd, idx[d], rev_o(idx[d]))
                    keys[:, n, 0] = lo
                    keys[:, n, 1] = hi
                    keys[:, n, 4] = _meta_arr_local(_EDGE, t)
                    signs[:, n] = np.where(fwd, 1.0, -1.0)
                    continue
                if dim == 3 and any(on_b):
                    # --- face dof: tangential component d ---
                    ab = trans_axes[on_b.index(True)]       # boundary axis
                    ain = trans_axes[1 - on_b.index(True)]  # in-face axis
                    side = 1 if idx[ab] == k else 0
                    fverts, au, su, av, sv, nout = F[(ab, side)]
                    self._face_tangential(
                        keys, signs, n, elems, fverts, au, su, av, sv,
                        d, idx[d], ain, idx[ain], rev_o, rev_c, n_open,
                    )
                    continue
                # interior
                keys[:, n, 0] = np.arange(ne)
                keys[:, n, 4] = _meta(_CELL, d, idx[trans_axes[0]],
                                      idx[trans_axes[1]] if dim == 3 else 0) \
                    + (idx[d] << 60)
                continue
            # ---- RT ----
            if idx[d] in (0, hi_closed):
                side = 1 if idx[d] == hi_closed else 0
                if dim == 2:
                    # edge dof with normal ê_d; along-edge axis = trans
                    a = trans_axes[0]
                    tc = (side,)
                    vneg, vpos = E[(a, (side,))]
                    gneg, gpos = elems[:, vneg], elems[:, vpos]
                    fwd = gneg < gpos
                    lo = np.minimum(gneg, gpos)
                    hi = np.maximum(gneg, gpos)
                    t = np.where(fwd, idx[a], n_open - 1 - idx[a])
                    keys[:, n, 0] = lo
                    keys[:, n, 1] = hi
                    keys[:, n, 4] = _meta_arr_local(_EDGE, t)
                    # canonical normal = R(canonical tangent), R = −90° rot:
                    # t=+ê_y → n=+ê_x ; t=+ê_x → n=−ê_y  (valid for detJ>0)
                    tang_ref_fwd = np.where(fwd, 1.0, -1.0)  # ±ê_a min→max
                    if (a, d) == (1, 0):
                        sgn = tang_ref_fwd
                    else:                                    # (a,d) == (0,1)
                        sgn = -tang_ref_fwd
                    signs[:, n] = sgn
                else:
                    fverts, au, su, av, sv, nout = F[(d, side)]
                    self._face_normal(
                        keys, signs, n, elems, fverts, au, su, av, sv,
                        trans_axes, idx, rev_o, nout, d,
                    )
                continue
            keys[:, n, 0] = np.arange(ne)
            keys[:, n, 4] = _meta(_CELL, d, idx[trans_axes[0]],
                                  idx[trans_axes[1]] if dim == 3 else 0) \
                + (idx[d] << 60)

        flat = keys.reshape(ne * ndl, _KEYLEN)
        uniq, ids, _ = encode_rows(flat, None)
        self.ndof = int(uniq)
        self.gather_map = ids.reshape(ne, ndl).astype(np.int32)
        self.signs = signs
        self._dofs = dofs
        self._k = k
        self._keys = keys                      # kept for essential-dof lookup

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        """Dofs with nonzero boundary trace: tangential (ND) / normal (RT).

        Every edge or face dof whose entity lies on a marked boundary face:
        the entity keys of the (element, local dof) slots looked up in the
        boundary's sorted face rows and edge pairs.  Analog of
        ``FiniteElementSpace::GetEssentialTrueDofs`` for ND/RT spaces."""
        mesh = self.mesh
        if mesh.nbe == 0:
            return np.zeros(0, dtype=np.int32)
        if bdr_marker is None:
            sel = np.ones(mesh.nbe, dtype=bool)
        else:
            sel = np.isin(mesh.bdr_attributes, np.asarray(list(bdr_marker)))
        bfaces = mesh.boundary[sel]
        if len(bfaces) == 0:
            return np.zeros(0, dtype=np.int32)
        keys = self._keys.reshape(-1, _KEYLEN)
        etype = keys[:, 4] >> 48
        gm = self.gather_map.reshape(-1)
        hit = np.zeros(len(gm), dtype=bool)
        is_edge = etype == _EDGE
        if is_edge.any():
            _, _, q = encode_rows(boundary_edge_pairs(bfaces), keys[is_edge, 0:2])
            hit[np.nonzero(is_edge)[0][q >= 0]] = True
        is_face = etype == _FACE
        if is_face.any():
            nvf = bfaces.shape[1]
            _, _, q = encode_rows(np.sort(bfaces, axis=1), keys[is_face, 0:nvf])
            hit[np.nonzero(is_face)[0][q >= 0]] = True
        return np.unique(gm[hit]).astype(np.int32)

    # -- helpers ----------------------------------------------------------
    @staticmethod
    def _canon_frames(gf):
        """Vectorized canonical frames: gf (ne, 4) cyclic global ids →
        (gsort (ne,4), EU (ne,2), EV (ne,2)) in the face-local (u,v) plane
        (same rule as _elem_node_keys)."""
        ne = gf.shape[0]
        ar = np.arange(ne)
        gsort = np.sort(gf, axis=1)
        r = np.argmin(gf, axis=1)
        nxt = gf[ar, (r + 1) % 4]
        prv = gf[ar, (r - 1) % 4]
        dsig = np.where(nxt < prv, 1, -1)
        c01 = np.array([(0, 0), (1, 0), (1, 1), (0, 1)])
        cr = c01[r]
        EU = c01[(r + dsig) % 4] - cr
        EV = c01[(r - dsig) % 4] - cr
        return gsort, EU, EV

    def _face_tangential(self, keys, signs, n, elems, fverts, au, su, av, sv,
                         d, i_open, ain, j_closed, rev_o, rev_c, n_open):
        """ND face dof: direction ê_d (= one in-face axis), open index i_open
        along d, closed-interior j_closed along ain.  Vectorized over ne."""
        if au == d:
            dir_loc, s1 = 0, su
            pu = i_open if su > 0 else rev_o(i_open)
            pv = j_closed if sv > 0 else rev_c(j_closed)
        else:
            dir_loc, s1 = 1, sv
            pv = i_open if sv > 0 else rev_o(i_open)
            pu = j_closed if su > 0 else rev_c(j_closed)
        p_dir = (pu, pv)[dir_loc]
        p_acr = (pu, pv)[1 - dir_loc]
        gf = elems[:, list(fverts)]
        gsort, EU, EV = self._canon_frames(gf)
        aU = np.argmax(np.abs(EU), axis=1)          # 0→local u, 1→local v
        aV = np.argmax(np.abs(EV), axis=1)
        sU = np.take_along_axis(EU, aU[:, None], 1)[:, 0]
        sV = np.take_along_axis(EV, aV[:, None], 1)[:, 0]
        on_U = aU == dir_loc                          # direction runs along U
        s2 = np.where(on_U, sU, sV)
        po = np.where(s2 > 0, p_dir, rev_o(p_dir))
        sC = np.where(on_U, sV, sU)
        pc = np.where(sC > 0, p_acr, rev_c(p_acr))
        axis_label = np.where(on_U, 0, 1).astype(np.int64)
        keys[:, n, 0:4] = gsort
        keys[:, n, 4] = (
            (np.int64(_FACE) << 48) | (axis_label << 32)
            | (po.astype(np.int64) << 16) | pc.astype(np.int64)
        )
        signs[:, n] = s1 * s2

    def _face_normal(self, keys, signs, n, elems, fverts, au, su, av, sv,
                     trans_axes, idx, rev_o, nout, d):
        """RT face dof: normal ê_d, open (j0, j1) across.  Vectorized."""
        pu = idx[au] if su > 0 else rev_o(idx[au])
        pv = idx[av] if sv > 0 else rev_o(idx[av])
        gf = elems[:, list(fverts)]
        gsort, EU, EV = self._canon_frames(gf)
        aU = np.argmax(np.abs(EU), axis=1)
        aV = np.argmax(np.abs(EV), axis=1)
        sU = np.take_along_axis(EU, aU[:, None], 1)[:, 0]
        sV = np.take_along_axis(EV, aV[:, None], 1)[:, 0]
        ploc = np.array([pu, pv])
        pU = np.where(sU > 0, ploc[aU], rev_o(ploc[aU]))
        pV = np.where(sV > 0, ploc[aV], rev_o(ploc[aV]))
        parity = EU[:, 0] * EV[:, 1] - EU[:, 1] * EV[:, 0]
        keys[:, n, 0:4] = gsort
        keys[:, n, 4] = (
            (np.int64(_FACE) << 48) | (pU.astype(np.int64) << 32)
            | (pV.astype(np.int64) << 16)
        )
        signs[:, n] = nout * parity

    @property
    def nd_elem(self):
        return self.gather_map.shape[1]


def _meta_arr_local(etype, t):
    t = np.asarray(t, dtype=np.int64)
    return (np.int64(etype) << 48) | (t << 32)


def NDSpaceHO(mesh: Mesh, order: int) -> VectorFESpaceHO:
    return VectorFESpaceHO(mesh=mesh, order=order, kind="nd")


def RTSpaceHO(mesh: Mesh, order: int) -> VectorFESpaceHO:
    return VectorFESpaceHO(mesh=mesh, order=order, kind="rt")
