"""Conforming FE space on a nonconforming (hanging-node) mesh (counterpart
of ``cardiac_ablation_ecm2_tpu/fem/ncfespace.py``; MFEM's conforming
prolongation ``cP`` of ``FiniteElementSpace`` on NC meshes,
``fem/fespace.hpp:299-301``, applied as PᵀAP in ``FormLinearSystem``).

The broken space is the ordinary key-based ``FESpace`` on the refined mesh
(continuous everywhere except across NC interfaces).  Each slave dof
(hanging vertex, slave-edge and slave-face interior node) is an
interpolation of its master entity's dofs; the prolongation is three host
tables, bitwise the JAX package's:

    slave_idx (ns,), slave_masters (ns, width), slave_w (ns, width)

with the masters numbered in the conforming space.  Chained constraints
are resolved at build time, in the JAX package's order.  The host build
keeps the JAX package's per-constraint code, whose order fixes the
tables; its position dicts are whole-array lookups here, and the 1D
Lagrange weights are evaluated once per distinct parameter value (the
same call, so the same bits).

On a device, P and Pᵀ run on the restriction kernels, as ``linalg/ams``'s
G and Π do: the (ns, width) master map (``master_map``: the masters, a
short row's weight-0 pads cycling over its own masters) is an
``ElementRestriction`` of the conforming space.  P copies the conforming values into their L slots and
forms each slave as Σ_j w_j·u_c[master_j], reading the masters with the
L→E gather (``gather_sum``) and applying the weights in that element
layout; Pᵀ applies the weights in the same layout and sums them into the
masters with the map's ``segment_sum``, an ordered and repeatable sum
where the JAX package scatter-adds (``.at[].add``).  Both are
differentiable through the restriction's autograd Functions.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..mesh.ncmesh import _PointIndex
from ..utils.config import resolve_device
from ..utils.native import encode_rows
from .basis import h1_nodes_1d, lagrange_matrices
from .fespace import (
    FESpace,
    _EDGE,
    _FACE,
    _KEYLEN,
    _VERT,
    _elem_node_keys,
    _meta,
)
from .restriction import ElementRestriction


def _vert_key(v):
    return [int(v), -1, -1, -1, _meta(_VERT)]


def _edge_key(a, b, t):
    lo, hi = (a, b) if a < b else (b, a)
    return [int(lo), int(hi), -1, -1, _meta(_EDGE, t)]


def _face_key(gf_cyc, uv, p):
    """Canonical quad-face node key: (u, v) in the caller's frame (u along
    corner0→1, v along corner0→3) mapped to the min-id-origin,
    smaller-neighbour-direction frame — must match _elem_node_keys exactly
    (the JAX package's integer arithmetic, on Python ints)."""
    gf = [int(x) for x in gf_cyc]
    gsort = sorted(gf)
    r = gf.index(gsort[0])
    d = 1 if gf[(r + 1) % 4] < gf[(r - 1) % 4] else -1
    corner_uv = ((0, 0), (p, 0), (p, p), (0, p))
    cr = corner_uv[r]
    cu, cv = corner_uv[(r + d) % 4], corner_uv[(r - d) % 4]
    eu = ((cu[0] - cr[0]) // p, (cu[1] - cr[1]) // p)
    ev = ((cv[0] - cr[0]) // p, (cv[1] - cr[1]) // p)
    rel = (uv[0] - cr[0], uv[1] - cr[1])
    a = rel[0] * eu[0] + rel[1] * eu[1]
    b = rel[0] * ev[0] + rel[1] * ev[1]
    return [gsort[0], gsort[1], gsort[2], gsort[3], _meta(_FACE, a, b)]


def _norm(x: np.ndarray) -> float:
    """``np.linalg.norm`` of a vector, as it computes it: sqrt(x·x)."""
    return math.sqrt(x.dot(x))


def _sigma_pos(mesh, pos, lo, hi):
    plo, phi = mesh.vertices[lo], mesh.vertices[hi]
    return float(_norm(pos - plo) / _norm(phi - plo))


class _Lagrange1D:
    """``lagrange_matrices(nodes, [x])[0][0]`` memoised by the value of x,
    and the flattened outer product of two such rows by the pair."""

    def __init__(self, nodes):
        self.nodes = nodes

    @functools.lru_cache(maxsize=None)
    def __call__(self, x: float) -> np.ndarray:
        W, _ = lagrange_matrices(self.nodes, np.array([x]))
        return W[0]

    @functools.lru_cache(maxsize=None)
    def outer(self, xu: float, xv: float) -> np.ndarray:
        return np.outer(self(xu), self(xv)).reshape(-1)


def _midpoints(index: _PointIndex, V: np.ndarray, pairs) -> list:
    """Vertex ids of the midpoints of each (x, y) id-array pair; raise
    where one is absent (the JAX package's ``pos[...]`` KeyError)."""
    out = []
    for x, y in pairs:
        m = index.lookup(0.5 * (V[x] + V[y]))
        if (m < 0).any():
            raise KeyError("NC constraint midpoint is not a mesh vertex")
        out.append(m)
    return out


@dataclasses.dataclass(eq=False)
class NCFESpace:
    """The conforming order-``order`` space of an NC quad, hex or tet mesh;
    P/Pᵀ tables on ``device`` (``None``: the card)."""

    nc: object                 # NCQuadMesh, NCHexMesh or NCTetMesh
    order: int
    device: Optional[object] = None

    def __post_init__(self):
        p = self.order
        self.fes = FESpace(self.nc.mesh, p)
        fes = self.fes
        mesh = self.nc.mesh
        V = mesh.vertices
        nL = fes.ndof_scalar
        nodes1d = h1_nodes_1d(p)
        lag = _Lagrange1D(nodes1d)

        # exact entity-key dof lookup: coincident-but-distinct dofs at NC
        # interfaces are told apart by entity identity, not coordinates
        main_keys = _elem_node_keys(
            mesh.geom, p, mesh.elements, np.arange(mesh.ne, dtype=np.int64)
        ).reshape(-1, _KEYLEN)

        queries = []
        per_con = []   # (master_slots, [(slave_slot, sigma), …]) per constraint
        for (v, a, b) in self.nc.constraints:
            lo, hi = (a, b) if a < b else (b, a)
            m_slots = [len(queries)]
            queries.append(_vert_key(lo))
            for t in range(1, p):
                m_slots.append(len(queries))
                queries.append(_edge_key(lo, hi, t))
            m_slots.append(len(queries))
            queries.append(_vert_key(hi))

            s_list = [(len(queries), _sigma_pos(mesh, V[v], lo, hi))]
            queries.append(_vert_key(v))
            for (c0, c1) in ((a, v), (v, b)):
                clo, chi = (c0, c1) if c0 < c1 else (c1, c0)
                for t in range(1, p):
                    pos = V[clo] + nodes1d[t] * (V[chi] - V[clo])
                    s_list.append((len(queries), _sigma_pos(mesh, pos, lo, hi)))
                    queries.append(_edge_key(clo, chi, t))
            per_con.append((m_slots, s_list))

        # --- face constraints (hex meshes): 2D tensor interpolation of all
        # fine dofs on a master face from its (p+1)² dof grid ---
        per_face = []   # (grid_slots[(p+1)²], [(slave_slot, σu, σv), …])
        face_cons = getattr(self.nc, "face_constraints", None)
        half_cons = getattr(self.nc, "half_face_constraints", None)
        has_face = face_cons is not None and len(face_cons)
        has_half = half_cons is not None and len(half_cons)
        if has_face or has_half:
            index = _PointIndex(V, first=True)

        def grid_slots_for(A, B, C, D):
            # master grid keys, index g = u*(p+1)+v; u along A→B, v A→D
            slots = []
            for u in range(p + 1):
                for v in range(p + 1):
                    if (u, v) == (0, 0):
                        k = _vert_key(A)
                    elif (u, v) == (p, 0):
                        k = _vert_key(B)
                    elif (u, v) == (p, p):
                        k = _vert_key(C)
                    elif (u, v) == (0, p):
                        k = _vert_key(D)
                    elif v == 0:
                        k = _edge_key(A, B, u if A < B else p - u)
                    elif u == p:
                        k = _edge_key(B, C, v if B < C else p - v)
                    elif v == p:
                        k = _edge_key(D, C, u if D < C else p - u)
                    elif u == 0:
                        k = _edge_key(A, D, v if A < D else p - v)
                    else:
                        k = _face_key((A, B, C, D), (u, v), p)
                    slots.append(len(queries))
                    queries.append(k)
            return slots

        node = [float(x) for x in nodes1d]

        def child_face_interiors(ids, P, s_list):
            """Interior nodes of child face ``ids`` with master-frame corner
            params ``P`` (the JAX package's float64 arithmetic, on Python
            floats, in its order)."""
            P0 = (float(P[0][0]), float(P[0][1]))
            eu = (float(P[1][0]) - P0[0], float(P[1][1]) - P0[1])
            ev = (float(P[3][0]) - P0[0], float(P[3][1]) - P0[1])
            for i in range(1, p):
                for j in range(1, p):
                    s_list.append((len(queries),
                                   P0[0] + node[i] * eu[0] + node[j] * ev[0],
                                   P0[1] + node[i] * eu[1] + node[j] * ev[1]))
                    queries.append(_face_key(ids, (i, j), p))

        if has_face:
            fc = np.asarray(face_cons, dtype=np.int64)
            A_, B_, C_, D_ = fc[:, 1], fc[:, 2], fc[:, 3], fc[:, 4]
            mids = _midpoints(index, V, ((A_, B_), (B_, C_), (C_, D_), (D_, A_)))
            for k, (c, A, B, C, D) in enumerate(fc.tolist()):
                mAB, mBC, mCD, mDA = (int(m[k]) for m in mids)
                grid_slots = grid_slots_for(A, B, C, D)

                s_list = [(len(queries), 0.5, 0.5)]
                queries.append(_vert_key(c))
                # interior nodes of the 4 internal child edges
                for (m, su, sv, du, dv) in (
                    (mAB, 0.5, 0.0, 0.0, 0.5),   # mAB → c
                    (mBC, 1.0, 0.5, -0.5, 0.0),  # mBC → c
                    (mCD, 0.5, 1.0, 0.0, -0.5),  # mCD → c
                    (mDA, 0.0, 0.5, 0.5, 0.0),   # mDA → c
                ):
                    for t in range(1, p):
                        f = nodes1d[t]
                        s_list.append((len(queries), su + f * du, sv + f * dv))
                        s_t = t if m < c else p - t
                        queries.append(_edge_key(m, c, s_t))
                # interior nodes of the 4 child faces; corner params (σu,σv)
                for ids, P in (
                    ((A, mAB, c, mDA), ((0, 0), (.5, 0), (.5, .5), (0, .5))),
                    ((mAB, B, mBC, c), ((.5, 0), (1, 0), (1, .5), (.5, .5))),
                    ((c, mBC, C, mCD), ((.5, .5), (1, .5), (1, 1), (.5, 1))),
                    ((mDA, c, mCD, D), ((0, .5), (.5, .5), (.5, 1), (0, 1))),
                ):
                    child_face_interiors(ids, P, s_list)
                per_face.append((grid_slots, s_list))

        # --- half-face constraints (anisotropic hex neighbour): the medial
        # edge mE–mF and both half child faces hang on the master face
        # (u along c1→c2, v along c1→c4; mE at (0.5,0), mF at (0.5,1)) ---
        if has_half:
            for (mE, mF, A, B, C, D) in np.asarray(half_cons).tolist():
                grid_slots = grid_slots_for(A, B, C, D)
                s_list = []
                # medial-edge interior nodes at (0.5, t from mE)
                for t in range(1, p):
                    s_list.append((len(queries), 0.5, float(nodes1d[t])))
                    s_t = t if mE < mF else p - t
                    queries.append(_edge_key(mE, mF, s_t))
                # interior nodes of the two half child faces
                child_face_interiors(
                    (A, mE, mF, D), ((0, 0), (.5, 0), (.5, 1), (0, 1)), s_list)
                child_face_interiors(
                    (mE, B, C, mF), ((.5, 0), (1, 0), (1, 1), (.5, 1)), s_list)
                if s_list:
                    per_face.append((grid_slots, s_list))

        # --- tri-face constraints (NC tet meshes, any order): every slave
        # dof interior to a refined master tri face — medial fine-edge nodes
        # and child-face interior nodes — interpolates the master face's
        # full P_p trace grid with the master triangle's nodal basis ---
        per_tri = []   # (master_slots[ndl_tri], [(slave_slot, (x, y)), …])
        tri_cons = getattr(self.nc, "tri_face_constraints", None)
        if tri_cons is not None and len(tri_cons) and p >= 2:
            from .basis import lattice_multi_index as _lmi
            from .geometry import Geometry as _G

            mi2 = _lmi(_G.TRIANGLE, p)
            tc = np.asarray(tri_cons, dtype=np.int64)
            tmids = _midpoints(_PointIndex(V, first=True), V,
                               ((tc[:, 0], tc[:, 1]), (tc[:, 1], tc[:, 2]),
                                (tc[:, 2], tc[:, 0])))

            def _tri_face_key(g3, bary):
                """Face-interior key matching _elem_node_keys' tri branch:
                sorted globals + barycentric params in the canonical
                (min-id origin, smaller-neighbour direction) frame."""
                gf = [int(x) for x in g3]
                gsort = sorted(gf)
                r = gf.index(min(gf))
                d = 1 if gf[(r + 1) % 3] < gf[(r - 1) % 3] else -1
                a = bary[(r + d) % 3]
                bb = bary[(r - d) % 3]
                return [gsort[0], gsort[1], gsort[2], -1,
                        _meta(_FACE, int(a), int(bb))]

            def _edge_node_key(x, y, t):
                """Interior node t (measured from x) of edge (x, y)."""
                return _edge_key(x, y, t if x < y else p - t)

            for k, (A, B, C) in enumerate(tc.tolist()):
                mAB, mBC, mCA = (int(m[k]) for m in tmids)
                # master trace grid in triangle-lattice order (the basis
                # column order of simplex_basis_matrices)
                m_slots = []
                for (i, j) in mi2:
                    i, j = int(i), int(j)
                    if (i, j) == (0, 0):
                        key = _vert_key(A)
                    elif (i, j) == (p, 0):
                        key = _vert_key(B)
                    elif (i, j) == (0, p):
                        key = _vert_key(C)
                    elif j == 0:
                        key = _edge_node_key(A, B, i)
                    elif i == 0:
                        key = _edge_node_key(A, C, j)
                    elif i + j == p:
                        key = _edge_node_key(B, C, j)
                    else:
                        key = _tri_face_key((A, B, C), (p - i - j, i, j))
                    m_slots.append(len(queries))
                    queries.append(key)

                # slaves with 2D face coords (A=(0,0), B=(1,0), C=(0,1))
                P = {mAB: np.array([.5, 0.]), mBC: np.array([.5, .5]),
                     mCA: np.array([0., .5])}
                s_list = []
                for (m1, m2) in ((mAB, mBC), (mBC, mCA), (mCA, mAB)):
                    for t in range(1, p):
                        xy = P[m1] + nodes1d[t] * (P[m2] - P[m1])
                        s_list.append((len(queries), tuple(xy)))
                        queries.append(_edge_node_key(m1, m2, t))
                if p >= 3:
                    PA, PB, PC = (np.array([0., 0.]), np.array([1., 0.]),
                                  np.array([0., 1.]))
                    for (g3, c3) in (
                        ((A, mAB, mCA), (PA, P[mAB], P[mCA])),
                        ((mAB, B, mBC), (P[mAB], PB, P[mBC])),
                        ((mCA, mBC, C), (P[mCA], P[mBC], PC)),
                        ((mAB, mBC, mCA), (P[mAB], P[mBC], P[mCA])),
                    ):
                        for (i, j) in mi2:
                            i, j = int(i), int(j)
                            if i == 0 or j == 0 or i + j == p:
                                continue
                            b0, b1, b2 = p - i - j, i, j
                            xy = (b0 * c3[0] + b1 * c3[1] + b2 * c3[2]) / p
                            s_list.append((len(queries), tuple(xy)))
                            queries.append(_tri_face_key(g3, (b0, b1, b2)))
                per_tri.append((m_slots, s_list))

        if queries:
            _, _, qids = encode_rows(main_keys, np.asarray(queries, dtype=np.int64))
            if (qids < 0).any():
                raise RuntimeError("NC constraint dof lookup failed")
            qids = qids.tolist()
        rows = {}                     # slave L-dof -> [(master L-dof, w)]
        for (m_slots, s_list) in per_con:
            masters = [qids[i] for i in m_slots]
            for (slot, sigma) in s_list:
                rows[qids[slot]] = list(zip(masters, lag(sigma)))
        for (grid_slots, s_list) in per_face:
            masters = [qids[i] for i in grid_slots]
            for (slot, su, sv) in s_list:
                w2 = lag.outer(su, sv)                        # g = u*(p+1)+v
                rows[qids[slot]] = [
                    (masters[g], w2[g])
                    for g in range(len(masters)) if abs(w2[g]) > 1e-14
                ]
        for (m_slots, s_list) in per_tri:
            from .basis import simplex_basis_matrices as _sbm
            from .geometry import Geometry as _G

            masters = [qids[i] for i in m_slots]
            pts = np.array([xy for (_slot, xy) in s_list], dtype=np.float64)
            Btr, _ = _sbm(_G.TRIANGLE, p, pts)
            Btr = np.asarray(Btr)
            for row_i, (slot, _xy) in enumerate(s_list):
                rows[qids[slot]] = [
                    (masters[g], Btr[row_i, g])
                    for g in range(len(masters))
                    if abs(Btr[row_i, g]) > 1e-14
                ]

        # resolve chained constraints (slave's master itself slave)
        for _ in range(32):
            changed = False
            for s, terms in list(rows.items()):
                if any(m in rows for m, _ in terms):
                    out = {}
                    for m, w in terms:
                        if m in rows:
                            for m2, w2 in rows[m]:
                                out[m2] = out.get(m2, 0.0) + w * w2
                        else:
                            out[m] = out.get(m, 0.0) + w
                    rows[s] = list(out.items())
                    changed = True
            if not changed:
                break

        ns = len(rows)
        slave_ids = np.array(sorted(rows), dtype=np.int64)
        width = max((len(rows[s]) for s in slave_ids), default=1)
        sm = np.zeros((ns, width), dtype=np.int64)
        sw = np.zeros((ns, width))
        row_len = np.zeros(ns, dtype=np.int64)
        for i, s in enumerate(slave_ids.tolist()):
            r = rows[s]
            sm[i, : len(r)] = [m for m, _ in r]
            sw[i, : len(r)] = [w for _, w in r]
            row_len[i] = len(r)

        is_slave = np.zeros(nL, dtype=bool)
        is_slave[slave_ids] = True
        conf_of_L = np.full(nL, -1, dtype=np.int64)
        conf_of_L[~is_slave] = np.arange((~is_slave).sum())
        self.ndof_conf = int((~is_slave).sum())
        self.L_of_conf = np.nonzero(~is_slave)[0]
        self.conf_of_L = conf_of_L
        self.slave_idx = slave_ids                   # (ns,) L-dofs
        self.slave_masters = conf_of_L[sm]           # (ns, width) conforming
        self.slave_w = sw                            # (ns, width) float64
        self.n_slaves = ns
        # the map P and Pᵀ run on: a short row's pad slots (weight 0; L-dof
        # 0 in the JAX package's table, −1 where that dof is a slave) cycle
        # over the row's own masters, so that no conforming dof collects
        # every row's pads in one long segment
        cyc = np.arange(width)[None, :] % np.maximum(row_len, 1)[:, None]
        self.master_map = np.take_along_axis(self.slave_masters, cyc, axis=1)

        self.device = resolve_device(self.device)
        dev = self.device
        self._Lc = torch.as_tensor(self.L_of_conf, device=dev)
        self._si = torch.as_tensor(slave_ids, device=dev)
        self.restr = (ElementRestriction(self.master_map, self.ndof_conf, dev)
                      if ns else None)
        self._w = {}

    # ------------------------------------------------------------------
    def weights(self, dtype) -> torch.Tensor:
        """(ns, width) slave weights on the space's device in ``dtype``."""
        if dtype not in self._w:
            self._w[dtype] = torch.as_tensor(self.slave_w, dtype=dtype,
                                             device=self.device)
        return self._w[dtype]

    def prolongate(self, uc: torch.Tensor) -> torch.Tensor:
        """P: conforming → broken L-vector (cP); each slave Σ_j w_j·u_c[m_j],
        the masters read by the L→E gather and weighted in its layout."""
        uL = uc.new_zeros(self.fes.ndof_scalar).index_copy(0, self._Lc, uc)
        if self.n_slaves:
            sv = (self.restr.mult(uc) * self.weights(uc.dtype)).sum(dim=1)
            uL = uL.index_copy(0, self._si, sv)
        return uL

    def restrict_t(self, vL: torch.Tensor) -> torch.Tensor:
        """Pᵀ: broken L-residual → conforming (the exact adjoint of P)."""
        vc = vL.index_select(0, self._Lc)
        if not self.n_slaves:
            return vc
        contrib = vL.index_select(0, self._si)[:, None] * self.weights(vL.dtype)
        return vc + self.restr.mult_transpose(contrib)

    def constrained_operator(self, A_L):
        """A_C(x) = Pᵀ A_L(P x) — the PᵀAP conforming operator."""

        def mult(x):
            return self.restrict_t(A_L(self.prolongate(x)))

        return mult

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        essL = self.fes.essential_dofs(bdr_marker)
        conf = self.conf_of_L[essL]
        return np.unique(conf[conf >= 0]).astype(np.int32)

    @property
    def dof_coords(self) -> np.ndarray:
        return self.fes.dof_coords[self.L_of_conf]


def prolongate_plain(sp: NCFESpace, uc: torch.Tensor) -> torch.Tensor:
    """P with the masters read by plain indexing (no kernel): the reference
    that ``chip_smoke.py`` holds the kernel path to."""
    uL = uc.new_zeros(sp.fes.ndof_scalar).index_copy(0, sp._Lc, uc)
    if sp.n_slaves:
        m = sp.restr.gm.long()
        uL = uL.index_copy(0, sp._si, (uc[m] * sp.weights(uc.dtype)).sum(dim=1))
    return uL


def restrict_t_plain(sp: NCFESpace, vL: torch.Tensor) -> torch.Tensor:
    """Pᵀ with the plain sorted segment-sum (``block_gather.segment_sum_plain``)."""
    from ..ops.block_gather import segment_sum_plain

    vc = vL.index_select(0, sp._Lc)
    if not sp.n_slaves:
        return vc
    contrib = vL.index_select(0, sp._si)[:, None] * sp.weights(vL.dtype)
    r = sp.restr
    return vc + segment_sum_plain(contrib.reshape(-1), r.slots, r.offsets)
