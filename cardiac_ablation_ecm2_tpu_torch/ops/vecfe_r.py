"""Restricted-dimension H(curl)/H(div) spaces: ND_R1D, ND_R2D and RT_R2D
(counterpart of ``cardiac_ablation_ecm2_tpu/ops/vecfe_r.py``; MFEM's
``ND_R1D_FECollection`` / ``ND_R2D_FECollection`` / ``RT_R2D_FECollection``,
ex31: 3-component fields on 1D and 2D meshes).

The spaces are direct sums of spaces the port has:

* ND_R2D(p) = ND_p (in-plane) ⊕ H1_p · ẑ
* RT_R2D(q) = RT_q (in-plane) ⊕ L2_{q-1} · ẑ
* ND_R1D(p) = L2_{p-1} · x̂ ⊕ H1_p · ŷ ⊕ H1_p · ẑ

with the 3-channel basis and curl tables concatenated into the
``ops/vecfe.VecFEOperator`` layout, so the apply is the same restriction
kernels and batched products, and full 3×3 matrix coefficients (ex31's
anisotropic σ) contract as vector-mass qdata do.  With ∂/∂z = 0,
curl E = (∂_y E_z, −∂_x E_z, curl₂ E_xy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..fem.basis import lagrange_matrices, h1_nodes_1d, make_dof_to_quad
from ..fem.fe_vector_ho import NDSpaceHO, RTSpaceHO, _open_nodes, nd_basis_ho, rt_basis_ho
from ..fem.fe_vector_simplex import (
    NDSimplexSpace,
    RTSimplexSpace,
    VectorSimplexSpace,
    _dense_transform,
    simplex_vec_element,
)
from ..fem.fespace import FESpace, L2FESpace
from ..fem.geom_factors import adjugate
from ..fem.geometry import Geometry
from ..fem.intrules import gauss_legendre_1d
from ..utils.config import real_t, resolve_device
from .vecfe import VecFEOperator, _restriction, geometry, mass_qd, scalar_qd


@dataclasses.dataclass(eq=False)
class R2DSpace:
    """Direct-sum space [in-plane vector dofs | out-of-plane scalar dofs]:
    ``kind='nd'`` ND_p ⊕ H1_p ẑ (essential E×n = 0 pins both blocks'
    boundary dofs), ``kind='rt'`` RT_q ⊕ L2_{q-1} ẑ."""

    mesh: object
    order: int
    kind: str
    vec: object = None     # in-plane ND/RT space
    sca: object = None     # out-of-plane H1 (nd) / L2 (rt) space

    def __post_init__(self):
        mesh, p = self.mesh, self.order
        tri = mesh.geom == Geometry.TRIANGLE
        if self.vec is None:
            if self.kind == "nd":
                self.vec = NDSimplexSpace(mesh, p) if tri else NDSpaceHO(mesh, p)
                self.sca = FESpace(mesh, p)
            else:
                self.vec = RTSimplexSpace(mesh, p) if tri else RTSpaceHO(mesh, p)
                self.sca = L2FESpace(mesh, p - 1)
        gv = np.asarray(self.vec.gather_map, np.int64)
        gs = np.asarray(self.sca.gather_map, np.int64) + self.vec.ndof
        self.gather_map = np.concatenate([gv, gs], axis=1).astype(np.int32)
        self.nvec = gv.shape[1]

    @property
    def ndof(self):
        return self.vec.ndof + self.sca.ndof

    @property
    def nd_elem(self):
        return self.gather_map.shape[1]

    @property
    def has_tf(self):
        return isinstance(self.vec, VectorSimplexSpace)

    def transform(self, e):
        n = self.nvec
        return torch.cat([self.vec.transform(e[:, :n]), e[:, n:]], dim=1)

    def transform_t(self, y):
        n = self.nvec
        return torch.cat([self.vec.transform_t(y[:, :n]), y[:, n:]], dim=1)

    def dense_transform(self):
        T = _dense_transform(self.vec)                 # (ne, nvec, nvec)
        ne, n, _ = T.shape
        out = np.tile(np.eye(self.nd_elem), (ne, 1, 1))
        out[:, :n, :n] = T
        return out

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        ess = [np.asarray(self.vec.essential_dofs(bdr_marker), np.int64)]
        if self.kind == "nd":
            ess.append(np.asarray(self.sca.essential_dofs(bdr_marker), np.int64)
                       + self.vec.ndof)
        return np.unique(np.concatenate(ess)).astype(np.int32)


def NDR2DSpace(mesh, order: int) -> R2DSpace:
    """ND_R2D_FECollection analog."""
    return R2DSpace(mesh, order, "nd")


def RTR2DSpace(mesh, order: int) -> R2DSpace:
    """RT_R2D_FECollection analog."""
    return R2DSpace(mesh, order, "rt")


def _scalar_tables(mesh, order, nq1d, pts_expect):
    """(nq, nd) values and (nq, nd, 2) gradients of the scalar block at the
    rule of the vector tables."""
    d2q = make_dof_to_quad(mesh.geom, order, nq1d)
    if not np.allclose(d2q.points, pts_expect):
        raise ValueError("scalar and vector quadrature rules differ")
    return d2q.full_B(), d2q.full_G()


def _vec_tables(space, nq1d):
    """Reference in-plane basis and curl-or-div tables."""
    geom = space.mesh.geom
    if isinstance(space, VectorSimplexSpace):
        el = simplex_vec_element(geom, space.kind, space.order, 2 * nq1d - 1)
        return el["pts"], el["B"], el["D"]
    if space.kind == "nd":
        return nd_basis_ho(geom, space.order, nq1d)
    pts, B, D = rt_basis_ho(geom, space.order - 1, nq1d)
    return pts, B, D[..., None]


def _t(a, rt, device):
    return torch.as_tensor(a, dtype=rt, device=device)


def build_nd_r2d_operator(space: R2DSpace, mass_coeff=1.0, curlcurl_coeff=None,
                          nq1d: Optional[int] = None, dtype=None,
                          device=None) -> VecFEOperator:
    """(σ E, F) + (ν curl E, curl F) with 3-component E, F on a 2D mesh;
    coefficients scalar, callable or full 3×3 matrices."""
    device = resolve_device(device)
    mesh = space.mesh
    p = space.order
    nq1d = p + 2 if nq1d is None else nq1d
    rt = real_t(dtype)
    gf = geometry(mesh, nq1d, rt, device)
    Jinv = adjugate(gf.jac) / gf.det[..., None, None]
    pts, Bref, Cref = _vec_tables(space.vec, nq1d)
    Bh, Gh = _scalar_tables(mesh, p, nq1d, pts)
    ne, nq = gf.det.shape
    nv, nh = Bref.shape[1], Bh.shape[1]
    Bq = torch.zeros((ne, nv + nh, nq, 3), dtype=rt, device=device)
    Bq[:, :nv, :, :2] = torch.einsum("eqab,qna->enqb", Jinv, _t(Bref, rt, device))
    Bq[:, nv:, :, 2] = _t(Bh.T, rt, device)[None]
    terms = []
    if mass_coeff is not None:
        terms.append(("mass", mass_qd(gf, mass_coeff, rt), Bq))
    if curlcurl_coeff is not None:
        # ND block → z channel (2D curl / det); H1 block → (g_y, −g_x)
        Gphys = torch.einsum("eqab,qna->eqnb", Jinv, _t(Gh, rt, device))
        Cq = torch.zeros((ne, nv + nh, nq, 3), dtype=rt, device=device)
        Cq[:, :nv, :, 2] = (_t(Cref[..., 0], rt, device)[None] / gf.det[..., None]).transpose(1, 2)
        Cq[:, nv:, :, 0] = Gphys[..., 1].transpose(1, 2)
        Cq[:, nv:, :, 1] = -Gphys[..., 0].transpose(1, 2)
        terms.append(("curlcurl", mass_qd(gf, curlcurl_coeff, rt), Cq))
    return _r_op(space, terms, gf, rt, device)


def build_rt_r2d_operator(space: R2DSpace, mass_coeff=1.0, divdiv_coeff=None,
                          nq1d: Optional[int] = None, dtype=None,
                          device=None) -> VecFEOperator:
    """(α u, v) + (β div u, div v) with 3-component u on a 2D mesh (the ẑ
    block is divergence-free)."""
    device = resolve_device(device)
    mesh = space.mesh
    q = space.order
    nq1d = q + 2 if nq1d is None else nq1d
    rt = real_t(dtype)
    gf = geometry(mesh, nq1d, rt, device)
    pts, Bref, Dref = _vec_tables(space.vec, nq1d)
    Bh, _ = _scalar_tables(mesh, q - 1, nq1d, pts)
    ne, nq = gf.det.shape
    nv, nh = Bref.shape[1], Bh.shape[1]
    Bq = torch.zeros((ne, nv + nh, nq, 3), dtype=rt, device=device)
    Bq[:, :nv, :, :2] = torch.einsum("eqab,qnb->enqa", gf.jac / gf.det[..., None, None],
                                     _t(Bref, rt, device))
    Bq[:, nv:, :, 2] = _t(Bh.T, rt, device)[None]
    terms = []
    if mass_coeff is not None:
        terms.append(("mass", mass_qd(gf, mass_coeff, rt), Bq))
    if divdiv_coeff is not None:
        Dq = torch.zeros((ne, nv + nh, nq, 1), dtype=rt, device=device)
        Dq[:, :nv, :, 0] = (_t(Dref[..., 0], rt, device)[None] / gf.det[..., None]).transpose(1, 2)
        terms.append(("divdiv", scalar_qd(gf, divdiv_coeff, rt), Dq))
    return _r_op(space, terms, gf, rt, device)


def _r_op(space, terms, gf, rt, device) -> VecFEOperator:
    restr = _restriction(space, device)
    if getattr(space, "has_tf", False):
        return VecFEOperator(space=space, restr=restr, signs=None, terms=tuple(terms),
                             ndof=space.ndof, gf=gf, tf=True)
    if isinstance(space, R2DSpace):
        sv = np.asarray(space.vec.signs)
        signs = np.concatenate([sv, np.ones((sv.shape[0], space.nd_elem - space.nvec))],
                               axis=1)
    else:
        signs = np.ones(space.gather_map.shape)
    return VecFEOperator(space=space, restr=restr, signs=_t(signs, rt, device),
                         terms=tuple(terms), ndof=space.ndof, gf=gf)


@dataclasses.dataclass(eq=False)
class NDR1DSpace:
    """ND_R1D_FECollection analog on the segment mesh with breakpoints
    ``x`` (sorted, (nv,)).  Per element: [E_x: p open (discontinuous)]
    [E_y: p+1 closed] [E_z: p+1 closed]; the E_y / E_z vertex dofs are
    shared between neighbours."""

    x: np.ndarray
    order: int

    def __post_init__(self):
        self.x = np.asarray(self.x, np.float64)
        if self.x.ndim != 1 or len(self.x) < 2:
            raise ValueError("x must be a sorted (nv,) array, nv ≥ 2")
        p = self.order
        nv = len(self.x)
        ne = nv - 1
        nx = ne * p                       # E_x block (L2)
        nyz = nv + ne * (p - 1)           # one H1 component
        self.ndof = nx + 2 * nyz
        e = np.arange(ne)[:, None]
        g = np.zeros((ne, 3 * p + 2), dtype=np.int64)
        g[:, :p] = e * p + np.arange(p)
        for c in range(2):                # E_y then E_z
            off = nx + c * nyz
            col = p + c * (p + 1)
            g[:, col] = off + e[:, 0]
            g[:, col + p] = off + e[:, 0] + 1
            g[:, col + 1: col + p] = off + nv + e * (p - 1) + np.arange(p - 1)
        self.gather_map = g.astype(np.int32)
        self._nyz_off = nx

    @property
    def ne(self):
        return len(self.x) - 1

    @property
    def nd_elem(self):
        return self.gather_map.shape[1]

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        # the tangential components at the end points are E_y, E_z
        nv = len(self.x)
        nyz = nv + self.ne * (self.order - 1)
        o = self._nyz_off
        return np.array([o, o + nv - 1, o + nyz, o + nyz + nv - 1], dtype=np.int32)


@dataclasses.dataclass(eq=False)
class _GF1D:
    """The geometric factors of a segment mesh at a rule: points, the
    per-element det (the length) and the measure."""

    x: torch.Tensor       # (ne, nq, 1)
    det: torch.Tensor     # (ne, nq)
    wdet: torch.Tensor    # (ne, nq)


def build_nd_r1d_operator(space: NDR1DSpace, mass_coeff=1.0, curlcurl_coeff=None,
                          nq1d: Optional[int] = None, dtype=None,
                          device=None) -> VecFEOperator:
    """(σ E, F) + (ν curl E, curl F) on a 1D mesh with 3-component E;
    curl E = (0, −E_z′, E_y′)."""
    device = resolve_device(device)
    p = space.order
    nq1d = p + 2 if nq1d is None else nq1d
    rt = real_t(dtype)
    xq, wq = gauss_legendre_1d(nq1d)
    Bo, _ = lagrange_matrices(_open_nodes(p), xq)          # (nq, p)
    Bc, Gc = lagrange_matrices(h1_nodes_1d(p), xq)         # (nq, p+1)
    h = np.diff(space.x)
    ne, nq = len(h), len(xq)
    xphys = (space.x[:-1, None] + h[:, None] * xq[None, :])[..., None]
    gf = _GF1D(x=_t(xphys, rt, device),
               det=_t(np.repeat(h[:, None], nq, axis=1), rt, device),
               wdet=_t(wq[None, :] * h[:, None], rt, device))
    ndl = space.nd_elem
    Bq = np.zeros((ne, ndl, nq, 3))
    Bq[:, :p, :, 0] = Bo.T[None]
    Bq[:, p:2 * p + 1, :, 1] = Bc.T[None]
    Bq[:, 2 * p + 1:, :, 2] = Bc.T[None]
    terms = []
    if mass_coeff is not None:
        terms.append(("mass", mass_qd(gf, mass_coeff, rt), _t(Bq, rt, device)))
    if curlcurl_coeff is not None:
        Cq = np.zeros((ne, ndl, nq, 3))
        Gphys = (Gc[None] / h[:, None, None]).transpose(0, 2, 1)   # (ne, p+1, nq)
        Cq[:, p:2 * p + 1, :, 2] = Gphys                   # +E_y′ ẑ
        Cq[:, 2 * p + 1:, :, 1] = -Gphys                   # −E_z′ ŷ
        terms.append(("curlcurl", mass_qd(gf, curlcurl_coeff, rt), _t(Cq, rt, device)))
    return _r_op(space, terms, gf, rt, device)
