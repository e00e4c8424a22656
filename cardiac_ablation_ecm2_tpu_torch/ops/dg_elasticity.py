"""DG (interior penalty) linear elasticity, the ex17 operator (counterpart
of ``cardiac_ablation_ecm2_tpu/ops/dg_elasticity.py``; MFEM's
``DGElasticityIntegrator``, SIPG form, weak Dirichlet):

  a(u,v) = Σ_K ∫ σ(u):ε(v) − Σ_F ∮ {σ(u)n}·[v] − ∮ {σ(v)n}·[u]
         + Σ_F (α(λ̄+2μ̄)/h) ∮ [u]·[v],     σ(u) = λ tr(ε)I + 2με.

The volume term is ``ops/elasticity.apply`` on the broken vector E-layout
(ne, nd, dim); the traction at the face points and its exact adjoint are
batched einsums over the face tables.  The face sides read their
elements' (nd, dim) rows with ``take_rows`` and every sum into the
elements is one ``segment_sum`` (``ops/face_sum.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..fem.build import basis_for, face_data_for, geom_factors_for
from ..fem.fespace import L2FESpace
from ..utils.config import real_t, resolve_device
from . import elasticity as emod
from .dg_advection import host_call
from .face_sum import FaceSum
from .operators import LinearOperator

_es = torch.einsum


def _traction(G, nrm, u_e, lam, mu):
    """σ(u)n at face points: (f, q, c) from per-component gradients."""
    Gu = _es("fqnd,fnc->fqcd", G, u_e)                 # ∂_d u_c
    div = _es("fqcc->fq", Gu)
    return (lam * div[..., None] * nrm
            + mu * _es("fqcd,fqd->fqc", Gu + Gu.transpose(2, 3), nrm))


def _traction_T(G, nrm, m, lam, mu):
    """Exact adjoint: ⟨m, σ(·)n⟩ distributed to the dofs → (f, n, e)."""
    mn = _es("fqc,fqc->fq", m, nrm)                   # m·n
    nG = _es("fqd,fqnd->fqn", nrm, G)                 # n·∇φ_n
    mG = _es("fqc,fqnc->fqn", m, G)                   # Σ_c m_c ∂_c φ_n
    out = (lam * mn[..., None, None] * G
           + mu * nG[..., None] * m[:, :, None, :]
           + mu * mG[..., None] * nrm[:, :, None, :])
    return torch.sum(out, dim=1)


@dataclasses.dataclass(eq=False)
class DGElasticity:
    """Matrix-free SIPG elasticity operator on a broken vector space (the
    scalar L2 space per component); ``device=None`` is the card."""

    fes: L2FESpace
    lam: float = 1.0
    mu: float = 1.0
    penalty: float = 10.0
    nq1d: Optional[int] = None
    dtype: object = None
    device: object = None

    def __post_init__(self):
        fes, mesh = self.fes, self.fes.mesh
        p = fes.order
        self.dim = mesh.dim
        self.device = dev = resolve_device(self.device)
        self.dtype = rt = real_t(self.dtype)
        self.db = basis_for(fes, rt, dev, self.nq1d)
        self.vol_qd = emod.setup(geom_factors_for(fes, self.nq1d, rt, dev),
                                 self.lam, self.mu)

        fd = face_data_for(fes, self.nq1d, with_gradients=True)
        alpha = self.penalty * max(p, 1) * (p + 1)
        kbar = self.lam + 2 * self.mu
        hmean = 2.0 / (1.0 / fd.h0 + 1.0 / fd.h1)
        t = lambda a: torch.as_tensor(a, dtype=rt, device=dev)
        self.B0, self.B1, self.G0, self.G1 = t(fd.B0), t(fd.B1), t(fd.G0), t(fd.G1)
        self.nrm, self.w_f, self.pen = t(fd.normal), t(fd.wdet), t(alpha * kbar / hmean)
        self.bB, self.bG, self.bn = t(fd.b_B), t(fd.b_G), t(fd.b_normal)
        self.bw, self.bpen = t(fd.b_wdet), t(alpha * kbar / fd.b_h)
        self.b_xq = fd.b_xq
        self.ne = mesh.ne
        self.faces = FaceSum(mesh.ne, fes.nd_elem * self.dim,
                             [np.arange(mesh.ne), fd.elem0, fd.elem1, fd.b_elem], dev)

    @property
    def ndof(self):
        return self.ne * self.fes.nd_elem * self.dim

    def mult(self, u_flat: torch.Tensor) -> torch.Tensor:
        F, lam, mu = self.faces, self.lam, self.mu
        u = u_flat.reshape(self.ne, self.fes.nd_elem, self.dim)
        y = emod.apply(self.db, self.vol_qd, u)

        ue0, ue1, ueb = F.read(u, 1), F.read(u, 2), F.read(u, 3)
        jump = _es("fqn,fnc->fqc", self.B0, ue0) - _es("fqn,fnc->fqc", self.B1, ue1)
        avg = 0.5 * (_traction(self.G0, self.nrm, ue0, lam, mu)
                     + _traction(self.G1, self.nrm, ue1, lam, mu))
        t = self.w_f[..., None] * avg                     # consistency
        s = 0.5 * self.w_f[..., None] * jump              # symmetry
        pw = self.pen[:, None, None] * self.w_f[..., None] * jump   # penalty
        y0 = (_es("fqn,fqc->fnc", self.B0, pw - t)
              - _traction_T(self.G0, self.nrm, s, lam, mu))
        y1 = (_es("fqn,fqc->fnc", self.B1, t - pw)
              - _traction_T(self.G1, self.nrm, s, lam, mu))

        # boundary (weak Dirichlet, u⁺ ≡ 0)
        ub = _es("fqn,fnc->fqc", self.bB, ueb)
        tb = _traction(self.bG, self.bn, ueb, lam, mu)
        yb = (_es("fqn,fqc->fnc", self.bB,
                  self.bw[..., None] * (self.bpen[:, None, None] * ub - tb))
              - _traction_T(self.bG, self.bn, self.bw[..., None] * ub, lam, mu))
        return F.sum([y, y0, y1, yb]).reshape(-1)

    def dirichlet_rhs(self, g: Callable) -> torch.Tensor:
        """Weak Dirichlet RHS: −∮ σ(v)n·g + (α k̄/h) ∮ v·g."""
        gq = torch.as_tensor(host_call(g, self.b_xq), dtype=self.dtype,
                             device=self.device)            # (nfb, nq, dim)
        b = (-_traction_T(self.bG, self.bn, self.bw[..., None] * gq, self.lam, self.mu)
             + _es("fqn,fqc->fnc", self.bB,
                   self.bpen[:, None, None] * self.bw[..., None] * gq))
        return self.faces.sum([None, None, None, b]).reshape(-1)

    def diagonal(self) -> torch.Tensor:
        """Jacobi diagonal (volume and penalty mass terms)."""
        d = emod.diagonal(self.db, self.vol_qd)            # (ne, nd, dim)

        def pen(p, w, B):
            return _es("f,fq,fqn,fqn->fn", p, w, B, B)[..., None].expand(
                -1, -1, self.dim)

        return self.faces.sum([d, pen(self.pen, self.w_f, self.B0),
                               pen(self.pen, self.w_f, self.B1),
                               pen(self.bpen, self.bw, self.bB)]).reshape(-1)

    def operator(self) -> LinearOperator:
        n = self.ndof
        return LinearOperator((n, n), self.mult, self.diagonal)
