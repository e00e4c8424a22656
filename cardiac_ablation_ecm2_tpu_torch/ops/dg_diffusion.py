"""DG diffusion by the symmetric interior penalty method, the ex14 operator
(counterpart of ``cardiac_ablation_ecm2_tpu/ops/dg_diffusion.py``; MFEM's
``DGDiffusionIntegrator`` with σ = −1, and ``DGDiffusionBR2Integrator``).

On an L2 space:

  a(u,v) = Σ_K ∫ κ∇u·∇v
         − Σ_F ∮ {κ∇u·n}[v] − Σ_F ∮ {κ∇v·n}[u] + Σ_F (α κ/h) ∮ [u][v]

with Dirichlet data imposed weakly through the boundary faces
(``dirichlet_rhs``, MFEM's ``DGDirichletLFIntegrator``).

The volume term is ``ops/diffusion.apply`` on packed qdata, so 3D hexes
run the ``fused_diffusion`` kernel on the card.  Each face side reads its
element's dofs once with ``take_rows``; every sum into the elements (the
volume term and all face terms of an apply, or of the diagonal) is one
``segment_sum`` (``ops/face_sum.py``).  A side's face terms are summed on
the face before that, so the sums' order differs from the JAX package's
one ``.at[].add`` per term (round-off).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..fem.build import basis_for, face_data_for, geom_factors_for
from ..fem.fespace import L2FESpace
from ..fem.geometry import FACES
from ..utils.config import real_t, resolve_device
from . import diffusion as dmod
from .dg_advection import host_call, mass_inverse
from .face_sum import FaceSum
from .operators import LinearOperator

_es = torch.einsum


def sipg_tables(fd, p: int, kappa: float, penalty: float) -> dict:
    """The SIPG face tables on the host in float64: side bases B, normal
    derivatives N = κ∇φ·n, measures w and penalties (ακ/h) of the interior
    and boundary faces."""
    alpha = penalty * p * (p + 1) if p > 0 else penalty
    hmean = 2.0 / (1.0 / fd.h0 + 1.0 / fd.h1)            # harmonic mean
    return dict(
        B0=fd.B0, B1=fd.B1,
        N0=kappa * np.einsum("fqnd,fqd->fqn", fd.G0, fd.normal),
        N1=kappa * np.einsum("fqnd,fqd->fqn", fd.G1, fd.normal),
        w_f=fd.wdet, pen=alpha * kappa / hmean,
        bB=fd.b_B, bN=kappa * np.einsum("fqnd,fqd->fqn", fd.b_G, fd.b_normal),
        bw=fd.b_wdet, bpen=alpha * kappa / fd.b_h)


def interior_rows(B0, B1, N0, N1, w, pen, ue0, ue1):
    """The SIPG rows (y0, y1) of interior faces from each side's element
    dofs: consistency −∮ {κ∇u·n}[v], symmetry −∮ {κ∇v·n}[u] and penalty
    (ακ/h) ∮ [u][v], summed on the face."""
    jump = _es("fqn,fn->fq", B0, ue0) - _es("fqn,fn->fq", B1, ue1)
    t = w * 0.5 * (_es("fqn,fn->fq", N0, ue0) + _es("fqn,fn->fq", N1, ue1))
    s = 0.5 * w * jump
    pw = pen[:, None] * w * jump
    return (_es("fqn,fq->fn", B0, pw - t) - _es("fqn,fq->fn", N0, s),
            _es("fqn,fq->fn", B1, t - pw) - _es("fqn,fq->fn", N1, s))


def boundary_rows(bB, bN, bw, bpen, ueb):
    """The SIPG rows of boundary faces (weak Dirichlet, u⁺ ≡ 0)."""
    ub = _es("fqn,fn->fq", bB, ueb)
    dub = _es("fqn,fn->fq", bN, ueb)
    return (_es("fqn,fq->fn", bB, bw * (bpen[:, None] * ub - dub))
            - _es("fqn,fq->fn", bN, bw * ub))


def face_diagonal(B, N, w, pen, sign):
    """One side's diagonal: Σ_q (pen w B² − sign w B N)."""
    return torch.sum(pen[:, None, None] * w[:, :, None] * B * B
                     - sign * w[:, :, None] * B * N, dim=1)


@dataclasses.dataclass(eq=False)
class DGDiffusion:
    """Matrix-free SIPG operator and weak-Dirichlet right-hand side;
    ``device=None`` is the card."""

    fes: L2FESpace
    kappa: float = 1.0
    penalty: float = 10.0          # α, scaled by p(p+1) internally
    nq1d: Optional[int] = None
    dtype: object = None
    device: object = None

    def __post_init__(self):
        fes, mesh = self.fes, self.fes.mesh
        self.device = dev = resolve_device(self.device)
        self.dtype = rt = real_t(self.dtype)
        self.db = basis_for(fes, rt, dev, self.nq1d)
        gf = geom_factors_for(fes, self.nq1d, rt, dev)
        self.vol_qd = dmod.setup_packed(gf, self.kappa)

        fd = face_data_for(fes, self.nq1d, with_gradients=True)
        T = sipg_tables(fd, fes.order, self.kappa, self.penalty)
        for k, v in T.items():
            setattr(self, k, torch.as_tensor(v, dtype=rt, device=dev))
        self.b_xq = fd.b_xq
        self.ne = mesh.ne
        self.faces = FaceSum(mesh.ne, fes.nd_elem,
                             [np.arange(mesh.ne), fd.elem0, fd.elem1, fd.b_elem], dev)
        self._setup_lifting(fd)

    def _setup_lifting(self, fd):
        """BR2's extra tables (none for SIPG)."""

    def _face_terms(self, u):
        """Each side's face rows: (y0, y1, yb) of the apply."""
        F = self.faces
        y0, y1 = interior_rows(self.B0, self.B1, self.N0, self.N1, self.w_f,
                               self.pen, F.read(u, 1), F.read(u, 2))
        return y0, y1, boundary_rows(self.bB, self.bN, self.bw, self.bpen,
                                     F.read(u, 3))

    def mult(self, u_flat: torch.Tensor) -> torch.Tensor:
        u = u_flat.reshape(self.ne, self.fes.nd_elem)
        y = dmod.apply(self.db, self.vol_qd, u)           # volume κ∇u·∇v
        return self.faces.sum([y, *self._face_terms(u)]).reshape(-1)

    def dirichlet_rhs(self, g: Callable) -> torch.Tensor:
        """Weak Dirichlet RHS: −∮ κ∇v·n g + (ακ/h)∮ v g
        (DGDirichletLFIntegrator)."""
        gq = torch.as_tensor(host_call(g, self.b_xq), dtype=self.dtype,
                             device=self.device)
        b = (-_es("fqn,fq->fn", self.bN, self.bw * gq)
             + _es("fqn,fq->fn", self.bB, self.bpen[:, None] * self.bw * gq))
        return self.faces.sum([None, None, None, b]).reshape(-1)

    def diagonal(self) -> torch.Tensor:
        """Jacobi diagonal: the volume and penalty terms and the
        consistency terms' diagonal on each side."""
        d = dmod.diagonal(self.db, self.vol_qd)
        d0 = face_diagonal(self.B0, self.N0, self.w_f, self.pen, 1.0)
        d1 = face_diagonal(self.B1, self.N1, self.w_f, self.pen, -1.0)
        db = face_diagonal(self.bB, self.bN, self.bw, self.bpen, 2.0)
        return self.faces.sum([d, d0, d1, db]).reshape(-1)

    def operator(self) -> LinearOperator:
        n = self.fes.ndof
        return LinearOperator((n, n), self.mult, self.diagonal)


@dataclasses.dataclass(eq=False)
class DGDiffusionBR2(DGDiffusion):
    """BR2 (Bassi–Rebay 2) stabilised DG diffusion
    (``DGDiffusionBR2Integrator``): the SIPG penalty is replaced by the
    lifted term η Σ_F ∫ r_F([u])·r_F([v]) with ∫ r·τ = −∮_F [u]{τ·n},
    applied matrix-free as η b(v)ᵀ M⁻¹ b(u) with the element mass
    inverses.  Coercive for η > faces per element; default η = faces + 1.
    The side's mass inverses are face reads (``take_rows``)."""

    eta: Optional[float] = None

    def _setup_lifting(self, fd):
        fes, dev, rt = self.fes, self.device, self.dtype
        if self.eta is None:
            self.eta = float(len(FACES[fes.mesh.geom]) + 1)
        self.Minv = mass_inverse(fes, self.nq1d, rt, dev)
        self.nrm = torch.as_tensor(fd.normal, dtype=rt, device=dev)
        self.bnrm = torch.as_tensor(fd.b_normal, dtype=rt, device=dev)
        # the Jacobi diagonal keeps the SIPG form at the BR2-equivalent
        # strength
        hmean = 2.0 / (1.0 / fd.h0 + 1.0 / fd.h1)
        self.pen = torch.as_tensor(self.eta * self.kappa / hmean, dtype=rt,
                                   device=dev)
        self.bpen = torch.as_tensor(self.eta * self.kappa / fd.b_h, dtype=rt,
                                    device=dev)

    def _lift_apply(self, jump, B0, B1, g0, g1, w, nrm, half):
        """η b(v)ᵀ M⁻¹ b(u) of one face batch: the (nf, nq) values to contract
        with B0 (+) and B1 (−); g0 / g1 the face-read groups of each side."""
        fac = -0.5 if half else -1.0
        wj = w * jump

        def side(B, g):
            M = self.faces.read(self.Minv, g)
            rhs = fac * _es("fqn,fq,fqs->fns", B, wj, nrm)
            return _es("fqn,fns,fqs->fq", B, _es("fmn,fns->fms", M, rhs), nrm)

        tn = side(B0, g0)
        if B1 is not None:
            tn = tn + side(B1, g1)
        return self.eta * self.kappa * fac * w * tn

    def _face_terms(self, u):
        F = self.faces
        ue0, ue1, ueb = F.read(u, 1), F.read(u, 2), F.read(u, 3)
        jump = _es("fqn,fn->fq", self.B0, ue0) - _es("fqn,fn->fq", self.B1, ue1)
        t = self.w_f * 0.5 * (_es("fqn,fn->fq", self.N0, ue0)
                              + _es("fqn,fn->fq", self.N1, ue1))
        s = 0.5 * self.w_f * jump
        z = self._lift_apply(jump, self.B0, self.B1, 1, 2, self.w_f, self.nrm, True)
        y0 = _es("fqn,fq->fn", self.B0, z - t) - _es("fqn,fq->fn", self.N0, s)
        y1 = _es("fqn,fq->fn", self.B1, t - z) - _es("fqn,fq->fn", self.N1, s)
        ub = _es("fqn,fn->fq", self.bB, ueb)
        dub = _es("fqn,fn->fq", self.bN, ueb)
        zb = self._lift_apply(ub, self.bB, None, 3, None, self.bw, self.bnrm, False)
        yb = (_es("fqn,fq->fn", self.bB, zb - self.bw * dub)
              - _es("fqn,fq->fn", self.bN, self.bw * ub))
        return y0, y1, yb

    def dirichlet_rhs(self, g: Callable) -> torch.Tensor:
        """Weak Dirichlet RHS: −∮ κ∇v·n g + η b(v)ᵀM⁻¹b(g)."""
        gq = torch.as_tensor(host_call(g, self.b_xq), dtype=self.dtype,
                             device=self.device)
        zg = self._lift_apply(gq, self.bB, None, 3, None, self.bw, self.bnrm, False)
        b = (-_es("fqn,fq->fn", self.bN, self.bw * gq)
             + _es("fqn,fq->fn", self.bB, zg))
        return self.faces.sum([None, None, None, b]).reshape(-1)
