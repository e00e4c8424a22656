"""SIMP compliance minimisation, MFEM's ex37 problem (counterpart of
``cardiac_ablation_ecm2_tpu/models/topopt.py``): the classic SIMP and
optimality-criteria loop of the 88-line topology-optimisation codes.

The density scales the elasticity partial-assembly qdata per quadrature
point (λ_q, μ_q); the element compliances come from the same quadrature
energy densities; the density filter is a sparse neighbour average built
once on the host (scipy ``cKDTree`` and ``scipy.sparse``) and applied
there, as in the JAX package.  The solves run on ``device`` (``None``:
the card).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.fespace import FESpace
from ..fem.geom_factors import adjugate
from ..fem.quadinterp import eval_grad
from ..linalg.solvers import cg
from ..ops import elasticity as emod
from ..ops.linearform import boundary_lf_vector
from ..utils.config import real_t, resolve_device


@dataclasses.dataclass(eq=False)
class TopOpt:
    """Cantilever compliance minimisation  min f·u(ρ)  s.t.
    Σ ρ_e v_e ≤ V̄,  ρ ∈ [ρ_min, 1]."""

    mesh: object
    order: int = 1
    volfrac: float = 0.4
    simp_p: float = 3.0
    E_min: float = 1e-4
    lam0: float = 1.0
    mu0: float = 1.0
    fixed_bdr: Sequence[int] = (4,)
    force_bdr: Sequence[int] = (2,)
    force: Sequence[float] = (0.0, -1.0)
    filter_radius: float = 0.0          # physical radius; 0 = no filter
    rel_tol: float = 1e-9
    max_iter: int = 2000
    dtype: object = None
    device: object = None

    def __post_init__(self):
        mesh = self.mesh
        dim = mesh.dim
        dev = self.device = resolve_device(self.device)
        rt = real_t(self.dtype)
        self.dim = dim
        self.fes = FESpace(mesh, self.order, vdim=dim)
        self.gf = geom_factors_for(self.fes, dtype=self.dtype, device=dev)
        self.db = basis_for(self.fes, self.dtype, dev)
        self.restr = restriction_for(self.fes, dev)
        self._adj = adjugate(self.gf.jac)
        self.vol_e = torch.sum(self.gf.wdet, dim=1)       # (ne,)

        ess_s = self.fes.essential_dofs(self.fixed_bdr)
        ns = self.fes.ndof_scalar
        ess = np.concatenate([ess_s + c * ns for c in range(dim)])
        mask = np.ones(self.fes.ndof)
        mask[ess] = 0.0
        self.mask = torch.as_tensor(mask, dtype=rt, device=dev)
        self.b = boundary_lf_vector(
            self.fes, np.asarray(self.force, dtype=np.float64),
            bdr_marker=self.force_bdr, dtype=self.dtype, device=dev) * self.mask
        #: the last solve's SolveInfo
        self.info = None

        if self.filter_radius > 0:
            import scipy.sparse as sp
            from scipy.spatial import cKDTree

            cent = mesh.vertices[mesh.elements].mean(axis=1)
            pairs = cKDTree(cent).query_ball_point(cent, self.filter_radius)
            rows, cols, w = [], [], []
            for i, nb in enumerate(pairs):
                wt = self.filter_radius - np.linalg.norm(cent[nb] - cent[i], axis=1)
                wt = wt / wt.sum()
                rows += [i] * len(nb)
                cols += list(nb)
                w += list(wt)
            self._filter = sp.csr_matrix((w, (rows, cols)),
                                         shape=(mesh.ne, mesh.ne))
        else:
            self._filter = None

    # ------------------------------------------------------------------
    def _qdata(self, rho):
        scale = self.E_min + (1 - self.E_min) * rho ** self.simp_p  # (ne,)
        sq = scale[:, None] * torch.ones_like(self.gf.det)
        return emod.setup(self.gf, self.lam0 * sq, self.mu0 * sq)

    def _solve(self, rho, u0=None):
        qd = self._qdata(rho)
        m = self.mask

        def A(v):
            y = self.restr.mult_transpose_vec(
                emod.apply(self.db, qd, self.restr.mult_vec(v * m, self.dim)))
            return y * m + (v - v * m)

        dg = self.restr.mult_transpose_vec(emod.diagonal(self.db, qd))
        dg = dg * m + (1 - m)
        u, info = cg(A, self.b, x0=u0, M=lambda r: r / dg,
                     rel_tol=self.rel_tol, max_iter=self.max_iter)
        self.info = info
        return u, info

    def _element_energies(self, rho, u):
        """u·K₁,e·u per element (the SIMP sensitivity's energy)."""
        g = eval_grad(self.db, self.restr.mult_vec(u, self.dim))  # (ne,nq,dim,vdim)
        H = torch.einsum("eqsa,eqsc->eqac", self._adj, g) \
            / self.gf.det[..., None, None]               # ∇u physical
        epsil = 0.5 * (H + H.transpose(2, 3))
        tr = torch.einsum("eqaa->eq", epsil)
        dens = (0.5 * self.lam0 * tr ** 2
                + self.mu0 * torch.einsum("eqab,eqab->eq", epsil, epsil))
        return 2.0 * torch.sum(self.gf.wdet * dens, dim=1)

    def step(self, rho, u0=None, move=0.2, rho_min=1e-3):
        """One OC update; returns (rho_new, u, compliance)."""
        u, _ = self._solve(rho, u0)
        compliance = float(torch.dot(self.b, u))
        UKU = self._element_energies(rho, u)
        dC = -self.simp_p * (1 - self.E_min) * rho ** (self.simp_p - 1) * UKU
        if self._filter is not None:
            dC = torch.as_tensor(self._filter @ (dC * rho).cpu().numpy(),
                                 dtype=dC.dtype, device=dC.device) \
                / torch.clamp_min(rho, rho_min)
        # optimality criteria, bisection on the volume multiplier
        vol_target = self.volfrac * float(self.vol_e.sum())
        lo, hi = 1e-12, 1e12
        for _ in range(60):
            lam = np.sqrt(lo * hi)
            Be = torch.sqrt(torch.clamp_min(-dC / (lam * self.vol_e), 0.0))
            cand = torch.clamp(rho * Be, torch.clamp_min(rho - move, rho_min),
                               torch.clamp_max(rho + move, 1.0))
            if float(torch.dot(self.vol_e, cand)) > vol_target:
                lo = lam
            else:
                hi = lam
        return cand, u, compliance

    def optimize(self, n_iter=30, rho0=None, verbose=False):
        rho = (torch.full((self.mesh.ne,), self.volfrac, dtype=self.vol_e.dtype,
                          device=self.device) if rho0 is None else rho0)
        u = None
        hist = []
        for it in range(n_iter):
            rho, u, c = self.step(rho, u)
            hist.append(c)
            if verbose:
                print(f"it {it}: compliance {c:.6f} "
                      f"vol {float(torch.dot(self.vol_e, rho)):.4f}")
        return rho, u, hist
