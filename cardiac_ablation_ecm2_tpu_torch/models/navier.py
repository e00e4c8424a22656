"""Transient incompressible Navier–Stokes by a BDF/EXT split step
(counterpart of ``cardiac_ablation_ecm2_tpu/models/navier.py``; MFEM's
Navier miniapp, ``miniapps/fluids/navier``), the incremental
pressure-correction scheme with the rotational term:

  1. u* : (bd0/dt·M + ν K) u* = −M Σᵢ bdᵢ uⁿ⁻ⁱ/dt − (N_ext, v)
          − (∇pⁿ, v) + (f, v),   u* = g on Γ_D
  2. φ  : (∇φ, ∇q) = −bd0/dt (∇·u*, q)        (Neumann, mean zero)
  3. p  : pⁿ⁺¹ = pⁿ + φ − ν·Π_p(∇·u*)          (rotational correction)
  4. u  : M uⁿ⁺¹ = M u* − dt/bd0 (∇φ, v)       (projection)

with N(u) = (u·∇)u extrapolated (EXTk) and BDFk time derivatives, k
ramping 1 → 2, on equal-order H1 velocity and pressure.  The four
sub-solves are Jacobi-PCG; a step is a plain function (the JAX package
jits it), and each step keeps its four SolveInfos (``last_infos``).  The
stiffness qdata are packed, so in 3D on hexes every K apply is the fused
diffusion kernel on the card, one component at a time.  ``device=None`` is
the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.fespace import FESpace
from ..fem.geom_factors import adjugate
from ..fem.quadinterp import eval_grad, eval_values, eval_values_t
from ..linalg.solvers import cg
from ..ops import diffusion as dmod
from ..ops import mass as mmod
from ..utils.config import real_t, resolve_device


@dataclasses.dataclass(eq=False)
class NavierSolver:
    mesh: object
    order: int = 3
    kin_vis: float = 1.0
    vel_bc: Optional[Callable] = None     # g(x) -> (..., dim) Dirichlet
    vel_bdr: Optional[Sequence[int]] = None   # None = all attributes
    forcing: Optional[Callable] = None    # f(x) -> (..., dim)
    rel_tol: float = 1e-10
    max_iter: int = 2000
    dtype: object = None
    device: object = None

    def __post_init__(self):
        mesh = self.mesh
        dim = mesh.dim
        dev = self.device = resolve_device(self.device)
        rt = real_t(self.dtype)
        self.dim = dim
        self.vfes = FESpace(mesh, self.order, vdim=dim)
        self.pfes = FESpace(mesh, self.order)
        fes = self.pfes                     # scalar structure shared
        self.restr = restriction_for(fes, dev)
        self.db = basis_for(fes, self.dtype, dev)
        self.gf = gf = geom_factors_for(fes, dtype=self.dtype, device=dev)
        self.A_adj = adjugate(gf.jac)                     # (ne,nq,d,d)
        self.inv_det = 1.0 / gf.det

        self.qmass = mmod.setup(gf)                       # w·detJ
        self.qdiff = dmod.setup_packed(gf, self.kin_vis)  # ν-scaled
        self.qdiff1 = dmod.setup_packed(gf, 1.0)          # pressure Poisson

        ns = fes.ndof_scalar
        self.ns = ns
        self.dM = self.restr.mult_transpose(mmod.diagonal(self.db, self.qmass))
        self.dK = self.restr.mult_transpose(dmod.diagonal(self.db, self.qdiff))
        self.dKp = self.restr.mult_transpose(dmod.diagonal(self.db, self.qdiff1))

        ess_s = fes.essential_dofs(self.vel_bdr)
        self.has_ess = len(ess_s) > 0
        m = np.ones(ns, dtype=np.float64)
        m[np.asarray(ess_s)] = 0.0
        self.ess_mask = torch.as_tensor(m, dtype=rt, device=dev)[None, :]  # (1, ns)
        if self.vel_bc is not None:
            gvals = np.asarray(self.vel_bc(fes.dof_coords), dtype=float)
            self.u_bc = torch.as_tensor(gvals.T.copy(), dtype=rt, device=dev)
        else:
            self.u_bc = torch.zeros((dim, ns), dtype=rt, device=dev)

        # lumped weights for the pressure mean (mean-zero Neumann solve)
        self.wlump = self.restr.mult_transpose(
            eval_values_t(self.db, self.qmass * torch.ones_like(gf.det)))
        self.wsum = torch.sum(self.wlump)

        if self.forcing is not None:
            fq = torch.as_tensor(np.asarray(self.forcing(gf.x.cpu().numpy())),
                                 dtype=rt, device=dev)
            self.b_f = self._vector_lf(fq)
        else:
            self.b_f = torch.zeros((dim, ns), dtype=rt, device=dev)
        self.last_infos = ()

    # -- building blocks -------------------------------------------------
    def _e(self, u_dn):
        """(d, ns) L-vector → E-vector (ne, nd, d)."""
        return self.restr.mult_vec(u_dn.reshape(-1), u_dn.shape[0])

    def _et(self, y):
        """(ne, nd, d) E-vector → (d, ns) L-vector."""
        return self.restr.mult_transpose_vec(y).view(y.shape[-1], self.ns)

    def _vals(self, u_dn):
        """(d, ns) → values at quad (ne, nq, d)."""
        return eval_values(self.db, self._e(u_dn))

    def _phys_grad(self, u_dn):
        """(d, ns) → ∂_b u_c at quad (ne, nq, b, c)."""
        g = eval_grad(self.db, self._e(u_dn))             # (ne,nq,a,c)
        return torch.einsum("eqab,eqac->eqbc", self.A_adj, g) \
            * self.inv_det[..., None, None]

    def _scalar_grad(self, p):
        g = eval_grad(self.db, self.restr.mult(p))        # (ne,nq,a)
        return torch.einsum("eqab,eqa->eqb", self.A_adj, g) * self.inv_det[..., None]

    def _vector_lf(self, vq):
        """(c, φ v): (ne, nq, d) → (d, ns) assembled linear form."""
        return self._et(eval_values_t(self.db, self.qmass[..., None] * vq))

    def _scalar_lf(self, q):
        return self.restr.mult_transpose(eval_values_t(self.db, self.qmass * q))

    def _mass_apply(self, u_dn):
        vq = eval_values(self.db, self._e(u_dn)) * self.qmass[..., None]
        return self._et(eval_values_t(self.db, vq))

    def _stiff_apply(self, u_dn):
        e = self._e(u_dn)
        return self._et(torch.stack([dmod.apply(self.db, self.qdiff, e[..., c])
                                     for c in range(e.shape[-1])], dim=-1))

    def _zero_ess(self, u_dn):
        return u_dn * self.ess_mask if self.has_ess else u_dn

    # -- one time step ---------------------------------------------------
    def _make_step(self, dt, k):
        """The BDFk/EXTk step (k ∈ {1, 2}): (hist, p, u_bc, b_f) → (u, p),
        ``hist`` the (d, ns) velocities, newest first."""
        if k == 1:
            bd, ab = (1.0, -1.0), (1.0, 0.0)
        else:
            bd, ab = (1.5, -2.0, 0.5), (2.0, -1.0)
        nu = self.kin_vis
        bd0dt = bd[0] / dt
        d, ns = self.dim, self.ns

        def conv_lf(u_dn):
            Nq = torch.einsum("eqj,eqjc->eqc", self._vals(u_dn),
                              self._phys_grad(u_dn))
            return self._vector_lf(Nq)

        def solve(op, rhs, inv, x0=None):
            return cg(op, rhs, x0=x0, M=lambda r: inv * r,
                      rel_tol=self.rel_tol, max_iter=self.max_iter)

        def step(hist, p, u_bc, b_f):
            rhs = b_f - sum(ab[i] * conv_lf(hist[i])
                            for i in range(len(ab)) if ab[i])
            rhs = rhs - self._mass_apply(
                sum((bd[i + 1] / dt) * hist[i] for i in range(len(bd) - 1)))
            rhs = rhs - self._vector_lf(self._scalar_grad(p))

            # Helmholtz solve for u*
            def H(v):
                v = v.view(d, ns)
                z = self._zero_ess(v)
                y = self._zero_ess(bd0dt * self._mass_apply(z)
                                   + self._stiff_apply(z))
                return (y + (v - z)).reshape(-1)

            dgv = (bd0dt * self.dM + self.dK)[None].repeat(d, 1)
            if self.has_ess:
                dgv = dgv * self.ess_mask + (1.0 - self.ess_mask)
            B = self._zero_ess(rhs - (bd0dt * self._mass_apply(u_bc)
                                      + self._stiff_apply(u_bc)))
            ustar_h, i1 = solve(H, B.reshape(-1), 1.0 / dgv.reshape(-1),
                                torch.zeros_like(B).reshape(-1))
            ustar = ustar_h.view(d, ns) + u_bc

            # pressure increment: (∇φ, ∇q) = −bd0/dt (∇·u*, q), mean zero
            divq = torch.einsum("eqcc->eq", self._phys_grad(ustar))
            bphi = -bd0dt * self._scalar_lf(divq)
            bphi = bphi - (torch.sum(bphi) / self.wsum) * self.wlump

            def Kp(v):
                return self.restr.mult_transpose(
                    dmod.apply(self.db, self.qdiff1, self.restr.mult(v)))

            invp = 1.0 / torch.where(self.dKp == 0, torch.ones_like(self.dKp),
                                     self.dKp)
            phi, i2 = solve(Kp, bphi, invp)
            phi = phi - torch.sum(self.wlump * phi) / self.wsum

            # rotational pressure correction: Π_p(ν ∇·u*)
            def Mp(v):
                return self.restr.mult_transpose(
                    mmod.apply(self.db, self.qmass, self.restr.mult(v)))

            invm = 1.0 / self.dM
            pdiv, i3 = solve(Mp, self._scalar_lf(nu * divq), invm)
            p_new = p + phi - pdiv

            # velocity projection: M u = M u* − dt/bd0 (∇φ, v)
            bu = self._mass_apply(ustar) - (1.0 / bd0dt) * self._vector_lf(
                self._scalar_grad(phi))

            def Mv(v):
                return self._mass_apply(v.view(d, ns)).reshape(-1)

            u_new, i4 = solve(Mv, bu.reshape(-1), invm[None].repeat(d, 1).reshape(-1),
                              ustar.reshape(-1))
            u_new = u_new.view(d, ns)
            if self.has_ess:
                u_new = u_new * self.ess_mask + u_bc * (1.0 - self.ess_mask)
            self.last_infos = (i1, i2, i3, i4)
            return u_new, p_new

        return step

    # -- public API -------------------------------------------------------
    def initial_state(self, u0: Optional[Callable] = None):
        rt = real_t(self.dtype)
        if u0 is None:
            u = torch.zeros((self.dim, self.ns), dtype=rt, device=self.device)
        else:
            u = torch.as_tensor(np.asarray(u0(self.pfes.dof_coords), dtype=float).T,
                                dtype=rt, device=self.device)
        return u, torch.zeros(self.ns, dtype=rt, device=self.device)

    def run(self, dt: float, nsteps: int, u0: Optional[Callable] = None,
            vel_bc_t: Optional[Callable] = None,
            forcing_t: Optional[Callable] = None, t0: float = 0.0):
        """``nsteps`` steps from ``u0``; ``vel_bc_t(x, t)`` / ``forcing_t(x,
        t)`` are optional time-dependent Dirichlet data and body force,
        evaluated at each step's end time."""
        rt = real_t(self.dtype)
        u, p = self.initial_state(u0)
        s1 = self._make_step(dt, 1)
        s2 = self._make_step(dt, 2)

        def bc_at(t):
            if vel_bc_t is None:
                return self.u_bc
            g = np.asarray(vel_bc_t(self.pfes.dof_coords, t), dtype=float)
            return torch.as_tensor(g.T.copy(), dtype=rt, device=self.device)

        def f_at(t):
            if forcing_t is None:
                return self.b_f
            fq = torch.as_tensor(np.asarray(forcing_t(self.gf.x.cpu().numpy(), t)),
                                 dtype=rt, device=self.device)
            return self._vector_lf(fq)

        t = t0 + dt
        u_new, p = s1((u,), p, bc_at(t), f_at(t))
        u, u_prev = u_new, u
        for _ in range(nsteps - 1):
            t = t + dt
            u_new, p = s2((u, u_prev), p, bc_at(t), f_at(t))
            u, u_prev = u_new, u
        return u, p

    # -- diagnostics ------------------------------------------------------
    def velocity_error(self, u, exact: Callable) -> float:
        uq = self._vals(u)
        eq = torch.as_tensor(np.asarray(exact(self.gf.x.cpu().numpy()), dtype=float),
                             dtype=uq.dtype, device=uq.device)
        d2 = torch.sum((uq - eq) ** 2, dim=-1)
        return float(torch.sqrt(torch.sum(self.gf.wdet * d2)))

    def div_norm(self, u) -> float:
        divq = torch.einsum("eqcc->eq", self._phys_grad(u))
        return float(torch.sqrt(torch.sum(self.gf.wdet * divq ** 2)))
