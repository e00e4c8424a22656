"""Hyperbolic conservation laws u_t + ∇·F(u) = 0 on DG spaces (counterpart
of ``cardiac_ablation_ecm2_tpu/ops/hyperbolic.py``; MFEM's
``HyperbolicFormIntegrator`` with the Rusanov ``RiemannSolver``, ex18).

    M du/dt = ∫ F(u) : ∇w dx − ∮ F̂(u⁻, u⁺, n)·w dS

with the Rusanov (local Lax-Friedrichs) flux.  The state is (ne·nd·nc,)
with nc conserved components last; the face sides read their elements'
(nd, nc) rows with ``take_rows``, and every sum into the elements is one
``segment_sum`` over a slot list of the (element, node, component) layout
(``ops/face_sum.py``).  A flux is a torch function of the state, so a new
law is one flux and one wave-speed function.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..fem.build import basis_for, face_data_for, geom_factors_for
from ..fem.fespace import L2FESpace
from ..fem.geom_factors import adjugate
from ..fem.quadinterp import eval_grad_t, eval_values
from ..utils.config import real_t, resolve_device
from .dg_advection import mass_inverse
from .face_sum import FaceSum

_es = torch.einsum


# -- flux libraries (fem/hyperbolic.cpp analogs) ----------------------------
def burgers_flux(u, dim):
    """F(u) = ½u²·(1,…,1) (BurgersFlux).  u: (..., 1) → (..., 1, dim)."""
    f = 0.5 * u[..., 0] ** 2
    return torch.stack([f] * dim, dim=-1)[..., None, :]


def burgers_max_speed(uL, uR, n):
    return torch.maximum(uL[..., 0].abs(), uR[..., 0].abs()) * float(
        np.sqrt(float(n.shape[-1])))


def _euler_pressure(q, dim, gamma):
    mom = q[..., 1:1 + dim]
    v = mom / q[..., 0][..., None]
    return v, (gamma - 1.0) * (q[..., 1 + dim] - 0.5 * torch.sum(mom * v, dim=-1))


def euler_flux(q, dim, gamma=1.4):
    """Compressible Euler (EulerFlux): q = (ρ, ρv…, E) → (..., nc, dim)."""
    mom = q[..., 1:1 + dim]
    v, p = _euler_pressure(q, dim, gamma)
    rows = [mom]                                            # ρv
    for i in range(dim):
        r = mom[..., i:i + 1] * v                            # ρ v_i v
        r[..., i] += p
        rows.append(r)
    rows.append((q[..., 1 + dim] + p)[..., None] * v)        # (E+p)v
    return torch.stack(rows, dim=-2)


def euler_max_speed(qL, qR, n, gamma=1.4):
    dim = n.shape[-1]

    def speed(q):
        v, p = _euler_pressure(q, dim, gamma)
        c = torch.sqrt(torch.clamp_min(gamma * p / q[..., 0], 1e-30))
        return torch.sum(v * n, dim=-1).abs() + c

    return torch.maximum(speed(qL), speed(qR))


FLUXES = {
    "burgers": (burgers_flux, burgers_max_speed, 1),
    "euler": (euler_flux, euler_max_speed, None),   # nc = dim + 2
}


@dataclasses.dataclass(eq=False)
class HyperbolicDG:
    """Rusanov-flux DG operator for u_t = −∇·F(u) (explicit RK stepping);
    ``device=None`` is the card."""

    fes: L2FESpace
    law: str = "burgers"
    nq1d: Optional[int] = None
    dtype: object = None
    gamma: float = 1.4
    device: object = None

    def __post_init__(self):
        fes, mesh = self.fes, self.fes.mesh
        dim = mesh.dim
        self.device = dev = resolve_device(self.device)
        self.dtype = rt = real_t(self.dtype)
        flux, speed, nc = FLUXES[self.law]
        self.nc = (dim + 2) if nc is None else nc
        if self.law == "euler":
            self.flux = lambda u: euler_flux(u, dim, self.gamma)
            self.speed = lambda a, b, n: euler_max_speed(a, b, n, self.gamma)
        else:
            self.flux = lambda u: flux(u, dim)
            self.speed = speed
        self.db = basis_for(fes, rt, dev, self.nq1d)
        gf = geom_factors_for(fes, self.nq1d, rt, dev)
        self.adj_w = adjugate(gf.jac) * gf.w[None, :, None, None]
        self.Minv = mass_inverse(fes, self.nq1d, rt, dev)

        fd = face_data_for(fes, self.nq1d)
        t = lambda a: torch.as_tensor(a, dtype=rt, device=dev)
        self.B0, self.B1, self.n_f, self.w_f = (t(fd.B0), t(fd.B1), t(fd.normal),
                                                t(fd.wdet))
        self.bB, self.bn, self.bw = t(fd.b_B), t(fd.b_normal), t(fd.b_wdet)
        self.ne = mesh.ne
        self.faces = FaceSum(mesh.ne, fes.nd_elem * self.nc,
                             [np.arange(mesh.ne), fd.elem0, fd.elem1, fd.b_elem], dev)

    def mult(self, t, u_flat: torch.Tensor) -> torch.Tensor:
        F = self.faces
        u = u_flat.reshape(self.ne, self.fes.nd_elem, self.nc)

        # volume: ∫ F(u) : ∇w  (pulled back: Σ_q w adj F : ∇̂w)
        Fq = self.flux(eval_values(self.db, u))             # (ne, nq, nc, d)
        y = eval_grad_t(self.db, _es("eqrd,eqcd->eqrc", self.adj_w, Fq))

        # interior faces: Rusanov flux
        u0 = _es("fqn,fnc->fqc", self.B0, F.read(u, 1))
        u1 = _es("fqn,fnc->fqc", self.B1, F.read(u, 2))
        F0 = _es("fqcd,fqd->fqc", self.flux(u0), self.n_f)
        F1 = _es("fqcd,fqd->fqc", self.flux(u1), self.n_f)
        lam = self.speed(u0, u1, self.n_f)
        Fs = (0.5 * (F0 + F1) - 0.5 * lam[..., None] * (u1 - u0)) * self.w_f[..., None]
        y0 = -_es("fqn,fqc->fnc", self.B0, Fs)
        y1 = _es("fqn,fqc->fnc", self.B1, Fs)

        # boundary: transmissive (the interior state on both sides)
        ub = _es("fqn,fnc->fqc", self.bB, F.read(u, 3))
        Fb = _es("fqcd,fqd->fqc", self.flux(ub), self.bn) * self.bw[..., None]
        yb = -_es("fqn,fqc->fnc", self.bB, Fb)

        y = F.sum([y, y0, y1, yb])
        return _es("emn,enc->emc", self.Minv, y).reshape(-1)
