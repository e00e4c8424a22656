"""DG advection with upwind fluxes, the ex9 operator (counterpart of
``cardiac_ablation_ecm2_tpu/ops/dg_advection.py``; MFEM's ex9
``FE_Evolution``: volume ``ConvectionIntegrator``, interior and boundary
``DGTraceIntegrator`` and the local DG mass inverse).

Semidiscrete weak form on an L2 space:

    M du/dt = ∫ u (v·∇w) dx − ∮ F*(u⁻, u⁺, n) w dS,  F* = (v·n)·upwind(u)

The volume term is the transpose-convection einsums; each face side reads
its element's dofs with ``take_rows`` and the face terms go back into the
elements, with the volume term, in one ``segment_sum`` per apply
(``ops/face_sum.py``); the mass inverse is a batched (ne, nd, nd) product.

Callables take physical points as tensors (..., dim) of float64 on the CPU
(the face points, from the host tables) or of the working dtype on the
operator's device (the volume quadrature points).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..fem.build import basis_for, face_data_for, geom_factors_for
from ..fem.fespace import L2FESpace, element_node_coords
from ..fem.geom_factors import adjugate, compute_geometric_factors
from ..fem.quadinterp import eval_grad_t, eval_values
from ..utils.config import real_t, resolve_device
from .face_sum import FaceSum

#: elements per chunk of the mass-inverse setup
_MINV_CHUNK = 8192


def host_call(f: Callable, x: np.ndarray) -> np.ndarray:
    """``f`` at host points ``x`` (a float64 CPU tensor) → float64 numpy."""
    out = f(torch.as_tensor(x))
    return np.asarray(torch.as_tensor(out, dtype=torch.float64).cpu())


def mass_inverse(fes, nq1d, dtype, device, elems: Optional[np.ndarray] = None):
    """The inverse element mass matrices (n, nd, nd) of ``elems`` (all by
    default) on ``device``, formed and inverted in float64 (DGMassInverse)."""
    d2q = fes.dof_to_quad(nq1d)
    X = element_node_coords(fes.mesh, fes.order)
    if elems is not None:
        X = X[elems]
    B = torch.as_tensor(d2q.full_B(), dtype=torch.float64, device=device)
    out = torch.empty((len(X), B.shape[1], B.shape[1]), dtype=real_t(dtype),
                      device=device)
    for s in range(0, len(X), _MINV_CHUNK):
        gf = compute_geometric_factors(X[s:s + _MINV_CHUNK], d2q, torch.float64,
                                       device)
        Me = torch.einsum("qm,eq,qn->emn", B, gf.wdet, B)
        out[s:s + _MINV_CHUNK] = torch.linalg.inv(Me).to(out.dtype)
    return out


def upwind_tables(fd, velocity: Callable, inflow: Optional[Callable]):
    """Host float64 (v·n) dS at the interior and boundary face points and
    the inflow values at the boundary points."""
    vn = np.einsum("fqd,fqd->fq", host_call(velocity, fd.xq), fd.normal) * fd.wdet
    bvn = np.einsum("fqd,fqd->fq", host_call(velocity, fd.b_xq),
                    fd.b_normal) * fd.b_wdet
    g_in = (host_call(inflow, fd.b_xq) if inflow is not None
            else np.zeros_like(bvn))
    return vn, bvn, g_in


def upwind_flux(vn, u0, u1):
    """(v·n) dS times the upwind trace: side 0's where v·n ≥ 0."""
    return vn * torch.where(vn >= 0.0, u0, u1)


def convection_qdata(gf, velocity: Callable) -> torch.Tensor:
    """Transpose-convection qdata w · adj(J) v at the quadrature points."""
    vq = torch.as_tensor(velocity(gf.x), dtype=gf.x.dtype, device=gf.x.device)
    return torch.einsum("eqba,eqa->eqb", adjugate(gf.jac), vq) * gf.w[None, :, None]


@dataclasses.dataclass(eq=False)
class DGAdvection:
    """y(u) = M⁻¹ (K u + F(u) + b_inflow), a time-dependent operator;
    ``device=None`` is the card."""

    fes: L2FESpace
    velocity: Callable                     # v(x) -> (..., dim)
    inflow: Optional[Callable] = None      # boundary value g(x)
    nq1d: Optional[int] = None
    dtype: object = None
    device: object = None

    def __post_init__(self):
        fes, mesh = self.fes, self.fes.mesh
        self.device = dev = resolve_device(self.device)
        self.dtype = rt = real_t(self.dtype)
        self.db = basis_for(fes, rt, dev, self.nq1d)
        gf = geom_factors_for(fes, self.nq1d, rt, dev)
        self.vol_qd = convection_qdata(gf, self.velocity)
        self.Minv = mass_inverse(fes, self.nq1d, rt, dev)

        fd = face_data_for(fes, self.nq1d)
        vn, bvn, g_in = upwind_tables(fd, self.velocity, self.inflow)
        t = lambda a: torch.as_tensor(a, dtype=rt, device=dev)
        self.B0, self.B1, self.vn = t(fd.B0), t(fd.B1), t(vn)
        self.bB, self.bvn, self.g_in = t(fd.b_B), t(bvn), t(g_in)
        self.ne = mesh.ne
        self.faces = FaceSum(mesh.ne, fes.nd_elem,
                             [np.arange(mesh.ne), fd.elem0, fd.elem1, fd.b_elem], dev)

    def rhs(self, u_flat: torch.Tensor) -> torch.Tensor:
        """K u + F(u) + b before the mass inverse; u_flat (ne·nd,)."""
        F = self.faces
        u = u_flat.reshape(self.ne, self.fes.nd_elem)

        # volume: ∫ u v·∇w
        y = eval_grad_t(self.db, self.vol_qd * eval_values(self.db, u)[..., None])

        # interior faces: upwind flux
        u0 = torch.einsum("fqn,fn->fq", self.B0, F.read(u, 1))
        u1 = torch.einsum("fqn,fn->fq", self.B1, F.read(u, 2))
        flux = upwind_flux(self.vn, u0, u1)
        y0 = -torch.einsum("fqn,fq->fn", self.B0, flux)
        y1 = torch.einsum("fqn,fq->fn", self.B1, flux)

        # boundary faces: outflow takes the interior value, inflow g
        ub = torch.einsum("fqn,fn->fq", self.bB, F.read(u, 3))
        bflux = upwind_flux(self.bvn, ub, self.g_in)
        yb = -torch.einsum("fqn,fq->fn", self.bB, bflux)
        return F.sum([y, y0, y1, yb]).reshape(-1)

    def mult(self, t, u_flat: torch.Tensor) -> torch.Tensor:
        r = self.rhs(u_flat).view(self.ne, self.fes.nd_elem)
        return torch.einsum("emn,en->em", self.Minv, r).reshape(-1)


def project_l2(fes: L2FESpace, f: Callable, dtype=None, device=None) -> torch.Tensor:
    """Nodal projection onto the L2 space (its nodes are the H1 lattice's):
    ``f`` at the float64 node coordinates on ``device``, then the working
    dtype."""
    device = resolve_device(device)
    X = torch.as_tensor(element_node_coords(fes.mesh, fes.order), device=device)
    return torch.as_tensor(f(X), dtype=real_t(dtype), device=device).reshape(-1)
