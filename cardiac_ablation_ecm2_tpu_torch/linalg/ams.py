"""Auxiliary-space preconditioners for H(curl) and H(div) solves
(counterpart of ``cardiac_ablation_ecm2_tpu/linalg/ams.py``; hypre's
``HypreAMS`` / ``HypreADS`` built from the Hiptmair–Xu decomposition).

  AMS, A = curl curl(α) + mass(β) on ND₁:
      B r = S r + G B_∇(Gᵀ r) + Σ_d Π_d B_Π(Π_dᵀ r)
  ADS, A = div div(α) + mass(β) on RT₁:
      B r = S r + C B_AMS(Cᵀ r) + Σ_d Π_d B_Π(Π_dᵀ r)

with S the point (Jacobi) smoother, G the discrete gradient, C the
discrete curl, Π_d the interpolation of the vertex field w·ê_d (edge
midpoint rule for ND, face centroid rule for RT) and B_∇ / B_Π h-multigrid
V-cycles on scalar H1₁ operators (``linalg/multigrid.make_h_multigrid``).

G, Π and C are gathers over an (nedge, 2) or (nface, nfv) map.  Each is
built as an ``ElementRestriction`` over that map with its weights applied
in the element layout, so the forward map is the L→E kernel and the
adjoint the map's ``segment_sum``: explicit, deterministic and without a
second forward pass (the JAX package takes the adjoints from
``jax.linear_transpose``; a ``torch.func.vjp`` through the restriction
would rerun the forward on every call).  G and the ND Π share one map.
The two auxiliary hierarchies share their H1 spaces.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..fem.fespace import FESpace
from ..fem.geometry import FACES
from ..fem.restriction import ElementRestriction
from ..mesh.mesh import unique_edges, unique_faces
from ..ops.bilinearform import BilinearForm
from ..ops.vecfe import (
    _vertex_dof_map,
    build_nd_operator,
    discrete_curl,
    discrete_gradient,
)
from ..utils.config import real_t, resolve_device
from .multigrid import make_h_multigrid
from .smoothers import chebyshev


def _mask_from(ess, n, dtype, device):
    m = np.ones(n, dtype=np.float64)
    if ess is not None and len(ess):
        m[np.asarray(ess)] = 0.0
    return torch.as_tensor(m, dtype=dtype, device=device)


class EdgeTransfer:
    """G (``discrete_gradient``, (Gu)_e = u_hi − u_lo) and the ND Π_d on G's
    (nedge, 2) map of H1 dofs [lo, hi]: (Π_d w)_e = ½(w_lo + w_hi)(x_hi −
    x_lo)_d."""

    def __init__(self, nd_space, h1_fes, dtype, device):
        self.G = discrete_gradient(h1_fes, nd_space, device, dtype)
        self.restr = self.G.restr
        V, edges = nd_space.mesh.vertices, nd_space.edges
        self.tang = torch.as_tensor(V[edges[:, 1]] - V[edges[:, 0]], dtype=dtype,
                                    device=device)         # (nedge, sdim)

    def pi(self, w, d):
        e = self.restr.mult(w)
        return 0.5 * (e[:, 0] + e[:, 1]) * self.tang[:, d]

    def pi_t(self, y, d):
        z = 0.5 * y * self.tang[:, d]
        return self.restr.mult_transpose(torch.stack([z, z], dim=1))


class FaceTransfer:
    """The RT Π_d over the (nface, nfv) map of H1 dofs:
    (Π_d w)_f = mean(w over the face's vertices)·(area·n)_d with the face's
    canonical orientation."""

    def __init__(self, mesh, h1_fes, dtype, device):
        V = mesh.vertices
        if mesh.dim == 2:
            edges, _ = unique_edges(mesh)
            t = V[edges[:, 1]] - V[edges[:, 0]]          # min→max tangent
            n_canon = np.stack([t[:, 1], -t[:, 0]], axis=1)
            verts = edges
        else:
            faces, elem_face = unique_faces(mesh)
            if faces.shape[1] == 3:
                n_canon = 0.5 * np.cross(V[faces[:, 1]] - V[faces[:, 0]],
                                         V[faces[:, 2]] - V[faces[:, 0]])
            else:
                # quad faces: the canonical min-vertex cyclic frame from the
                # element-local cycles; area vector ½ (d13 × d24)
                n_canon = np.zeros((len(faces), 3))
                elems = mesh.elements
                ar = np.arange(elems.shape[0])
                for lf, fverts in enumerate(FACES[mesh.geom]):
                    gf = elems[:, list(fverts)]
                    r = np.argmin(gf, axis=1)
                    d = np.where(gf[ar, (r + 1) % 4] < gf[ar, (r - 1) % 4], 1, -1)
                    g0, g1 = gf[ar, r], gf[ar, (r + d) % 4]
                    g2, g3 = gf[ar, (r + 2 * d) % 4], gf[ar, (r - d) % 4]
                    n_canon[elem_face[:, lf]] = 0.5 * np.cross(V[g2] - V[g0],
                                                               V[g3] - V[g1])
            verts = faces
        vmap = _vertex_dof_map(h1_fes)
        self.restr = ElementRestriction(vmap[verts], h1_fes.ndof_scalar, device)
        self.nrm = torch.as_tensor(n_canon, dtype=dtype, device=device)
        self.nfv = verts.shape[1]

    def pi(self, w, d):
        return self.restr.mult(w).sum(dim=1) * (1.0 / self.nfv) * self.nrm[:, d]

    def pi_t(self, y, d):
        z = y * (1.0 / self.nfv) * self.nrm[:, d]
        return self.restr.mult_transpose(z[:, None].expand(-1, self.nfv).contiguous())


@dataclasses.dataclass(eq=False)
class AMSPreconditioner:
    """Callable preconditioner r → B r (``M=`` of ``cg``); ``parts`` keeps
    the transfers and the auxiliary multigrids."""

    apply_fn: Callable
    parts: dict = dataclasses.field(default_factory=dict)

    def __call__(self, r):
        return self.apply_fn(r)


class _MaskedH1:
    """(diff ∇u, ∇v) + (mass u, v) on H1₁ with identity rows at the
    essential dofs."""

    def __init__(self, f, diff_coeff, mass_coeff, ess_bdr, dtype, device):
        a = BilinearForm(f, device).add_domain_integrator("diffusion", coeff=diff_coeff)
        if mass_coeff:
            a.add_domain_integrator("mass", coeff=mass_coeff)
        self.A = a.assemble(dtype=dtype)
        ess = f.essential_dofs(ess_bdr) if ess_bdr else np.zeros(0, np.int32)
        self.m = _mask_from(ess, f.ndof_scalar, real_t(dtype), device)

    def mult(self, v):
        return self.A.mult(v * self.m) * self.m + (v - v * self.m)

    def diagonal(self):
        return self.A.diagonal() * self.m + (1 - self.m)


def h1_mg_solver(h1_fes, meshes, diff_coeff, mass_coeff, ess_bdr, cheb_order,
                 dtype, device, spaces: Optional[dict] = None):
    """Approximate solver of (diff ∇u, ∇v) + (mass u, v) on H1₁: an h-MG
    V-cycle over ``meshes`` (coarse → fine, the last h1_fes.mesh) when
    given, else one Chebyshev sweep.  ``spaces`` (id(mesh) → FESpace) is
    shared between calls.  Returns (preconditioner, Multigrid or None)."""
    def op_factory(f):
        return _MaskedH1(f, diff_coeff, mass_coeff, ess_bdr, dtype, device)

    if meshes is None:
        op = op_factory(h1_fes)
        return chebyshev(op.mult, op.diagonal(), order=cheb_order), None
    spaces = {} if spaces is None else spaces
    spaces.setdefault(id(meshes[-1]), h1_fes)

    def space_of(mm):
        if id(mm) not in spaces:
            spaces[id(mm)] = FESpace(mm, 1)
        return spaces[id(mm)]

    mg = make_h_multigrid(
        meshes, space_of, op_factory,
        smoother_order=cheb_order,
        ess_factory=(lambda f: f.essential_dofs(ess_bdr)) if ess_bdr else None,
        dtype=dtype, device=device)
    return mg.preconditioner(), mg


def make_ams(nd_space, h1_fes, A_mult: Callable, A_diag: torch.Tensor, *,
             alpha=1.0, beta=1.0, ess_bdr: Optional[Sequence[int]] = None,
             meshes: Optional[Sequence] = None, cheb_order: int = 3, dtype=None,
             device=None, spaces: Optional[dict] = None) -> AMSPreconditioner:
    """AMS preconditioner for ``A = curlcurl(α) + mass(β)`` on ND₁.

    ``A_mult`` / ``A_diag``: the essential-constrained operator and its
    diagonal (on ``device``; ``None`` is the card).  ``meshes``: the
    uniform-refinement hierarchy ending at ``nd_space.mesh`` for the
    auxiliary V-cycles (without it they are Chebyshev sweeps)."""
    device = resolve_device(device)
    rt = real_t(dtype)
    mesh = nd_space.mesh
    dim = mesh.dim
    m_nd = _mask_from(nd_space.essential_dofs(ess_bdr) if ess_bdr else None,
                      nd_space.ndof, rt, device)
    m_h1 = _mask_from(h1_fes.essential_dofs(ess_bdr) if ess_bdr else None,
                      h1_fes.ndof_scalar, rt, device)
    tr = EdgeTransfer(nd_space, h1_fes, rt, device)
    spaces = {} if spaces is None else spaces
    # the gradient space's operator Gᵀ(curlcurl_α + mass_β)G = β-stiffness;
    # Πᵀ A Π per component ≈ (α∇,∇) + (β·,·)
    bgrad, mg_grad = h1_mg_solver(h1_fes, meshes, beta if beta else 1.0, 0.0,
                                  ess_bdr, cheb_order, dtype, device, spaces)
    bpi, mg_pi = h1_mg_solver(h1_fes, meshes, alpha, beta, ess_bdr, cheb_order,
                              dtype, device, spaces)
    inv_diag = torch.where(A_diag > 0, 1.0 / A_diag, torch.ones_like(A_diag))

    def apply_fn(r):
        x = inv_diag * r                      # point smoother
        rm = r * m_nd
        x = x + tr.G(bgrad(tr.G.t(rm) * m_h1) * m_h1) * m_nd
        for d in range(dim):
            x = x + tr.pi(bpi(tr.pi_t(rm, d) * m_h1) * m_h1, d) * m_nd
        return x

    return AMSPreconditioner(apply_fn, dict(transfer=tr, mg_grad=mg_grad,
                                            mg_pi=mg_pi, spaces=spaces))


def make_ads(rt_space, nd_space, h1_fes, A_mult: Callable, A_diag: torch.Tensor,
             *, alpha=1.0, beta=1.0, ess_bdr: Optional[Sequence[int]] = None,
             meshes: Optional[Sequence] = None, cheb_order: int = 3, dtype=None,
             device=None) -> AMSPreconditioner:
    """ADS preconditioner for ``A = divdiv(α) + mass(β)`` on RT₁ (3D; in 2D
    the Π terms cover it without the curl sweep)."""
    device = resolve_device(device)
    rt = real_t(dtype)
    mesh = rt_space.mesh
    dim = mesh.dim
    m_rt = _mask_from(rt_space.essential_dofs(ess_bdr) if ess_bdr else None,
                      rt_space.ndof, rt, device)
    m_h1 = _mask_from(h1_fes.essential_dofs(ess_bdr) if ess_bdr else None,
                      h1_fes.ndof_scalar, rt, device)
    tr = FaceTransfer(mesh, h1_fes, rt, device)
    spaces: dict = {}
    bpi, mg_pi = h1_mg_solver(h1_fes, meshes, alpha, beta, ess_bdr, cheb_order,
                              dtype, device, spaces)
    parts = dict(transfer=tr, mg_pi=mg_pi, spaces=spaces)

    curl_sweep = None
    if dim == 3 and nd_space is not None:
        C = discrete_curl(nd_space, rt_space, device=device, dtype=dtype)
        m_nd = _mask_from(nd_space.essential_dofs(ess_bdr) if ess_bdr else None,
                          nd_space.ndof, rt, device)
        # Cᵀ A C = β (curl·, curl·) on ND: an AMS cycle on its own curl-curl
        # operator with a small mass regularization
        bshift = (beta if beta else 1.0) * 1e-2
        nd_op = build_nd_operator(nd_space, mass_coeff=bshift,
                                  curlcurl_coeff=(beta if beta else 1.0),
                                  dtype=dtype, device=device)
        nd_diag = nd_op.diagonal() * m_nd + (1 - m_nd)

        def nd_mult(e):
            return nd_op.mult(e * m_nd) * m_nd + (e - e * m_nd)

        ams_inner = make_ams(nd_space, h1_fes, nd_mult, nd_diag,
                             alpha=(beta if beta else 1.0), beta=bshift,
                             ess_bdr=ess_bdr, meshes=meshes, cheb_order=cheb_order,
                             dtype=dtype, device=device, spaces=spaces)
        parts.update(curl=C, ams=ams_inner)

        def curl_sweep(r):
            return C(ams_inner(C.t(r * m_rt) * m_nd) * m_nd) * m_rt

    inv_diag = torch.where(A_diag > 0, 1.0 / A_diag, torch.ones_like(A_diag))

    def apply_fn(r):
        x = inv_diag * r
        rm = r * m_rt
        for d in range(dim):
            x = x + tr.pi(bpi(tr.pi_t(rm, d) * m_h1) * m_h1, d) * m_rt
        if curl_sweep is not None:
            x = x + curl_sweep(r)
        return x

    return AMSPreconditioner(apply_fn, parts)
