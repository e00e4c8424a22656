"""Right-hand-side assembly (counterpart of
``cardiac_ablation_ecm2_tpu/ops/linearform.py``; MFEM's ``LinearForm``
integrators).

(f, v) = Rᵀ Bᵀ (w·detJ·f(x_q)): the transposed basis contraction on the
space's cached geometric factors and basis, then the restriction's E→L sum
(``fem/build.py``; the segment-sum kernel on the card).  Boundary terms run
the same pipeline on the boundary faces as a mesh of their own, through the
``bdr_gather_map`` restriction into the volume's L-dofs.  Vector results
are byNODES, one E→L sum per component.  Every function runs on
``device`` (``None``: the card).

``white_noise_lf`` takes its standard normal draws ``w`` as an argument
(or a ``torch.Generator`` to draw them): the JAX package draws them from
``jax.random``, which no torch generator reproduces.

``delta_lf`` (point sources) is host work, as in the JAX package: the
points are located on the host (``mesh/point_eval.py``) and summed with
``np.add.at`` in float64 in the JAX package's order, then cast, so ``b``
is bitwise the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..fem.build import (
    basis_for,
    bdr_geom_for,
    bdr_marker_mask,
    bdr_restriction_for,
    geom_factors_for,
    restriction_for,
)
from ..fem.coefficient import eval_coeff, eval_vector_coeff
from ..fem.geom_factors import adjugate
from ..fem.quadinterp import eval_grad_t, eval_values_t
from ..utils.config import real_t, resolve_device


def domain_lf(fes, coeff, nq1d: Optional[int] = None, dtype=None,
              device=None) -> torch.Tensor:
    """(f, v) over the domain → L-vector; ``coeff`` is anything
    ``eval_coeff`` takes (None integrates 1)."""
    gf = geom_factors_for(fes, nq1d, dtype, device)
    fq = eval_coeff(coeff, gf, dtype)
    return _integrate_against_basis(fes, gf.wdet if fq is None else gf.wdet * fq,
                                    nq1d, dtype, device)


def domain_lf_from_qvec(fes, fq: torch.Tensor, nq1d: Optional[int] = None,
                        dtype=None, device=None) -> torch.Tensor:
    """(f, v) with f given as an (ne, nq) Q-vector."""
    gf = geom_factors_for(fes, nq1d, dtype, device)
    return _integrate_against_basis(fes, gf.wdet * fq, nq1d, dtype, device)


def _integrate_against_basis(fes, q, nq1d, dtype, device):
    db = basis_for(fes, dtype, device, nq1d)
    return restriction_for(fes, device).mult_transpose(eval_values_t(db, q))


def domain_lf_vector(fes, vec, nq1d: Optional[int] = None, dtype=None,
                     device=None) -> torch.Tensor:
    """(f, v) for a vector f on a vdim space → byNODES (ndof·vdim,)
    (VectorDomainLFIntegrator)."""
    gf = geom_factors_for(fes, nq1d, dtype, device)
    db = basis_for(fes, dtype, device, nq1d)
    b_e = eval_values_t(db, gf.wdet[..., None] * eval_vector_coeff(vec, gf, dtype))
    return restriction_for(fes, device).mult_transpose_vec(b_e)


def vector_quadrature_lf(fes, fq, nq1d: Optional[int] = None, dtype=None,
                         device=None) -> torch.Tensor:
    """(f, v) with f an (ne, nq, vdim) Q-vector → byNODES flat vector
    (VectorQuadratureLFIntegrator)."""
    gf = geom_factors_for(fes, nq1d, dtype, device)
    db = basis_for(fes, dtype, device, nq1d)
    fq = torch.as_tensor(fq, dtype=real_t(dtype), device=gf.det.device)
    b_e = eval_values_t(db, gf.wdet[..., None] * fq)
    return restriction_for(fes, device).mult_transpose_vec(b_e)


def boundary_lf(fes, coeff, bdr_marker=None, nq1d: Optional[int] = None,
                dtype=None, device=None) -> torch.Tensor:
    """(g, v) over the marked boundary faces (BoundaryLFIntegrator); the
    face measure is sqrt(det(JᵀJ))."""
    mesh = fes.mesh
    if mesh.nbe == 0:
        return torch.zeros(fes.ndof, dtype=real_t(dtype),
                           device=resolve_device(device))
    gf, db = bdr_geom_for(fes, nq1d, dtype, device)
    fq = eval_coeff(coeff, gf, dtype)
    q = gf.wdet if fq is None else gf.wdet * fq
    if bdr_marker is not None:
        q = q * bdr_marker_mask(mesh, bdr_marker, q.dtype, q.device)[:, None]
    return bdr_restriction_for(fes, device).mult_transpose(eval_values_t(db, q))


def boundary_lf_vector(fes, vec, bdr_marker=None, nq1d: Optional[int] = None,
                       dtype=None, device=None) -> torch.Tensor:
    """(f, v)_∂Ω for a vector f on a vdim space → (ndof_scalar·vdim,)
    byNODES (VectorBoundaryLFIntegrator)."""
    mesh = fes.mesh
    if mesh.nbe == 0:
        return torch.zeros(fes.ndof, dtype=real_t(dtype),
                           device=resolve_device(device))
    gf, db = bdr_geom_for(fes, nq1d, dtype, device)
    q = gf.wdet[..., None] * eval_vector_coeff(vec, gf, dtype)
    if bdr_marker is not None:
        q = q * bdr_marker_mask(mesh, bdr_marker, q.dtype, q.device)[:, None, None]
    return bdr_restriction_for(fes, device).mult_transpose_vec(eval_values_t(db, q))


def domain_lf_grad(fes, vec, nq1d: Optional[int] = None, dtype=None,
                   device=None) -> torch.Tensor:
    """(f, ∇v) for a vector coefficient f → L-vector
    (DomainLFGradIntegrator): Σ_q w ĝᵀ (adj(J) f)."""
    gf = geom_factors_for(fes, nq1d, dtype, device)
    db = basis_for(fes, dtype, device, nq1d)
    A = adjugate(gf.jac)
    q = torch.einsum("eqds,eqs->eqd", A.transpose(-1, -2), eval_vector_coeff(vec, gf, dtype))
    q = q * gf.w[None, :, None]
    return restriction_for(fes, device).mult_transpose(eval_grad_t(db, q))


def _outward_unit_normals(mesh, gf) -> np.ndarray:
    """(nbe, nq, sdim) outward unit normals at the boundary points (host
    float64 setup): the sign is fixed by the face point minus the
    centroid of the first element (in element order) that holds every
    vertex of the face."""
    J = gf.jac.double().cpu().numpy()                    # (nbe, nq, sdim, dim-1)
    if mesh.dim == 3:
        n = np.cross(J[..., 0], J[..., 1])
    else:
        t = J[..., 0]
        n = np.stack([t[..., 1], -t[..., 0]], axis=-1)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    # the first element holding each vertex
    first = np.full(mesh.nv, -1, dtype=np.int64)
    flat = mesh.elements.reshape(-1)
    seen, idx = np.unique(flat, return_index=True)
    first[seen] = idx // mesh.elements.shape[1]
    cent = mesh.vertices[mesh.elements].mean(axis=1)
    xq = gf.x.double().cpu().numpy()
    for f in range(mesh.nbe):
        face = mesh.boundary[f]
        e = first[face[0]]
        verts = set(int(v) for v in face)
        for c in sorted(set(int(first[v]) for v in face if first[v] >= 0)):
            if verts.issubset(set(int(v) for v in mesh.elements[c])):
                e = c
                break
        if np.dot(n[f].mean(axis=0), xq[f].mean(axis=0) - cent[e]) < 0:
            n[f] = -n[f]
    return n


def boundary_normal_lf(fes, vec, bdr_marker=None, nq1d: Optional[int] = None,
                       dtype=None, device=None) -> torch.Tensor:
    """∮ (f·n) v over the marked boundary faces, n the outward unit normal
    (BoundaryNormalLFIntegrator)."""
    mesh = fes.mesh
    rt = real_t(dtype)
    if mesh.nbe == 0:
        return torch.zeros(fes.ndof, dtype=rt, device=resolve_device(device))
    gf, db = bdr_geom_for(fes, nq1d, dtype, device)
    n = _outward_unit_normals(mesh, gf)
    if callable(vec):
        fq = np.asarray(vec(gf.x.double().cpu().numpy()))
    else:
        fq = np.broadcast_to(np.asarray(vec), n.shape)
    q = torch.as_tensor((fq * n).sum(axis=-1), dtype=rt,
                        device=gf.det.device) * gf.wdet
    if bdr_marker is not None:
        q = q * bdr_marker_mask(mesh, bdr_marker, q.dtype, q.device)[:, None]
    return bdr_restriction_for(fes, device).mult_transpose(eval_values_t(db, q))


def vector_boundary_flux_lf(fes, coeff, bdr_marker=None,
                            nq1d: Optional[int] = None, dtype=None,
                            vdim: Optional[int] = None,
                            device=None) -> torch.Tensor:
    """∮ f (v·n) over the marked boundary faces for a vdim-valued test
    space (VectorBoundaryFluxLFIntegrator, the traction of a pressure
    load); ``coeff`` is scalar (value or callable of host x).  Returns
    (ndof_scalar·vdim,) byNODES."""
    mesh = fes.mesh
    rt = real_t(dtype)
    vdim = vdim or getattr(fes, "vdim", mesh.sdim) or mesh.sdim
    nds = fes.ndof_scalar
    if mesh.nbe == 0:
        return torch.zeros(nds * vdim, dtype=rt, device=resolve_device(device))
    gf, db = bdr_geom_for(fes, nq1d, dtype, device)
    n = _outward_unit_normals(mesh, gf)
    if callable(coeff):
        fq = np.asarray(coeff(gf.x.double().cpu().numpy()))
    else:
        fq = np.broadcast_to(float(coeff), n.shape[:2])
    sel = 1.0
    if bdr_marker is not None:
        sel = np.isin(mesh.bdr_attributes,
                      np.asarray(list(bdr_marker))).astype(float)[:, None]
    kw = dict(dtype=rt, device=gf.det.device)
    w = torch.as_tensor(fq * sel, **kw) * gf.wdet
    restr = bdr_restriction_for(fes, device)
    return torch.cat([restr.mult_transpose(eval_values_t(
        db, w * torch.as_tensor(n[..., c], **kw))) for c in range(vdim)])


def boundary_tangential_lf(fes, vec, bdr_marker=None,
                           nq1d: Optional[int] = None, dtype=None,
                           device=None) -> torch.Tensor:
    """∮ (g·τ) v along the boundary of a 2D mesh, τ the boundary
    parametrisation's tangent, whose length carries the arc measure
    (BoundaryTangentialLFIntegrator)."""
    mesh = fes.mesh
    rt = real_t(dtype)
    if mesh.dim != 2:
        raise ValueError("BoundaryTangentialLF makes sense only in 2D")
    if mesh.nbe == 0:
        return torch.zeros(fes.ndof, dtype=rt, device=resolve_device(device))
    gf, db = bdr_geom_for(fes, nq1d, dtype, device)
    tang = gf.jac[..., 0]                                 # (nbe, nq, 2)
    if callable(vec):
        fq = torch.as_tensor(vec(gf.x), dtype=rt, device=tang.device)
    else:
        fq = torch.as_tensor(vec, dtype=rt, device=tang.device).expand(tang.shape)
    q = (fq * tang).sum(-1) * gf.w[None, :]
    if bdr_marker is not None:
        q = q * bdr_marker_mask(mesh, bdr_marker, q.dtype, q.device)[:, None]
    return bdr_restriction_for(fes, device).mult_transpose(eval_values_t(db, q))


def white_noise_lf(fes, w: Optional[torch.Tensor] = None, num: Optional[int] = None,
                   generator: Optional[torch.Generator] = None,
                   nq1d: Optional[int] = None, dtype=None,
                   device=None) -> torch.Tensor:
    """Gaussian random right-hand side b ~ N(0, M): b = Rᵀ diag(L_e) w with
    L_e L_eᵀ = M_e the element mass matrix's Cholesky factor (float64, one
    batched factorisation) and w ~ N(0, I)
    (WhiteGaussianNoiseDomainLFIntegrator), so E[b bᵀ] = M.

    ``w`` is the (ne, nd, num or 1) float64 draw; without it one is drawn
    on the CPU from ``generator`` (a fresh unseeded one if None) and moved
    to ``device``.  ``num=None`` gives one sample (ndof,), ``num=k`` k
    samples (k, ndof)."""
    dev = resolve_device(device)
    gf = geom_factors_for(fes, nq1d, dtype, dev)
    B = torch.as_tensor(fes.dof_to_quad(nq1d).full_B(), dtype=gf.wdet.dtype,
                        device=dev)                              # (nq, nd)
    Me = torch.einsum("qi,eq,qj->eij", B, gf.wdet, B)
    # float64 Cholesky: in float32 the high-order mass blocks lose PD
    L = torch.linalg.cholesky(Me.double())
    ne, nd = Me.shape[0], Me.shape[1]
    if w is None:
        w = torch.randn((ne, nd, num or 1), generator=generator,
                        dtype=torch.float64)
    w = torch.as_tensor(w, dtype=torch.float64, device=dev)
    b_e = torch.einsum("eij,ejs->eis", L, w).to(real_t(dtype))     # (ne, nd, k)
    r = restriction_for(fes, dev)
    b = torch.stack([r.mult_transpose(b_e[..., s].contiguous())
                     for s in range(b_e.shape[-1])])             # (k, ndof)
    return b[0] if num is None else b


def delta_lf(fes, points, strengths=None, dtype=None, device=None) -> torch.Tensor:
    """Point (Dirac delta) sources: b_i = Σ_k s_k φ_i(x_k)
    (DeltaCoefficient's right-hand side, ex34's delta loads).  Points
    outside the mesh add nothing."""
    from ..fem.faces import _eval_volume_basis
    from ..mesh.point_eval import locate_points

    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    s = (np.ones(len(pts)) if strengths is None
         else np.broadcast_to(np.asarray(strengths, np.float64), (len(pts),)))
    elem, ref = locate_points(fes.mesh, pts)
    b = np.zeros(fes.ndof_scalar)
    found = elem >= 0
    if found.any():
        B = _eval_volume_basis(fes.mesh.geom, fes.order, ref[found])
        np.add.at(b, fes.gather_map[elem[found]].reshape(-1),
                  (B * s[found, None]).reshape(-1))
    return torch.as_tensor(b, dtype=real_t(dtype), device=resolve_device(device))
