"""Error estimators for AMR (counterpart of
``cardiac_ablation_ecm2_tpu/fem/estimators.py``; MFEM's
``ZienkiewiczZhuEstimator``, ``LSZienkiewiczZhuEstimator`` and
``KellyErrorEstimator``).  Each runs on the device of ``u`` and returns a
(ne,) float64 numpy array.

* ZZ: a nodal gradient field recovered by mass-lumped L2 projection of the
  elementwise gradients, then ``η_K = ‖∇u_h − G(u_h)‖_L2(K)``;
* LSZZ: a per-vertex weighted least-squares affine fit of the gradient
  over the vertex's patch, interpolated linearly;
* Kelly: ``η_K² = Σ_{F⊂∂K} h_F ∮_F [∇u·n]² / 2`` from the face tables
  (``fem/faces.py``), on the host as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from .build import basis_for, geom_factors_for, restriction_for
from .gridfunction import phys_grad_at_quad
from .quadinterp import eval_values, eval_values_t


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return np.sqrt(np.maximum(t.double().cpu().numpy(), 0.0))


def zz_estimator(fes, u, nq1d=None, dtype=None) -> np.ndarray:
    """Zienkiewicz-Zhu recovery estimate per element → (ne,) numpy."""
    dev = u.device
    db = basis_for(fes, dtype, dev, nq1d)
    gf = geom_factors_for(fes, nq1d, dtype, dev)
    restr = restriction_for(fes, dev)
    g = phys_grad_at_quad(fes, u, nq1d, dtype)            # (ne, nq, dim)

    # mass-lumped nodal recovery: G_i = Σ_q w detJ B g / Σ_q w detJ B
    wd = gf.wdet
    num_e = eval_values_t(db, wd[..., None] * g)          # (ne, nd, dim)
    den = restr.mult_transpose(eval_values_t(db, wd))     # (ndof,)
    num = torch.stack([restr.mult_transpose(num_e[..., d].contiguous())
                       for d in range(g.shape[-1])], dim=-1)
    G = num / den[:, None]
    Ge = torch.stack([restr.mult(G[:, d].contiguous()) for d in range(g.shape[-1])],
                     dim=-1)
    diff2 = torch.sum((eval_values(db, Ge) - g) ** 2, dim=-1)
    return _to_numpy(torch.sum(wd * diff2, dim=1))


def kelly_estimator(fes, u, nq1d=None, dtype=None) -> np.ndarray:
    """Kelly flux-jump estimator: η_K² = Σ_{F⊂∂K} h_F ∮_F [∇u·n]² /2."""
    from .faces import build_face_data

    mesh = fes.mesh
    fd = build_face_data(mesh, fes.order, nq1d, with_gradients=True)
    e = restriction_for(fes, u.device).mult(u).double().cpu().numpy()  # (ne, nd)
    g0 = np.einsum("fqnd,fqd,fn->fq", fd.G0, fd.normal, e[fd.elem0])
    g1 = np.einsum("fqnd,fqd,fn->fq", fd.G1, fd.normal, e[fd.elem1])
    h_f = 0.5 * (fd.h0 + fd.h1)
    face_eta = h_f * np.sum(fd.wdet * (g0 - g1) ** 2, axis=1)   # (nfi,)
    eta2 = (np.bincount(fd.elem0, 0.5 * face_eta, minlength=mesh.ne)
            + np.bincount(fd.elem1, 0.5 * face_eta, minlength=mesh.ne))
    return np.sqrt(eta2)


def _vertex_patches(mesh):
    """Each vertex's incident elements, ascending, padded to the largest
    patch: (nv, pmax) ids and 0/1 weights."""
    from ..utils.native import counting_argsort

    v = mesh.elements.reshape(-1)
    e = np.repeat(np.arange(mesh.ne), mesh.elements.shape[1])
    counts = np.bincount(v, minlength=mesh.nv)
    order = counting_argsort(v, mesh.nv)            # by vertex, elements ascending
    start = np.zeros(mesh.nv, dtype=np.int64)
    np.cumsum(counts[:-1], out=start[1:])
    pos = np.arange(len(v)) - np.repeat(start, counts)
    pmax = int(counts.max())
    patch = np.zeros((mesh.nv, pmax), dtype=np.int64)
    pw = np.zeros((mesh.nv, pmax))
    patch[v[order], pos] = e[order]
    pw[v[order], pos] = 1.0
    return patch, pw


def lszz_estimator(fes, u, nq1d=None, dtype=None) -> np.ndarray:
    """Least-squares ZZ estimator: per-vertex patch weighted least-squares
    fit of an affine gradient model evaluated at the vertex, interpolated
    linearly; all nv (dim+1)² normal systems in one batched solve."""
    mesh, dev = fes.mesh, u.device
    gf = geom_factors_for(fes, nq1d, dtype, dev)
    g = phys_grad_at_quad(fes, u, nq1d, dtype)            # (ne, nq, dim)
    ne, nq, dim = g.shape
    nv = mesh.nv
    patch, pw = _vertex_patches(mesh)
    pmax = patch.shape[1]
    patch_t = torch.as_tensor(patch, device=dev)
    kw = dict(dtype=g.dtype, device=dev)

    xs = gf.x[patch_t].reshape(nv, pmax * nq, dim)
    gs = g[patch_t].reshape(nv, pmax * nq, dim)
    ws = (gf.wdet[patch_t] * torch.as_tensor(pw, **kw)[:, :, None]).reshape(
        nv, pmax * nq)
    dx = xs - torch.as_tensor(mesh.vertices[:, :dim], **kw)[:, None, :]
    phi = torch.cat([torch.ones_like(ws)[..., None], dx], dim=-1)   # (nv, S, dim+1)
    M = torch.einsum("vs,vsi,vsj->vij", ws, phi, phi)
    rhs = torch.einsum("vs,vsi,vsd->vid", ws, phi, gs)
    # regularize degenerate corners (few samples): the affine term dominates
    M = M + 1e-12 * torch.eye(dim + 1, **kw)[None]
    Gv = torch.linalg.solve(M, rhs)[:, 0, :]               # (nv, dim)

    d2q = fes.dof_to_quad(nq1d)
    S = torch.as_tensor(_vertex_basis_at(mesh.geom, np.asarray(d2q.points)), **kw)
    Gq = torch.einsum("qn,end->eqd", S, Gv[torch.as_tensor(mesh.elements, device=dev)])
    eta2 = torch.sum(gf.wdet * torch.sum((Gq - g) ** 2, dim=-1), dim=1)
    return _to_numpy(eta2)


def _vertex_basis_at(geom, pts: np.ndarray) -> np.ndarray:
    """Linear vertex shape functions (element vertex order) at ref points."""
    from .geometry import REF_VERTS, Geometry

    if geom in (Geometry.TRIANGLE, Geometry.TETRAHEDRON):
        lam0 = 1.0 - pts.sum(axis=1)
        return np.concatenate([lam0[:, None], pts], axis=1)
    rv = np.asarray(REF_VERTS[geom])
    S = np.ones((len(pts), len(rv)))
    for n, v in enumerate(rv):
        for d in range(rv.shape[1]):
            S[:, n] *= np.where(v[d] > 0.5, pts[:, d], 1.0 - pts[:, d])
    return S
