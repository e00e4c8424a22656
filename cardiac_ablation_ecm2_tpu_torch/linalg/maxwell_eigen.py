"""Maxwell cavity eigensolver: LOBPCG with the gradient projection of
hypre's ``HypreAME`` (counterpart of
``cardiac_ablation_ecm2_tpu/linalg/maxwell_eigen.py``):

    (curl E, curl F) = λ (E, F),   n × E = 0 on the PEC boundary.

The block is kept M-orthogonal to the discrete gradients by

    P = I − M⁻¹ Gₘ A₁⁻¹ Gₘᵀ,   A₁ = (∇u, ∇v) on H1 with matching BCs,

with Gₘ = (∇u, v) the mixed integrator (``ops/mixed_vecfe``).  Each
projection is one H1-diffusion CG and one ND-mass CG, Jacobi-PCG, run
eagerly.  The port's ``lobpcg`` draws its own start: pass JAX's start
block as ``X0`` to start where the JAX package starts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.bilinearform import BilinearForm
from ..ops.mixed_vecfe import mixed_vector_gradient
from ..ops.vecfe import build_nd_operator
from ..utils.config import real_t, resolve_device
from .lobpcg import lobpcg
from .solvers import cg


@dataclasses.dataclass
class MaxwellEigResult:
    eigenvalues: np.ndarray       # (k,) ascending, gradients removed
    eigenvectors: torch.Tensor    # (ndof, k) ND coefficients
    iterations: int


def maxwell_eigenvalues(nd_space, h1_fes, k: int = 5,
                        ess_bdr: Optional[Sequence[int]] = "all",
                        nq1d: Optional[int] = None, iters: int = 60,
                        inner_tol: float = 1e-10, seed: int = 0, dtype=None,
                        sigma=None, X0: Optional[torch.Tensor] = None,
                        device=None) -> MaxwellEigResult:
    """Smallest k nonzero Maxwell eigenvalues on an ND space; ``h1_fes``
    the H1 space of the same order on the same mesh; ``ess_bdr="all"``
    PEC on every boundary attribute; ``sigma`` an optional (d×d)
    permittivity for (curl E, curl F) = λ (σE, F); ``device=None`` is the
    card."""
    device = resolve_device(device)
    rt = real_t(dtype)
    mesh = nd_space.mesh
    if nq1d is None:
        nq1d = getattr(nd_space, "order", 1) + 2
    kw = dict(nq1d=nq1d, dtype=dtype, device=device)
    A = build_nd_operator(nd_space, mass_coeff=None, curlcurl_coeff=1.0, **kw)
    M = build_nd_operator(nd_space, mass_coeff=(1.0 if sigma is None else sigma),
                          curlcurl_coeff=None, **kw)
    Gm = mixed_vector_gradient(h1_fes, nd_space, matrix_coeff=sigma, **kw)
    sig_cb = None
    if sigma is not None:
        sig_t = torch.as_tensor(np.asarray(sigma, dtype=np.float64), dtype=rt,
                                device=device)

        def sig_cb(x):
            return sig_t.expand(x.shape[:-1] + sig_t.shape)

    A1 = BilinearForm(h1_fes, device, nq1d=nq1d) \
        .add_domain_integrator("diffusion", coeff=sig_cb).assemble(dtype=dtype)

    if ess_bdr == "all":
        ess_bdr = sorted(set(mesh.bdr_attributes.tolist())) if mesh.nbe else []
    ess_nd = nd_space.essential_dofs(ess_bdr) if ess_bdr else np.zeros(0, np.int32)
    ess_h1 = h1_fes.essential_dofs(ess_bdr) if ess_bdr else np.zeros(0, np.int32)

    def mask(n, ess):
        m = torch.ones(n, dtype=rt, device=device)
        return m.index_fill(0, torch.as_tensor(ess, dtype=torch.int64, device=device), 0.0)

    m_nd = mask(A.ndof, ess_nd)
    m_h1 = mask(h1_fes.ndof_scalar, ess_h1)
    dM = M.diagonal() * m_nd + (1 - m_nd)
    dA1 = A1.diagonal() * m_h1 + (1 - m_h1)

    def Amult(v):
        return A.mult(v * m_nd) * m_nd

    def Mmult(v):
        return M.mult(v * m_nd) * m_nd

    def Msolve(b):
        x, _ = cg(lambda v: Mmult(v) + (1 - m_nd) * v, b, M=lambda r: r / dM,
                  rel_tol=inner_tol, max_iter=2000)
        return x

    def A1solve(b):
        def op(v):
            return A1.mult(v * m_h1) * m_h1 + (1 - m_h1) * v

        x, _ = cg(op, b * m_h1, M=lambda r: r / dA1, rel_tol=inner_tol,
                  max_iter=2000)
        return x * m_h1

    def project(x):
        """x ← x − M⁻¹ Gₘ A₁⁻¹ Gₘᵀ x, then the PEC dofs masked."""
        x = x * m_nd
        y = A1solve(Gm.mult_t(x))
        return (x - Msolve(Gm.mult(y) * m_nd)) * m_nd

    # Jacobi on A + M keeps the preconditioner SPD despite A's nullspace
    dAM = (A.diagonal() + M.diagonal()) * m_nd + (1 - m_nd)
    res = lobpcg(Amult, Mmult, A.ndof, k, precond=lambda v: v / dAM, iters=iters,
                 seed=seed, dtype=rt, X0=None if X0 is None else X0.to(device),
                 constraint=project, device=device)
    return MaxwellEigResult(eigenvalues=res.eigenvalues.detach().cpu().numpy(),
                            eigenvectors=res.eigenvectors, iterations=iters)
