"""Matérn / Whittle Gaussian random fields by the fractional SPDE
(counterpart of ``cardiac_ablation_ecm2_tpu/models/spde.py``; MFEM's
``miniapps/spde``):

    A^α u = η W,   A = 1 − (ℓ²/(2ν)) Δ,   α = (ν + d/2)/2,

with W white noise (``ops/linearform.white_noise_lf``) and η the
normalisation that makes the marginal variance 1.  The fractional part of
α is the sinc-quadrature sum of ``linalg/fractional.py``, the integer part
repeated (A, M) solves; every solve is Jacobi-PCG on the partially
assembled operators.  The white-noise draws come in as ``w`` or from a
``torch.Generator`` (the JAX package draws from ``jax.random``).
``device=None`` is the card.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..linalg.fractional import fractional_apply
from ..linalg.solvers import cg
from ..ops.bilinearform import BilinearForm
from ..ops.linearform import white_noise_lf
from ..utils.config import real_t, resolve_device


def matern_normalization(nu: float, ell: float, dim: int) -> float:
    """η = sqrt((2π)^{d/2} √det Θ · Γ(ν + d/2) / (ν^{d/2} Γ(ν))), Θ = ℓ²I."""
    det_theta = ell ** (2 * dim)
    return math.sqrt(
        (2 * math.pi) ** (dim / 2) * math.sqrt(det_theta)
        * math.gamma(nu + dim / 2) / (nu ** (dim / 2) * math.gamma(nu)))


def sample_matern_field(fes, w: Optional[torch.Tensor] = None,
                        nu: float = 1.0, ell: float = 0.1,
                        num: Optional[int] = None, bc: str = "dirichlet",
                        rel_tol: float = 1e-10, lam_max: float = 1e6,
                        generator: Optional[torch.Generator] = None,
                        dtype=None, device=None):
    """Sample(s) of the Matérn(ν, ℓ) field on ``fes``: (ndof,) for
    ``num=None`` else (num, ndof).  ``w`` is the (ne, nd, num or 1)
    standard normal draw (see ``white_noise_lf``).  ``bc="dirichlet"``
    pins the boundary to 0, ``"neumann"`` leaves the natural condition."""
    dev = resolve_device(device)
    rt = real_t(dtype)
    dim = fes.mesh.dim
    alpha = (nu + dim / 2.0) / 2.0
    eta = matern_normalization(nu, ell, dim)
    kappa = ell ** 2 / (2 * nu)

    A = (BilinearForm(fes, dev).add_domain_integrator("diffusion", kappa)
         .add_domain_integrator("mass").assemble(dtype))
    M = BilinearForm(fes, dev).add_domain_integrator("mass").assemble(dtype)
    m = torch.ones(fes.ndof_scalar, dtype=rt, device=dev)
    if bc == "dirichlet":
        m[torch.as_tensor(fes.essential_dofs(), device=dev)] = 0.0
    Am = lambda v: A.mult(v * m) * m + v * (1 - m)
    Mm = lambda v: M.mult(v * m) * m + v * (1 - m)
    dA = A.diagonal() * m + (1 - m)
    dM = M.diagonal() * m + (1 - m)

    b = eta * white_noise_lf(fes, w, num=num, generator=generator,
                             dtype=dtype, device=dev)
    n_int = int(np.floor(alpha))
    s_frac = alpha - n_int

    def one(bi):
        u, _ = cg(Mm, bi * m, M=lambda r: r / dM, rel_tol=rel_tol,
                  max_iter=4000)
        if s_frac > 1e-12:
            u = fractional_apply(Am, Mm, dA, dM, s_frac, u, lam_min=1.0,
                                 lam_max=lam_max, rel_tol=rel_tol)
        for _ in range(n_int):
            u, _ = cg(Am, Mm(u), M=lambda r: r / dA, rel_tol=rel_tol,
                      max_iter=4000)
        return u

    if num is None:
        return one(b)
    return torch.stack([one(b[i]) for i in range(num)])
