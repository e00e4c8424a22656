"""LOBPCG for the smallest eigenpairs of A x = λ M x (counterpart of
``cardiac_ablation_ecm2_tpu/linalg/lobpcg.py``; MFEM's ``HypreLOBPCG``,
used by ex11 / ex12 / ex13).

Matrix-free locally optimal block PCG: block Rayleigh–Ritz in [X, W, P]
with an eigenvalue-filtered M-orthonormal basis and a fixed number of
iterations.  The operators act on single vectors; a block is applied one
column at a time (the JAX package's ``jax.vmap`` over columns).  The
(3k × 3k) dense work is ``torch.linalg`` on the vectors' device; the
Rayleigh–Ritz step reads the kept basis size on the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class EigResult(NamedTuple):
    eigenvalues: torch.Tensor    # (k,)
    eigenvectors: torch.Tensor   # (n, k), M-orthonormal
    residuals: torch.Tensor      # (k,) final ‖A x − λ M x‖


def _apply_cols(op: Callable, V: torch.Tensor) -> torch.Tensor:
    return torch.stack([op(V[:, j]) for j in range(V.shape[1])], dim=1)


def _m_orthonormalize(V, Mmult):
    G = V.T @ _apply_cols(Mmult, V)
    L = torch.linalg.cholesky(G + 1e-14 * torch.eye(G.shape[0], dtype=G.dtype,
                                                    device=G.device))
    return torch.linalg.solve_triangular(L, V.T, upper=False).T


def lobpcg(
    A: Callable,
    M: Optional[Callable],
    n: int,
    k: int,
    precond: Optional[Callable] = None,
    iters: int = 50,
    seed: int = 0,
    dtype=torch.float64,
    X0: Optional[torch.Tensor] = None,
    constraint: Optional[Callable] = None,
    device=None,
) -> EigResult:
    """Smallest k eigenpairs of A x = λ M x (M None: the identity).

    ``X0`` is the (n, k) start; without it a standard normal block is drawn
    on the CPU from a ``torch.Generator`` seeded with ``seed`` and moved to
    ``device`` (``None``: the card).  The JAX package draws
    ``jax.random.normal(PRNGKey(seed))``, which this cannot reproduce: pass
    that block as ``X0`` to start where JAX starts.  ``constraint`` projects
    onto the admissible subspace (HypreLOBPCG::SetSubSpaceProjector); it is
    applied to the start and to every expansion direction."""
    from ..utils.config import resolve_device

    Mmult = M if M is not None else (lambda v: v)
    prec = precond if precond is not None else (lambda v: v)
    proj = constraint if constraint is not None else (lambda v: v)

    if X0 is None:
        gen = torch.Generator().manual_seed(seed)
        X = torch.randn((n, k), generator=gen, dtype=dtype).to(resolve_device(device))
    else:
        X = X0.to(dtype)
    X = _m_orthonormalize(_apply_cols(proj, X), Mmult)
    P = torch.zeros_like(X)
    def rayleigh_ritz(S):
        # rank-revealing M-orthonormalisation: the null directions of the
        # basis (the zero P block of the first iteration) are dropped.  JAX
        # keeps them with zero weight and a 1e30 diagonal in H, which ranks
        # them last in exact arithmetic, but a dense eigensolver's absolute
        # error scales with that 1e30; the Ritz pairs of the kept block are
        # the same
        G = S.T @ _apply_cols(Mmult, S)
        G = 0.5 * (G + G.T)
        w, Q = torch.linalg.eigh(G)
        keep = torch.nonzero(w > 1e-12 * torch.max(w)).squeeze(1)
        Sb = S @ (Q[:, keep] / torch.sqrt(torch.abs(w[keep]) + 1e-300)[None, :])
        H = Sb.T @ _apply_cols(A, Sb)
        mu, Z = torch.linalg.eigh(0.5 * (H + H.T))
        return Sb @ Z[:, :k], mu[:k]

    lam = torch.ones(k, dtype=dtype, device=X.device)
    for _ in range(iters):
        R = _apply_cols(A, X) - _apply_cols(Mmult, X) * lam[None, :]
        W = _apply_cols(proj, _apply_cols(prec, R))
        Xn, lam = rayleigh_ritz(torch.cat([X, W, P], dim=1))
        P = Xn - X @ (X.T @ _apply_cols(Mmult, Xn))
        X = Xn

    R = _apply_cols(A, X) - _apply_cols(Mmult, X) * lam[None, :]
    return EigResult(eigenvalues=lam, eigenvectors=X,
                     residuals=torch.sqrt(torch.sum(R * R, dim=0)))
