"""Integration rules (numpy copy of the tensor-product and simplex parts of
``cardiac_ablation_ecm2_tpu/fem/intrules.py``).

Rules are computed on the host in float64 on the reference interval [0, 1].
A rule of ``n`` Gauss points integrates polynomials of degree ``2n-1``
exactly; Gauss-Lobatto of ``n`` points integrates degree ``2n-3``.  Simplex
rules are conical products of Gauss-Jacobi factors through the Duffy
collapse.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
from numpy.polynomial import legendre as npleg


@functools.lru_cache(maxsize=None)
def gauss_legendre_1d(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0,1] → (points, weights), float64."""
    if n < 1:
        raise ValueError("need n >= 1 quadrature points")
    x, w = npleg.leggauss(n)  # on [-1,1]
    return (x + 1.0) / 2.0, w / 2.0


@functools.lru_cache(maxsize=None)
def gauss_lobatto_1d(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Lobatto-Legendre rule on [0,1] (endpoints included).

    Interior points are the roots of P'_{n-1}; weights
    w_i = 2 / (n(n-1) P_{n-1}(x_i)^2) on [-1,1], halved for [0,1].
    """
    if n < 2:
        if n == 1:
            return np.array([0.5]), np.array([1.0])
        raise ValueError("need n >= 1 points")
    c = np.zeros(n)
    c[-1] = 1.0
    dc = npleg.legder(c)
    xi = npleg.legroots(dc)
    x = np.concatenate([[-1.0], np.sort(xi), [1.0]])
    Pn = npleg.legval(x, c)
    w = 2.0 / (n * (n - 1) * Pn**2)
    return (x + 1.0) / 2.0, w / 2.0


@functools.lru_cache(maxsize=None)
def tensor_rule(dim: int, nq1d: int) -> Tuple[np.ndarray, np.ndarray]:
    """Tensor-product Gauss rule on the unit quad/hex.

    Returns (points (nq, dim), weights (nq,)) in lexicographic order, the
    first coordinate fastest (q = qx + nq1d*(qy + nq1d*qz)).
    """
    x, w = gauss_legendre_1d(nq1d)
    if dim == 1:
        return x[:, None].copy(), w.copy()
    if dim == 2:
        X, Y = np.meshgrid(x, x, indexing="ij")
        pts = np.stack([X.ravel(order="F"), Y.ravel(order="F")], axis=1)
        wts = np.outer(w, w).ravel(order="F")
        return pts, wts
    if dim == 3:
        X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
        pts = np.stack(
            [X.ravel(order="F"), Y.ravel(order="F"), Z.ravel(order="F")], axis=1
        )
        wts = np.einsum("i,j,k->ijk", w, w, w).ravel(order="F")
        return pts, wts
    raise ValueError(f"unsupported dim {dim}")


def gauss_jacobi_1d(n: int, alpha: int) -> Tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Jacobi rule for the weight (1-x)^alpha on [0,1],
    integer alpha (Golub-Welsch on the Jacobi matrix)."""
    a, b = float(alpha), 0.0
    n = int(n)
    k = np.arange(n, dtype=np.float64)
    denom = (2.0 * k + a + b) * (2.0 * k + a + b + 2.0)
    A = np.zeros(n)
    if n > 0:
        A[0] = (b - a) / (a + b + 2.0)
    if n > 1:
        A[1:] = (b**2 - a**2) / denom[1:]
    kk = np.arange(1.0, n)
    B = (
        4.0
        * kk
        * (kk + a)
        * (kk + b)
        * (kk + a + b)
        / ((2.0 * kk + a + b) ** 2 * ((2.0 * kk + a + b) ** 2 - 1.0))
    )
    J = np.diag(A) + np.diag(np.sqrt(B), 1) + np.diag(np.sqrt(B), -1)
    x, V = np.linalg.eigh(J)
    mu0_m11 = 2.0 ** (a + 1.0) / (a + 1.0)  # ∫_{-1}^{1} (1-x)^a dx
    w = mu0_m11 * V[0, :] ** 2
    # [-1,1] → [0,1]: the weight scales by 1/2^{a+1}
    return (x + 1.0) / 2.0, w / (2.0 ** (a + 1.0))


@functools.lru_cache(maxsize=None)
def simplex_rule(dim: int, order: int) -> Tuple[np.ndarray, np.ndarray]:
    """Quadrature on the unit triangle/tet exact to polynomial ``order``:
    triangle = GJ(1) ⊗ GL, tet = GJ(2) ⊗ GJ(1) ⊗ GL, n = order//2 + 1
    points per direction."""
    n = order // 2 + 1
    if dim == 2:
        xu, wu = gauss_jacobi_1d(n, 1)   # weight (1-u)
        xv, wv = gauss_legendre_1d(n)
        U, V = np.meshgrid(xu, xv, indexing="ij")
        pts = np.stack([U.ravel(), ((1.0 - U) * V).ravel()], axis=1)
        return pts, np.outer(wu, wv).ravel()
    if dim == 3:
        xu, wu = gauss_jacobi_1d(n, 2)   # weight (1-u)^2
        xv, wv = gauss_jacobi_1d(n, 1)   # weight (1-v)
        xt, wt = gauss_legendre_1d(n)
        U, V, T = np.meshgrid(xu, xv, xt, indexing="ij")
        x = U
        y = (1.0 - U) * V
        z = (1.0 - U) * (1.0 - V) * T
        w = np.einsum("i,j,k->ijk", wu, wv, wt)
        pts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
        return pts, w.ravel()
    raise ValueError(f"unsupported simplex dim {dim}")
