"""Complex-valued FEM in the 2×2 real block form (counterpart of
``cardiac_ablation_ecm2_tpu/ops/complex_fem.py``; MFEM's
``ComplexOperator``, ``SesquilinearForm`` and ``ComplexGridFunction``, ex22).

A complex dof vector is the stacked real pair ``z = [x_r; x_i]`` (2n,) and
A = A_r + i A_i acts as one of the two real block forms:

    HERMITIAN        y = [A_r x_r − A_i x_i;  A_i x_r + A_r x_i]
    BLOCK_SYMMETRIC  y = [A_r x_r − A_i x_i; −A_i x_r − A_r x_i]

(BLOCK_SYMMETRIC computes conj(A x)).  Both parts are ordinary real
operators (``PAOperator``, ``LinearOperator`` or any ``.mult`` object), so
there is no complex arithmetic on the device: two real streams, each
through the port's kernels.  The H(curl)/H(div) cases (ex22 problem 1,
ex25 with a PML) build the two parts with ``ops/vecfe.build_nd_operator``
/ ``build_rt_operator``, the complex coefficients split into real and
imaginary (matrix) callables, and wrap them in :class:`ComplexOperator`;
``complex_jacobi`` takes their diagonals.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .bilinearform import BilinearForm
from .operators import LinearOperator

HERMITIAN = "hermitian"
BLOCK_SYMMETRIC = "block_symmetric"


def _mult_of(op):
    if op is None:
        return None
    return op.mult if hasattr(op, "mult") else op


def cstack(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Stack real/imag parts into the (2n,) block vector."""
    return torch.cat([xr, xi])


def csplit(z: torch.Tensor):
    n = z.shape[0] // 2
    return z[:n], z[n:]


@dataclasses.dataclass(frozen=True, eq=False)
class ComplexOperator:
    """A = A_r + i A_i acting on stacked ``[x_r; x_i]`` (2n,) vectors.
    Either part may be None (zero).  ``diagonal_parts`` returns the real
    pair (d_r, d_i) for the 2×2-block Jacobi preconditioner."""

    op_r: object
    op_i: object
    n: int
    convention: str = HERMITIAN

    def __post_init__(self):
        if self.convention not in (HERMITIAN, BLOCK_SYMMETRIC):
            raise ValueError(self.convention)

    def mult(self, z: torch.Tensor) -> torch.Tensor:
        xr, xi = z[: self.n], z[self.n:]
        mr, mi = _mult_of(self.op_r), _mult_of(self.op_i)
        yr = mr(xr) if mr is not None else torch.zeros_like(xr)
        yi = mr(xi) if mr is not None else torch.zeros_like(xi)
        if mi is not None:
            yr = yr - mi(xi)
            yi = yi + mi(xr)
        if self.convention == BLOCK_SYMMETRIC:
            yi = -yi
        return torch.cat([yr, yi])

    def __call__(self, z):
        return self.mult(z)

    @property
    def shape(self):
        return (2 * self.n, 2 * self.n)

    def diagonal_parts(self):
        d_r = self.op_r.diagonal() if self.op_r is not None else None
        d_i = self.op_i.diagonal() if self.op_i is not None else None
        if d_r is None:
            d_r = torch.zeros_like(d_i) if d_i is not None else torch.zeros(
                self.n, dtype=torch.float64)
        if d_i is None:
            d_i = torch.zeros_like(d_r)
        return d_r, d_i

    def operator(self) -> LinearOperator:
        return LinearOperator(self.shape, self.mult)


def complex_jacobi(A: ComplexOperator, ess_mask=None) -> Callable:
    """2×2-block Jacobi: per dof the inverse of the complex diagonal
    d_r + i d_i.

    HERMITIAN block  [d_r, −d_i; d_i, d_r]   → inv = [d_r, d_i; −d_i, d_r]/Δ
    BLOCK_SYMMETRIC  [d_r, −d_i; −d_i, −d_r] → inv = [d_r, −d_i; −d_i, −d_r]/Δ
    with Δ = d_r² + d_i².  ``ess_mask`` (n,) 1.0 at essential dofs makes
    those rows identity (matching the constrained operator)."""
    d_r, d_i = A.diagonal_parts()
    if ess_mask is not None:
        m = torch.as_tensor(ess_mask, dtype=d_r.dtype, device=d_r.device)
        d_r = d_r * (1.0 - m) + m
        d_i = d_i * (1.0 - m)
    delta = d_r * d_r + d_i * d_i
    delta = torch.where(delta == 0, torch.ones_like(delta), delta)
    herm = A.convention == HERMITIAN

    def prec(z):
        rr, ri = z[: A.n], z[A.n:]
        if herm:
            return torch.cat([(d_r * rr + d_i * ri) / delta,
                              (-d_i * rr + d_r * ri) / delta])
        return torch.cat([(d_r * rr - d_i * ri) / delta,
                          (-d_i * rr - d_r * ri) / delta])

    return prec


@dataclasses.dataclass(frozen=True, eq=False)
class ComplexConstrainedOperator:
    """Essential-BC wrap of a ComplexOperator (the FormLinearSystem path):
    the same dofs are constrained in both halves, with identity rows
    (−identity in the bottom half under BLOCK_SYMMETRIC, so the eliminated
    block stays symmetric)."""

    A: ComplexOperator
    mask: torch.Tensor          # (n,) 0.0 at constrained dofs

    @staticmethod
    def wrap(A: ComplexOperator, ess_dofs, device=None) -> "ComplexConstrainedOperator":
        m = np.ones(A.n)
        ess = np.asarray(ess_dofs)
        if ess.size:
            m[ess] = 0.0
        return ComplexConstrainedOperator(A=A, mask=torch.as_tensor(m, device=device))

    @property
    def shape(self):
        return self.A.shape

    def _m2(self, dtype):
        m = self.mask.to(dtype)
        return torch.cat([m, m])

    def _sign(self, dtype):
        s = torch.ones(self.A.n, dtype=dtype, device=self.mask.device)
        return torch.cat([s, -s if self.A.convention == BLOCK_SYMMETRIC else s])

    def mult(self, z: torch.Tensor) -> torch.Tensor:
        m2 = self._m2(z.dtype)
        w = z * m2
        return self.A.mult(w) * m2 + (z - w) * self._sign(z.dtype)

    def __call__(self, z):
        return self.mult(z)

    def eliminate_rhs(self, z_bc: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Fold the BC values (both halves) into the block RHS."""
        m2 = self._m2(z_bc.dtype)
        w = z_bc * (1.0 - m2)
        return (b - self.A.mult(w)) * m2 + w * self._sign(z_bc.dtype)


def form_complex_linear_system(A: ComplexOperator, ess_dofs, z_bc: torch.Tensor,
                               b: torch.Tensor):
    """SesquilinearForm::FormLinearSystem: returns (A_constrained, B); the
    solution Z of A_constrained Z = B has Z[ess] = z_bc[ess] in both
    halves."""
    Ac = ComplexConstrainedOperator.wrap(A, ess_dofs, device=b.device)
    return Ac, Ac.eliminate_rhs(z_bc, b)


class SesquilinearForm:
    """Paired-integrator front end for scalar H1 spaces
    (``SesquilinearForm``): ``add_domain_integrator(kind, coeff_real,
    coeff_imag)`` mirrors ``AddDomainIntegrator(bfi_real, bfi_imag)``;
    None for a side omits that part.  ``device=None`` is the card."""

    def __init__(self, fes, convention: str = HERMITIAN,
                 nq1d: Optional[int] = None, device=None):
        self.fes = fes
        self.convention = convention
        self._br = BilinearForm(fes, device, nq1d)
        self._bi = BilinearForm(fes, device, nq1d)
        self._has_r = False
        self._has_i = False

    def add_domain_integrator(self, kind: str, coeff_real=None, coeff_imag=None,
                              **kw):
        if coeff_real is None and coeff_imag is None:
            raise ValueError("at least one of coeff_real/coeff_imag")
        if coeff_real is not None:
            self._br.add_domain_integrator(kind, coeff_real, **kw)
            self._has_r = True
        if coeff_imag is not None:
            self._bi.add_domain_integrator(kind, coeff_imag, **kw)
            self._has_i = True
        return self

    def add_boundary_integrator(self, kind: str, coeff_real=None, coeff_imag=None,
                                marker=None):
        if coeff_real is not None:
            self._br.add_boundary_integrator(kind, coeff_real, marker=marker)
            self._has_r = True
        if coeff_imag is not None:
            self._bi.add_boundary_integrator(kind, coeff_imag, marker=marker)
            self._has_i = True
        return self

    def assemble(self, dtype=None) -> ComplexOperator:
        op_r = self._br.assemble(dtype).operator() if self._has_r else None
        op_i = self._bi.assemble(dtype).operator() if self._has_i else None
        return ComplexOperator(op_r=op_r, op_i=op_i, n=self.fes.ndof,
                               convention=self.convention)


@dataclasses.dataclass(eq=False)
class ComplexGridFunction:
    """(real, imag) dof pair (``ComplexGridFunction``)."""

    fes: object
    re: torch.Tensor
    im: torch.Tensor

    @staticmethod
    def zero(fes, dtype=None, device=None) -> "ComplexGridFunction":
        from ..utils.config import real_t, resolve_device

        z = torch.zeros(fes.ndof, dtype=real_t(dtype), device=resolve_device(device))
        return ComplexGridFunction(fes, z, z)

    @staticmethod
    def project(fes, f_real: Callable, f_imag: Callable, dtype=None,
                device=None) -> "ComplexGridFunction":
        from ..fem.gridfunction import project

        return ComplexGridFunction(fes, project(fes, f_real, dtype, device),
                                   project(fes, f_imag, dtype, device))

    def vec(self) -> torch.Tensor:
        return cstack(self.re, self.im)

    @staticmethod
    def from_vec(fes, z: torch.Tensor) -> "ComplexGridFunction":
        n = z.shape[0] // 2
        return ComplexGridFunction(fes, z[:n], z[n:])

    def l2_error(self, exact_real: Callable, exact_imag: Callable,
                 nq1d=None) -> float:
        from ..fem.gridfunction import l2_error

        er = float(l2_error(self.fes, self.re, exact_real, nq1d, self.re.dtype))
        ei = float(l2_error(self.fes, self.im, exact_imag, nq1d, self.im.dtype))
        return float(np.sqrt(er * er + ei * ei))
