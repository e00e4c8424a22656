"""Right-hand-side assembly over the domain (``domain_lf`` and
``domain_lf_from_qvec`` of ``cardiac_ablation_ecm2_tpu/ops/linearform.py``;
MFEM's ``DomainLFIntegrator`` and ``QuadratureLFIntegrator``).

(f, v) = Rᵀ Bᵀ (w·detJ·f(x_q)): the transposed basis contraction on the
space's cached geometric factors and basis, then the restriction's E→L sum
(``fem/build.py``; the segment-sum kernel on the card).  Every function
runs on ``device`` (``None``: the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.coefficient import eval_coeff
from ..fem.quadinterp import eval_values_t


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
