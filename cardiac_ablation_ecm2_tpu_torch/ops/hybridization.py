"""Hybridization for H(div) problems: face multipliers and batched local
elimination (counterpart of ``cardiac_ablation_ecm2_tpu/ops/hybridization.py``;
MFEM's ``Hybridization``).

The broken space is the E-vector: each element owns private copies of its
canonical face dofs, and continuity is the constraint "the two copies of
each interior face dof agree", a ±1 incidence C derived from the gather
map alone (a canonical dof in exactly two (element, slot) pairs gets one
multiplier).  With A block-diagonal per element:

    H λ = C A⁻¹ b,   H = C A⁻¹ Cᵀ (SPD),   u = A⁻¹(b − Cᵀ λ)

one batched Cholesky factorization (``torch.linalg.cholesky`` on
(ne, ndl, ndl)), then CG on the interface system.  C and Cᵀ are a signed
``ElementRestriction`` over the (ne, ndl) multiplier map into nlam + 1
dofs, the last a trash slot for the slots without a multiplier: Cᵀ is its
L→E gather, C its ``segment_sum``.  The final average of the two copies
is two ``segment_sum``s on the space's own restriction.  Essential
(normal-trace) dofs are eliminated inside the element blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..fem.restriction import ElementRestriction
from ..linalg.solvers import cg
from ..utils.config import real_t
from .vecfe import VecFEOperator, eval_basis_t, host_points


def _elem_rhs(op: VecFEOperator, vec_fn):
    """Per-element (f, φ) in canonical dofs (the linear form before its
    scatter)."""
    _, B = op.term("mass")
    c = torch.as_tensor(vec_fn(host_points(op.gf)), dtype=B.dtype, device=B.device)
    return op._post(eval_basis_t(B, op.gf.wdet[..., None] * c))


@dataclasses.dataclass(eq=False)
class HybridizedHdiv:
    """Hybridized SPD H(div) solver state."""

    space: object
    op: VecFEOperator
    chol: torch.Tensor            # (ne, ndl, ndl) Cholesky factors
    lam: ElementRestriction       # (ne, ndl) multiplier map into nlam + 1
    lam_sign: torch.Tensor        # (ne, ndl) ±1 / 0
    nlam: int
    ess_mask: torch.Tensor        # (ne, ndl) 0 at essential slots
    bc_vals: torch.Tensor         # (ne, ndl) essential values
    bc_fix: torch.Tensor          # (ne, ndl) A_canon @ ((1 − m)·bc)

    def _Ainv(self, r):
        return torch.cholesky_solve(r[..., None], self.chol)[..., 0]

    def _CT(self, lam):
        """Multipliers → per-element vector (signed copies at face slots)."""
        return self.lam.mult(torch.cat([lam, lam.new_zeros(1)])) * self.lam_sign

    def _C(self, u):
        """Per-element vector → the jumps at interior faces."""
        return self.lam.mult_transpose(u * self.lam_sign)[: self.nlam]

    def solve(self, vec_fn, rel_tol=1e-10, max_iter=2000):
        """Solve A u = (f, φ) with continuity and the essential BCs
        (``vec_fn`` of host numpy points); returns (u, λ, SolveInfo of the
        interface CG)."""
        m = self.ess_mask
        b = (_elem_rhs(self.op, vec_fn) - self.bc_fix) * m + self.bc_vals * (1 - m)
        rhs = self._C(self._Ainv(b))

        def H(lam):
            return self._C(self._Ainv(self._CT(lam)))

        lam, info = cg(H, rhs, rel_tol=rel_tol, max_iter=max_iter)
        u_e = self._Ainv(b - self._CT(lam))
        # the copies agree to the solver's tolerance: average them
        r = self.op.restr
        return r.mult_transpose(u_e) / r.mult_transpose(torch.ones_like(u_e)), lam, info


def hybridize_hdiv(space, op: VecFEOperator, ess: Optional[np.ndarray] = None,
                   bc_vals=None, dtype=None) -> HybridizedHdiv:
    """The hybridized solver of an SPD ``VecFEOperator`` on an RT space
    (``RTSimplexSpace`` or ``RTSpaceHO``), on the operator's device.
    ``ess``: essential (normal trace) global dofs with optional values
    ``bc_vals`` (a global vector)."""
    rt = real_t(dtype)
    dev = op.device
    gm = np.asarray(space.gather_map, dtype=np.int64)
    ne, ndl = gm.shape

    # interior-face dofs: a canonical dof of exactly two (element, slot)
    # pairs gets a multiplier; the constraint is copy₁ − copy₂ = 0
    flat = gm.reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_ids = flat[order]
    uniq, start, counts = np.unique(sorted_ids, return_index=True, return_counts=True)
    shared = uniq[counts == 2]
    nlam = len(shared)
    lam_of_dof = np.full(int(flat.max()) + 1, -1, dtype=np.int64)
    lam_of_dof[shared] = np.arange(nlam)
    lam_elem = lam_of_dof[gm]
    run = np.searchsorted(uniq, sorted_ids)
    occ = np.arange(len(flat)) - start[run]
    sign = np.zeros(len(flat))
    sign[order] = np.where(counts[run] == 2, np.where(occ == 0, 1.0, -1.0), 0.0)
    lam_elem = np.where(lam_elem < 0, nlam, lam_elem)

    A_canon = op.canonical_elem_mats().to(rt)
    ess = np.zeros(0, np.int64) if ess is None else np.asarray(ess)
    m = torch.as_tensor(~np.isin(gm, ess), dtype=rt, device=dev)
    if bc_vals is not None:
        bc = np.asarray(bc_vals.detach().cpu() if torch.is_tensor(bc_vals) else bc_vals)
        bc_e = torch.as_tensor(bc[gm], dtype=rt, device=dev)
    else:
        bc_e = torch.zeros((ne, ndl), dtype=rt, device=dev)
    # the BC coupling moves to the RHS before the rows and columns are zeroed
    bc_fix = torch.einsum("enm,em->en", A_canon, bc_e * (1 - m))
    eye = torch.eye(ndl, dtype=rt, device=dev)
    A_canon = A_canon * m[:, :, None] * m[:, None, :] + eye[None] * (1 - m)[:, :, None]
    return HybridizedHdiv(
        space=space, op=op, chol=torch.linalg.cholesky(A_canon),
        lam=ElementRestriction(lam_elem, nlam + 1, dev),
        lam_sign=torch.as_tensor(sign.reshape(ne, ndl), dtype=rt, device=dev),
        nlam=nlam, ess_mask=m, bc_vals=bc_e, bc_fix=bc_fix)
