"""Lane-major (transposed) full-matrix PA applies (counterpart of
``cardiac_ablation_ecm2_tpu/ops/lanemajor.py``, 2D and 3D).

The E-vector is laid out ``(nd, ne)`` and every basis contraction is one
``(k·nq, nd) @ (nd, ne)`` matmul with the element axis as the long one.  On
tensor (hex) bases the full matrices are Kronecker products of the 1D
``B1``/``G1`` factors; E-vectors are lex-flat with x fastest, so the matrix
acting on a flattened ``(k, j, i)`` tensor is ``kron(Fz, Fy, Fx)`` (a
quad's ``(j, i)`` one ``kron(Fy, Fx)``).  Dense (simplex) bases already
are the full matrices ``B (nq, nd)`` and ``G (nq, nd, dim)``.  Packed
symmetric diffusion qdata is ``[00, 11, 22, 01, 02, 12]`` in 3D and
``[00, 11, 01]`` in 2D; convection qdata is the pulled-back velocity per
reference axis (``ops/convection.py``).

The contractions are ``torch.matmul`` in full float32 (TF32 is off, see
``utils/config.py``), as the JAX package leaves them to XLA at HIGHEST.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..fem.quadinterp import DeviceBasis


@dataclasses.dataclass(frozen=True, eq=False)
class LaneBasis:
    """Full (nq, nd) dofs→quads matrices; ``S`` stacks [B; G₀; …] into one
    ((1+dim)·nq, nd) matrix so values and gradients are one matmul, ``SG``
    the gradients alone."""

    Bf: torch.Tensor                  # (nq, nd)
    G: Tuple[torch.Tensor, ...]       # per reference axis, (nq, nd)
    S: torch.Tensor                   # ((1+dim)·nq, nd)
    SG: torch.Tensor                  # (dim·nq, nd)

    @property
    def nq(self) -> int:
        return self.Bf.shape[0]

    @property
    def dim(self) -> int:
        return len(self.G)


def lane_basis(db: DeviceBasis) -> LaneBasis:
    """The full matrices in the basis dtype: Kronecker products of a tensor
    basis' 1D factors (formed on the host from the device-dtype factors, as
    the JAX package forms them), or a dense basis' own ``B`` and
    ``G[:, :, d]``."""
    if db.tensor:
        B1 = db.B1.cpu().numpy()
        G1 = db.G1.cpu().numpy()
        dev = db.B1.device
        if db.dim == 2:
            Bf = np.kron(B1, B1)
            G = (np.kron(B1, G1), np.kron(G1, B1))
        else:
            Bf = np.kron(B1, np.kron(B1, B1))
            G = (np.kron(B1, np.kron(B1, G1)),
                 np.kron(B1, np.kron(G1, B1)),
                 np.kron(G1, np.kron(B1, B1)))
        Bft = torch.as_tensor(Bf, device=dev)
        Gt = tuple(torch.as_tensor(g, device=dev) for g in G)
    else:
        Bft = db.B
        Gt = tuple(db.G[:, :, d].contiguous() for d in range(db.dim))
    return LaneBasis(Bf=Bft, G=Gt, S=torch.cat((Bft,) + Gt, dim=0),
                     SG=torch.cat(Gt, dim=0))


def supports(db: DeviceBasis, qdata=None, kind: str = "",
             max_nd: int = 256) -> bool:
    """Whether the lane-major path applies: full matrices with nd ≤
    ``max_nd`` (n1^dim on a tensor basis, the columns of a dense one), and
    diffusion qdata in the packed (3|6, ne, nq) layout."""
    if db.tensor:
        nd = db.n1d ** db.dim
    elif db.B is not None and db.G is not None:
        nd = db.B.shape[1]
    else:
        return False
    if nd > max_nd:
        return False
    if kind == "diffusion" and qdata is not None:
        return qdata.dim() == 3 and qdata.shape[0] in (3, 6)
    return True


def mass_qT(qd: torch.Tensor) -> torch.Tensor:
    """(ne|1, nq) → (nq, ne|1), contiguous."""
    return qd.T.contiguous()


def diffusion_qT(qd_packed: torch.Tensor) -> torch.Tensor:
    """Packed symmetric (3|6, ne, nq) → (3|6, nq, ne), contiguous."""
    return qd_packed.permute(0, 2, 1).contiguous()


def convection_qT(qd: torch.Tensor) -> torch.Tensor:
    """(ne, nq, dim) → (dim, nq, ne), contiguous."""
    return qd.permute(2, 1, 0).contiguous()


_QT = {"mass": mass_qT, "diffusion": diffusion_qT, "convection": convection_qT}


def transpose_qdata(kind: str, qd: torch.Tensor) -> torch.Tensor:
    """Setup-time transpose of one integrator's qdata to the lane layout."""
    return _QT[kind](qd)


#: the (a, b) of each packed symmetric component, by dimension
PAIRS = {2: ((0, 0), (1, 1), (0, 1)),
         3: ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))}


def sym_flux(q, g):
    """Packed-symmetric D·g, elementwise in any layout: ``q`` the 3|6
    packed components, ``g`` the two or three gradient components."""
    if len(g) == 2:
        gx, gy = g
        return [q[0] * gx + q[2] * gy, q[2] * gx + q[1] * gy]
    gx, gy, gz = g
    return [
        q[0] * gx + q[3] * gy + q[4] * gz,
        q[3] * gx + q[1] * gy + q[5] * gz,
        q[4] * gx + q[5] * gy + q[2] * gz,
    ]


def mass_apply(lb: LaneBasis, qT: torch.Tensor, eT: torch.Tensor) -> torch.Tensor:
    """Bᵀ (q ∘ (B u)) on (nd, ne) E-vectors, ``qT`` (nq, ne|1)."""
    return lb.Bf.T @ (qT * (lb.Bf @ eT))


def diffusion_apply(lb: LaneBasis, qT: torch.Tensor,
                    eT: torch.Tensor) -> torch.Tensor:
    """Gᵀ (D ∘ (G u)), packed-symmetric ``qT`` (3|6, nq, ne|1): one stacked
    (dim·nq × nd) matmul each way."""
    t = lb.SG @ eT
    nq = lb.nq
    D = sym_flux(qT, [t[d * nq:(d + 1) * nq] for d in range(lb.dim)])
    return lb.SG.T @ torch.cat(D, dim=0)


def convection_apply(lb: LaneBasis, qT: torch.Tensor,
                     eT: torch.Tensor) -> torch.Tensor:
    """Bᵀ (q · (G u)), ``qT`` (dim, nq, ne)."""
    t = lb.SG @ eT
    nq = lb.nq
    s = qT[0] * t[:nq]
    for d in range(1, lb.dim):
        s = s + qT[d] * t[d * nq:(d + 1) * nq]
    return lb.Bf.T @ s


_APPLY = {"mass": mass_apply, "diffusion": diffusion_apply,
          "convection": convection_apply}


def mass_diffusion_apply(lb: LaneBasis, qmT: torch.Tensor, qdT: torch.Tensor,
                         eT: torch.Tensor, gamma=None) -> torch.Tensor:
    """Fused (M + γ K) v on (nd, ne) E-vectors: one stacked matmul
    evaluates values and gradients, one transposed stacked matmul
    accumulates; γ is folded into the flux.  ``qmT`` (nq, ne), ``qdT``
    (3|6, nq, ne)."""
    t = lb.S @ eT
    nq = lb.nq
    bu = t[:nq]
    g = [t[(1 + d) * nq:(2 + d) * nq] for d in range(lb.dim)]
    D = sym_flux(qdT, g)
    if gamma is not None:
        D = [gamma * d for d in D]
    return lb.S.T @ torch.cat([qmT * bu] + D, dim=0)


# ----------------------------------------------------------------------------
# affine fast path: separable qdata → reference-matrix apply
# ----------------------------------------------------------------------------
#
# With a constant Jacobian per element every qdata array separates as
# ``qT[..., q, e] = W[q] · d[..., e]`` (detected numerically at setup), and
# the element matrix is a fixed combination of reference matrices
#   K_e = Σ_c d_c[e] · K̂_c,   K̂_(a,b) = ĜₐᵀWĜ_b (+ sym),   M̂ = BᵀWB,
# so the apply is one (nd, 7·nd) @ (7·nd, ne) matmul.


@dataclasses.dataclass(frozen=True, eq=False)
class AffineOps:
    """Reference element matrices for the affine (separable-qdata) apply."""

    Mhat: torch.Tensor                 # (nd, nd)  BᵀWB
    Khat: Tuple[torch.Tensor, ...]     # packed-sym component matrices
    Chat: Tuple[torch.Tensor, ...]     # per reference axis BᵀWĜ_d


def affine_ops(db: DeviceBasis, lb: LaneBasis) -> AffineOps:
    """Reference matrices from float64 quadrature sums over the full
    matrices of the device-dtype basis (so a float32 run keeps the JAX
    package's bits), stored in the basis dtype."""
    Bf = lb.Bf.cpu().double().numpy()
    G = [g.cpu().double().numpy() for g in lb.G]
    W = db.W.cpu().double().numpy()
    Mhat = Bf.T @ (W[:, None] * Bf)
    Khat = []
    for a, b in PAIRS[lb.dim]:
        K = G[a].T @ (W[:, None] * G[b])
        if a != b:
            K = K + K.T
        Khat.append(K)
    Chat = [Bf.T @ (W[:, None] * g) for g in G]
    kw = dict(dtype=lb.Bf.dtype, device=lb.Bf.device)
    return AffineOps(Mhat=torch.as_tensor(Mhat, **kw),
                     Khat=tuple(torch.as_tensor(K, **kw) for K in Khat),
                     Chat=tuple(torch.as_tensor(C, **kw) for C in Chat))


def separable_collapse(qT: torch.Tensor, W: torch.Tensor,
                       rtol: float = 1e-5) -> Optional[torch.Tensor]:
    """If ``qT[..., q, e] == W[q] · d[..., e]`` to ``rtol``, return ``d``
    (trailing ne axis kept); else None."""
    r = qT / W[:, None]
    d = r.mean(dim=-2)
    scale = float(d.abs().max())
    if scale == 0.0:
        return torch.zeros_like(d)
    dev = float((r - d.unsqueeze(-2)).abs().max())
    return d if dev <= rtol * scale else None


def _scaled_rows(mats, scales, eT):
    """hstack(mats) @ vstack(scales_i ∘ eT) in one matmul."""
    Z = torch.cat([s[None, :] * eT for s in scales], dim=0)
    return torch.cat(mats, dim=1) @ Z


def affine_mass_diffusion_apply(af: AffineOps, dm, dk, eT,
                                gamma=None) -> torch.Tensor:
    """Fused (M + γ K) v: ``dm`` (ne,) mass factors (γ already folded in by
    the caller where needed), ``dk`` (3|6, ne) diffusion factors."""
    scales = [dm] + [dk[c] if gamma is None else gamma * dk[c]
                     for c in range(dk.shape[0])]
    return _scaled_rows((af.Mhat,) + af.Khat, scales, eT)


def affine_mass_apply(af: AffineOps, d: torch.Tensor,
                      eT: torch.Tensor) -> torch.Tensor:
    """M̂ @ (d ∘ eT); ``d`` is (ne|1,)."""
    return af.Mhat @ (d[None, :] * eT)


def affine_diffusion_apply(af: AffineOps, d: torch.Tensor,
                           eT: torch.Tensor) -> torch.Tensor:
    """Σ_c K̂_c @ (d_c ∘ eT) as one stacked matmul; ``d`` is (3|6, ne|1)."""
    return _scaled_rows(af.Khat, [d[c] for c in range(d.shape[0])], eT)


def affine_convection_apply(af: AffineOps, d: torch.Tensor,
                            eT: torch.Tensor) -> torch.Tensor:
    """Σ_d Ĉ_d @ (d_d ∘ eT); ``d`` is (dim, ne|1)."""
    return _scaled_rows(af.Chat, [d[c] for c in range(d.shape[0])], eT)


_AFF_MATS = {
    "mass": lambda af, d: (af.Mhat,),
    "diffusion": lambda af, d: af.Khat[:d.shape[0]],
    "convection": lambda af, d: af.Chat[:d.shape[0]],
}


def try_affine(kind: str, qT: torch.Tensor, db: DeviceBasis):
    """The affine factors of transposed qdata when it separates as W ⊗ d
    (a leading component axis; mass gets a singleton one), else None."""
    from ..utils.config import config

    if config.affine_collapse == "off":
        return None
    d = separable_collapse(qT, db.W)
    if d is None:
        return None
    return d[None, :] if kind == "mass" else d


def apply_terms(lb: LaneBasis, terms, eT: torch.Tensor,
                af: Optional[AffineOps] = None, aff_terms=()) -> torch.Tensor:
    """Sum of lane-major integrator applies sharing one (nd, ne) E-vector:
    ``terms`` are (kind, transposed qdata), ``aff_terms`` (kind, affine
    factors), which fuse into one stacked reference-matrix matmul."""
    out = None
    if aff_terms:
        mats, scales = [], []
        for kind, d in aff_terms:
            mats.extend(_AFF_MATS[kind](af, d))
            scales.extend(d[c] for c in range(d.shape[0]))
        out = _scaled_rows(mats, scales, eT)
    for kind, qT in terms:
        y = _APPLY[kind](lb, qT, eT)
        out = y if out is None else out + y
    return out
