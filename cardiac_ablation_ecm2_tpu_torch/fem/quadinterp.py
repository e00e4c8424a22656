"""E-vector → Q-vector evaluation (counterpart of
``cardiac_ablation_ecm2_tpu/fem/quadinterp.py``; 3D volumes are the port's
meshes, 2D and 1D bases serve their boundary faces).

Tensor bases (hexes): every contraction is a ``torch.einsum`` against the
1D ``B1``/``G1`` factors.  E-vectors are ``(ne, nd)`` lex-flat (i fastest),
so the tensor reshape ``(ne, n1, n1, n1)`` has axes ``(e, k, j, i)`` (a
face's ``(ne, n1, n1)`` has ``(e, j, i)``);
Q-vectors come back lex-flat ``(ne, nq)`` with qx fastest.  Dense bases
(tets): one einsum against the full ``B (nq, nd)`` / ``G (nq, nd, dim)``.
The ``*_t`` functions are the exact adjoints used by operator applies.
Trailing component axes (``...``) pass through, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.config import real_t, resolve_device
from .basis import DofToQuad

_es = torch.einsum


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceBasis:
    """DofToQuad matrices as tensors of the working dtype on one device:
    the 1D factors of a tensor basis, or the dense matrices otherwise."""

    dim: int
    tensor: bool
    W: torch.Tensor                    # (nq,) quadrature weights
    B1: Optional[torch.Tensor] = None  # (nq1, n1)
    G1: Optional[torch.Tensor] = None
    B: Optional[torch.Tensor] = None   # (nq, nd)
    G: Optional[torch.Tensor] = None   # (nq, nd, dim)

    @property
    def n1d(self):
        return self.B1.shape[1]

    @property
    def nq1d(self):
        return self.B1.shape[0]


def device_basis(d2q: DofToQuad, dtype=None, device=None) -> DeviceBasis:
    """``device=None`` is the card."""
    kw = dict(dtype=real_t(dtype), device=resolve_device(device))
    W = torch.as_tensor(d2q.weights, **kw)
    if d2q.tensor:
        return DeviceBasis(dim=d2q.dim, tensor=True, W=W,
                           B1=torch.as_tensor(d2q.B1, **kw),
                           G1=torch.as_tensor(d2q.G1, **kw))
    return DeviceBasis(dim=d2q.dim, tensor=False, W=W,
                       B=torch.as_tensor(d2q.B, **kw),
                       G=torch.as_tensor(d2q.G, **kw))


def _tensorize(u, n1, dim):
    """(ne, n1**dim, ...) → (ne, n1, ..., n1, ...), slowest axis first."""
    return u.reshape(u.shape[0], *(n1,) * dim, *u.shape[2:])


def _fwd(*args):
    """(e, [k,] j, i, ...) → (ne, nq, ...) with per-axis factors (x first)."""
    *F, u = args
    if len(F) == 1:
        return _es("ai,ei...->ea...", F[0], u)
    if len(F) == 2:
        t = _es("ai,eji...->eja...", F[0], u)
        t = _es("bj,eja...->eba...", F[1], t)
        return t.reshape(u.shape[0], -1, *u.shape[3:])
    Fx, Fy, Fz = F
    t = _es("ai,ekji...->ekja...", Fx, u)
    t = _es("bj,ekja...->ekba...", Fy, t)
    t = _es("ck,ekba...->ecba...", Fz, t)
    return t.reshape(u.shape[0], -1, *u.shape[4:])


def _adj(*args):
    """(e, [c,] b, a, ...) → (ne, nd, ...): adjoint of :func:`_fwd`."""
    *F, v = args
    if len(F) == 1:
        return _es("ai,ea...->ei...", F[0], v)
    if len(F) == 2:
        t = _es("ai,eba...->ebi...", F[0], v)
        t = _es("bj,ebi...->eji...", F[1], t)
        return t.reshape(v.shape[0], -1, *v.shape[3:])
    Fx, Fy, Fz = F
    t = _es("ai,ecba...->ecbi...", Fx, v)
    t = _es("bj,ecbi...->ecji...", Fy, t)
    t = _es("ck,ecji...->ekji...", Fz, t)
    return t.reshape(v.shape[0], -1, *v.shape[4:])


def _grad_factors(db: DeviceBasis):
    """Per reference axis d, the per-axis factors of ∂/∂ξ_d (x first)."""
    B, G = db.B1, db.G1
    return [tuple(G if a == d else B for a in range(db.dim))
            for d in range(db.dim)]


def eval_values(db: DeviceBasis, u_e: torch.Tensor) -> torch.Tensor:
    """(ne, nd[, c]) → (ne, nq[, c]) basis values at quadrature points."""
    if not db.tensor:
        return _es("qn,en...->eq...", db.B, u_e)
    return _fwd(*(db.B1,) * db.dim, _tensorize(u_e, db.n1d, db.dim))


def eval_values_t(db: DeviceBasis, q: torch.Tensor) -> torch.Tensor:
    """Adjoint of eval_values: (ne, nq[, c]) → (ne, nd[, c])."""
    if not db.tensor:
        return _es("qn,eq...->en...", db.B, q)
    return _adj(*(db.B1,) * db.dim, _tensorize(q, db.nq1d, db.dim))


def eval_grad(db: DeviceBasis, u_e: torch.Tensor) -> torch.Tensor:
    """Reference-space gradients: (ne, nd[, c]) → (ne, nq, dim[, c])."""
    if not db.tensor:
        return _es("qnd,en...->eqd...", db.G, u_e)
    u = _tensorize(u_e, db.n1d, db.dim)
    return torch.stack([_fwd(*F, u) for F in _grad_factors(db)], dim=2)


def eval_grad_t(db: DeviceBasis, q: torch.Tensor) -> torch.Tensor:
    """Adjoint of eval_grad: (ne, nq, dim[, c]) → (ne, nd[, c])."""
    if not db.tensor:
        return _es("qnd,eqd...->en...", db.G, q)
    dim = db.dim
    v = q.reshape(q.shape[0], *(db.nq1d,) * dim, dim, *q.shape[3:])
    out = None
    for d, F in enumerate(_grad_factors(db)):
        t = _adj(*F, v.select(dim + 1, d))
        out = t if out is None else out + t
    return out


def contract_q_to_e(factors, q: torch.Tensor) -> torch.Tensor:
    """Transpose contraction with distinct per-axis 1D factors (nq1, n1):
    (ne, nq[, c]) → (ne, nd[, c]); used by the PA diagonals, where a factor
    is an elementwise product such as B∘G."""
    return _adj(*factors, _tensorize(q, factors[0].shape[0], len(factors)))
