"""E-vector → Q-vector evaluation (counterpart of
``cardiac_ablation_ecm2_tpu/fem/quadinterp.py``, 3D).

Tensor bases (hexes): every contraction is a ``torch.einsum`` against the
1D ``B1``/``G1`` factors.  E-vectors are ``(ne, nd)`` lex-flat (i fastest),
so the tensor reshape ``(ne, n1, n1, n1)`` has axes ``(e, k, j, i)``;
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
    if d2q.dim != 3:
        raise NotImplementedError("the port's kernels are 3D")
    kw = dict(dtype=real_t(dtype), device=resolve_device(device))
    W = torch.as_tensor(d2q.weights, **kw)
    if d2q.tensor:
        return DeviceBasis(dim=d2q.dim, tensor=True, W=W,
                           B1=torch.as_tensor(d2q.B1, **kw),
                           G1=torch.as_tensor(d2q.G1, **kw))
    return DeviceBasis(dim=d2q.dim, tensor=False, W=W,
                       B=torch.as_tensor(d2q.B, **kw),
                       G=torch.as_tensor(d2q.G, **kw))


def _t3(u, n1):
    return u.reshape(u.shape[0], n1, n1, n1, *u.shape[2:])


def _fwd(Fx, Fy, Fz, u):
    """(e, k, j, i, ...) → (ne, nq, ...) with per-axis factors."""
    t = _es("ai,ekji...->ekja...", Fx, u)
    t = _es("bj,ekja...->ekba...", Fy, t)
    t = _es("ck,ekba...->ecba...", Fz, t)
    return t.reshape(u.shape[0], -1, *u.shape[4:])


def _adj(Fx, Fy, Fz, v):
    """(e, c, b, a, ...) → (ne, nd, ...): adjoint of :func:`_fwd`."""
    t = _es("ai,ecba...->ecbi...", Fx, v)
    t = _es("bj,ecbi...->ecji...", Fy, t)
    t = _es("ck,ecji...->ekji...", Fz, t)
    return t.reshape(v.shape[0], -1, *v.shape[4:])


def eval_values(db: DeviceBasis, u_e: torch.Tensor) -> torch.Tensor:
    """(ne, nd[, c]) → (ne, nq[, c]) basis values at quadrature points."""
    if not db.tensor:
        return _es("qn,en...->eq...", db.B, u_e)
    B = db.B1
    return _fwd(B, B, B, _t3(u_e, db.n1d))


def eval_values_t(db: DeviceBasis, q: torch.Tensor) -> torch.Tensor:
    """Adjoint of eval_values: (ne, nq[, c]) → (ne, nd[, c])."""
    if not db.tensor:
        return _es("qn,eq...->en...", db.B, q)
    B = db.B1
    return _adj(B, B, B, _t3(q, db.nq1d))


def eval_grad(db: DeviceBasis, u_e: torch.Tensor) -> torch.Tensor:
    """Reference-space gradients: (ne, nd[, c]) → (ne, nq, dim[, c])."""
    if not db.tensor:
        return _es("qnd,en...->eqd...", db.G, u_e)
    B, G = db.B1, db.G1
    u = _t3(u_e, db.n1d)
    return torch.stack([_fwd(G, B, B, u), _fwd(B, G, B, u), _fwd(B, B, G, u)],
                       dim=2)


def eval_grad_t(db: DeviceBasis, q: torch.Tensor) -> torch.Tensor:
    """Adjoint of eval_grad: (ne, nq, dim[, c]) → (ne, nd[, c])."""
    if not db.tensor:
        return _es("qnd,eqd...->en...", db.G, q)
    B, G = db.B1, db.G1
    n = db.nq1d
    v = q.reshape(q.shape[0], n, n, n, 3, *q.shape[3:])
    return (_adj(G, B, B, v[:, :, :, :, 0]) + _adj(B, G, B, v[:, :, :, :, 1])
            + _adj(B, B, G, v[:, :, :, :, 2]))


def contract_q_to_e(factors, q: torch.Tensor) -> torch.Tensor:
    """Transpose contraction with distinct per-axis 1D factors (nq1, n1):
    (ne, nq[, c]) → (ne, nd[, c]); used by the PA diagonals, where a factor
    is an elementwise product such as B∘G."""
    return _adj(*factors, _t3(q, factors[0].shape[0]))
