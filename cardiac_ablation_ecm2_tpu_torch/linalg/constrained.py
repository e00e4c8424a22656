"""Linear solves under linear constraints, A x = f subject to B x = r
(counterpart of ``cardiac_ablation_ecm2_tpu/linalg/constrained.py``;
MFEM's ``ConstrainedSolver`` with its elimination, penalty and Schur
strategies and ``BuildNormalConstraints``, behind ex28's sliding
boundary conditions).

B is stored as padded rows, ``(m, kmax)`` column indices and values
(``Constraints``): B v is a gather and a row sum, Bᵀλ the sorted
segment-sum of ``ops/block_gather.py`` over the entries' slots (no float
atomics, so it is deterministic, where the JAX package scatter-adds).
Elimination is a projection P = I − Bᵀ(BBᵀ)⁻¹B around the operator and
the preconditioner, with the small Gram matrix BBᵀ factored once on the
host and solved by ``torch.cholesky_solve`` on the vectors' device.  Every
solve returns (x, λ, SolveInfo).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.block_gather import segment_sum
from ..utils.config import real_t
from .krylov_extra import minres
from .solvers import SolveInfo, cg, default_dot


@dataclass(frozen=True)
class Constraints:
    """Padded-sparse constraint matrix B (m × n): ``idx[i, k]`` /
    ``val[i, k]`` is the k-th (column, coefficient) of row i, padding has
    ``val == 0``; block b of physical constraints spans rows
    ``rowstarts[b]:rowstarts[b+1]`` (host)."""

    idx: torch.Tensor          # (m, kmax) int64
    val: torch.Tensor          # (m, kmax)
    n: int                     # column count (= dof count)
    rowstarts: np.ndarray      # (nblocks + 1,)

    def __post_init__(self):
        from ..fem.restriction import scatter_slots

        slots, offsets = scatter_slots(self.idx.reshape(-1).cpu().numpy(), self.n)
        object.__setattr__(self, "_slots", torch.as_tensor(slots, device=self.idx.device))
        object.__setattr__(self, "_offsets", torch.as_tensor(offsets, device=self.idx.device))

    @property
    def m(self) -> int:
        return int(self.idx.shape[0])

    def mult(self, v: torch.Tensor) -> torch.Tensor:
        """B v."""
        return (v[self.idx] * self.val).sum(dim=1)

    def mult_t(self, lam: torch.Tensor) -> torch.Tensor:
        """Bᵀ λ: the row entries summed into their columns in slot order."""
        return segment_sum((self.val * lam[:, None]).reshape(-1), self._slots,
                           self._offsets)

    def select_rows(self, rows: np.ndarray) -> "Constraints":
        """A host-side row subset (active-set contact loops)."""
        rows = torch.as_tensor(np.asarray(rows), device=self.idx.device)
        return Constraints(idx=self.idx[rows], val=self.val[rows], n=self.n,
                           rowstarts=np.arange(len(rows) + 1))

    def gram_cholesky(self) -> np.ndarray:
        """Host Cholesky factor of G = B Bᵀ (m × m, at setup)."""
        import scipy.sparse as sp

        idx = self.idx.cpu().numpy()
        val = self.val.double().cpu().numpy()
        m, kmax = idx.shape
        B = sp.csr_matrix((val.ravel(), (np.repeat(np.arange(m), kmax),
                                         idx.ravel())), shape=(m, self.n))
        G = np.asarray((B @ B.T).todense())
        # a tiny shift guards duplicated or near-dependent rows
        G[np.diag_indices_from(G)] += 1e-14 * max(G.diagonal().max(), 1.0)
        return np.linalg.cholesky(G)


def from_rows(rows, n: int, rowstarts=None, dtype=None, device=None) -> Constraints:
    """``Constraints`` from a list of rows, each a list of ``(column,
    coefficient)`` pairs, on ``device`` (``None``: the card)."""
    from ..utils.config import resolve_device

    dev = resolve_device(device)
    kmax = max((len(r) for r in rows), default=1)
    m = len(rows)
    idx = np.zeros((m, kmax), np.int64)
    val = np.zeros((m, kmax), np.float64)
    for i, r in enumerate(rows):
        for k, (j, c) in enumerate(r):
            idx[i, k] = j
            val[i, k] = c
    if rowstarts is None:
        rowstarts = np.arange(m + 1)
    return Constraints(idx=torch.as_tensor(idx, device=dev),
                       val=torch.as_tensor(val, dtype=real_t(dtype), device=dev),
                       n=n, rowstarts=np.asarray(rowstarts))


def penalty_constrained_solve(
    Amult: Callable, B: Constraints, f: torch.Tensor,
    r: Optional[torch.Tensor] = None, penalty: float = 1e8,
    M: Optional[Callable] = None, rel_tol: float = 1e-10,
    max_iter: int = 2000, dot: Callable = default_dot,
) -> Tuple[torch.Tensor, torch.Tensor, SolveInfo]:
    """PenaltyConstrainedSolver: CG on A + p BᵀB with right-hand side
    f + p Bᵀr; λ ≈ p (B x − r)."""
    rr = (torch.zeros(B.m, dtype=f.dtype, device=f.device) if r is None
          else torch.as_tensor(r, dtype=f.dtype, device=f.device))

    def Ap(v):
        return Amult(v) + penalty * B.mult_t(B.mult(v))

    x, info = cg(Ap, f + penalty * B.mult_t(rr), M=M, rel_tol=rel_tol,
                 max_iter=max_iter, dot=dot)
    return x, penalty * (B.mult(x) - rr), info


def eliminate_constrained_solve(
    Amult: Callable, B: Constraints, f: torch.Tensor,
    r: Optional[torch.Tensor] = None, M: Optional[Callable] = None,
    rel_tol: float = 1e-10, max_iter: int = 2000,
    dot: Callable = default_dot, chol: Optional[np.ndarray] = None,
) -> Tuple[torch.Tensor, torch.Tensor, SolveInfo]:
    """EliminationCGSolver as projected CG: with P = I − Bᵀ(BBᵀ)⁻¹B and
    x_p = Bᵀ(BBᵀ)⁻¹r, solve (P A P + (I − P)) y = P (f − A x_p) by CG,
    x = x_p + P y, λ = (BBᵀ)⁻¹ B (f − A x)."""
    L = torch.as_tensor(B.gram_cholesky() if chol is None else chol,
                        dtype=f.dtype, device=f.device)

    def Ginv(y):
        return torch.cholesky_solve(y[:, None], L, upper=False)[:, 0]

    def proj(v):
        return v - B.mult_t(Ginv(B.mult(v)))

    xp = (B.mult_t(Ginv(torch.as_tensor(r, dtype=f.dtype, device=f.device)))
          if r is not None else torch.zeros_like(f))

    def Ac(v):
        pv = proj(v)
        return proj(Amult(pv)) + (v - pv)

    Mc = None
    if M is not None:
        def Mc(v):  # noqa: E306
            pv = proj(v)
            return proj(M(pv)) + (v - pv)

    y, info = cg(Ac, proj(f - Amult(xp)), M=Mc, rel_tol=rel_tol,
                 max_iter=max_iter, dot=dot)
    x = xp + proj(y)
    return x, Ginv(B.mult(f - Amult(x))), info


def schur_constrained_solve(
    Amult: Callable, B: Constraints, f: torch.Tensor,
    r: Optional[torch.Tensor] = None, Adiag: Optional[torch.Tensor] = None,
    rel_tol: float = 1e-10, max_iter: int = 4000,
    dot: Callable = default_dot,
) -> Tuple[torch.Tensor, torch.Tensor, SolveInfo]:
    """SchurConstrainedSolver: MINRES on the saddle-point system with the
    block-diagonal preconditioner (diag(A)⁻¹, diag(B diag(A)⁻¹ Bᵀ)⁻¹)."""
    n, m = B.n, B.m
    rr = (torch.zeros(m, dtype=f.dtype, device=f.device) if r is None
          else torch.as_tensor(r, dtype=f.dtype, device=f.device))

    def K(z):
        x, lam = z[:n], z[n:]
        return torch.cat([Amult(x) + B.mult_t(lam), B.mult(x)])

    dA = (torch.ones(n, dtype=f.dtype, device=f.device) if Adiag is None
          else torch.as_tensor(Adiag, dtype=f.dtype, device=f.device))
    dS = (B.val * B.val / dA[B.idx]).sum(dim=1)
    dS = torch.where(dS > 0, dS, torch.ones_like(dS))

    def prec(z):
        return torch.cat([z[:n] / dA, z[n:] / dS])

    z, info = minres(K, torch.cat([f, rr]), M=prec, rel_tol=rel_tol,
                     max_iter=max_iter, dot=dot)
    return z[:n], z[n:], info


# ---------------------------------------------------------------------------
# constraint builders (host, at setup)
# ---------------------------------------------------------------------------

def boundary_face_normals(mesh) -> np.ndarray:
    """Outward unit normal of each boundary face from its vertices (flat
    faces), oriented away from the adjacent element's centroid."""
    V = mesh.vertices
    bf = mesh.boundary
    if mesh.dim == 2:
        t = V[bf[:, 1]] - V[bf[:, 0]]
        n = np.stack([t[:, 1], -t[:, 0]], axis=-1)
    else:
        n = np.cross(V[bf[:, 1]] - V[bf[:, 0]], V[bf[:, -1]] - V[bf[:, 0]])
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    vmap = {}
    for e in range(mesh.ne):
        for v in mesh.elements[e]:
            vmap.setdefault(int(v), []).append(e)
    cent = V[mesh.elements].mean(axis=1)
    fcent = V[bf].mean(axis=1)
    for fi in range(mesh.nbe):
        fset = set(int(v) for v in bf[fi])
        elem = None
        for c in vmap.get(int(bf[fi, 0]), []):
            if fset.issubset(set(int(v) for v in mesh.elements[c])):
                elem = c
                break
        if elem is None:
            elem = vmap[int(bf[fi, 0])][0]
        if np.dot(n[fi], fcent[fi] - cent[elem]) < 0:
            n[fi] = -n[fi]
    return n


def build_normal_constraints(fes, constrained_att, dtype=None,
                             device=None) -> Constraints:
    """BuildNormalConstraints: one row per (boundary node, attribute)
    holding the area-averaged normal displacement to zero on a byNODES
    vector space; a node on several constrained attributes gets one row
    each (Gram–Schmidt within the node's block, near-parallel rows
    dropped), grouped into one block."""
    mesh = fes.mesh
    ns = fes.ndof_scalar
    vdim = fes.vdim
    fn = boundary_face_normals(mesh)
    gmap = np.asarray(fes.bdr_gather_map)          # (nbe, ndf) scalar dofs
    V = mesh.vertices
    bf = mesh.boundary
    if mesh.dim == 2:
        area = np.linalg.norm(V[bf[:, 1]] - V[bf[:, 0]], axis=-1)
    else:
        area = np.linalg.norm(
            np.cross(V[bf[:, 1]] - V[bf[:, 0]], V[bf[:, -1]] - V[bf[:, 0]]),
            axis=-1)
    att = np.asarray(mesh.bdr_attributes)
    want = set(int(a) for a in constrained_att)
    acc: dict = {}
    for fi in range(mesh.nbe):
        a = int(att[fi])
        if a not in want:
            continue
        for d in gmap[fi]:
            acc.setdefault(int(d), {}).setdefault(a, np.zeros(mesh.dim))
            acc[int(d)][a] += area[fi] * fn[fi]

    rows, starts = [], [0]
    for d in sorted(acc):
        block = []
        for a in sorted(acc[d]):
            nrm = acc[d][a]
            nn = np.linalg.norm(nrm)
            if nn < 1e-14:
                continue
            nrm = nrm / nn
            for prev in block:
                nrm = nrm - np.dot(nrm, prev) * prev
            nn = np.linalg.norm(nrm)
            if nn < 1e-8:
                continue
            block.append(nrm / nn)
        for nrm in block:
            rows.append([(d + c * ns, float(nrm[c])) for c in range(vdim)])
        starts.append(len(rows))
    return from_rows(rows, fes.ndof, rowstarts=np.asarray(starts), dtype=dtype,
                     device=device)
