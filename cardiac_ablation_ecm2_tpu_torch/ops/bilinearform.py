"""Domain mass and diffusion forms, partially or fully assembled (the
``assemble`` and ``assemble_matrix`` subset of ``BilinearForm`` in
``cardiac_ablation_ecm2_tpu/ops/bilinearform.py``).

PARTIAL assembly (``assemble``: hex spaces, generic or Cartesian, and
simplex spaces) builds the qdata of every term and returns a matrix-free
:class:`PAOperator`: the affine terms apply through reference matrices, the
others through the lane-major per-point applies, all in one restriction
round trip (``ops/lanemajor.py``, as the JAX package's
``_build_lane_group``).  A term is affine when its coefficient is a
constant on a straight-sided simplex mesh (factors from the vertices in
float64, ``fem/geom_factors.affine_packed_factors``), or else when its
qdata separate numerically as W ⊗ d (parallelepiped hexes).  Its diagonal
goes through the element-major PA diagonals and the E→L sum.  Scalar
coefficients only.

FULL assembly (``assemble_matrix``, simplex spaces) goes to scipy CSR.
The quadrature and precision are the JAX package's: the space's rule
(``fes.d2q``), geometric factors in the configured dtype, element matrices
contracted in float64 against the float64 basis, diffusion from the
unpacked ``diffusion.setup``.  The element matrices are computed with torch
on the operator's device, in chunks of elements; duplicate (row, column)
entries are summed there in a fixed order (a stable key sort and the
sorted segment-sum, :func:`sum_duplicates`), and the canonical CSR (sorted
columns, exact zeros dropped as scipy's sum ``0 + A`` drops them) comes back
to the host.  Only simplex (dense-basis) spaces are covered: they are the
ones the assembled-ELL path runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.coefficient import eval_coeff
from ..fem.fespace import element_node_coords
from ..fem.geom_factors import (
    affine_element_jacobians,
    affine_packed_factors,
    compute_geometric_factors,
)
from ..fem.quadinterp import DeviceBasis
from ..utils.config import config, resolve_device
from . import diffusion, lanemajor, mass
from .block_gather import segment_sum
from .operators import LinearOperator

_KINDS = ("mass", "diffusion")
_MODULES = {"mass": mass, "diffusion": diffusion}
#: elements per chunk of element matrices (bounds the einsum temporaries)
_CHUNK = 1 << 16


def sum_duplicates(keys: torch.Tensor, vals: torch.Tensor):
    """The sorted unique ``keys`` and, for each, the sum of its ``vals`` in
    the order they come (the first initialises the sum): a stable sort of
    the keys and the sorted segment-sum (``ops/block_gather.segment_sum``,
    a kernel on the card; no atomics, so the sums repeat bit for bit).  On
    the CPU it equals ``zeros.index_add_(0, inverse, vals)``, which adds
    serially in the same order, bit for bit but for the sign of a zero
    sum."""
    if keys.numel() > torch.iinfo(torch.int32).max:
        raise ValueError(f"{keys.numel()} entries do not fit int32 slot indices")
    uniq, counts = torch.unique(keys, sorted=True, return_counts=True)
    offsets = torch.zeros(len(uniq) + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    slots = torch.argsort(keys, stable=True).to(torch.int32)
    return uniq, segment_sum(vals.contiguous(), slots, offsets)


@dataclasses.dataclass(frozen=True, eq=False)
class _BoundTerm:
    """One integrator bound to its qdata (restriction and basis shared)."""

    kind: str
    qdata: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class _LaneGroup:
    """Domain terms fused into one lane-major pass: ``terms`` hold
    transposed qdata, ``aff_terms`` affine factors (one stacked
    reference-matrix matmul)."""

    lb: lanemajor.LaneBasis
    terms: Tuple[Tuple[str, torch.Tensor], ...]
    af: Optional[lanemajor.AffineOps] = None
    aff_terms: Tuple[Tuple[str, torch.Tensor], ...] = ()


@dataclasses.dataclass(frozen=True, eq=False)
class PAOperator:
    """Partially assembled operator y = Σ_terms Rᵀ apply_t(qdata_t, R x).

    ``terms`` holds every integrator (the diagonal); ``lane`` and
    ``std_terms`` partition them for ``mult`` into the fused lane-major
    group and the element-major rest."""

    terms: Tuple[_BoundTerm, ...]
    ndof: int
    restr: object
    db: DeviceBasis
    lane: Optional[_LaneGroup] = None
    std_terms: Tuple[_BoundTerm, ...] = ()

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        out = None
        if self.lane is not None:
            lane = self.lane
            yT = lanemajor.apply_terms(lane.lb, lane.terms, self.restr.mult_t(x),
                                       af=lane.af, aff_terms=lane.aff_terms)
            out = self.restr.mult_transpose_t(yT)
        for t in (self.std_terms if self.lane is not None else self.terms):
            e = self.restr.mult(x)
            y = self.restr.mult_transpose(_MODULES[t.kind].apply(self.db, t.qdata, e))
            out = y if out is None else out + y
        return out

    def diagonal(self) -> torch.Tensor:
        out = None
        for t in self.terms:
            d = self.restr.mult_transpose(_MODULES[t.kind].diagonal(self.db, t.qdata))
            out = d if out is None else out + d
        return out

    def operator(self) -> LinearOperator:
        return LinearOperator((self.ndof, self.ndof), self.mult, self.diagonal)


def _geom_affine_term(kind, coeff, geo, qdata):
    """A term's affine factors from the host-float64 geometry ``geo`` =
    (det, dk), in the qdata's dtype and device: a leading component axis
    (mass gets a singleton one); None unless the coefficient is a constant
    scalar."""
    if coeff is None:
        cs = 1.0
    elif not callable(coeff) and np.ndim(coeff) == 0:
        cs = float(coeff)
    else:
        return None
    det, dk = geo
    f = det[None, :] if kind == "mass" else dk
    return torch.as_tensor(cs * f, dtype=qdata.dtype, device=qdata.device)


def _build_lane_group(coeffs, bound, db, mesh):
    """Partition the terms into the fused lane-major group and the rest, as
    the JAX package's ``_build_lane_group``: on a straight-sided simplex
    mesh a term with a constant coefficient joins as affine factors from
    the vertices (float32 qdata of sliver tets defeat a numerical check);
    otherwise a term whose transposed qdata separate as W ⊗ d joins as
    affine factors (``lanemajor.try_affine``), else as transposed qdata.
    ``coeffs`` are the terms' coefficients, in the order of ``bound``."""
    geo = None
    if config.affine_collapse != "off":
        J = affine_element_jacobians(mesh)
        if J is not None:
            geo = affine_packed_factors(J)
    lane_terms, aff_terms, std = [], [], []
    for coeff, t in zip(coeffs, bound):
        if not lanemajor.supports(db, t.qdata, t.kind):
            std.append(t)
            continue
        d = (_geom_affine_term(t.kind, coeff, geo, t.qdata)
             if geo is not None else None)
        qT = None
        if d is None:
            qT = lanemajor.transpose_qdata(t.kind, t.qdata)
            d = lanemajor.try_affine(t.kind, qT, db)
        if d is not None:
            aff_terms.append((t.kind, d))
        else:
            lane_terms.append((t.kind, qT))
    if not lane_terms and not aff_terms:
        return None, ()
    lb = lanemajor.lane_basis(db)
    return (_LaneGroup(lb=lb, terms=tuple(lane_terms),
                       af=lanemajor.affine_ops(db, lb) if aff_terms else None,
                       aff_terms=tuple(aff_terms)),
            tuple(std))


class BilinearForm:
    """Sum of domain integrators on one space; ``device=None`` is the card."""

    def __init__(self, fes, device=None, nq1d: Optional[int] = None):
        self.fes = fes
        self.device = resolve_device(device)
        self.nq1d = nq1d
        self._terms = []

    def add_domain_integrator(self, kind: str, coeff=None) -> "BilinearForm":
        if kind not in _KINDS:
            raise NotImplementedError(f"integrator {kind!r}: the port "
                                      f"assembles {_KINDS}")
        self._terms.append((kind, coeff))
        return self

    def assemble(self, dtype=None) -> PAOperator:
        """PARTIAL assembly: qdata of every term, and the matrix-free
        operator over the space's restriction and basis (shared through
        ``fem/build.py``)."""
        fes, dev = self.fes, self.device
        gf = geom_factors_for(fes, self.nq1d, dtype, dev)
        db = basis_for(fes, dtype, dev, self.nq1d)
        bound = []
        for kind, coeff in self._terms:
            cq = eval_coeff(coeff, gf, dtype)
            if cq is not None and cq.dim() != 2:
                raise NotImplementedError("the port's partial assembly takes "
                                          "scalar coefficients")
            qd = (diffusion.setup_packed(gf, cq) if kind == "diffusion"
                  else mass.setup(gf, cq))
            bound.append(_BoundTerm(kind, qd))
        lane, std = _build_lane_group([c for _, c in self._terms], bound, db,
                                      fes.mesh)
        return PAOperator(terms=tuple(bound), ndof=fes.ndof_scalar,
                          restr=restriction_for(fes, dev), db=db, lane=lane,
                          std_terms=std)

    def assemble_matrix(self, dtype=None):
        """FULL assembly to a scipy CSR matrix (float64 data)."""
        import scipy.sparse as sp

        fes = self.fes
        d2q = fes.dof_to_quad(self.nq1d)
        if d2q.tensor:
            raise NotImplementedError("FULL assembly covers simplex spaces")
        dev = self.device
        n = fes.ndof_scalar
        X = element_node_coords(fes.mesh, fes.order)
        B = torch.as_tensor(d2q.B, dtype=torch.float64, device=dev)
        G = torch.as_tensor(d2q.G, dtype=torch.float64, device=dev)
        ne, nd = fes.gather_map.shape
        Ae = torch.zeros(ne, nd, nd, dtype=torch.float64, device=dev)
        for e0 in range(0, ne, _CHUNK):
            gf = compute_geometric_factors(X[e0:e0 + _CHUNK], d2q, dtype, dev)
            for kind, coeff in self._terms:
                cq = eval_coeff(coeff, gf, dtype)
                if kind == "mass":
                    q = mass.setup(gf, cq).double()
                    Ae[e0:e0 + _CHUNK] += torch.einsum("qm,eq,qn->emn", B, q, B)
                else:
                    q = diffusion.setup(gf, cq).double()
                    Ae[e0:e0 + _CHUNK] += torch.einsum("qma,eqab,qnb->emn",
                                                       G, q, G)
        gm = torch.as_tensor(fes.gather_map, dtype=torch.int64, device=dev)
        keys = (gm[:, :, None] * n + gm[:, None, :]).reshape(-1)
        uniq, vals = sum_duplicates(keys, Ae.reshape(-1))
        indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        indptr[1:] = torch.cumsum(torch.bincount(uniq // n, minlength=n), 0)
        A = sp.csr_matrix((vals.cpu().numpy(), (uniq % n).int().cpu().numpy(),
                           indptr.cpu().numpy()), shape=(n, n))
        A.eliminate_zeros()
        return A
