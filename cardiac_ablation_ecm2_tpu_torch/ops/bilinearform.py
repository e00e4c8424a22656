"""The operator-assembly front end (counterpart of ``BilinearForm`` in
``cardiac_ablation_ecm2_tpu/ops/bilinearform.py``; MFEM's ``BilinearForm``
with ``AddDomainIntegrator`` / ``AddBoundaryIntegrator`` / ``Assemble``).

Integrators are registered by name (``mass``, ``diffusion``,
``convection``, ``elasticity``; :func:`register_integrator` adds more),
each a module with ``setup``/``apply``/``diagonal``.  Boundary integrators
(``mass``: Robin (σu, v)_∂Ω, with an attribute marker) run the same
pipeline through the boundary faces' restriction and geometric factors
(``fem/build.py``).  A vector space (``vdim`` > 1, byNODES) gathers each
component through the scalar restriction; the component-wise integrators
apply per component, elasticity to the (ne, nd, vdim) E-vector.

PARTIAL assembly (``assemble``: hex spaces, generic or Cartesian, and
simplex spaces) builds the qdata of every term and returns a matrix-free
:class:`PAOperator`: on a scalar space the domain mass, diffusion and
convection terms apply in one lane-major restriction round trip, affine
terms through reference matrices (``ops/lanemajor.py``, as the JAX
package's ``_build_lane_group``); the rest apply element-major.  A term is
affine when its coefficient is a constant (a constant vector for
convection) on a straight-sided simplex mesh (factors from the vertices in
float64, ``fem/geom_factors.affine_packed_factors``), or else when its
qdata separate numerically as W ⊗ d (parallelepiped hexes).  Its diagonal
goes through the element-major PA diagonals and the E→L sum.

FULL assembly (``assemble_matrix``, hex and simplex spaces, boundary terms,
convection, elasticity) goes to scipy CSR; ``assemble_ell`` packs it into a
device :class:`~.ell.ELLOperator`.  The quadrature and precision are the
JAX package's: the space's rule (``fes.d2q``; p + 2 points on the boundary
faces), geometric factors in the configured dtype, element matrices
contracted in float64 against the float64 basis, diffusion from the
unpacked ``diffusion.setup``.  The element matrices are computed with torch
on the form's device, in chunks of elements; duplicate (row, column)
entries are summed there in a fixed order (a stable key sort and the
sorted segment-sum, :func:`sum_duplicates`), so the matrix repeats bit for
bit on the card, and the canonical CSR (sorted columns, exact zeros
dropped) comes back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fem.build import (
    basis_for,
    bdr_dof_to_quad,
    bdr_geom_for,
    bdr_marker_mask,
    bdr_mesh,
    bdr_restriction_for,
    geom_factors_for,
    restriction_for,
)
from ..fem.coefficient import eval_coeff, eval_vector_coeff
from ..fem.fespace import element_node_coords
from ..fem.geom_factors import (
    _np_det_adj,
    affine_element_jacobians,
    affine_packed_factors,
    compute_geometric_factors,
)
from ..fem.quadinterp import DeviceBasis
from ..utils.config import config, real_t, resolve_device
from . import convection, diffusion, elasticity, lanemajor, mass
from .block_gather import segment_sum
from .operators import LinearOperator

_INTEGRATORS = {
    "mass": mass,
    "diffusion": diffusion,
    "convection": convection,
    "elasticity": elasticity,   # coeff = (lambda, mu)
}
#: integrators that act on each component of a vector space alike
_COMPONENTWISE = (mass, diffusion, convection)


def register_integrator(name: str, module) -> None:
    """Extension hook: ``module`` provides setup/apply/diagonal."""
    _INTEGRATORS[name] = module


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
    uniq, slots, offsets = duplicate_segments(keys)
    return uniq, segment_sum(vals.contiguous(), slots, offsets)


def duplicate_segments(keys: torch.Tensor):
    """The sorted unique ``keys``, and the int32 slots (a stable sort) and
    int64 offsets that segment the entries by key, for ``segment_sum``."""
    if keys.numel() > torch.iinfo(torch.int32).max:
        raise ValueError(f"{keys.numel()} entries do not fit int32 slot indices")
    uniq, counts = torch.unique(keys, sorted=True, return_counts=True)
    offsets = torch.zeros(len(uniq) + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return uniq, torch.argsort(keys, stable=True).to(torch.int32), offsets


@dataclasses.dataclass
class _Term:
    kind: str
    coeff: object = None
    vector_coeff: object = None
    boundary: bool = False
    marker: Optional[Sequence[int]] = None


@dataclasses.dataclass(frozen=True, eq=False)
class _BoundTerm:
    """One integrator bound to its module (at assembly, as the JAX
    package's) and qdata; a boundary term also to the faces' (restriction,
    basis), a domain term runs on the operator's."""

    kind: str
    mod: object
    qdata: object
    bdr: Optional[Tuple[object, DeviceBasis]] = None


@dataclasses.dataclass(frozen=True, eq=False)
class _LaneGroup:
    """Domain terms fused into one lane-major pass: ``terms`` hold
    transposed qdata, ``aff_terms`` affine factors (one stacked
    reference-matrix matmul)."""

    lb: lanemajor.LaneBasis
    terms: Tuple[Tuple[str, torch.Tensor], ...]
    af: Optional[lanemajor.AffineOps] = None
    aff_terms: Tuple[Tuple[str, torch.Tensor], ...] = ()


def _term_mult(op: "PAOperator", t: _BoundTerm, x: torch.Tensor) -> torch.Tensor:
    """Rᵀ apply(R x) of one term on a (vdim·ndof,) byNODES vector."""
    r, db = t.bdr or (op.restr, op.db)
    mod, vdim = t.mod, op.vdim
    if vdim == 1:
        return r.mult_transpose(mod.apply(db, t.qdata, r.mult(x)))
    if mod in _COMPONENTWISE:
        xs = x.view(vdim, -1)
        return torch.cat([r.mult_transpose(mod.apply(db, t.qdata, r.mult(xs[c])))
                          for c in range(vdim)])
    return r.mult_transpose_vec(mod.apply(db, t.qdata, r.mult_vec(x, vdim)))


def _term_diagonal(op: "PAOperator", t: _BoundTerm) -> torch.Tensor:
    r, db = t.bdr or (op.restr, op.db)
    d = t.mod.diagonal(db, t.qdata)
    if d.dim() == 2:                # component-agnostic
        return r.mult_transpose(d).repeat(op.vdim)
    return r.mult_transpose_vec(d)


@dataclasses.dataclass(frozen=True, eq=False)
class PAOperator:
    """Partially assembled operator y = Σ_terms Rᵀ_t apply_t(qdata_t, R_t x)
    on (ndof·vdim,) byNODES vectors.

    ``terms`` holds every integrator (the diagonal); ``lane`` and
    ``std_terms`` partition them for ``mult`` into the fused lane-major
    group (scalar spaces) and the element-major rest.  ``restr`` and ``db``
    are the domain's restriction and basis."""

    terms: Tuple[_BoundTerm, ...]
    ndof: int
    restr: object
    db: DeviceBasis
    vdim: int = 1
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
            y = _term_mult(self, t, x)
            out = y if out is None else out + y
        return out

    def diagonal(self) -> torch.Tensor:
        out = None
        for t in self.terms:
            d = _term_diagonal(self, t)
            out = d if out is None else out + d
        return out

    def operator(self) -> LinearOperator:
        n = self.ndof * self.vdim
        return LinearOperator((n, n), self.mult, self.diagonal)


def _geom_affine_term(t: _Term, geo, qdata):
    """A term's affine factors from the host-float64 geometry ``geo`` =
    (det, dk, adj), in the qdata's dtype and device, with a leading
    component axis (mass gets a singleton one); None unless the
    coefficient is a constant scalar (and, for convection, the velocity a
    constant vector)."""
    c = t.coeff
    if c is None:
        cs = 1.0
    elif not callable(c) and np.ndim(c) == 0:
        cs = float(c)
    else:
        return None
    det, dk, adj = geo
    kw = dict(dtype=qdata.dtype, device=qdata.device)
    if t.kind == "mass" and t.vector_coeff is None:
        return torch.as_tensor(cs * det, **kw)[None, :]
    if t.kind == "diffusion" and t.vector_coeff is None:
        return torch.as_tensor(cs * dk, **kw)
    if t.kind == "convection" and t.vector_coeff is not None:
        v = t.vector_coeff
        if callable(v) or np.ndim(v) != 1:
            return None
        # (v·∇u, w): qdata = w_q ⊗ (adj(J) v) per element
        v = torch.as_tensor(v, dtype=torch.float64).cpu().numpy()
        return torch.as_tensor(cs * np.einsum("eds,s->de", adj, v), **kw)
    return None


def _build_lane_group(terms, bound, vdim, mesh, db):
    """Partition the terms into the fused lane-major group and the rest, as
    the JAX package's ``_build_lane_group``: on a scalar space, the domain
    mass, diffusion and convection terms (they share the domain's
    restriction and basis ``db``).  On a
    straight-sided simplex mesh a term with a constant coefficient joins as
    affine factors from the vertices (float32 qdata of sliver tets defeat a
    numerical check); otherwise a term whose transposed qdata separate as
    W ⊗ d joins as affine factors (``lanemajor.try_affine``), else as
    transposed qdata."""
    if vdim > 1:
        return None, ()
    geo = None
    if config.affine_collapse != "off":
        J = affine_element_jacobians(mesh)
        if J is not None:
            geo = (*affine_packed_factors(J), _np_det_adj(J)[1])
    lane_terms, aff_terms, std = [], [], []
    for t, bt in zip(terms, bound):
        if (t.boundary or t.kind not in ("mass", "diffusion", "convection")
                or not lanemajor.supports(db, bt.qdata, t.kind)):
            std.append(bt)
            continue
        d = _geom_affine_term(t, geo, bt.qdata) if geo is not None else None
        qT = None
        if d is None:
            qT = lanemajor.transpose_qdata(t.kind, bt.qdata)
            d = lanemajor.try_affine(t.kind, qT, db)
        if d is not None:
            aff_terms.append((t.kind, d))
        else:
            lane_terms.append((t.kind, qT))
    if not lane_terms and not aff_terms:
        return None, tuple(std)
    lb = lanemajor.lane_basis(db)
    return (_LaneGroup(lb=lb, terms=tuple(lane_terms),
                       af=lanemajor.affine_ops(db, lb) if aff_terms else None,
                       aff_terms=tuple(aff_terms)),
            tuple(std))


def _chunk(c, e0, e1):
    """The rows [e0, e1) of a per-element array coefficient; scalars and
    callables as they are."""
    if c is None or callable(c) or np.ndim(c) == 0:
        return c
    return c[e0:e1]


def _setup_term(t: _Term, gf, dtype, packed=True):
    """A domain or boundary term's qdata on the factors ``gf``; diffusion
    with a scalar coefficient is packed unless ``packed`` is False."""
    mod = _INTEGRATORS[t.kind]
    if t.kind == "elasticity":
        lam, mu = t.coeff if t.coeff is not None else (None, None)
        return mod.setup(gf, eval_coeff(lam, gf, dtype), eval_coeff(mu, gf, dtype))
    cq = eval_coeff(t.coeff, gf, dtype)
    if t.vector_coeff is not None:
        return mod.setup(gf, cq, eval_vector_coeff(t.vector_coeff, gf, dtype))
    if packed and t.kind == "diffusion" and (cq is None or cq.dim() == 2):
        return mod.setup_packed(gf, cq)
    return mod.setup(gf, cq)


class BilinearForm:
    """Sum of domain and boundary integrators on one space; ``device=None``
    is the card."""

    def __init__(self, fes, device=None, nq1d: Optional[int] = None):
        self.fes = fes
        self.device = resolve_device(device)
        self.nq1d = nq1d
        self._terms: List[_Term] = []

    def add_domain_integrator(self, kind: str, coeff=None,
                              vector_coeff=None) -> "BilinearForm":
        if kind not in _INTEGRATORS:
            raise ValueError(f"unknown integrator {kind!r}; have "
                             f"{sorted(_INTEGRATORS)}")
        self._terms.append(_Term(kind, coeff, vector_coeff))
        return self

    def add_boundary_integrator(self, kind: str, coeff=None,
                                marker=None) -> "BilinearForm":
        """Boundary terms: ``"mass"``, Robin (σu, v)_∂Ω on the faces whose
        attribute is in ``marker`` (all faces if None)."""
        if kind != "mass":
            raise NotImplementedError("boundary integrators: only 'mass' (Robin)")
        self._terms.append(_Term(kind, coeff, boundary=True, marker=marker))
        return self

    def assemble(self, dtype=None) -> PAOperator:
        """PARTIAL assembly: qdata of every term, and the matrix-free
        operator over the space's restrictions and bases (shared through
        ``fem/build.py``)."""
        fes, dev = self.fes, self.device
        dom_db = basis_for(fes, dtype, dev, self.nq1d)
        dom_restr = restriction_for(fes, dev)
        bound = []
        for t in self._terms:
            if t.boundary:
                gf, db = bdr_geom_for(fes, self.nq1d, dtype, dev)
                qd = _setup_term(t, gf, dtype)
                if t.marker is not None:
                    qd = qd * bdr_marker_mask(fes.mesh, t.marker, qd.dtype,
                                              qd.device)[:, None]
                bound.append(_BoundTerm(t.kind, _INTEGRATORS[t.kind], qd,
                                        (bdr_restriction_for(fes, dev), db)))
            else:
                gf = geom_factors_for(fes, self.nq1d, dtype, dev)
                bound.append(_BoundTerm(t.kind, _INTEGRATORS[t.kind],
                                        _setup_term(t, gf, dtype)))
        vdim = getattr(fes, "vdim", 1)
        lane, std = _build_lane_group(self._terms, bound, vdim, fes.mesh, dom_db)
        return PAOperator(terms=tuple(bound), ndof=fes.ndof_scalar,
                          restr=dom_restr, db=dom_db, vdim=vdim, lane=lane,
                          std_terms=std)

    def assemble_ell(self, dtype=None):
        """FULL assembly packed into a device :class:`~.ell.ELLOperator` in
        ``dtype`` (one SELL weight plane; the low-order simplex fast path
        of the JAX package)."""
        from .ell import ELLOperator

        return ELLOperator.from_csr(self.assemble_matrix(dtype), real_t(dtype),
                                    device=self.device)

    def assemble_matrix(self, dtype=None):
        """FULL assembly to a scipy CSR matrix (float64 data)."""
        import scipy.sparse as sp

        fes = self.fes
        vdim = getattr(fes, "vdim", 1)
        if any(t.kind == "elasticity" for t in self._terms):
            if len(self._terms) != 1:
                raise NotImplementedError("elasticity must be the sole term")
            return _to_csr(*_element_entries(fes, self, self._terms, False,
                                             dtype, vdim), fes.ndof_scalar * vdim)
        keys, vals = [], []
        for boundary in (False, True):
            terms = [t for t in self._terms if t.boundary == boundary]
            if terms:
                k, v = _element_entries(fes, self, terms, boundary, dtype, 1)
                keys.append(k)
                vals.append(v)
        n = fes.ndof_scalar
        if not keys:
            A = sp.csr_matrix((n, n))
        else:
            A = _to_csr(torch.cat(keys), torch.cat(vals), n)
        if vdim > 1:
            A = sp.block_diag([A] * vdim).tocsr()
        return A


def _element_entries(fes, form, terms, boundary, dtype, vdim):
    """The (row·N + column) keys and float64 values of every element
    matrix entry of ``terms`` (all domain or all boundary), summed over
    the terms per element, computed on the form's device in chunks of
    ``_CHUNK`` elements.  ``vdim`` > 1 is elasticity's coupled matrix
    (components byNODES)."""
    dev = form.device
    mesh, p = fes.mesh, fes.order
    if boundary:
        d2q = bdr_dof_to_quad(fes, form.nq1d)
        X = element_node_coords(bdr_mesh(mesh), p)
        gmap = fes.bdr_gather_map
    else:
        d2q = fes.dof_to_quad(form.nq1d)
        X = element_node_coords(mesh, p)
        gmap = fes.gather_map
    B = torch.as_tensor(d2q.full_B(), dtype=torch.float64, device=dev)
    G = torch.as_tensor(d2q.full_G(), dtype=torch.float64, device=dev)
    ne, nd = gmap.shape
    ndofs = fes.ndof_scalar
    N = ndofs * vdim
    gm = torch.as_tensor(gmap, dtype=torch.int64, device=dev)
    if vdim > 1:
        comp = torch.arange(vdim, device=dev) * ndofs
        gm = (gm[:, None, :] + comp[None, :, None]).reshape(ne, vdim * nd)
    keys = (gm[:, :, None] * N + gm[:, None, :]).reshape(-1)
    vals = torch.zeros(ne, vdim * nd, vdim * nd, dtype=torch.float64, device=dev)
    for e0 in range(0, ne, _CHUNK):
        e1 = min(e0 + _CHUNK, ne)
        gf = compute_geometric_factors(X[e0:e1], d2q, dtype, dev)
        for t in terms:
            tc = dataclasses.replace(t, coeff=_chunk(t.coeff, e0, e1),
                                     vector_coeff=_chunk(t.vector_coeff, e0, e1))
            if t.kind == "elasticity":
                vals[e0:e1] += _elasticity_element_matrices(gf, G, tc, dtype)
                continue
            q = _setup_term(tc, gf, dtype, packed=False).double()
            if boundary and t.marker is not None:
                q = q * bdr_marker_mask(mesh, t.marker, q.dtype, dev)[e0:e1, None]
            vals[e0:e1] += _element_matrices(t.kind, B, G, q)
    return keys, vals.reshape(-1)


def _element_matrices(kind: str, B, G, q) -> torch.Tensor:
    if kind == "mass":
        return torch.einsum("qm,eq,qn->emn", B, q, B)
    if kind == "diffusion":
        return torch.einsum("qma,eqab,qnb->emn", G, q, G)
    if kind == "convection":        # (v·∇u, w): rows test B, columns trial G
        return torch.einsum("qm,eqa,qna->emn", B, q, G)
    raise NotImplementedError(f"element matrices for {kind}")


def _elasticity_element_matrices(gf, G, t: _Term, dtype) -> torch.Tensor:
    """(ne, dim·nd, dim·nd) element matrices [(c, m), (d, n)] of
    λ (div u)(div v) + μ (∇u + ∇uᵀ):∇v, in float64 from the physical
    gradients."""
    from ..fem.geom_factors import adjugate

    lam_c, mu_c = t.coeff if t.coeff is not None else (None, None)
    A = adjugate(gf.jac).double()
    det = gf.det.double()
    w = gf.w.double()
    lam = eval_coeff(lam_c, gf, dtype)
    mu = eval_coeff(mu_c, gf, dtype)
    lam = 1.0 if lam is None else lam.double()
    mu = 1.0 if mu is None else mu.double()
    Gp = torch.einsum("eqra,qnr->eqna", A, G) / det[..., None, None]
    wdet = w[None, :] * det
    lam_q, mu_q = lam * wdet, mu * wdet
    div = torch.einsum("eq,eqma,eqnb->emanb", lam_q, Gp, Gp)
    cross = torch.einsum("eq,eqma,eqnb->emanb", mu_q, Gp, Gp)
    lap = torch.einsum("eq,eqma,eqna->emn", mu_q, Gp, Gp)
    ne, _, nd, dim = Gp.shape
    el = torch.zeros(ne, dim, nd, dim, nd, dtype=torch.float64, device=Gp.device)
    for c in range(dim):
        for d in range(dim):
            el[:, c, :, d, :] = div[:, :, c, :, d] + cross[:, :, d, :, c]
            if c == d:
                el[:, c, :, d, :] += lap
    return el.reshape(ne, dim * nd, dim * nd)


def _to_csr(keys: torch.Tensor, vals: torch.Tensor, n: int):
    """Canonical n×n CSR of (row·n + column) keys: duplicates summed in a
    fixed order on the keys' device, exact zeros dropped."""
    import scipy.sparse as sp

    uniq, sums = sum_duplicates(keys, vals)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    indptr[1:] = torch.cumsum(torch.bincount(uniq // n, minlength=n), 0)
    A = sp.csr_matrix((sums.cpu().numpy(), (uniq % n).int().cpu().numpy(),
                       indptr.cpu().numpy()), shape=(n, n))
    A.eliminate_zeros()
    return A
