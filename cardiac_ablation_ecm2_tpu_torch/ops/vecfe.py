"""H(curl)/H(div) operators: vector mass, curl-curl and div-div on the ND
and RT spaces (counterpart of ``cardiac_ablation_ecm2_tpu/ops/vecfe.py``;
MFEM's ``VectorFEMassIntegrator``, ``CurlCurlIntegrator`` and
``DivDivIntegrator``), the discrete de Rham maps and the vector linear
forms.

Pullbacks on an element with Jacobian J:

* H(curl): E = J^{-T} Ê; curl E = J (∇̂×Ê)/det J (3D), (∇̂×Ê)/det J (2D)
* H(div):  u = J û / det J; div u = (∇̂·û)/det J

Each term keeps its physical basis per element and quadrature point, the
JAX package's design, laid out (ne, ndl, nq, c) so that the apply is two
batched matrix products per term (``torch.bmm``).  The gather and the
scatter are the space's ``fem/restriction.ElementRestriction``: L→E is
``gather_sum`` and E→L the deterministic ``segment_sum`` on the card.
The ±1 signs, or the simplex DofTransformation, act in the element layout
between the restriction and the products (the JAX package's ``_pre`` /
``_post``).  The discrete gradient, curl and divergence are restrictions
too, over the (nedge, 2), (nface, nfv) and element-face maps, with their
weights applied in the element layout: the forward map is the L→E kernel
and the adjoint (``.t``) its ``segment_sum``.

Callables: a coefficient takes the (ne, nq, sdim) tensor of physical
points (the port's convention); a right-hand side ``fn`` of a linear form
takes them as host numpy, as the JAX package's linear forms do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..fem.basis import h1_nodes, make_dof_to_quad
from ..fem.fe_vector import RTSpace, nd0_basis, rt0_basis
from ..fem.fe_vector_ho import nd_basis_ho, rt_basis_ho
from ..fem.fe_vector_simplex import VectorSimplexSpace, simplex_vec_element
from ..fem.fespace import element_node_coords
from ..fem.geom_factors import adjugate, compute_geometric_factors
from ..fem.geometry import EDGES, FACES, REF_VERTS, Geometry
from ..fem.intrules import simplex_rule, tensor_rule
from ..fem.restriction import ElementRestriction
from ..mesh.mesh import _row_ids, unique_edges, unique_faces
from ..utils.config import real_t, resolve_device
from ..utils.native import encode_rows


def _restriction(space, device):
    """The space's ``ElementRestriction`` on ``device``, built once per
    device and kept on the space."""
    cache = space.__dict__.setdefault("_restrictions", {})
    if device not in cache:
        cache[device] = ElementRestriction(space.gather_map, space.ndof, device)
    return cache[device]


@dataclasses.dataclass(eq=False)
class VecFEOperator:
    """Matrix-free sum of mass/curl-curl (ND) or mass/div-div (RT) terms.

    ``terms``: (name, qd, B) with B the physical basis (ne, ndl, nq, c) and
    qd the (ne, nq) weights or (ne, nq, c, c) matrix weights.  Orientation:
    ``signs`` (ne, ndl), or the space's ``transform`` / ``transform_t``
    (``tf`` True)."""

    space: object
    restr: ElementRestriction
    signs: Optional[torch.Tensor]
    terms: tuple
    ndof: int
    gf: object = None             # GeometricFactors (for linear forms)
    tf: bool = False

    @property
    def device(self):
        return self.restr.g.device

    def _pre(self, e):
        return self.space.transform(e) if self.tf else e * self.signs

    def _post(self, y):
        return self.space.transform_t(y) if self.tf else y * self.signs

    def term(self, name: str):
        """(qd, B) of the term ``name``; ``ValueError`` if absent."""
        for n, qd, B in self.terms:
            if n == name:
                return qd, B
        raise ValueError(f"operator has no {name!r} term; build it with the "
                         "matching coefficient to expose the physical basis")

    def element_values(self, x: torch.Tensor) -> torch.Tensor:
        """Reference-oriented element coefficients (ne, ndl) of ``x``."""
        return self._pre(self.restr.mult(x))

    def values(self, x: torch.Tensor, name: str = "mass") -> torch.Tensor:
        """The field of term ``name`` at the quadrature points, (ne, nq, c)."""
        _, B = self.term(name)
        return eval_basis(B, self.element_values(x))

    def pairs(self):
        """The terms' (qd, B) pairs."""
        return [(qd, B) for _, qd, B in self.terms]

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        y = apply_terms(self.pairs(), self._pre(self.restr.mult(x)))
        return self.restr.mult_transpose(self._post(y))

    def __call__(self, x):
        return self.mult(x)

    def elem_mats(self) -> torch.Tensor:
        """Element matrices (ne, ndl, ndl) in reference coefficients."""
        return element_matrices(self.pairs())

    def dense_transform(self) -> torch.Tensor:
        """(ne, ndl, ndl) canonical → reference matrices on the device."""
        T = self.space.dense_transform()
        return torch.as_tensor(T, dtype=self.terms[0][2].dtype, device=self.device)

    def canonical_elem_mats(self) -> torch.Tensor:
        """Element matrices in canonical dof values (Tᵀ A_e T, or sᵢsⱼ A_e)."""
        A_e = self.elem_mats()
        if self.tf:
            T = self.dense_transform()
            return torch.einsum("eml,emn,ens->els", T, A_e, T)
        return A_e * self.signs[:, :, None] * self.signs[:, None, :]

    def diagonal(self) -> torch.Tensor:
        d = (element_diagonal(self.pairs(), T=self.dense_transform()) if self.tf
             else element_diagonal(self.pairs(), signs=self.signs))
        return self.restr.mult_transpose(d.contiguous())

    def assemble_matrix(self):
        """Assembled scipy CSR (host, the FULL cross-check)."""
        import scipy.sparse as sp

        gm = np.asarray(self.space.gather_map, dtype=np.int64)
        ne, ndl = gm.shape
        A_e = self.canonical_elem_mats().detach().cpu().numpy()
        rows = np.repeat(gm, ndl, axis=1).reshape(-1)
        cols = np.tile(gm, (1, ndl)).reshape(-1)
        return sp.coo_matrix((A_e.reshape(-1), (rows, cols)),
                             shape=(self.ndof, self.ndof)).tocsr()


def eval_basis(B: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Σ_n B[e, n, q, c] e[e, n] → (ne, nq, c): a row vector times an
    (ndl, nq·c) panel per element."""
    ne, n, nq, c = B.shape
    return torch.bmm(e.unsqueeze(1), B.reshape(ne, n, nq * c)).view(ne, nq, c)


def eval_basis_t(B: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Σ_{q,c} B[e, n, q, c] v[e, q, c] → (ne, ndl)."""
    ne, n, nq, c = B.shape
    return torch.bmm(B.reshape(ne, n, nq * c), v.reshape(ne, nq * c, 1)).view(ne, n)


def apply_terms(terms, e: torch.Tensor) -> torch.Tensor:
    """Σ over (qd, B) terms of Bᵀ qd B e per element: the apply in the
    element layout, (ne, ndl) → (ne, ndl)."""
    y = None
    for qd, B in terms:
        t = eval_basis_t(B, couple(qd, eval_basis(B, e)))
        y = t if y is None else y + t
    return y


def element_diagonal(terms, signs=None, T=None) -> torch.Tensor:
    """The diagonal (ne, ndl) of the (qd, B) terms' element matrices in
    canonical dof values: diag(Tᵀ A_e T) with the dense transforms ``T``
    (ne, ndl, ndl), else the weighted squares times ``signs``²."""
    if T is not None:
        A_e = element_matrices(terms)
        return torch.diagonal(torch.einsum("eml,emn,ens->els", T, A_e, T), dim1=1, dim2=2)
    d = None
    for qd, B in terms:
        t = basis_diagonal(B, qd)
        d = t if d is None else d + t
    return d * signs * signs


def element_matrices(terms) -> torch.Tensor:
    """Σ over (qd, B) terms of Bᵀ qd B per element: (ne, ndl, ndl)."""
    A_e = None
    for qd, B in terms:
        ne, n, nq, c = B.shape
        QB = couple(qd, B.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        t = torch.bmm(B.reshape(ne, n, nq * c), QB.reshape(ne, n, nq * c).transpose(1, 2))
        A_e = t if A_e is None else A_e + t
    return A_e


def basis_diagonal(B: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """Σ_{q,c,d} B[e, n, q, c] qd[e, q, c, d] B[e, n, q, d] → (ne, ndl)
    (scalar qd: the weighted squares)."""
    if qd.dim() == 4:
        return torch.einsum("enqc,eqcd,enqd->en", B, qd, B)
    return torch.einsum("enqc,eq->en", B * B, qd)


def couple(qd: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The quadrature weights on the field channels: scalar (ne, nq) or
    matrix (ne, nq, c, c) qdata on v (ne, nq, c[, ...])."""
    if qd.dim() == 4:
        return torch.einsum("eqcd,eqd...->eqc...", qd, v)
    return v * qd.reshape(qd.shape + (1,) * (v.dim() - 2))


def geometry(mesh, nq1d, dtype, device, elems=None):
    """Order-1 geometric factors at the ``nq1d`` rule, of the elements
    ``elems`` (all when None)."""
    d2q = make_dof_to_quad(mesh.geom, 1, nq1d)
    X = element_node_coords(mesh, 1)
    return compute_geometric_factors(X if elems is None else X[elems], d2q,
                                     dtype=dtype, device=device)


def _coeff_q(coeff, gf, rt):
    """A callable, array or scalar coefficient as a tensor on the factors'
    device (a callable gets the physical points)."""
    kw = dict(dtype=rt, device=gf.det.device)
    return torch.as_tensor(coeff(gf.x) if callable(coeff) else coeff, **kw)


def mass_qd(gf, coeff, rt):
    """Mass qdata for a scalar, field or (dim×dim) matrix coefficient: a
    matrix gives (ne, nq, d, d) qdata."""
    w = gf.wdet
    if callable(coeff):
        C = _coeff_q(coeff, gf, rt)
        return w[..., None, None] * C if C.dim() == 4 else w * C
    C = np.asarray(coeff)
    if C.ndim == 2:
        return w[..., None, None] * _coeff_q(C, gf, rt)[None, None]
    return float(coeff) * w


def scalar_qd(gf, coeff, rt):
    """Weights for a scalar channel (2D curl, divergence): a scalar or a
    callable scalar field."""
    if callable(coeff):
        return _coeff_q(coeff, gf, rt) * gf.wdet
    return float(coeff) * gf.wdet


def _t(a, rt, device):
    return torch.as_tensor(a, dtype=rt, device=device)


def nd_tables(space, nq1d):
    """Reference (pts, B, CURL) of an ND space at the ``nq1d`` rule."""
    geom = space.mesh.geom
    if isinstance(space, VectorSimplexSpace):
        el = simplex_vec_element(geom, "nd", space.order, 2 * nq1d - 1)
        return el["pts"], el["B"], el["D"]
    if getattr(space, "kind", None) == "nd":
        return nd_basis_ho(geom, space.order, nq1d)
    return nd0_basis(geom, nq1d)


def rt_tables(space, nq1d):
    """Reference (pts, B, DIV (nq, ndl)) of an RT space."""
    geom = space.mesh.geom
    if isinstance(space, VectorSimplexSpace):
        el = simplex_vec_element(geom, "rt", space.order, 2 * nq1d - 1)
        return el["pts"], el["B"], el["D"][..., 0]
    if getattr(space, "kind", None) == "rt":
        return rt_basis_ho(geom, space.order - 1, nq1d)
    return rt0_basis(geom, nq1d)


def covariant(gf, Bref, rt):
    """J^{-T} B̂ per element: (ne, ndl, nq, dim), contiguous (einsum's
    output is a permuted view, which every apply's reshape would copy)."""
    Jinv = adjugate(gf.jac) / gf.det[..., None, None]
    return torch.einsum("eqab,qna->enqb", Jinv,
                        _t(Bref, rt, gf.det.device)).contiguous()


def piola(gf, Bref, rt):
    """J B̂ / det J per element: (ne, ndl, nq, dim), contiguous."""
    Jd = gf.jac / gf.det[..., None, None]
    return torch.einsum("eqab,qnb->enqa", Jd, _t(Bref, rt, gf.det.device)).contiguous()


def nd_terms(space, mass_coeff, curlcurl_coeff, nq1d, rt, device, elems=None):
    """(terms, gf) of α (E, F) + β (curl E, curl F) on the elements
    ``elems`` of an ND space (all when None)."""
    mesh = space.mesh
    gf = geometry(mesh, nq1d, rt, device, elems)
    _, Bref, Cref = nd_tables(space, nq1d)
    terms = []
    if mass_coeff is not None:
        terms.append(("mass", mass_qd(gf, mass_coeff, rt), covariant(gf, Bref, rt)))
    if curlcurl_coeff is not None:
        if mesh.dim == 3:
            # a scalar, field or (3×3) matrix reluctivity on the 3-channel curl
            terms.append(("curlcurl", mass_qd(gf, curlcurl_coeff, rt),
                          piola(gf, Cref, rt)))
        else:
            C = _t(Cref[..., 0], rt, device)[None] / gf.det[..., None]
            terms.append(("curlcurl", scalar_qd(gf, curlcurl_coeff, rt),
                          C.transpose(1, 2).unsqueeze(-1).contiguous()))
    return terms, gf


def rt_terms(space, mass_coeff, divdiv_coeff, nq1d, rt, device, elems=None):
    """(terms, gf) of α (u, v) + β (div u, div v) on the elements ``elems``
    of an RT space (all when None)."""
    gf = geometry(space.mesh, nq1d, rt, device, elems)
    _, Bref, Dref = rt_tables(space, nq1d)
    terms = []
    if mass_coeff is not None:
        terms.append(("mass", mass_qd(gf, mass_coeff, rt), piola(gf, Bref, rt)))
    if divdiv_coeff is not None:
        D = _t(Dref, rt, device)[None] / gf.det[..., None]
        terms.append(("divdiv", scalar_qd(gf, divdiv_coeff, rt),
                      D.transpose(1, 2).unsqueeze(-1).contiguous()))
    return terms, gf


def build_nd_operator(space, mass_coeff=1.0, curlcurl_coeff=None, nq1d: int = 3,
                      dtype=None, device=None) -> VecFEOperator:
    """α (E, F) + β (curl E, curl F) on an ND space (``NDSpace``,
    ``NDSpaceHO`` or ``NDSimplexSpace``); ``device=None`` is the card."""
    device, rt = resolve_device(device), real_t(dtype)
    terms, gf = nd_terms(space, mass_coeff, curlcurl_coeff, nq1d, rt, device)
    return make_operator(space, terms, gf, rt, device)


def build_rt_operator(space, mass_coeff=1.0, divdiv_coeff=None, nq1d: int = 3,
                      dtype=None, device=None) -> VecFEOperator:
    """α (u, v) + β (div u, div v) on an RT space; ``device=None`` is the
    card."""
    device, rt = resolve_device(device), real_t(dtype)
    terms, gf = rt_terms(space, mass_coeff, divdiv_coeff, nq1d, rt, device)
    return make_operator(space, terms, gf, rt, device)


def make_operator(space, terms, gf, rt, device) -> VecFEOperator:
    tf = hasattr(space, "transform")
    signs = None if tf else _t(space.signs, rt, device)
    return VecFEOperator(space=space, restr=_restriction(space, device),
                         signs=signs, terms=tuple(terms), ndof=space.ndof,
                         gf=gf, tf=tf)


def host_points(gf) -> np.ndarray:
    return gf.x.detach().cpu().numpy()


def vecfe_linear_form(op: VecFEOperator, vec_fn: Callable) -> torch.Tensor:
    """(c, φ) for a vector field c(x) (VectorFEDomainLFIntegrator), on the
    operator's mass term."""
    return _lf_against(op, "mass", vec_fn)


def vecfe_linear_form_curl(op: VecFEOperator, fn: Callable) -> torch.Tensor:
    """(f, curl φ) (VectorFEDomainLFCurlIntegrator): ``fn`` a 3-vector in
    3D, a scalar in 2D; the operator needs a curl-curl term."""
    return _lf_against(op, "curlcurl", fn)


def vecfe_linear_form_div(op: VecFEOperator, fn: Callable) -> torch.Tensor:
    """(f, div φ) on RT (VectorFEDomainLFDivIntegrator): ``fn`` scalar; the
    operator needs a div-div term."""
    return _lf_against(op, "divdiv", fn)


def _lf_against(op: VecFEOperator, term: str, fn: Callable) -> torch.Tensor:
    _, B = op.term(term)
    f = torch.as_tensor(fn(host_points(op.gf)), dtype=B.dtype, device=B.device)
    if f.dim() == 2:                              # scalar data of a 1-channel term
        f = f[..., None]
    v = eval_basis_t(B, op.gf.wdet[..., None] * f)
    return op.restr.mult_transpose(op._post(v))


# ----------------------------------------------------------------------------
# discrete de Rham operators (ex24 DiscreteLinearOperator analogs)
# ----------------------------------------------------------------------------


class Incidence:
    """y[i] = Σ_j w[i, j] x[map[i, j]] over an (n, k) map into ``ndof``
    entries with (n, k) weights: the forward map is the map's L→E kernel,
    the adjoint :meth:`t` its deterministic ``segment_sum``."""

    def __init__(self, gmap: np.ndarray, ndof: int, weights, device, dtype=None):
        self.restr = ElementRestriction(np.asarray(gmap), ndof, device)
        self.weights = None if weights is None else torch.as_tensor(
            weights, dtype=real_t(dtype), device=self.restr.g.device)

    def _w(self, x):
        return self.weights.to(x.dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (self.restr.mult(x) * self._w(x)).sum(dim=1)

    def t(self, y: torch.Tensor) -> torch.Tensor:
        return self.restr.mult_transpose(y[:, None] * self._w(y))


def discrete_gradient(h1_fes, nd_space, device=None, dtype=None) -> Incidence:
    """G: H1 (order 1) → ND0, (Gu)_edge = u(max) − u(min) (∫ ∇u·t dl)."""
    edges = getattr(nd_space, "edges", None)
    if edges is None:
        edges, _ = unique_edges(nd_space.mesh)
    vmap = _vertex_dof_map(h1_fes)
    w = np.tile(np.array([-1.0, 1.0]), (len(edges), 1))
    return Incidence(vmap[edges], h1_fes.ndof_scalar, w, resolve_device(device),
                     dtype)


def face_cycles(mesh, elem_face=None) -> np.ndarray:
    """(nface, nfv) canonical cycle of every unique face, taken from its
    first incident element (argmin vertex, then its smaller neighbour);
    ``elem_face`` the (ne, nlf) face ids when known."""
    if elem_face is None:
        _, elem_face = unique_faces(mesh)
    nf = int(elem_face.max()) + 1
    loc = np.array(FACES[mesh.geom], dtype=np.int64)
    nlf, nfv = loc.shape
    gids = mesh.elements[:, loc].reshape(-1, nfv)       # (ne·nlf, nfv) cyclic
    _, first = np.unique(elem_face.reshape(-1), return_index=True)
    g = gids[first]                                      # (nf, nfv)
    ar = np.arange(nf)
    r = np.argmin(g, axis=1)
    d = np.where(g[ar, (r + 1) % nfv] < g[ar, (r - 1) % nfv], 1, -1)
    return np.stack([g[ar, (r + d * i) % nfv] for i in range(nfv)], axis=1)


def discrete_curl(nd_space, rt_space, device=None, dtype=None) -> Incidence:
    """C: ND0 → RT0 (3D), (CE)_face = ∮_∂f E·t, the signed sum of the
    face's edge dofs around its canonical cycle.  With
    :func:`discrete_gradient` C∘G = 0, with :func:`discrete_divergence`
    D∘C = 0."""
    mesh = nd_space.mesh
    if mesh.dim != 3:
        raise ValueError("discrete_curl: 3D meshes")
    edges = nd_space.edges if hasattr(nd_space, "edges") else unique_edges(mesh)[0]
    cyc = face_cycles(mesh, rt_space.gather_map if isinstance(rt_space, RTSpace) else None)
    a, b = cyc, np.roll(cyc, -1, axis=1)
    pairs = np.stack([np.minimum(a, b), np.maximum(a, b)], axis=-1)
    eid = _row_ids(edges, pairs.reshape(-1, 2)).reshape(cyc.shape)
    return Incidence(eid, nd_space.ndof, np.where(a < b, 1.0, -1.0),
                     resolve_device(device), dtype)


class Divergence:
    """D: RT0 → P0, (Du)|_K = (Σ outward-signed face dofs)/|K|."""

    def __init__(self, rt_space, device, dtype):
        mesh = rt_space.mesh
        rt = real_t(dtype)
        gf = geometry(mesh, 2, rt, device)
        self.op = Incidence(rt_space.gather_map, rt_space.ndof, rt_space.signs,
                            device, dtype)
        self.vol = gf.wdet.sum(dim=1)                    # (ne,)

    def __call__(self, u):
        return self.op(u) / self.vol.to(u.dtype)

    def t(self, p):
        return self.op.t(p / self.vol.to(p.dtype))


def discrete_divergence(rt_space, l2_fes=None, device=None, dtype=None) -> Divergence:
    """D: RT0 → P0(L2), exact since div u is constant per element for RT0;
    D∘C = 0 identically."""
    return Divergence(rt_space, resolve_device(device), dtype)


def _vertex_of_dof(mesh) -> np.ndarray:
    """The element vertex at each lex order-1 local dof (matched on the
    reference element: the same match as on any non-degenerate element)."""
    X0 = h1_nodes(mesh.geom, 1)
    V0 = REF_VERTS[mesh.geom]
    vtx_of_dof = np.array([int(np.argmin(((V0 - X0[n]) ** 2).sum(axis=1)))
                           for n in range(X0.shape[0])])
    if len(np.unique(vtx_of_dof)) != len(vtx_of_dof):
        raise ValueError("the order-1 nodes do not match the element vertices")
    return vtx_of_dof


def vertex_dof_positions(mesh) -> np.ndarray:
    """dofpos[v]: the lex order-1 local dof of element vertex v."""
    vtx_of_dof = _vertex_of_dof(mesh)
    dofpos = np.empty_like(vtx_of_dof)
    dofpos[vtx_of_dof] = np.arange(len(vtx_of_dof))
    return dofpos


def _vertex_dof_map(h1_fes) -> np.ndarray:
    """vertex id → H1 order-1 scalar dof id (the lex local dof order is a
    permutation of the element vertex order on tensor geometries)."""
    mesh = h1_fes.mesh
    if h1_fes.order != 1:
        raise ValueError("the vertex map needs an order-1 H1 space")
    out = np.zeros(mesh.nv, dtype=np.int64)
    out[mesh.elements[:, _vertex_of_dof(mesh)].reshape(-1)] = \
        h1_fes.gather_map.reshape(-1)
    return out


# ----------------------------------------------------------------------------
# boundary linear forms
# ----------------------------------------------------------------------------


def _face_chart(geom, pts: np.ndarray):
    """P1/Q1 face chart shape values N (nq, nv) and gradients G (nq, nv, 2)."""
    u, v = pts[:, 0], pts[:, 1]
    if geom == Geometry.TRIANGLE:
        N = np.stack([1 - u - v, u, v], axis=1)
        G = np.broadcast_to(np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]),
                            (len(pts), 3, 2)).copy()
        return N, G
    if geom == Geometry.SQUARE:
        N = np.stack([(1 - u) * (1 - v), u * (1 - v), u * v, (1 - u) * v], axis=1)
        Gu = np.stack([-(1 - v), (1 - v), v, -v], axis=1)
        Gv = np.stack([-(1 - u), -u, u, (1 - u)], axis=1)
        return N, np.stack([Gu, Gv], axis=2)
    raise ValueError(geom)


def _chart_outward_signs(mesh, bdr: np.ndarray, x: np.ndarray,
                         J: np.ndarray) -> np.ndarray:
    """+1 where the face chart's normal points out of the volume (centroid
    test against the element that holds the face)."""
    nc = np.cross(J[:, :, :, 0], J[:, :, :, 1]).mean(axis=1)   # (nbf, 3)
    loc = np.array(FACES[mesh.geom], dtype=np.int64)
    efaces = np.sort(mesh.elements[:, loc], axis=2).reshape(-1, loc.shape[1])
    _, ids, q = encode_rows(efaces, np.sort(bdr, axis=1))
    first = np.empty(int(ids.max()) + 1, dtype=np.int64)
    first[ids[::-1]] = np.arange(len(ids))[::-1]         # first (element, face)
    elem = first[q] // loc.shape[0]
    cent = mesh.vertices[mesh.elements[elem]].mean(axis=1)
    return np.where(np.einsum("fd,fd->f", nc, x.mean(axis=1) - cent) < 0, -1.0, 1.0)


def nd_boundary_tangent_lf(space, vec_fn, bdr_marker=None, nq1d: int = 3,
                           dtype=None, device=None) -> torch.Tensor:
    """∮ (n × f)·v over marked boundary faces of a 3D mesh for the ND0 test
    space (VectorFEBoundaryTangentLFIntegrator): assembled on the face mesh
    from the faces' own 2D ND0 basis (host numpy, as the JAX package)."""
    mesh = space.mesh
    rt = real_t(dtype)
    device = resolve_device(device)
    if mesh.dim != 3:
        raise NotImplementedError("nd_boundary_tangent_lf: 3D meshes only")
    if getattr(space, "order", 1) != 1 or isinstance(space, RTSpace):
        raise NotImplementedError("nd_boundary_tangent_lf: ND0 spaces only")
    bdr = mesh.boundary
    if bdr_marker is not None:
        bdr = bdr[np.isin(mesh.bdr_attributes, np.asarray(list(bdr_marker)))]
    if len(bdr) == 0:
        return torch.zeros(space.ndof, dtype=rt, device=device)
    fgeom = mesh.bdr_geom
    pts, B2, _ = nd0_basis(fgeom, nq1d)
    if fgeom == Geometry.TRIANGLE:
        _, w = simplex_rule(2, 2 * nq1d - 1)
    else:
        _, w = tensor_rule(2, nq1d)
    N, G = _face_chart(fgeom, pts)
    X = mesh.vertices[bdr]                              # (nbf, nv, 3)
    J = np.einsum("qvd,fvs->fqsd", G, X)                # (nbf, nq, 3, 2)
    x = np.einsum("qv,fvs->fqs", N, X)                  # (nbf, nq, 3)
    f = np.broadcast_to(np.asarray(vec_fn(x) if callable(vec_fn) else vec_fn,
                                   np.float64), x.shape)
    fh = np.einsum("fqsd,fqs->fqd", J, f)               # Jᵀ f
    rot = np.stack([-fh[..., 1], fh[..., 0]], axis=-1)  # chart rep of n×f
    s = _chart_outward_signs(mesh, bdr, x, J)
    elv = np.einsum("qkd,fqd,q->fk", B2, rot, w) * s[:, None]
    edges, _ = unique_edges(mesh)
    base = np.int64(mesh.nv + 1)
    ekey = edges[:, 0].astype(np.int64) * base + edges[:, 1]
    order = np.argsort(ekey)
    loc = np.array(EDGES[fgeom])
    fa, fb = bdr[:, loc[:, 0]], bdr[:, loc[:, 1]]
    key = np.minimum(fa, fb).astype(np.int64) * base + np.maximum(fa, fb)
    gid = order[np.searchsorted(ekey[order], key)]
    sgn = np.where(fa < fb, 1.0, -1.0)
    b = np.zeros(space.ndof)
    np.add.at(b, gid.reshape(-1), (elv * sgn).reshape(-1))
    return torch.as_tensor(b, dtype=rt, device=device)
