"""Mixed-geometry meshes and H1 spaces (counterpart of
``cardiac_ablation_ecm2_tpu/fem/mixed.py``; MFEM's per-element-type
containers and geometry-batched kernels, one launch set per geometry).

A mixed mesh is a tuple of homogeneous **blocks**, one (geometry, elements,
attributes) batch per element type, over one vertex set.  The dof numbering
is the entity-key one of ``fem/fespace.py`` over every block's keys at once,
so blocks share the dofs of shared vertices, edges and faces (the simplex
edge nodes sit at the 1D Gauss-Lobatto positions of the tensor elements,
and the pyramid's at the same ones).  Each block has its own
``ElementRestriction``, and an operator is

    y = Σ_b R_bᵀ apply_b(qdata_b, R_b x),

each R_bᵀ one segment-sum, the blocks' sums added in block order, so the
result is deterministic.  The host tables (keys, gather maps, essential
dofs) are bitwise the JAX package's; its per-key Python loop over the
essential entities is a whole-array lookup here.

Callables (``project``, ``mixed_domain_lf``, a callable mass coefficient)
take the points as a tensor on the space's device in its dtype, as every
coefficient of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..mesh.mesh import Mesh
from ..utils.config import real_t, resolve_device
from ..utils.native import encode_rows
from .basis import make_dof_to_quad
from .fespace import _EDGE, _FACE, _KEYLEN, _VERT, _elem_node_keys, element_node_coords
from .geom_factors import compute_geometric_factors
from .geometry import DIMENSION, FACES, Geometry
from .quadinterp import device_basis, eval_values_t
from .restriction import ElementRestriction


@dataclasses.dataclass(eq=False)
class MixedMesh:
    """Mixed-geometry mesh: per-geometry element blocks over one vertex set."""

    vertices: np.ndarray                       # (nv, sdim)
    blocks: Tuple                              # ((geom, elements, attrs), …)
    boundary: np.ndarray                       # (nbe, 2) segments (2D)
    bdr_attributes: np.ndarray
    #: 3D: per-shape boundary face blocks ((geom, faces, attrs), …)
    boundary_blocks: Tuple = ()

    @property
    def nv(self) -> int:
        return len(self.vertices)

    @property
    def ne(self) -> int:
        return sum(len(b[1]) for b in self.blocks)

    @property
    def nbe(self) -> int:
        return len(self.boundary)

    @property
    def dim(self) -> int:
        return DIMENSION[self.blocks[0][0]]


def _block_mesh(mesh: MixedMesh, geom, elems) -> Mesh:
    """One block as a single-geometry mesh (no boundary), for its node
    coordinates."""
    return Mesh(geom=geom, vertices=mesh.vertices,
                elements=np.asarray(elems, dtype=np.int64),
                attributes=np.ones(len(elems), dtype=np.int64),
                boundary=np.zeros((0, 2), dtype=np.int64),
                bdr_attributes=np.zeros(0, dtype=np.int64))


def make_mixed_strip(n: int = 4) -> MixedMesh:
    """Unit square, 2n×n cells: the left half quads, the right half
    triangles (each quad cut along its (v0, v2) diagonal)."""
    from ..mesh.mesh import make_cartesian_2d

    h = make_cartesian_2d(2 * n, n)
    left = h.vertices[h.elements].mean(axis=1)[:, 0] < 0.5
    right = h.elements[~left]
    tris = np.stack([right[:, [0, 1, 2]], right[:, [0, 2, 3]]],
                    axis=1).reshape(-1, 3)
    return MixedMesh(
        vertices=h.vertices,
        blocks=(
            (Geometry.SQUARE, h.elements[left], h.attributes[left]),
            (Geometry.TRIANGLE, tris.astype(np.int64),
             np.repeat(h.attributes[~left], 2).astype(np.int64)),
        ),
        boundary=h.boundary,
        bdr_attributes=h.bdr_attributes,
    )


@dataclasses.dataclass(eq=False)
class MixedFESpace:
    """H1 space over a MixedMesh on ``device`` (``None``: the card): one
    conforming numbering shared by the blocks, and each block's gather map,
    DofToQuad (``nq1d`` = p + 2), geometric factors, device basis and
    ``ElementRestriction``, in ``dtype``."""

    mesh: MixedMesh
    order: int
    device: object = None
    dtype: object = None

    def __post_init__(self):
        p, mesh = self.order, self.mesh
        self.device = resolve_device(self.device)
        keys_all, nds = [], []
        offs = 0
        for (geom, elems, _a) in mesh.blocks:
            eids = np.arange(offs, offs + len(elems), dtype=np.int64)
            k = _elem_node_keys(geom, p, np.asarray(elems, dtype=np.int64), eids)
            keys_all.append(k.reshape(-1, _KEYLEN))
            nds.append(k.shape[1])
            offs += len(elems)
        flat = np.concatenate(keys_all, axis=0)
        count, ids, _ = encode_rows(flat, None)
        self.ndof_scalar = int(count)
        self.gather_maps = []
        pos = 0
        for (_g, elems, _a), nd in zip(mesh.blocks, nds):
            cnt = len(elems) * nd
            self.gather_maps.append(
                ids[pos:pos + cnt].reshape(len(elems), nd).astype(np.int32))
            pos += cnt
        self._keys_flat = flat
        self._ids = ids

        self.d2qs, self.gfs, self.dbs, self.restrictions = [], [], [], []
        for (geom, elems, _a), gm in zip(mesh.blocks, self.gather_maps):
            d2q = make_dof_to_quad(geom, p)
            X = element_node_coords(_block_mesh(mesh, geom, elems), p)
            self.d2qs.append(d2q)
            self.gfs.append(compute_geometric_factors(X, d2q, self.dtype,
                                                      self.device))
            self.dbs.append(device_basis(d2q, self.dtype, self.device))
            self.restrictions.append(
                ElementRestriction(gm, self.ndof_scalar, self.device))

    @property
    def ndof(self) -> int:
        return self.ndof_scalar

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        """Dofs on the marked boundary (``None``: all of it), sorted int32:
        the vertices, edges and (3D) faces of the boundary segments or face
        blocks, looked up among every block's node keys."""
        mesh = self.mesh
        keys = self._keys_flat
        etype = keys[:, 4] >> 48

        def marked(attrs):
            if bdr_marker is None:
                return np.ones(len(attrs), dtype=bool)
            return np.isin(attrs, np.asarray(list(bdr_marker)))

        if mesh.boundary_blocks:
            rows = [np.asarray(f, dtype=np.int64)[marked(a)]
                    for (_g, f, a) in mesh.boundary_blocks]
        else:
            rows = [np.asarray(mesh.boundary, dtype=np.int64)[
                marked(mesh.bdr_attributes)]]
        verts, edges, faces = [], [], []
        for r in rows:
            if not len(r):
                continue
            k = r.shape[1]
            verts.append(r.reshape(-1))
            e = np.stack([r, np.roll(r, -1, axis=1)], axis=2).reshape(-1, 2)
            edges.append(np.sort(e, axis=1))
            if mesh.boundary_blocks:
                f = np.full((len(r), 4), -1, dtype=np.int64)
                f[:, :k] = np.sort(r, axis=1)
                faces.append(f)
        ess = np.zeros(len(keys), dtype=bool)
        if verts:
            v = etype == _VERT
            ess[v] = np.isin(keys[v, 0], np.concatenate(verts))
            e = np.nonzero(etype == _EDGE)[0]
            ess[e] = _found(np.concatenate(edges), keys[e, :2])
            if faces:
                f = np.nonzero(etype == _FACE)[0]
                # a triangle's key is its sorted corners then −1, as the
                # padded boundary rows
                ess[f] = _found(np.concatenate(faces), keys[f, :4])
        return np.unique(self._ids[ess]).astype(np.int32)

    @property
    def dof_coords(self) -> np.ndarray:
        out = np.zeros((self.ndof_scalar, self.mesh.vertices.shape[1]))
        for (geom, elems, _a), gm in zip(self.mesh.blocks, self.gather_maps):
            X = element_node_coords(_block_mesh(self.mesh, geom, elems),
                                    self.order)
            out[gm.reshape(-1)] = X.reshape(-1, X.shape[-1])
        return out

    def project(self, f) -> torch.Tensor:
        """f at the dof coordinates (a tensor of them on the space's
        device) → (ndof,)."""
        kw = dict(dtype=real_t(self.dtype), device=self.device)
        return torch.as_tensor(f(torch.as_tensor(self.dof_coords, **kw)),
                               **kw).reshape(-1)


def _found(table: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Whether each of ``rows`` is a row of ``table`` (duplicates allowed)."""
    if not len(rows):
        return np.zeros(0, dtype=bool)
    _, _, q = encode_rows(table, rows)
    return q >= 0


class MixedPAOperator:
    """Σ_b R_bᵀ apply_b(qdata_b, R_b x) with each block's diffusion and
    mass terms, the blocks' E→L sums added in block order."""

    def __init__(self, fes: MixedFESpace, diffusion_coeff=None,
                 mass_coeff=None):
        from ..ops import diffusion as dmod
        from ..ops import mass as mmod

        self.fes = fes
        self.terms = []
        for db, gf, R in zip(fes.dbs, fes.gfs, fes.restrictions):
            blk = []
            if diffusion_coeff is not None:
                # a scalar broadcast to (ne, nq), as the JAX package's
                # setup does, so the qdata round alike
                blk.append((dmod, dmod.setup(gf, torch.full_like(
                    gf.det, float(diffusion_coeff)))))
            if mass_coeff is not None:
                qd = mmod.setup(gf)
                if callable(mass_coeff):
                    qd = qd * torch.as_tensor(mass_coeff(gf.x), dtype=qd.dtype)
                else:
                    qd = qd * mass_coeff
                blk.append((mmod, qd))
            self.terms.append((db, R, blk))

    def block_apply(self, b: int, x: torch.Tensor) -> torch.Tensor:
        """Block b's E-vector output apply_b(qdata_b, R_b x), (ne_b, nd_b)."""
        db, R, blk = self.terms[b]
        e = R.mult(x)
        acc = None
        for mod, qd in blk:
            t = mod.apply(db, qd, e)
            acc = t if acc is None else acc + t
        return acc

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.zeros_like(x)
        for b, (_db, R, _blk) in enumerate(self.terms):
            y = y + R.mult_transpose(self.block_apply(b, x))
        return y

    def diagonal(self) -> torch.Tensor:
        fes = self.fes
        d = torch.zeros(fes.ndof_scalar, dtype=real_t(fes.dtype), device=fes.device)
        for db, R, blk in self.terms:
            acc = None
            for mod, qd in blk:
                t = mod.diagonal(db, qd)
                acc = t if acc is None else acc + t
            d = d + R.mult_transpose(acc)
        return d


def mixed_domain_lf(fes: MixedFESpace, f) -> torch.Tensor:
    """(f, v) summed over the blocks in block order; ``f`` takes the
    quadrature points (ne_b, nq_b, sdim) as a tensor."""
    b = torch.zeros(fes.ndof_scalar, dtype=real_t(fes.dtype), device=fes.device)
    for db, gf, R in zip(fes.dbs, fes.gfs, fes.restrictions):
        fq = torch.as_tensor(f(gf.x), dtype=gf.wdet.dtype, device=fes.device)
        b = b + R.mult_transpose(eval_values_t(db, gf.wdet * fq))
    return b


# ----------------------------------------------------------------------------
# 3D mixed mesh: a hex region and a tet region glued by pyramids
# ----------------------------------------------------------------------------


def make_mixed_cube(n: int = 2) -> MixedMesh:
    """Unit cube, 2n×n×n cells: the left half hexes, the right half tets and
    pyramids.  Each right cell is split from its centre: a face shared with
    a hex becomes a pyramid's base, every other face is split along the
    diagonal at its smallest vertex id (so neighbours agree) into two tets.
    Boundary faces: quads on the hex side, triangles on the tet side
    (``boundary_blocks``).  Bitwise the JAX package's tables."""
    from ..mesh.mesh import make_cartesian_3d

    h = make_cartesian_3d(2 * n, n, n)
    left = h.vertices[h.elements].mean(axis=1)[:, 0] < 0.5
    verts = [v for v in h.vertices]

    hexes = h.elements[left]
    hattr = h.attributes[left]
    loc_faces = FACES[Geometry.CUBE]

    pyramids, pattr, tets, tattr = [], [], [], []
    tri_bdr, tri_battr = [], []

    bdr_map = {tuple(sorted(map(int, f))): int(a)
               for f, a in zip(h.boundary, h.bdr_attributes)}
    hex_face_keys = set()
    for t in hexes:
        for f in loc_faces:
            hex_face_keys.add(tuple(sorted(int(t[v]) for v in f)))

    def tri_split(quad):
        """Split a cyclic quad across the diagonal at its min-id vertex."""
        r = int(np.argmin(quad))
        q = [quad[(r + k) % 4] for k in range(4)]
        return (q[0], q[1], q[2]), (q[0], q[2], q[3])

    for t, a in zip(h.elements[~left], h.attributes[~left]):
        verts.append(h.vertices[t].mean(axis=0))
        c = len(verts) - 1
        for f in loc_faces:
            quad = [int(t[v]) for v in f]
            key = tuple(sorted(quad))
            if key in hex_face_keys:
                b = list(quad)
                v0, v1, v3 = (np.asarray(verts[b[0]]), np.asarray(verts[b[1]]),
                              np.asarray(verts[b[3]]))
                if np.dot(np.cross(v1 - v0, v3 - v0), np.asarray(verts[c]) - v0) < 0:
                    b = [b[0], b[3], b[2], b[1]]
                pyramids.append(b + [c])
                pattr.append(a)
                continue
            battr = bdr_map.get(key)
            for tri in tri_split(quad):
                p0, p1, p2 = (np.asarray(verts[tri[0]]), np.asarray(verts[tri[1]]),
                              np.asarray(verts[tri[2]]))
                tet = list(tri) + [c]
                if np.dot(np.cross(p1 - p0, p2 - p0), np.asarray(verts[c]) - p0) < 0:
                    tet = [tri[0], tri[2], tri[1], c]
                tets.append(tet)
                tattr.append(a)
                if battr is not None:
                    tri_bdr.append(list(tri))
                    tri_battr.append(battr)

    quad_bdr, quad_battr = [], []
    for f, a in zip(h.boundary, h.bdr_attributes):
        if tuple(sorted(map(int, f))) in hex_face_keys:
            quad_bdr.append([int(v) for v in f])
            quad_battr.append(int(a))

    blocks = [(Geometry.CUBE, np.asarray(hexes, dtype=np.int64), hattr)]
    if pyramids:
        blocks.append((Geometry.PYRAMID, np.array(pyramids, dtype=np.int64),
                       np.array(pattr, dtype=np.int64)))
    blocks.append((Geometry.TETRAHEDRON, np.array(tets, dtype=np.int64),
                   np.array(tattr, dtype=np.int64)))
    bblocks = []
    if quad_bdr:
        bblocks.append((Geometry.SQUARE, np.array(quad_bdr, dtype=np.int64),
                        np.array(quad_battr, dtype=np.int64)))
    if tri_bdr:
        bblocks.append((Geometry.TRIANGLE, np.array(tri_bdr, dtype=np.int64),
                        np.array(tri_battr, dtype=np.int64)))
    return MixedMesh(
        vertices=np.array(verts),
        blocks=tuple(blocks),
        boundary=np.zeros((0, 2), dtype=np.int64),
        bdr_attributes=np.zeros(0, dtype=np.int64),
        boundary_blocks=tuple(bblocks),
    )
