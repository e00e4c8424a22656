"""Mixed bilinear integrators across H1 / ND / RT / L2 spaces (counterpart
of ``cardiac_ablation_ecm2_tpu/ops/mixed_vecfe.py``; MFEM's mixed family of
``fem/bilininteg.hpp``: ``MixedVectorGradientIntegrator``,
``MixedVectorCurlIntegrator``, ``VectorFEDivergenceIntegrator``, the
cross/dot/directional pairings, ...).

One rectangular partial-assembly operator serves every pairing:

    y = Rₛᵀ post_s(Bₛᵀ diag(qd) Bₜ pre_t(Rₜ x))

with Bₜ / Bₛ the physical basis tables of the two spaces at one
quadrature rule (the pullbacks applied) and Rₜ / Rₛ their
``ElementRestriction``s: the gathers run on ``gather_sum`` and the
scatters on ``segment_sum``.  The orientation of an ND/RT side (signs or
the simplex DofTransformation) rides its pre/post maps, as in
``ops/vecfe.py``.  Tables keep the JAX package's layout: (ne, nq, nd, c)
per element, (nq, nd) shared, or (ne, nq, nd) for one channel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..fem.build import geom_factors_for, restriction_for
from ..fem.fe_vector import NDSpace, RTSpace
from ..fem.geom_factors import adjugate
from ..fem.restriction import ElementRestriction
from ..utils.config import real_t, resolve_device
from .vecfe import _restriction, build_nd_operator, build_rt_operator, geometry


def _kind(space) -> str:
    k = getattr(space, "kind", None)
    if k is not None:
        return k
    if isinstance(space, NDSpace):
        return "nd"
    if isinstance(space, RTSpace):
        return "rt"
    raise TypeError(f"not a vector FE space: {space!r}")


def _ident(e):
    return e


def _wrap(space, rt, device):
    """(restriction, pre, post, ndof) for any supported space."""
    if hasattr(space, "transform"):                       # VectorSimplexSpace
        return (_restriction(space, device), space.transform, space.transform_t,
                space.ndof)
    if hasattr(space, "signs"):                           # ND/RT, lowest or HO
        sg = torch.as_tensor(space.signs, dtype=rt, device=device)

        def pre(e):
            return e * sg

        return _restriction(space, device), pre, pre, space.ndof
    return restriction_for(space, device), _ident, _ident, space.ndof_scalar


def _vec_tables(space, nq1d, dtype, device):
    """(gf, value (ne, nq, ndl, dim), derivative) for an ND/RT space: the
    curl ((ne, nq, ndl, 3) in 3D, (ne, nq, ndl) in 2D) or the divergence
    (ne, nq, ndl), from the square operators' tables."""
    if _kind(space) == "nd":
        op = build_nd_operator(space, mass_coeff=1.0, curlcurl_coeff=1.0,
                               nq1d=nq1d, dtype=dtype, device=device)
        val = op.term("mass")[1].transpose(1, 2)
        der = op.term("curlcurl")[1].transpose(1, 2)
        if space.mesh.dim == 2:
            der = der[..., 0]
    else:
        op = build_rt_operator(space, mass_coeff=1.0, divdiv_coeff=1.0,
                               nq1d=nq1d, dtype=dtype, device=device)
        val = op.term("mass")[1].transpose(1, 2)
        der = op.term("divdiv")[1][..., 0].transpose(1, 2)
    return op.gf, val, der


def _scalar_value(fes, nq1d, rt, device):
    """Shared value table (nq, nd) of an H1/L2 space at the nq1d rule."""
    return torch.as_tensor(fes.dof_to_quad(nq1d).full_B(), dtype=rt, device=device)


def _scalar_grad(fes, gf, nq1d, rt):
    """Physical gradient table (ne, nq, nd, dim): J⁻ᵀ∇̂ = adjᵀ∇̂/det."""
    G = torch.as_tensor(fes.dof_to_quad(nq1d).full_G(), dtype=rt,
                        device=gf.det.device)
    A = adjugate(gf.jac)
    return torch.einsum("eqab,qna->eqnb", A / gf.det[..., None, None], G)


@dataclasses.dataclass(eq=False)
class MixedVecFEOperator:
    """Rectangular PA operator y = Rₛᵀ Bₛᵀ diag(qd) Bₜ Rₜ x."""

    r_trial: object
    r_test: object
    pre_trial: Callable
    post_trial: Callable
    pre_test: Callable
    post_test: Callable
    Bt: torch.Tensor
    Bs: torch.Tensor
    qd: torch.Tensor              # (ne, nq) or (ne, nq, cs, ct)
    ndof_trial: int
    ndof_test: int

    @staticmethod
    def _eval(B, e):
        if B.dim() == 4:
            return torch.einsum("eqnc,en->eqc", B, e)
        if B.dim() == 2:                                  # shared (nq, nd)
            return torch.einsum("qn,en->eq", B, e)[..., None]
        return torch.einsum("eqn,en->eq", B, e)[..., None]

    @staticmethod
    def _evalT(B, q):
        if B.dim() == 4:
            return torch.einsum("eqnc,eqc->en", B, q)
        if B.dim() == 2:
            return torch.einsum("qn,eq->en", B, q[..., 0])
        return torch.einsum("eqn,eq->en", B, q[..., 0])

    def _couple(self, qe, transpose=False):
        if self.qd.dim() == 4:
            eq = "eqst,eqs->eqt" if transpose else "eqst,eqt->eqs"
            return torch.einsum(eq, self.qd, qe)
        return qe * self.qd[..., None]

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        e = self.pre_trial(self.r_trial.mult(x))
        y = self.post_test(self._evalT(self.Bs, self._couple(self._eval(self.Bt, e))))
        return self.r_test.mult_transpose(y.contiguous())

    def mult_t(self, y: torch.Tensor) -> torch.Tensor:
        e = self.pre_test(self.r_test.mult(y))
        q = self._couple(self._eval(self.Bs, e), transpose=True)
        x = self.post_trial(self._evalT(self.Bt, q))
        return self.r_trial.mult_transpose(x.contiguous())

    def __call__(self, x):
        return self.mult(x)

    def assemble_matrix(self):
        """scipy CSR (ndof_test, ndof_trial), host."""
        import scipy.sparse as sp

        gt = self.r_trial.gm.cpu().numpy().astype(np.int64)
        gs = self.r_test.gm.cpu().numpy().astype(np.int64)
        ne, nt = gt.shape
        ns = gs.shape[1]
        cols_e = np.zeros((ne, ns, nt))
        eye = torch.eye(nt, dtype=self.qd.dtype, device=self.qd.device)
        for j in range(nt):
            e = self.pre_trial(eye[j].expand(ne, nt).contiguous())
            q = self._couple(self._eval(self.Bt, e))
            cols_e[:, :, j] = self.post_test(self._evalT(self.Bs, q)).cpu().numpy()
        rows = np.broadcast_to(gs[:, :, None], cols_e.shape).reshape(-1)
        cols = np.broadcast_to(gt[:, None, :], cols_e.shape).reshape(-1)
        return sp.csr_matrix((cols_e.reshape(-1), (rows, cols)),
                             shape=(self.ndof_test, self.ndof_trial))


def _make(trial, test, Bt, Bs, gf, coeff, rt, device):
    rt_, pre_t, post_t, nt = _wrap(trial, rt, device)
    rs_, pre_s, post_s, ns = _wrap(test, rt, device)
    return MixedVecFEOperator(
        r_trial=rt_, r_test=rs_, pre_trial=pre_t, post_trial=post_t,
        pre_test=pre_s, post_test=post_s, Bt=Bt, Bs=Bs, qd=coeff * gf.wdet,
        ndof_trial=nt, ndof_test=ns)


def mixed_vector_gradient(h1_fes, nd_space, coeff=1.0, nq1d=3, dtype=None,
                          matrix_coeff=None, device=None):
    """(σ∇u, v): H1 trial → ND test (MixedVectorGradientIntegrator);
    ``matrix_coeff`` an optional (d×d) σ, constant or callable of x."""
    device, rt = resolve_device(device), real_t(dtype)
    gf, Bnd, _ = _vec_tables(nd_space, nq1d, rt, device)
    Gh1 = _scalar_grad(h1_fes, gf, nq1d, rt)
    if matrix_coeff is not None:
        if callable(matrix_coeff):
            sig = torch.as_tensor(matrix_coeff(gf.x), dtype=rt, device=device)
        else:
            m = torch.as_tensor(np.asarray(matrix_coeff), dtype=rt, device=device)
            sig = m.expand(gf.det.shape + m.shape)
        Gh1 = torch.einsum("eqcd,eqnd->eqnc", sig, Gh1)
    return _make(h1_fes, nd_space, Gh1, Bnd, gf, coeff, rt, device)


def mixed_vector_weak_divergence(nd_space, h1_fes, coeff=1.0, nq1d=3,
                                 dtype=None, device=None):
    """−(u, ∇v): ND trial → H1 test (MixedVectorWeakDivergenceIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    gf, Bnd, _ = _vec_tables(nd_space, nq1d, rt, device)
    Gh1 = _scalar_grad(h1_fes, gf, nq1d, rt)
    return _make(nd_space, h1_fes, Bnd, Gh1, gf, -coeff, rt, device)


def mixed_vector_mass(trial_space, test_space, coeff=1.0, nq1d=3, dtype=None,
                      device=None):
    """(u, v) with distinct trial/test vector spaces (ND×RT or RT×ND)."""
    device, rt = resolve_device(device), real_t(dtype)
    gf, Bt, _ = _vec_tables(trial_space, nq1d, rt, device)
    _, Bs, _ = _vec_tables(test_space, nq1d, rt, device)
    return _make(trial_space, test_space, Bt, Bs, gf, coeff, rt, device)


def mixed_vector_curl(nd_space, rt_space, coeff=1.0, nq1d=3, dtype=None,
                      device=None):
    """(curl u, v): ND trial → RT test, 3D (MixedVectorCurlIntegrator)."""
    if nd_space.mesh.dim != 3:
        raise ValueError("mixed_vector_curl: 3D meshes")
    device, rt = resolve_device(device), real_t(dtype)
    gf, _, Cnd = _vec_tables(nd_space, nq1d, rt, device)
    _, Brt, _ = _vec_tables(rt_space, nq1d, rt, device)
    return _make(nd_space, rt_space, Cnd, Brt, gf, coeff, rt, device)


def mixed_weak_curl(rt_space, nd_space, coeff=1.0, nq1d=3, dtype=None,
                    device=None):
    """(u, curl v): RT trial → ND test, 3D (MixedVectorWeakCurlIntegrator)."""
    if nd_space.mesh.dim != 3:
        raise ValueError("mixed_weak_curl: 3D meshes")
    device, rt = resolve_device(device), real_t(dtype)
    gf, Brt, _ = _vec_tables(rt_space, nq1d, rt, device)
    _, _, Cnd = _vec_tables(nd_space, nq1d, rt, device)
    return _make(rt_space, nd_space, Brt, Cnd, gf, coeff, rt, device)


def mixed_scalar_curl(nd_space, l2_fes, coeff=1.0, nq1d=3, dtype=None,
                      device=None):
    """(curl u, q): ND trial → L2 test, 2D scalar curl
    (MixedScalarCurlIntegrator)."""
    if nd_space.mesh.dim != 2:
        raise ValueError("mixed_scalar_curl: 2D meshes")
    device, rt = resolve_device(device), real_t(dtype)
    gf, _, Cnd = _vec_tables(nd_space, nq1d, rt, device)
    Bl2 = _scalar_value(l2_fes, nq1d, rt, device)
    return _make(nd_space, l2_fes, Cnd[..., None], Bl2, gf, coeff, rt, device)


def vectorfe_divergence(rt_space, l2_fes, coeff=1.0, nq1d=3, dtype=None,
                        device=None):
    """(div u, q): RT trial → L2 test, any order
    (VectorFEDivergenceIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    gf, _, Drt = _vec_tables(rt_space, nq1d, rt, device)
    Bl2 = _scalar_value(l2_fes, nq1d, rt, device)
    return _make(rt_space, l2_fes, Drt[..., None], Bl2, gf, coeff, rt, device)


def mixed_scalar_mass(trial_fes, test_fes, coeff=1.0, nq1d=3, dtype=None,
                      device=None):
    """(u, q) across distinct scalar spaces, e.g. H1×L2
    (MixedScalarMassIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    gf = geometry(trial_fes.mesh, nq1d, rt, device)
    Bt = _scalar_value(trial_fes, nq1d, rt, device)
    Bs = _scalar_value(test_fes, nq1d, rt, device)
    return _make(trial_fes, test_fes, Bt, Bs, gf, coeff, rt, device)


def _byn_restriction(vfes, device):
    """The byNODES vector gather (ne, nd·vdim) of a vdim H1 space."""
    gm = np.asarray(vfes.gather_map, np.int64)
    g = np.concatenate([gm + c * vfes.ndof_scalar for c in range(vfes.vdim)], axis=1)
    return ElementRestriction(g, vfes.ndof, device)


def _cq(coeff, gf, rt):
    if callable(coeff):
        return torch.as_tensor(coeff(gf.x), dtype=rt, device=gf.det.device)
    return float(coeff)


def vector_divergence(vfes, pfes, coeff=1.0, nq1d=None, dtype=None, device=None):
    """(c div u, q): vector-H1 trial (byNODES) → scalar test
    (VectorDivergenceIntegrator), the Stokes pressure block."""
    device, rt = resolve_device(device), real_t(dtype)
    nq1d = nq1d or (vfes.order + 2)
    gf = geom_factors_for(vfes, nq1d, rt, device)
    Gphys = _scalar_grad(vfes, gf, nq1d, rt)              # (ne, nq, nd, dim)
    Bt = torch.cat([Gphys[..., c] for c in range(vfes.vdim)], dim=2)[..., None]
    Bs = _scalar_value(pfes, nq1d, rt, device)
    return MixedVecFEOperator(
        r_trial=_byn_restriction(vfes, device), r_test=restriction_for(pfes, device),
        pre_trial=_ident, post_trial=_ident, pre_test=_ident, post_test=_ident,
        Bt=Bt, Bs=Bs, qd=_cq(coeff, gf, rt) * gf.wdet,
        ndof_trial=vfes.ndof, ndof_test=pfes.ndof_scalar)


def derivative(fes_trial, fes_test, direction: int, coeff=1.0, nq1d=None,
               dtype=None, device=None):
    """(c ∂u/∂x_i, v) on scalar spaces (DerivativeIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    nq1d = nq1d or (fes_trial.order + 2)
    gf = geom_factors_for(fes_trial, nq1d, rt, device)
    Bt = _scalar_grad(fes_trial, gf, nq1d, rt)[..., direction][..., None]
    Bs = _scalar_value(fes_test, nq1d, rt, device)
    return MixedVecFEOperator(
        r_trial=restriction_for(fes_trial, device), r_test=restriction_for(fes_test, device),
        pre_trial=_ident, post_trial=_ident, pre_test=_ident, post_test=_ident,
        Bt=Bt, Bs=Bs, qd=_cq(coeff, gf, rt) * gf.wdet,
        ndof_trial=fes_trial.ndof_scalar, ndof_test=fes_test.ndof_scalar)


# ----------------------------------------------------------------------------
# the cross/dot/directional pairing family
# ----------------------------------------------------------------------------


def _h1_vec_value(vfes, nq1d, rt, device):
    """(restriction, table) for a vdim H1 space as a vector field: block
    value table B[q, n + c·nd, c'] = φ_n(q) δ_cc' with byNODES gathers."""
    Bsc = vfes.dof_to_quad(nq1d).full_B()               # (nq, nd)
    nq, nd = Bsc.shape
    d = vfes.vdim
    tab = np.zeros((nq, nd * d, d))
    for c in range(d):
        tab[:, c * nd:(c + 1) * nd, c] = Bsc
    return _byn_restriction(vfes, device), torch.as_tensor(tab, dtype=rt, device=device)


def _vq(V, gf, rt, dim):
    """Vector coefficient at quadrature points → (ne, nq, dim)."""
    if callable(V):
        return torch.as_tensor(V(gf.x), dtype=rt, device=gf.det.device)
    arr = torch.as_tensor(np.asarray(V), dtype=rt, device=gf.det.device)
    return arr[None, None, :].expand(gf.det.shape + (dim,))


def _bcast(B, gf):
    """Shared (nq, nd, c) tables broadcast across the elements."""
    ne, nq = gf.det.shape
    if B.dim() == 3 and B.shape[0] == nq:
        return B[None].expand((ne,) + tuple(B.shape))
    return B


def _coupled(trial_pack, test_pack, QD, gf):
    """A mixed operator from (restriction, table, pre, post, ndof) packs
    and (ne, nq, cs, ct) qdata."""
    rt_, Bt, pre_t, post_t, nt = trial_pack
    rs_, Bs, pre_s, post_s, ns = test_pack
    return MixedVecFEOperator(
        r_trial=rt_, r_test=rs_, pre_trial=pre_t, post_trial=post_t,
        pre_test=pre_s, post_test=post_s, Bt=_bcast(Bt, gf), Bs=_bcast(Bs, gf),
        qd=QD * gf.wdet[..., None, None], ndof_trial=nt, ndof_test=ns)


def _vec_pack(vfes, nq1d, rt, device):
    r, B = _h1_vec_value(vfes, nq1d, rt, device)
    return r, B, _ident, _ident, vfes.ndof


def _sc_pack(sfes, nq1d, rt, device):
    """A scalar space as a 1-channel table (nq, nd, 1)."""
    return (restriction_for(sfes, device), _scalar_value(sfes, nq1d, rt, device)[..., None],
            _ident, _ident, sfes.ndof_scalar)


def _grad_pack(fes, gf, nq1d, rt, device):
    return (restriction_for(fes, device), _scalar_grad(fes, gf, nq1d, rt),
            _ident, _ident, fes.ndof_scalar)


def mixed_dot_product(vfes, sfes, V, nq1d=None, dtype=None, device=None):
    """(V·u, q): vector-H1 trial → scalar test (MixedDotProductIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    nq1d = nq1d or (vfes.order + 2)
    gf = geom_factors_for(vfes, nq1d, rt, device)
    Vq = _vq(V, gf, rt, vfes.vdim)
    return _coupled(_vec_pack(vfes, nq1d, rt, device), _sc_pack(sfes, nq1d, rt, device),
                    Vq[:, :, None, :], gf)


def mixed_vector_product(sfes, vfes, V, nq1d=None, dtype=None, device=None):
    """(V u, w): scalar trial → vector-H1 test (MixedVectorProductIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    nq1d = nq1d or (vfes.order + 2)
    gf = geom_factors_for(vfes, nq1d, rt, device)
    Vq = _vq(V, gf, rt, vfes.vdim)
    return _coupled(_sc_pack(sfes, nq1d, rt, device), _vec_pack(vfes, nq1d, rt, device),
                    Vq[:, :, :, None], gf)


def _skew3(Vq):
    """(ne, nq, 3) → (ne, nq, 3, 3) with S u = V × u."""
    z = torch.zeros_like(Vq[..., 0])
    vx, vy, vz = Vq[..., 0], Vq[..., 1], Vq[..., 2]
    return torch.stack([torch.stack([z, -vz, vy], dim=-1),
                        torch.stack([vz, z, -vx], dim=-1),
                        torch.stack([-vy, vx, z], dim=-1)], dim=-2)


def mixed_cross_product(vfes_t, vfes_s, V, nq1d=None, dtype=None, device=None):
    """(V × u, w): 3D vector-H1 trial and test (MixedCrossProductIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    nq1d = nq1d or (vfes_t.order + 2)
    gf = geom_factors_for(vfes_t, nq1d, rt, device)
    return _coupled(_vec_pack(vfes_t, nq1d, rt, device), _vec_pack(vfes_s, nq1d, rt, device),
                    _skew3(_vq(V, gf, rt, 3)), gf)


def mixed_scalar_cross_product(vfes, sfes, V, nq1d=None, dtype=None, device=None):
    """(V × u, q) in 2D, V×u = V_x u_y − V_y u_x
    (MixedScalarCrossProductIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    nq1d = nq1d or (vfes.order + 2)
    gf = geom_factors_for(vfes, nq1d, rt, device)
    Vq = _vq(V, gf, rt, 2)
    QD = torch.stack([-Vq[..., 1], Vq[..., 0]], dim=-1)[:, :, None, :]
    return _coupled(_vec_pack(vfes, nq1d, rt, device), _sc_pack(sfes, nq1d, rt, device),
                    QD, gf)


def mixed_directional_derivative(h1_fes, sfes, V, nq1d=None, dtype=None, device=None):
    """(V·∇u, q): H1 trial → scalar test (MixedDirectionalDerivativeIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    nq1d = nq1d or (h1_fes.order + 2)
    gf = geom_factors_for(h1_fes, nq1d, rt, device)
    Vq = _vq(V, gf, rt, h1_fes.mesh.dim)
    return _coupled(_grad_pack(h1_fes, gf, nq1d, rt, device),
                    _sc_pack(sfes, nq1d, rt, device), Vq[:, :, None, :], gf)


def gradient(pfes, vfes, coeff=1.0, nq1d=None, dtype=None, device=None):
    """(c ∇p, v): scalar H1 trial → vector-H1 test (GradientIntegrator).
    The derivative lands on the trial space: this is not the transpose of
    :func:`vector_divergence` (that is ``vector_divergence(...).mult_t``)."""
    device, rt = resolve_device(device), real_t(dtype)
    nq1d = nq1d or (vfes.order + 2)
    gf = geom_factors_for(vfes, nq1d, rt, device)
    d = vfes.vdim
    cq = _cq(coeff, gf, rt)
    cq = cq if torch.is_tensor(cq) else torch.tensor(cq, dtype=rt, device=device)
    QD = (cq[..., None, None] * torch.eye(d, dtype=rt, device=device)).expand(
        gf.det.shape + (d, d))
    return _coupled(_grad_pack(pfes, gf, nq1d, rt, device),
                    _vec_pack(vfes, nq1d, rt, device), QD, gf)


def mixed_grad_grad(trial_fes, test_fes, coeff=1.0, nq1d=None, dtype=None,
                    device=None):
    """(λ ∇u, ∇v) across two H1 spaces (MixedGradGradIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    nq1d = nq1d or (max(trial_fes.order, test_fes.order) + 2)
    gf = geom_factors_for(trial_fes, nq1d, rt, device)
    d = trial_fes.mesh.dim
    eye = torch.eye(d, dtype=rt, device=device)
    if callable(coeff):
        QD = _cq(coeff, gf, rt)[..., None, None] * eye
    else:
        QD = float(coeff) * eye.expand(gf.det.shape + (d, d))
    return _coupled(_grad_pack(trial_fes, gf, nq1d, rt, device),
                    _grad_pack(test_fes, gf, nq1d, rt, device), QD, gf)


def mixed_cross_grad_grad(trial_fes, test_fes, V, nq1d=None, dtype=None,
                          device=None):
    """(V × ∇u, ∇v) on 3D H1 spaces (MixedCrossGradGradIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    nq1d = nq1d or (max(trial_fes.order, test_fes.order) + 2)
    gf = geom_factors_for(trial_fes, nq1d, rt, device)
    return _coupled(_grad_pack(trial_fes, gf, nq1d, rt, device),
                    _grad_pack(test_fes, gf, nq1d, rt, device),
                    _skew3(_vq(V, gf, rt, 3)), gf)


def mixed_cross_curl(nd_space, vfes, V, nq1d=3, dtype=None, device=None):
    """(V × curl u, w): 3D ND trial → vector-H1 test (MixedCrossCurlIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    gf, _, curl = _vec_tables(nd_space, nq1d, rt, device)
    r, pre, post, n = _wrap(nd_space, rt, device)
    return _coupled((r, curl, pre, post, n), _vec_pack(vfes, nq1d, rt, device),
                    _skew3(_vq(V, gf, rt, 3)), gf)


def mixed_cross_grad(h1_fes, vfes, V, nq1d=None, dtype=None, device=None):
    """(V × ∇u, w): 3D H1 trial → vector-H1 test (MixedCrossGradIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    nq1d = nq1d or (h1_fes.order + 2)
    gf = geom_factors_for(h1_fes, nq1d, rt, device)
    return _coupled(_grad_pack(h1_fes, gf, nq1d, rt, device),
                    _vec_pack(vfes, nq1d, rt, device), _skew3(_vq(V, gf, rt, 3)), gf)


def mixed_scalar_weak_divergence(sfes, h1_fes, V, nq1d=None, dtype=None,
                                 device=None):
    """−(V u, ∇w): scalar trial → H1 test
    (MixedScalarWeakDivergenceIntegrator)."""
    device, rt = resolve_device(device), real_t(dtype)
    nq1d = nq1d or (h1_fes.order + 2)
    gf = geom_factors_for(h1_fes, nq1d, rt, device)
    Vq = _vq(V, gf, rt, h1_fes.mesh.dim)
    return _coupled(_sc_pack(sfes, nq1d, rt, device),
                    _grad_pack(h1_fes, gf, nq1d, rt, device), -Vq[:, :, :, None], gf)
