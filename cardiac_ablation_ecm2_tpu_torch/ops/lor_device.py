"""All-device LOR preconditioning: batched LOR assembly and a two-level
geometric multigrid (``lor_element_matrices``, ``DeviceLOROperator`` and
``make_lor_multigrid`` of ``cardiac_ablation_ecm2_tpu/ops/lor_device.py``;
MFEM's batched LOR assembly, ``fem/lor/lor_batched.hpp``, under
``LORSolver<HypreBoomerAMG>``).

* The Q1 element matrices of all ``ne·p^dim`` LOR sub-elements come from
  one batched einsum chain (in chunks of sub-elements, which bounds the
  temporaries and gives the same numbers): the sub-elements' geometric
  factors are lattice slices of the high-order node coordinates, since the
  LOR vertices are the order-p nodes (``ops/lor.py``).
* The LOR operator applies as L→E through the sub-element connectivity, a
  batched (nsub, nv, nv)·(nsub, nv) matvec, and E→L: the sub-element
  restriction is an ``ElementRestriction`` of the connectivity, so both
  directions run the gather and segment-sum kernels on the card.
* The BoomerAMG seat is a V-cycle: Chebyshev smoothing on the LOR lattice
  over the order-1 partially assembled operator on the original mesh,
  joined by the order transfer (``fem/transfer.PTransfer``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..fem.basis import make_dof_to_quad
from ..fem.fespace import FESpace, element_node_coords
from ..fem.geom_factors import adjugate, compute_geometric_factors
from ..fem.restriction import ElementRestriction
from ..utils.config import elapsed, real_t, resolve_device
from .lor import lor_corner_slots

#: sub-elements per chunk of the element-matrix chain
_CHUNK = 1 << 20


def _coef(c, gf):
    """A scalar coefficient, or a callable one at the quadrature points."""
    if c is None:
        return None
    x = gf.x
    return torch.as_tensor(c(x) if callable(c) else c, dtype=x.dtype, device=x.device)


def _lor_matrices(X, corners, geom, diffusion_coeff, mass_coeff, dtype):
    """(nsub, nv, nv) Q1 diffusion(+mass) matrices of the sub-elements whose
    corners are the ``corners`` lattice slots of the (ne, nd, sdim) node
    coordinates ``X`` (a tensor on the target device)."""
    rt = X.dtype
    dev = X.device
    nv = corners.shape[1]
    nsub = X.shape[0] * corners.shape[0]
    d2q1 = make_dof_to_quad(geom, 1, 2)
    B = torch.as_tensor(d2q1.full_B(), dtype=rt, device=dev)      # (nq, nv)
    G = torch.as_tensor(d2q1.full_G(), dtype=rt, device=dev)      # (nq, nv, sdim)
    w = torch.as_tensor(d2q1.weights, dtype=rt, device=dev)
    idx = torch.as_tensor(corners, device=dev)
    A_e = torch.zeros(nsub, nv, nv, dtype=rt, device=dev)
    per = corners.shape[0]
    step = max(1, _CHUNK // per)                 # whole elements per chunk
    for e0 in range(0, X.shape[0], step):
        Xc = X[e0:e0 + step][:, idx, :].reshape(-1, nv, X.shape[-1])
        gf = compute_geometric_factors(Xc, d2q1, rt, dev)
        kd, km = _coef(diffusion_coeff, gf), _coef(mass_coeff, gf)
        out = A_e[e0 * per:(e0 + step) * per]
        if kd is not None:
            adj = adjugate(gf.jac)                           # (n, nq, d, d)
            D = (w[None, :, None, None] / gf.det[..., None, None]
                 * torch.einsum("eqab,eqcb->eqac", adj, adj))
            D = D * (kd[..., None, None] if kd.ndim else kd)
            out += torch.einsum("qma,eqab,qnb->emn", G, D, G)
        if km is not None:
            q = w[None, :] * gf.det * km
            out += torch.einsum("qm,eq,qn->emn", B, q, B)
    return A_e


def lor_element_matrices(fes, diffusion_coeff=1.0, mass_coeff=None,
                         dtype=None, device=None):
    """Batched LOR element matrices on ``device`` (``None``: the card).

    Returns ``(A_e, conn)``: ``A_e`` the (nsub, nv, nv) tensor of Q1
    diffusion(+mass) matrices of every LOR sub-element, ``conn`` the
    (nsub, nv) connectivity in HIGH-ORDER dof ids (numpy).  Coefficients
    are scalars or callables of the physical coordinates (a tensor),
    evaluated at the sub-elements' quadrature points."""
    mesh, p = fes.mesh, fes.order
    corners = lor_corner_slots(mesh.geom, p)
    X = torch.as_tensor(element_node_coords(mesh, p), dtype=real_t(dtype),
                        device=resolve_device(device))
    A_e = _lor_matrices(X, corners, mesh.geom, diffusion_coeff, mass_coeff,
                        real_t(dtype))
    gm = fes.gather_map.astype(np.int64)
    return A_e, gm[:, corners].reshape(-1, corners.shape[1])


class DeviceLOROperator:
    """Matrix-free LOR operator on high-order L-vectors, on ``device``
    (``None``: the card).

    ``mult`` is the constrained apply (identity on the essential dofs
    ``ess``), the convention of the constrained high-order operators it
    preconditions.  ``setup_seconds`` splits the setup into the element
    matrices (host node coordinates included) and the sub-element
    restriction (host slot lists and their upload)."""

    def __init__(self, fes, diffusion_coeff=1.0, mass_coeff=None, ess=None,
                 dtype=None, device=None):
        device = resolve_device(device)
        t0 = time.perf_counter()
        A_e, conn = lor_element_matrices(fes, diffusion_coeff, mass_coeff,
                                         dtype, device)
        seconds = {"lor_matrices": elapsed(t0, device)}
        self._bind(A_e, conn, ess, fes.ndof_scalar)
        self.setup_seconds = dict(seconds, lor_restriction=elapsed(
            t0, device) - seconds["lor_matrices"])

    @classmethod
    def from_jax_arrays(cls, A_e, conn, ess, ndof, device=None):
        """The operator over the JAX operator's element matrices ``A_e``
        (numpy, its dtype kept) and connectivity ``conn``, with essential
        dofs ``ess`` (or None) of an ``ndof``-dof space: the apply without
        the assembly."""
        op = cls.__new__(cls)
        op._bind(torch.as_tensor(np.asarray(A_e), device=resolve_device(device)),
                 conn, ess, ndof)
        op.setup_seconds = {}
        return op

    def _bind(self, A_e, conn, ess, ndof):
        self.A_e = A_e
        self.ndof = int(ndof)
        self.restr = ElementRestriction(np.asarray(conn), self.ndof, A_e.device)
        m = torch.zeros(self.ndof, dtype=A_e.dtype, device=A_e.device)
        if ess is not None and len(ess):
            m[torch.as_tensor(np.asarray(ess, np.int64), device=A_e.device)] = 1.0
        self.ess_mask = m

    def mult(self, x):
        m = self.ess_mask
        z = x * (1.0 - m)
        e = self.restr.mult(z)                            # (nsub, nv)
        y = self.restr.mult_transpose(torch.einsum("snm,sm->sn", self.A_e, e))
        return y * (1.0 - m) + x * m

    def diagonal(self):
        d = self.restr.mult_transpose(
            torch.diagonal(self.A_e, dim1=1, dim2=2).contiguous())
        m = self.ess_mask
        d = d * (1.0 - m) + m
        return torch.where(d == 0.0, torch.ones_like(d), d)


def make_lor_multigrid(fes, diffusion_coeff=1.0, mass_coeff=None,
                       ess_bdr=None, smoother_order=3, coarse_iters=32,
                       dtype=None, device=None):
    """Geometric MG on the LOR lattice, the all-device BoomerAMG seat, on
    ``device`` (``None``: the card).

    Two levels: fine = the Chebyshev-smoothed LOR operator on the order-p
    dofs, coarse = the order-1 partially assembled operator on the original
    mesh (the LOR lattice coarsened back to the element corners), joined by
    the order transfer.  The essential dofs of the levels are the same
    boundary attributes' on each space, so they nest.  Returns a
    ``linalg.multigrid.Multigrid`` whose ``setup_seconds`` splits the setup
    (``lor_matrices``, ``lor_restriction``, ``order1_space`` on the host,
    ``coarse_level``, ``transfer``, ``smoothers``: the power-method
    estimates); ``.preconditioner()`` drops into any CG.  Hex spaces only,
    as in the JAX package: a simplex space raises ``ValueError``."""
    if not fes.d2q.tensor:
        raise ValueError("the LOR multigrid needs a hex (tensor-product) "
                         "space; on a simplex (tet) space use the 'jacobi' "
                         "or 'chebyshev' preconditioner")
    from ..fem.transfer import PTransfer
    from ..linalg.multigrid import MGLevel, Multigrid, ess_tensor
    from ..linalg.smoothers import chebyshev
    from .bilinearform import BilinearForm

    device = resolve_device(device)
    ess_f = fes.essential_dofs(ess_bdr)
    lor_op = DeviceLOROperator(fes, diffusion_coeff, mass_coeff, ess=ess_f,
                               dtype=dtype, device=device)
    seconds = dict(lor_op.setup_seconds)

    t0 = time.perf_counter()
    fes1 = FESpace(fes.mesh, 1)
    seconds["order1_space"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bf = BilinearForm(fes1, device)
    if diffusion_coeff is not None:
        bf.add_domain_integrator("diffusion", coeff=diffusion_coeff)
    if mass_coeff is not None:
        bf.add_domain_integrator("mass", coeff=mass_coeff)
    A1 = bf.assemble(dtype=dtype)
    ess_c = fes1.essential_dofs(ess_bdr)
    m1 = torch.zeros(fes1.ndof_scalar, dtype=real_t(dtype), device=device)
    if len(ess_c):
        m1[torch.as_tensor(ess_c.astype(np.int64), device=device)] = 1.0

    def A1c(x, m=m1):
        z = x * (1.0 - m)
        return A1.mult(z) * (1.0 - m) + x * m

    d1 = A1.diagonal() * (1.0 - m1) + m1
    d1 = torch.where(d1 == 0.0, torch.ones_like(d1), d1)
    seconds["coarse_level"] = elapsed(t0, device)

    t0 = time.perf_counter()
    tr = PTransfer(fes1, fes, dtype=dtype, device=device)
    seconds["transfer"] = elapsed(t0, device)
    t0 = time.perf_counter()
    levels = [
        MGLevel(A1c, chebyshev(A1c, d1, order=smoother_order), None, None,
                ess_tensor(ess_c, device)),
        MGLevel(lor_op.mult, chebyshev(lor_op.mult, lor_op.diagonal(),
                                       order=smoother_order),
                tr.prolongate, tr.restrict_t, ess_tensor(ess_f, device)),
    ]
    seconds["smoothers"] = elapsed(t0, device)
    return Multigrid(levels=levels, coarse_iters=coarse_iters,
                     setup_seconds=seconds)
