"""Static condensation for H1 partial-assembly operators (counterpart of
``cardiac_ablation_ecm2_tpu/ops/condense.py``; MFEM's
``StaticCondensation``): the element-interior dofs are eliminated so the
Krylov solve runs on the interface dofs, and the interiors are recovered
element by element.

Per-element dense blocks, batched on the leading element axis:

    S_e   = A_ff − A_fc A_cc⁻¹ A_cf          (ne, nf, nf)
    y_f   = Σ_e Rᵀ_f S_e R_f x_f
    x_c   = A_cc⁻¹ (b_c − A_cf x_f)

The interface gather R_f and its transpose are an ``ElementRestriction``
on the (ne, nf) interface map (``gather_sum`` / ``segment_sum`` on the
card), the interior gather one on the (ne, nc) interior map; A_cc⁻¹ is a
plain batched inverse.  Interior dofs of a tensor H1 element (its CELL
lattice nodes) belong to one element, so the interface space is the global
dof set minus the interiors, and the essential dofs lie on it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fem.basis import lattice_multi_index
from ..fem.build import geom_factors_for
from ..fem.geom_factors import adjugate
from ..fem.restriction import ElementRestriction
from ..utils.config import real_t, resolve_device

#: elements per chunk of the element-matrix setup
_CHUNK = 2048


def element_matrices(fes, diffusion_coeff=None, mass_coeff=None, nq1d=None,
                     dtype=None, device=None) -> torch.Tensor:
    """Batched dense element matrices (ne, nd, nd) from PA qdata with
    scalar coefficients, on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    rt = real_t(dtype)
    gf = geom_factors_for(fes, nq1d, rt, device)
    d2q = fes.dof_to_quad(nq1d)
    kw = dict(dtype=rt, device=device)
    G = torch.as_tensor(d2q.full_G(), **kw)                 # (nq, nd, dim)
    B = torch.as_tensor(d2q.full_B(), **kw)                 # (nq, nd)
    if diffusion_coeff is None and mass_coeff is None:
        return None
    A = torch.zeros((fes.mesh.ne, B.shape[1], B.shape[1]), **kw)
    for s in range(0, fes.mesh.ne, _CHUNK):
        c = slice(s, s + _CHUNK)
        if diffusion_coeff is not None:
            adj = adjugate(gf.jac[c])
            qd = (torch.einsum("eqab,eqcb->eqac", adj, adj) * diffusion_coeff
                  * (gf.w[None, :] / gf.det[c])[..., None, None])
            GD = torch.einsum("qma,eqab->eqmb", G, qd)
            A[c] += torch.einsum("eqmb,qnb->emn", GD, G)
        if mass_coeff is not None:
            if not np.isscalar(mass_coeff):
                raise NotImplementedError("scalar mass coeff only")
            A[c] += mass_coeff * torch.einsum("qm,eq,qn->emn", B, gf.wdet[c], B)
    return A


@dataclasses.dataclass(eq=False)
class StaticCondensation:
    """Condensed interface operator, RHS reduction and interior recovery,
    on the device of ``A_e``."""

    fes: object
    A_e: torch.Tensor             # (ne, nd, nd) element matrices

    def __post_init__(self):
        fes = self.fes
        p = fes.order
        dev = self.A_e.device
        mi = lattice_multi_index(fes.mesh.geom, p)
        interior = np.all((mi > 0) & (mi < p), axis=1)   # CELL lattice nodes
        self.loc_f = np.nonzero(~interior)[0]
        self.loc_c = np.nonzero(interior)[0]
        gm = fes.gather_map.astype(np.int64)             # (ne, nd)

        # interface numbering: the dofs of any interface slot, ascending
        iface_dofs = np.unique(gm[:, self.loc_f].reshape(-1))
        self.n_iface = len(iface_dofs)
        g2c = np.full(fes.ndof_scalar, -1, dtype=np.int64)
        g2c[iface_dofs] = np.arange(self.n_iface)
        self.iface_dofs = iface_dofs                     # condensed → global
        self._iface = torch.as_tensor(iface_dofs, device=dev)
        self.r_f = ElementRestriction(g2c[gm[:, self.loc_f]], self.n_iface, dev)
        self.r_c = ElementRestriction(gm[:, self.loc_c], fes.ndof_scalar, dev)
        self._gather_c = self.r_c.g[0].long()

        A = self.A_e
        f, c = (torch.as_tensor(i, device=dev) for i in (self.loc_f, self.loc_c))
        Aff = A[:, f][:, :, f]
        self.Afc = A[:, f][:, :, c]
        self.Acf = A[:, c][:, :, f]
        self.Acc_inv = torch.linalg.inv(A[:, c][:, :, c])
        self.S = Aff - torch.einsum("emk,ekl,eln->emn", self.Afc, self.Acc_inv, self.Acf)

    # -- condensed operator -------------------------------------------------
    def mult(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.einsum("emn,en->em", self.S, self.r_f.mult(x))
        return self.r_f.mult_transpose(y)

    def diagonal(self) -> torch.Tensor:
        return self.r_f.mult_transpose(torch.diagonal(self.S, dim1=1, dim2=2))

    # -- RHS reduction and recovery ------------------------------------------
    def reduce_rhs(self, b: torch.Tensor) -> torch.Tensor:
        """Full L-vector RHS → condensed RHS b_f − A_fc A_cc⁻¹ b_c."""
        t = torch.einsum("emk,ekl,el->em", self.Afc, self.Acc_inv, self.r_c.mult(b))
        return self.r_f.mult_transpose(-t) + b[self._iface]

    def recover(self, x_f: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Condensed solution → full L-vector (interiors back-substituted)."""
        full = torch.zeros(self.fes.ndof_scalar, dtype=x_f.dtype, device=x_f.device)
        full[self._iface] = x_f
        xc = torch.einsum("ekl,el->ek", self.Acc_inv,
                          self.r_c.mult(b) - torch.einsum(
                              "ekm,em->ek", self.Acf, self.r_f.mult(x_f)))
        full[self._gather_c] = xc.reshape(-1)
        return full

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        """Essential dofs in condensed numbering."""
        ess = self.fes.essential_dofs(bdr_marker)
        g2c = np.full(self.fes.ndof_scalar, -1, dtype=np.int64)
        g2c[self.iface_dofs] = np.arange(self.n_iface)
        c = g2c[ess]
        assert (c >= 0).all(), "essential dof eliminated as interior?"
        return c.astype(np.int32)
