"""Multidomain coupled heat transfer: a tissue and a catheter subdomain of
one cube, coupled through the interface temperature (counterpart of the
root ``examples/multidomain_heat.py``; MFEM's
``miniapps/multidomain/multidomain.cpp``, SubMesh + TransferMap).

    python -m cardiac_ablation_ecm2_tpu_torch.examples.multidomain_heat [-n 6] [-s 10] [--cpu] [--x64]

The parent is the unit cube of n³ hexes; the catheter is the inner column
|x−½|, |y−½| < ¼ (attribute 2), the tissue the rest (attribute 1).  Each
step the catheter takes a backward-Euler step with a volume source and a
free interface, its field goes onto the parent, and the tissue takes a
step with 37 on the outer boundary and the catheter's values on the
interface.  It takes the root driver's arguments and prints its lines.
The root driver rebuilds both forms in every step; here each subdomain
builds its mass and diffusion operators (and the source's linear form)
once, which gives the same numbers.

The host part (:func:`setup_host`: the parent mesh, both extractions, the
three spaces and the transfer tables) is numpy and can be built in another
process; :class:`Coupled` holds the device part.
"""

import dataclasses
import time

import numpy as np
import torch

from .common import setup, standard_parser

#: the root driver's constants
KAPPA_CATHETER, KAPPA_TISSUE, SOURCE, T_BODY = 0.1, 0.5, 80.0, 37.0
REL_TOL, MAX_ITER = 1e-10, 2000


def parent_mesh(n: int):
    """The unit cube of n³ hexes, attribute 2 on the inner column."""
    from ..mesh.mesh import Mesh, make_cartesian_3d

    m = make_cartesian_3d(n, n, n)
    cent = m.vertices[m.elements].mean(axis=1)
    inner = (np.abs(cent[:, 0] - 0.5) < 0.25) & (np.abs(cent[:, 1] - 0.5) < 0.25)
    return Mesh(geom=m.geom, vertices=m.vertices, elements=m.elements,
                attributes=np.where(inner, 2, 1), boundary=m.boundary,
                bdr_attributes=m.bdr_attributes)


@dataclasses.dataclass(eq=False)
class HostProblem:
    """The host tables of the coupled problem (picklable numpy)."""

    pfes: object                 # parent FESpace
    tfes: object                 # tissue FESpace
    cfes: object                 # catheter FESpace
    s2p_t: np.ndarray            # tissue dof → parent dof
    s2p_c: np.ndarray            # catheter dof → parent dof
    iface_t: np.ndarray          # tissue interface dofs
    outer_t: np.ndarray          # tissue outer-boundary dofs
    seconds: dict                # host seconds of each part


def setup_host(n: int, order: int) -> HostProblem:
    """The parent mesh, the tissue (1) and catheter (2) submeshes, the three
    order-``order`` spaces and the transfer tables, each part timed."""
    from ..fem.fespace import FESpace
    from ..mesh.submesh import create_from_domain, sub_to_parent_map

    t = [time.perf_counter()]
    parent = parent_mesh(n)
    t.append(time.perf_counter())
    tissue = create_from_domain(parent, [1])
    t.append(time.perf_counter())
    cath = create_from_domain(parent, [2])
    t.append(time.perf_counter())
    pfes = FESpace(parent, order)
    t.append(time.perf_counter())
    tfes = FESpace(tissue.mesh, order)
    t.append(time.perf_counter())
    cfes = FESpace(cath.mesh, order)
    t.append(time.perf_counter())
    s2p_t = sub_to_parent_map(pfes, tfes, tissue)
    s2p_c = sub_to_parent_map(pfes, cfes, cath)
    new_attr = int(parent.bdr_attributes.max()) + 1      # the interface
    iface_t = tfes.essential_dofs([new_attr])
    outer_t = tfes.essential_dofs([1, 2, 3, 4, 5, 6])
    t.append(time.perf_counter())
    names = ("mesh", "tissue extraction", "catheter extraction", "parent space",
             "tissue space", "catheter space", "transfer tables")
    return HostProblem(pfes=pfes, tfes=tfes, cfes=cfes, s2p_t=s2p_t, s2p_c=s2p_c,
                       iface_t=iface_t, outer_t=outer_t,
                       seconds=dict(zip(names, np.diff(t))))


class HeatStep:
    """One backward-Euler step of u_t = ∇·(κ∇u) + q on one subdomain, with
    the root driver's masked system and its CG (rel_tol 1e-10, at most 2,000
    iterations); the mass and diffusion operators built once."""

    def __init__(self, fes, kappa, dt, device, dtype, q=None):
        from ..ops.bilinearform import BilinearForm
        from ..ops.linearform import domain_lf

        self.fes, self.dt = fes, dt
        self.M = BilinearForm(fes, device).add_domain_integrator("mass").assemble(dtype)
        self.A = BilinearForm(fes, device).add_domain_integrator(
            "diffusion", kappa).assemble(dtype)
        self.lf = None if q is None else domain_lf(fes, q, dtype=dtype, device=device)

    def lhs(self, v, mvec):
        z = v * mvec
        return (self.M.mult(z) + self.dt * self.A.mult(z)) * mvec + (v - z)

    def __call__(self, u, ess, ess_vals):
        from ..linalg.solvers import cg

        mvec = torch.ones_like(u)
        mvec[ess] = 0.0
        b = self.M.mult(u)
        if self.lf is not None:
            b = b + self.dt * self.lf
        fixed = ess_vals * (1 - mvec)
        b = (b - self.lhs(fixed, mvec)) * mvec + fixed
        return cg(lambda v: self.lhs(v, mvec), b, rel_tol=REL_TOL, max_iter=MAX_ITER)


class Coupled:
    """The device part: the transfer maps, the two subdomain steps and the
    parent field Tp (37 everywhere at the start)."""

    def __init__(self, prob: HostProblem, dt, device=None, dtype=None):
        from ..fem.gridfunction import project
        from ..mesh.submesh import TransferMap
        from ..utils.config import resolve_device

        device = resolve_device(device)
        self.tm_t = TransferMap(prob.s2p_t, device)
        self.tm_c = TransferMap(prob.s2p_c, device)
        self.cath = HeatStep(prob.cfes, KAPPA_CATHETER, dt, device, dtype,
                             q=lambda x: SOURCE + 0 * x[..., 0])
        self.tissue = HeatStep(prob.tfes, KAPPA_TISSUE, dt, device, dtype)
        self.Tp = project(prob.pfes, lambda x: T_BODY + 0 * x[..., 0], dtype=dtype,
                          device=device)
        self.iface = torch.as_tensor(prob.iface_t.astype(np.int64), device=device)
        self.outer = torch.as_tensor(prob.outer_t.astype(np.int64), device=device)
        self.ess = torch.cat([self.outer, self.iface])
        self.none = torch.zeros(0, dtype=torch.int64, device=device)

    def step(self):
        """One coupled step: (Tc, Tt, the catheter's and the tissue's CG
        infos)."""
        Tc = self.tm_c.to_sub(self.Tp)
        Tc, info_c = self.cath(Tc, self.none, torch.zeros_like(Tc))
        self.Tp = self.tm_c.to_parent(Tc, self.Tp)

        Tt = self.tm_t.to_sub(self.Tp)
        vals = torch.zeros_like(Tt)
        vals[self.outer] = T_BODY
        vals[self.iface] = Tt[self.iface]
        Tt, info_t = self.tissue(Tt, self.ess, vals)
        self.Tp = self.tm_t.to_parent(Tt, self.Tp)
        return Tc, Tt, info_c, info_t


def main(argv=None):
    ap = standard_parser("Two-domain heat conduction coupled via SubMesh")
    ap.add_argument("-n", "--ncell", type=int, default=6)
    ap.add_argument("-s", "--steps", type=int, default=10)
    ap.add_argument("--dt", type=float, default=0.05)
    args = ap.parse_args(argv)
    kw = setup(args)

    run = Coupled(setup_host(args.ncell, args.order), args.dt, **kw)
    Tc = Tt = None
    for step in range(args.steps):
        Tc, Tt, _, info = run.step()
        print(f"step {step}: catheter max {float(Tc.max()):.3f}  "
              f"tissue max {float(Tt.max()):.3f}  iters {info.iterations}")

    assert float(Tc.max()) > 37.5, "catheter should heat up"
    print("OK: interface-coupled two-domain transient heat")
    return run, Tc, Tt


if __name__ == "__main__":
    main()
