"""Example 26: p-multigrid preconditioned Poisson (counterpart of the root
``examples/ex26_multigrid.py``; MFEM's ex26).

    python -m cardiac_ablation_ecm2_tpu_torch.examples.ex26_multigrid [-o 4] [--cpu] [--x64]
"""

import numpy as np

from .common import load_mesh, setup, standard_parser


def main(argv=None):
    ap = standard_parser("Poisson with p-multigrid-PCG vs Jacobi-PCG")
    args = ap.parse_args(argv)
    if args.order < 2:
        args.order = 4
    kw = setup(args)

    from ..fem.fespace import FESpace
    from ..linalg.multigrid import make_p_multigrid
    from ..linalg.smoothers import jacobi
    from ..linalg.solvers import cg
    from ..ops.bilinearform import BilinearForm
    from ..ops.linearform import domain_lf
    from ..ops.operators import ConstrainedOperator

    mesh = load_mesh(args, "inline-quad-16")
    orders = [1]
    while orders[-1] * 2 <= args.order:
        orders.append(orders[-1] * 2)
    if orders[-1] != args.order:
        orders.append(args.order)
    spaces = {p: FESpace(mesh, p) for p in orders}

    def opf(fes):
        return ConstrainedOperator.wrap(
            BilinearForm(fes, kw["device"]).add_domain_integrator("diffusion")
            .assemble(kw["dtype"]).operator(),
            fes.essential_dofs(), **kw)

    mg = make_p_multigrid(lambda p: spaces[p], opf, orders,
                          ess_factory=lambda f: f.essential_dofs(), **kw)
    fes = spaces[args.order]
    A = opf(fes)
    b = domain_lf(fes, None, **kw) * A.mask

    x1, i1 = cg(A.mult, b, M=jacobi(A.diagonal()), rel_tol=1e-10, max_iter=2000)
    x2, i2 = cg(A.mult, b, M=mg.preconditioner(), rel_tol=1e-10, max_iter=200)
    print(f"ndof={fes.ndof}  order={args.order}  levels={orders}")
    print(f"Jacobi-PCG iters: {int(i1.iterations)}   "
          f"MG-PCG iters: {int(i2.iterations)}")
    agree = np.allclose(x1.cpu().numpy(), x2.cpu().numpy(), atol=1e-7)
    print(f"solutions agree: {agree}")
    return i1.iterations, i2.iterations, agree


if __name__ == "__main__":
    main()
