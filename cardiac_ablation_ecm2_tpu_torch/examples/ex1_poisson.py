"""Example 1: Poisson with PCG (counterpart of the root
``examples/ex1_poisson.py``; MFEM's ex1).

    python -m cardiac_ablation_ecm2_tpu_torch.examples.ex1_poisson [-m inline-quad-16] [-o 2] [-r 0] [--cpu] [--x64]
"""

from .common import load_mesh, maybe_vtu, setup, standard_parser


def main(argv=None):
    ap = standard_parser("Poisson: -div(grad u) = 1, u=0 on boundary")
    ap.add_argument("--prec", default="jacobi",
                    choices=["jacobi", "chebyshev", "lor", "none"])
    ap.add_argument("--tol", type=float, default=1e-10)
    args = ap.parse_args(argv)
    kw = setup(args)

    from ..models import poisson

    mesh = load_mesh(args, "inline-quad-16")
    res = poisson.solve(mesh, order=args.order, rhs=1.0, rel_tol=args.tol,
                        preconditioner=None if args.prec == "none" else args.prec,
                        **kw)
    print(f"ndof={res.fes.ndof}  CG iters={res.iterations}  "
          f"converged={res.converged}  |r|={res.final_norm:.3e}")
    maybe_vtu(args, mesh, res.fes, res.u)
    return res


if __name__ == "__main__":
    main()
