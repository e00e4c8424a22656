"""Example 15: dynamic AMR — refine and derefine tracking a moving front
(counterpart of the root ``examples/ex15_dynamic_amr.py``; MFEM's ex15).

    python -m cardiac_ablation_ecm2_tpu_torch.examples.ex15_dynamic_amr [-n 8] [-s 5] [-o 2] [--cpu] [--x64]
"""

import numpy as np

from .common import setup, standard_parser


def main(argv=None):
    ap = standard_parser("Dynamic refine/derefine AMR on a moving front")
    ap.add_argument("-n", "--ncell", type=int, default=8)
    ap.add_argument("-s", "--steps", type=int, default=5)
    args = ap.parse_args(argv)
    kw = setup(args)

    import torch

    from ..fem.ncfespace import NCFESpace
    from ..mesh.forest import AMRForest
    from ..mesh.mesh import make_cartesian_2d
    from ..utils.config import real_t

    forest = AMRForest(make_cartesian_2d(args.ncell, args.ncell))
    lines = []
    for step in range(args.steps):
        t = step / max(args.steps - 1, 1)
        cx, cy = 0.2 + 0.6 * t, 0.5           # moving front center

        h_min = 1.0 / args.ncell / 8                  # ≤3 extra levels
        for _round in range(3):
            m = forest.mesh()
            cent = m.vertices[m.elements].mean(axis=1)
            h = (m.vertices[m.elements].max(axis=1)
                 - m.vertices[m.elements].min(axis=1)).max(axis=1)
            d = np.hypot(cent[:, 0] - cx, cent[:, 1] - cy)
            marks = (d < 0.15) & (h > h_min)
            refined = bool(marks.any())
            if refined:
                forest.refine(marks)
            m = forest.mesh()
            cent = m.vertices[m.elements].mean(axis=1)
            d = np.hypot(cent[:, 0] - cx, cent[:, 1] - cy)
            merged = forest.derefine(d > 0.3)
            if not refined and merged == 0:
                break
        nc = forest.nc()
        sp = NCFESpace(nc, args.order, device=kw["device"])
        x = sp.dof_coords
        u = torch.as_tensor(np.exp(-40 * ((x[:, 0] - cx) ** 2 + (x[:, 1] - cy) ** 2)),
                            dtype=real_t(kw["dtype"]), device=kw["device"])
        lines.append(f"step {step}: elements={nc.mesh.ne} "
                     f"conforming dofs={sp.ndof_conf} hanging={nc.n_hanging} "
                     f"max u={float(u.max()):.3f}")
        print(lines[-1])
    return lines


if __name__ == "__main__":
    main()
