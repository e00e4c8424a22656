#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

0. Device: a CUDA device must be visible; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
1. Build: the host setup library (g++) and the four CUDA sources,
   gather-sum (with the transposing gather and the segment-sum), SELL
   SpMV, fused diffusion apply and the probe gathers (one nvcc each,
   ``sm_90a``, started together), from the sources in this checkout;
   prints ptxas' registers, spills and shared memory of the restriction,
   SpMV and probe-gather kernels.
2. Restriction kernels against their plain PyTorch versions on the card:
   random planes with sentinels (J = 1 and 8), a random transposing gather
   (a partial last tile, sentinels) and a random segment-sum (−0.0
   sources, empty segments), float32 and float64; then the maps of the
   995,336-hex mesh in all four layouts (L→E element-major on the
   one-plane gather, L→E into (nd, ne) on the transposing gather, E→L from
   either layout on the segment-sum), float32 and float64.  All must be
   bitwise equal; prints the median CUDA-event time of each next to the
   plain version's and the library call's (``index_select``,
   ``index_add_``), the bound under the least-work count (map, source and
   output once) beside the old count (every index plane), and the round
   trip of one hex CG apply (L→E into (nd, ne), E→L from it).
3. End to end, kernel path against plain path: cardiac hex n=16 in float64,
   three SDIRK33 steps on CUDA and on CPU tensors; θ must agree to 1e-10
   relative and every stage solve must take the same number of CG
   iterations; prints the CPU side's thread count beside the per-array
   differences.
4. Main path: the benchmark's implicit Pennes-bioheat step on the cardiac
   hex mesh n=126 (995,336 hexes, 8,092,657 dofs, order 2, float32): one
   warm-up step and two timed steps, the run MFEM's reference program timed
   (``tools/mfem_bioheat_bench.cpp``, ``bench_baseline.json``).  θ_max must
   lie within 2e-3 relative of MFEM's 1.21339844, CG iterations per solve
   within 16 ± 2, and the gather kernel and the fused diffusion kernel (the
   element-major residual), the transposing gather and the segment-sum (the
   stage apply's restriction) must have launched; after the run, the fused
   kernel is held to its plain version on this operator's own diffusion
   qdata (ne = 995,336, a last tile of 8 elements) as in [8].
5. Tet kernels against their plain versions on the card, at the shapes of
   the 956,820-tet mesh (n=66): its E→L as 46 multiplicity planes on the
   gather-sum and as the segment-sum (float32 and float64, bitwise equal,
   ``index_add_`` as the library call); FULL assembly of the pair twice,
   bitwise equal (no float atomics); the SELL SpMV on the assembled pair in
   float32 and float64 with c0 = 1 and c1 = γ of an SDIRK33 stage, random
   x: the kernel on the stage plane bitwise equal to its plain version
   (the same rounded operations in the same order).  Prints the padding,
   the packing seconds, the median CUDA-event time of the kernel, of
   forming the stage plane, of the plain version and of cuSPARSE
   (``torch.mv`` on the combined CSR matrix with int64 and with int32
   indices, timed as a yardstick only), the bytes moved, GB/s and the bound under the
   least-work count (one matrix's entries, row ids, x and y once) beside
   the old count (both weight planes).
6. Tet end to end: cardiac tet n=12 in float64 with the assembled ELL,
   three steps on CUDA and on CPU tensors (θ within 1e-10 relative, equal CG
   iterations per stage); cardiac tet n=32 in float32 on CUDA, θ_max within
   2e-3 relative of the JAX package's (float64, CPU), CG iterations per
   solve printed beside MFEM's 22.0.  MFEM's n=32 θ_max (2.39986753) is
   printed but not held: neither package reaches it after any of the first
   eight steps on this mesh, while the n=66 row holds (PERF.md).
7. Tet main path: ``BENCH_MESH=cardiac-tet BENCH_N=66 BENCH_ELL=1`` at full
   size (956,820 tets, 1,278,670 dofs, order 2, float32), MFEM's FULL
   assembly run (``bench_baseline.json``; its mesh built in a worker
   process from the start of the run): host and device setup seconds,
   one warm-up and two timed steps, θ_max within 2e-3 relative of MFEM's
   1.19519539, CG iterations per solve within 15% of 39.78, and the ELL
   kernel must have launched; prints the host packing seconds beside the
   width-bucket layout's 9.77 s and the peak device memory.
8. Fused diffusion kernel against its plain PyTorch version (the einsum
   chain) on the card, within 1e-5·max|y| in float32 and 1e-12·max|y| in
   float64: random inputs at ne = 4,099 for every (n1, nq1) it takes, in
   both types; an unsupported shape must raise; the 48³ unit lattice at
   order 2 and quad_extra 1 (the shape of
   ``benchmarks/pallas_profile.py``); after [10], the masked n=126
   operator's own diffusion qdata with a random E-vector in float32 and
   float64 ([4] and [9] hold it the same way at their own shapes).  The float32 cases print the median CUDA-event time of the
   kernel, of the plain version and of a cuBLAS composition (stacked
   gradient matmul, packed-D product, transposed matmul; a yardstick only),
   the bytes moved, GB/s and the bound.
9. The 48³ lattice, ``bench.py``'s default (110,592 hexes, 912,673 dofs,
   ``CartesianFESpace``, uniform-qdata collapse on, order 2, float32): host
   and device setup seconds, one warm-up and two timed steps; the apply
   branch (collapsed / affine) must be the JAX package's in float32, θ_max
   within 2e-3 relative of the JAX package's float64 value and CG
   iterations per solve within ±1 of its 5; after the run, the fused kernel
   against its plain version on this operator's diffusion qdata (ne =
   110,592, nq1 = 3) as in [8].  MFEM's 5.3171 s/step
   (``bench_baseline.json``) is printed beside.
10. The masked cardiac-hex lattice, ``BENCH_MESH=cardiac-hex
   BENCH_STRUCTURED=1``: first n=10 in float64 on CUDA and on CPU tensors
   (θ within 1e-10 relative, equal CG iterations); then n=126 in float32
   (1,000,188 lattice hexes, 8,129,143 lattice dofs, 8,092,657 of them
   active, MFEM's ndof): one warm-up and two timed steps, the
   per-quadrature-point apply, θ_max within 2e-3 relative of MFEM's
   1.21339844 (the carved problem is the same by construction), CG
   iterations per solve within 16 ± 2, DOF/s on the active dofs, the fused
   diffusion kernel launched and the gather kernel not at all.
11. The Mosaic gather probes: first their main path, ``python -m
   cardiac_ablation_ecm2_tpu_torch.benchmarks.gather_micro`` at n=48
   (``benchmarks.gather_micro.run``), every output equal to its probe's
   numpy reference and every probe kernel launched; then the launch floor
   (an empty kernel, ``torch.cuda._sleep(0)``, timed as the probes are);
   then each kernel (``take_flat`` on gather-sum, ``take_along_rows``,
   ``take_along_lanes``, ``take_rows``) at every probe shape, bitwise
   equal to its plain version and to the numpy reference, in float32 and
   float64; prints the median CUDA-event time of the kernel, the plain
   version and the library call (``index_select``, ``torch.gather``), each
   the device time of one of 20 calls queued behind a sleep kernel (one
   call between two events would time its launch), the least bytes
   (indices and output once, each source element the indices touch once),
   GB/s and the bound.  The probe shapes reach both branches of
   ``take_along_rows`` (strips at t1, direct for u1, whose B < 2R) and of
   ``take_along_lanes`` (staged t2, direct u2); ``PROBE_BRANCHES`` adds a
   strip of four floats, the direct ``take_along_rows`` for a table too
   tall for any strip and a lane row wider than 48 KB, each bitwise equal
   to plain and numpy in float32 and float64.
12. The coupled RF-ablation app (``models/ablation.AblationSim``: Laplace →
   SAR → Pennes → Arrhenius; electrode 2, ground 3, body 1, 30 V, σ 0.54,
   σ(T) = 0.54·(1 + 0.015(T − 37)) re-solved every step).  (a) Cardiac hex
   n=16 in float64 on CUDA and on CPU tensors, one plain step and two
   coupled steps with σ(T) and with k(T): Φ, SAR, T and Ω within 1e-10
   relative, equal CG counts in every RF and stage solve.  (b) The [4] mesh n=126 in float32, rel_tol 1e-5: setup
   seconds (space, RF solve and its iterations, operators), one warm-up and
   two timed steps, one timed coupled step with its re-solve; holds the RF
   solve's true residual ≤ 1e-5, the delivered power P equal to ΦᵀAΦ of
   the unconstrained operator within 1e-4, T finite with T_max > T_a, Ω
   finite, ≥ 0 and non-decreasing, and launches of the gather-sum, the
   transposing gather, the segment-sum and the fused diffusion kernels.  No MFEM reference exists for the coupled app.
13. Poisson on the [4] mesh (``models/poisson.solve``): −∇·(0.54∇u) = 1
   with u = 0 on the electrode (2) and the ground (3), order 2, float32,
   rel_tol 1e-5, once with each of the JAX package's device
   preconditioners, ``"jacobi"``, ``"chebyshev"`` (order 4) and ``"lor"``
   (the LOR multigrid: 7,962,688 sub-hexes, a V-cycle over the order-1
   space with a 32-iteration coarse CG), each run's launch counts set to
   0 before it.  Prints each run's setup and solve seconds, CG iterations,
   peak memory and kernel launches, and for ``"lor"`` the sub-hexes,
   V-cycles and the setup's split; holds each run converged, within
   1e-4·max|u| of a float64 Jacobi-PCG solution at rel_tol 1e-10 (whose
   true relative residual ≤ 1e-6 is held), ``"lor"`` < ``"jacobi"`` / 2
   and ``"chebyshev"`` ≤ ``"jacobi"`` iterations (the JAX tests'
   relations), the three solutions within 1e-3·max|u| of each other, and
   launches of the gather-sum, the transposing gather and the
   segment-sum.  Each float32 solution's true relative residual
   ‖B − A_c u‖/‖B‖ (a float64 evaluation) is printed, not held: rounding
   the float64 solution to float32 alone leaves ~5e-4 at this size.  After
   the ``"lor"`` solve's launches are read, every kernel and layout of its
   two restrictions (7,962,688 sub-hexes × 8, and the order-1 space's
   995,336 × 8) is held bitwise to its plain version in float32 and
   float64.
14. ex16 nonlinear heat (``models/heat.py``): the 80³ unit cube (cut from
   100³, 8,120,601 dofs), order 2 (4,173,281 dofs), float32,
   κ = 0.5 + 0.01u, dt 0.01,
   SDIRK33, u₀ = exp(−20 r²) about the centre; one warm-up and two steps
   timed with CUDA events.  Prints s/step, the stage CG counts and ‖u‖_L2
   after each step; holds u finite, every stage solve converged (fewer
   iterations than max_iter), ‖u‖_L2 non-increasing (the JAX
   package's ``test_nonlinear_heat_energy_decay``) and launches of the
   fused diffusion kernel, the gather-sum and the segment-sum; then holds
   the restriction's kernels bitwise, and the fused diffusion apply on the
   last state's κ(u) qdata within [8]'s tolerances, to their plain
   versions at the path's shapes (1,000,000 hexes).
15. ``entry()`` (``cardiac_ablation_ecm2_tpu_torch/entry.py``, the
   counterpart of ``__graft_entry__.entry``) on the card and on the CPU
   in float64 and float32: θ = T − 37 within 1e-10·max|θ| in float64, T
   within 1e-6·max|T| in float32.
16. The tet partial-assembly step (``BENCH_MESH=cardiac-tet BENCH_N=66``
   without ``BENCH_ELL``, the JAX bench's tet default), after [7] on its
   mesh and space: first tet n=12 in float64 on CUDA and on CPU tensors
   (θ within 1e-10 relative, equal CG iterations); then n=66 in float32
   with [7]'s settings: the apply it took (the affine one expected: the
   vertices' float64 factors), host and device setup seconds, one warm-up
   and two timed steps beside [7]'s ELL s/step, CG iterations per solve,
   θ_max within 2e-3 relative of MFEM's 1.19519539 and printed beside
   [7]'s, peak memory and the launches of the transposing gather and the
   segment-sum, which must have launched; then every kernel and layout of
   its (956,820 × 10) restriction bitwise against plain in float32 and
   float64, the float32 calls timed against plain, ``index_select`` /
   ``index_add_`` and the least-work bound.
17. The coupled RF-ablation app on the tet mesh ([12]'s settings): first
   tet n=12 in float64, CUDA against CPU tensors with σ(T) and with k(T)
   (Φ, SAR, T, Ω within 1e-10, equal CG counts); then n=66 in float32 as
   [12b] (the RF solve's seconds, iterations and true residual ≤ 1e-5,
   s/step, one σ(T) re-solve and coupled step, P = ΦᵀAΦ within 1e-4, Ω ≥ 0
   and non-decreasing, launches of the restriction kernels; the dense
   basis runs no fused diffusion).
18. The bioheat step's other modes on [4]'s space (run right after [4]):
   ``cg_variant="merged"`` and ``qdata_bf16=True``, each one warm-up and
   two timed steps, θ_max within 2e-3 of MFEM's 1.21339844, CG per solve
   printed beside [4]'s; the bf16 run must launch the fused diffusion
   kernel's bfloat16-qdata instantiation, which is then held to its plain
   version on the run's own bfloat16 K_qd within [8]'s float32 tolerance
   (and timed beside its bound at 2-byte qdata); then one explicit RK4 step
   (``BioheatOperator.mult``, an M_ρc solve a stage) on cardiac hex n=16
   in float64, CUDA against CPU tensors (1e-10, equal CG counts).

19. The CEED BP harness (``benchmarks/bp.run``, the counterpart of the root
   ``benchmarks/bp.py``): BP1 (mass) and BP3 (diffusion), orders 1-4,
   Jacobi, 100 fixed CG iterations (``check_convergence=False``) from
   b = 1, each solve timed with CUDA events after a warm-up solve.  First
   every mode at n=4 in float64 (8 iterations: the default 100 reach
   exact convergence and then 0/0 on these tiny spaces) on CUDA and on CPU
   tensors, within 1e-10 with equal counts, and on the ELL spaces the PA
   operator against the FULL-assembled one within 1e-12·max|y|.  Then
   float32, n = max(2, N // order) elements a side: hex generic and
   ``--structured`` at N = 80 (about 0.5M dofs at every order; cut from
   N = 128, 2.1M), ``--simplex`` PA at N = 64 (cut from 96) and
   ``--ell`` on hexes and tets at N = 64 (all cut; PERF.md section 4).  Prints for every run MDof/s,
   setup seconds, peak memory, the kernels it launched, the lane path it
   took and, for ELL, the SELL padding.  The launch counts are zeroed
   before each (mode, order)'s ``bp.run`` and read right after it; only
   then are the kernels held at that run's shapes: each ELL run's plane
   by ``ell_spmv`` bitwise against plain and the PA operator of the same
   space against it (within 1e-5·max|y|), each ELL space's FULL-assembly
   duplicate sum (``segment_sum``) bitwise, and each PA space's
   restriction (hex nd = 8/27/64/125, tet nd = 4/10/20/35) bitwise in
   float32 and float64, timed at order 4.  ``ell_spmv`` on the hex
   order-4 BP3 plane (rows 729 wide) is also timed beside cuSPARSE and
   its bound.
20. ex2 elasticity (``models/elasticity.solve``): first a 16x2x2 beam on
   CUDA and on CPU tensors (1e-10, equal counts) and, on a 64x8x8 beam,
   the PA apply against the FULL-assembled elasticity matrix applied by
   ``ell_spmv`` (1e-10); then the 96x12x12 beam of length 8 (x = 0
   fixed, the load (0, 0, -0.01) on x = 8; cut from 128x16x16, 839,619
   dofs), order 2, vdim 3, 361,875 dofs, float64, Jacobi-PCG at rel_tol 1e-9: iterations, seconds, ms an
   iteration, the tip deflection and peak memory; holds convergence and
   ||B - A_c u|| <= 1e-8 ||B||, and launches of the gather-sum and the
   segment-sum (one of each per component and apply); then the beam's
   domain and boundary-face restrictions bitwise.
21. Convection-diffusion with a Robin boundary by restarted GMRES:
   -0.01 lap u + (1, 0.5, 0.25).grad u = 1 on the unit cube, 0.01 du/dn +
   u = 0 on every face (``diffusion``, ``convection`` with a constant
   ``vector_coeff``, ``add_boundary_integrator("mass")``, ``domain_lf``);
   first n=6 in float64 on CUDA and on CPU tensors (1e-10, equal
   iterations); then 64^3, order 2, 2,146,689 dofs, float32, GMRES(50)
   with Jacobi at rel_tol 1e-6: iterations, seconds and whether convection
   took the affine lane path; holds convergence and ||b - A x|| <= 1e-5
   ||b||; then the cube's domain and boundary-face (nd 9) restrictions
   bitwise.
22. The sharded paths (``parallel/``) at world size 1 over NCCL, in this
   process (``launch.run_single``; the card runs one rank, so no halo
   exchange crosses ranks here: tier-1 holds those over gloo).  [22a]
   the sharded bioheat step on cardiac hex n=16 in float64 at rel_tol
   1e-10, three SDIRK33 steps: the card against world size 1 over gloo on
   the CPU (1e-10, equal CG counts) and against the serial T-form
   ``BioheatOperator`` on the same source (1e-8).  [22b] on [4]'s mesh and
   space, float32, Jacobi, rel_tol 1e-5, dt 0.25, the source of
   ``tools/dress_rehearsal.py:90-92`` centred on the mesh: host-table and
   device setup seconds, s/step (CUDA events, two steps after a warm-up),
   CG per stage, peak memory; the launches of the setup and three steps
   held to the counts the CG counts imply (per stage the residual's L→E,
   fused diffusion and E→L, and for each of the k + 1 stage applies two
   L→E, two E→L and one fused diffusion; three E→L in setup); T within
   1e-3 of the serial T-form step's rise with CG within ±1 a stage, and
   the s/step ratio; then the rank's restriction (its trash slot
   included) bitwise in float32 and float64 and ``fused_diffusion`` on
   its packed, weight-scaled qdata.  [22c] the same with ``"chebyshev"``
   and ``"pmg"``, each with JAX's 12 power steps (printed: the bound
   falls short at this size, ROADMAP Queue 3) and with 60 (held within
   1e-3 of the rise of Jacobi's T), their launches printed; after each
   p-MG run its order-1 coarse level's local restriction bitwise and
   ``fused_diffusion`` on that level's packed qdata at the stage's γ.  [22d] on [7]'s tet n=66 space (after
   [16]): setup, s/step, CG, launches held, the restriction at nd = 10
   bitwise.
23. Sharded Poisson on [13]'s problem and space with ``"pmg"`` and
   ``"lor"`` (after [13]): setup and solve seconds, iterations, the true
   relative residual, u within 1e-4 max|u| of [13]'s float64 reference;
   after each run the order-1 coarse level's local restriction bitwise
   and ``fused_diffusion`` on its packed qdata, and after a LOR run the
   LOR sub-hex local restriction bitwise.
24. The z-slab lattice stepper (``parallel/cartesian_bioheat``) on the 48³
   lattice (after [9]): s/step, CG, T against [9]'s θ (within 1e-2 of its
   rise: its quadrature has p + 2 points a direction, [9]'s p + 1), the
   fused diffusion kernel and no gather launched.
25. h-multigrid Poisson on a refined cardiac hierarchy: −Δu = 1, u = 0 on
   the boundary, on the cardiac hex mesh n=32 refined twice (16,305 →
   130,440 → 1,043,520 hexes, children numbered o·ne_c + e), order 2
   (about 8.5M dofs on the fine level), float32, rel_tol 1e-5: PCG with
   ``make_h_multigrid``'s Chebyshev smoothers (20 power steps; printed,
   flagged where the bound falls short), then with the levels rebuilt
   from the same ``HTransfer``s at 60 power steps, and Jacobi-PCG: setup
   and solve seconds, CG counts, peak memory, the true relative residual
   (float64 evaluation); the 60-step solution held within 1e-3 max|u| of
   Jacobi's in under a fifth of its iterations.  After the launch counts,
   every level's restriction bitwise, and the fine level's round trip
   timed beside [2]'s n=126 one.
26. ex1 in 2D, float64, rel_tol 1e-10: n=16 on the card against the CPU
   (quads, h-MG, triangles, curved quads; 1e-10, equal CG counts); then
   D2_N² quads at order 2 (512²: 1,050,625 dofs; cut from 1024²) with
   Jacobi-PCG and with h-MG over (D2_N/16)² refined four times, D2_N²
   triangles and the quads curved by a
   smooth map of the square at geometry order 2, with Jacobi-PCG: each
   true residual ≤ 1e-6 (CG stops on √(r, z)), (b, u) of the two quad
   runs within 1e-8 and of
   the triangles and curved quads within 1e-6; each fine restriction
   bitwise after its run.
27. ``parallel/refine.refine_uniform`` at world size 1 over NCCL: [25]'s
   16,305-hex order-2 ``ParFESpace`` to 130,440 hexes (cut from 130,440 →
   1,043,520, whose host tables took 23–49 s); the rank's
   prolongation of a seeded float32 field within 1e-6 max|u| of the
   serial ``HTransfer`` (an average over the written element slots
   against ``inv_mult_f``), then the rank's fine local restriction
   bitwise.
28. The five torch example programs (``cardiac_ablation_ecm2_tpu_torch/
   examples``: ex1, ex2, ex16, ex26, the ablation demo) at their defaults
   on the card, and ex16 on ``inline-hex-8`` (the defaults are 2D and the
   demo's cube is affine, so only hexes reach the fused diffusion
   kernel), each its ``main`` in a subprocess, all six together: exit 0
   and its last line; then the restriction at their spaces' shapes and
   the fused diffusion kernel at ex16 hex-8's, against plain.

29. The restriction's derivatives (``fem/restriction.py``'s autograd
   Functions) at the n=126 map (995,336 × 27) and the [30] beam's
   (1,728 × 27), float32 and float64: each direction's forward bitwise
   the kernel called directly, its backward bitwise the other direction's
   kernel, its jvp bitwise the kernel on the tangent, one launch each and
   a ``grad_fn`` on every output; the gradient of ||R u||² through the
   kernels; ``gradcheck`` / ``gradgradcheck`` (forward mode and
   forward-over-reverse too) in float64 on a small map on the card.
30. ex10 hyperelasticity (``models/hyperelastic.HyperelasticProblem``):
   Newton with JAX's defaults (line search 12, Jacobi-PCG to 1e-8, at most
   800), the exact tangent through the kernels (``gradient_tangent``: the
   gradient's graph built once a Newton step, one backward pass an
   apply).  First a 16x2x2 beam on CUDA and on CPU tensors
   (1e-10, equal Newton counts, CG counts equal but for round-off, within
   3: ``counts_close``); then 32x4x4 (cut from 64x8x8) at a tiny traction
   against ex2's linear elasticity (5e-3, JAX's test) and its tangent
   apply's ms; then the main run on 48x6x6 (length 8, order 2, vdim 3,
   float64; a cut of [20]'s 128x16x16, whose solve was predicted over ~120
   s, and then of 96x12x12, 75-115 s a phase)
   under a traction of 0.01 along it: setup, Newton and CG counts, solve
   seconds, ms a tangent apply (CUDA events), the residual drop (held ≤
   1e-9), peak memory and launches; then the restriction kernels bitwise
   against their plain versions at the beam's map and its boundary
   faces' map.
31. ex23's wave equation (``models/wave.WaveOperator``, Newmark β = 1/4,
   dt 1e-3): cardiac hex n=16 in float64 on CUDA and on the CPU (1e-10,
   equal CG counts), then [4]'s n=126 space in float32 (rel_tol 1e-5):
   three steps after a warm-up, s/step (CUDA events), CG per mass and
   implicit solve, the discrete energy's drift (held ≤ 1e-3), launches
   of the restriction and ``fused_diffusion`` kernels, both then held to
   their plain versions at this path's shapes.
32. The rest of the slice on the card against the CPU at the JAX tests'
   sizes, float64, 1e-10 and equal counts (``counts_close`` inside Newton
   solves, on the SIMP systems and the Schur MINRES): MINRES, BiCGStab,
   FGMRES, L-BFGS; generalized-α and SIA on a wave operator;
   incompressible and eikonal; topopt and the obstacle problem; the
   fractional solve, the Matérn sampler with given draws and LOBPCG from
   a given block; the three constrained solves and
   BlockILU-PCG; three Navier–Stokes steps in 3D.

33. DG advection, ex9 in 3D (``ops/dg_advection.DGAdvection``): first
   12³ hexes at order 3 in float64, five RK3-SSP steps on CUDA and on the
   CPU (1e-12); then ``make_cartesian_3d(48, 48, 48)``, L2 order 3 at 4
   points a direction (110,592 hexes, 7,077,888 dofs, 324,864 interior
   and 13,824 boundary faces), velocity (1, 0.5, 0.25), zero inflow, the
   root ex9 example's pulse at (0.3, 0.3, 0.3), float32 RK3-SSP dt 1e-3, 100
   steps: host face-table seconds, setup, s/step and ms a ``mult`` (CUDA
   events), peak memory, the launches of ``take_rows``, ``segment_sum``
   and ``gather_sum``; ∫u kept to 1e-4, u ≡ 1 with inflow 1 kept to 1e-5,
   the float64 run within 1e-4·max|u|; then ``take_rows`` at every face
   group and the one ``segment_sum`` at the operator's slot list bitwise
   against their plain versions, float32 (timed) and float64.
34. SIPG Poisson (``ops/dg_diffusion.DGDiffusion``) on the same mesh at
   order 2, 3 points (2,985,984 dofs): f = 1, g = 0, penalty 10,
   float32 Jacobi-PCG to 1e-6 on ``operator()``: host seconds, CG, solve
   seconds, launches; the same solve in float64 with its true relative
   residual (≤ 1e-5; a float32 iterate's stalls near eps32·‖A‖‖x‖) and
   the float32 solution within 1e-4·max|u| of it;
   ``fused_diffusion`` at the volume qdata against plain (1e-5·max|y|),
   the face route's kernels bitwise; one BR2 apply at the same size,
   timed in float32 and held in float64 to the same apply on the plain
   versions (1e-10).
35. ``parallel/dg`` at world size 1 over NCCL: [33]'s problem for 10
   steps (within 1e-6·max|u| of the serial port) and [34]'s SIPG solve
   (the serial CG count).
36. Static condensation (``ops/condense``) of order-4 Poisson on
   ``make_cartesian_3d(32, 32, 32)`` (2,146,689 dofs, 1,261,953 on the
   interface), float64: the condensed Jacobi-PCG solve and its recovery
   within 1e-8·max|u| of the uncondensed PA solve, launches, the
   interface restriction's kernels bitwise; ex22 problem 0
   (``ops/complex_fem``, Hermitian, order 2) on 256² and 512² quads
   (1,050,625 complex dofs), Jacobi-GMRES(200): seconds, iterations, the
   L2 error and its rate (≥ 2.6).
37. The rest of the DG modules at the JAX tests' sizes, card against CPU,
   float64 (1e-10, Krylov counts within 3): BR2, DG elasticity, Burgers
   and Euler, the IMEX advection–diffusion, the three estimators; then
   the face reads and sums of every card operator bitwise.

38. ex3 with AMS, the vector-FE slice's main path: ``make_cartesian_3d(2,
   2, 2)`` refined six times (2,097,152 hexes, 6,390,144 ND₁ dofs,
   2,146,689 H1 dofs), curl curl + mass with n×E = 0, float32 Jacobi-PCG
   (capped at 4,000) and AMS-PCG (two 7-level h-MG auxiliaries) to 1e-6:
   counts, seconds, ms an iteration, true residuals, the setup split, the
   peak, the launches (Jacobi's held to one gather and one segment-sum an
   apply, AMS's to the sum over the operator, G, Π and every V-cycle
   level of calls times launches a call); AMS within a quarter of Jacobi's count; the float64 L2 errors
   of ex3's field (rate 2: each component is constant along its own axis)
   and of a gradient field (ND₁'s first order) from 64³ to 128³; 8³ in
   float64 on the card against the CPU; the torch ex3 driver ``--ams -n
   32`` on the card and the CPU as subprocesses (the CPU one started with
   the phase, on 4 threads, the card one after the solves); then the ND
   map, the AMS edge map and every H1 level bitwise against plain.
39. Magnetic diffusion on the cardiac hex mesh n=126 (3,050,992 ND₀ dofs),
   three SDIRK33 steps, PEC, Jacobi-PCG, float32; ‖∫_K div B‖ ≤ 1e-6 ‖B·n‖
   for B = curl A (``discrete_curl``, ``discrete_divergence``); n=8 card
   against CPU in float64; the ND, RT and curl maps bitwise.
40. H(div): Darcy (ex5) on 64³ by MINRES; ADS-PCG on div-div + mass to 32³
   against Jacobi; ``hybridize_hdiv`` on an RT₂ hex and an RT₂ tet case
   against the unhybridized solve (1e-5 of max|u|, float64); every map
   bitwise.
41. The rest of the slice at the JAX tests' sizes, card against CPU in
   float64 (1e-10, equal counts): the Maxwell eigenvalues, the mixed
   family, ND/RT_R2D and ND_R1D, the ND/RT operators at orders 1–3, ex22
   problem 1 and the ex25 PML operators.
42. ``parallel/pvecfe`` at world size 1 over NCCL on 64³ (811,200 ND₀
   dofs): Jacobi held to the serial port's solve (1e-5 of max|u|, equal CG
   counts), the in-shard AMS within 1e-3; the rank's maps bitwise.

43. The NC slice's main path, an NC-refined cardiac hex RF-Laplace solve:
   ``make_cardiac_hex_mesh(48)`` (55,025 warped hexes; cut from 64 to stay
   under the time limit on a slow host), ``make_nc``, two
   isotropic 2:1 rounds on the centroids within 10 mm, then 7 mm, of the
   electrode centre (20, 20, 20) mm; ``NCFESpace`` order 2; the diffusion
   PA operator (lane-major, per point) under PᵀAP; the electrode
   (attribute 2) at 1, the ground pad (3) at 0; cg with M the identity,
   float32, rel_tol 1e-6.  Prints the host seconds of each stage, the
   hexes, hanging entities and slave dofs, the device set-up, the CG
   count, ms an iteration, the true residual (≤ 1e-3) and the peak; holds
   the launches to the applies times one ``gather_sum`` (P), one
   ``gather_transpose`` and two ``segment_sum`` (the PA apply and Pᵀ)
   each; P and Pᵀ bitwise their plain versions and timed, ⟨Pᵀv, u⟩ =
   ⟨v, Pu⟩ within 1e-5; the master map and the broken space's map
   bitwise; the ZZ estimate's largest and median values.
44. The rest of the NC slice: the [43] pipeline on
   ``make_cardiac_hex_mesh(24)`` in float64 to rel_tol 1e-12, card against
   CPU (1e-10 of max|u|, counts within 2; the CPU solve runs in a worker
   process from the start of the script, on one thread); ``parallel/pnc``
   at world 1 over NCCL on [43]'s space against its serial form on the
   card (Jacobi-PCG, counts within 2, 1e-4 of max|u|) and the rank's
   master map bitwise; the NC tet order-2 case and the ``AMRForest`` ex15
   loop at the JAX tests' sizes against the CPU; the ex15 and
   boundary-layer drivers at their defaults on the card as subprocesses.

Last, ``dryrun_multichip(torch.cuda.device_count())``: one spawned rank a
card over NCCL, the sharded bioheat step and the JAX dryrun's parts (a) a
sharded NC Poisson solve, (b) a sharded DG apply and (c) a sharded ND
solve with the in-shard AMS.

The last two lines of standard output are one JSON object describing the
kernels and one JSON object with the device.  The ``gather_sum``,
``gather_transpose``, ``segment_sum`` and ``fused_diffusion`` entries carry
``parallel_launches``, the launches of [22b]'s Jacobi run.  The ``gather_transpose`` and
``segment_sum`` entries also carry ``tet_*`` fields, their float32 numbers
on [16]'s (956,820 × 10) restriction with the launches of [16]'s run; the
``fused_diffusion`` entry carries ``bf16_*`` fields, its bfloat16-qdata
instantiation on [18]'s hex n=126 K_qd with the launches of that run.  The ``take_along_rows`` and
``take_along_lanes`` entries report t1 and t2; their ``probes`` field
holds u1's and u2's numbers (each width), with the launch floor; every
probe entry's ``measures`` says that its times run out of L2 while its
``bound_ms`` is the HBM byte bound.  The ``gather_transpose`` and ``segment_sum``
entries carry ``bp_hex_o4_*`` and ``bp_tet_o4_*`` fields (float32, [19]'s
order-4 restrictions) and ``bp_launches``; the ``ell_spmv`` entry carries
``bp_*`` fields, its float32 numbers on [19]'s hex order-4 BP3 plane, and
``bp_launches``, the launches of [19]'s full-size runs (each run's window
summed).  The ``gather_sum`` entry's ``ms`` is its element-major L→E; its
``round_trip_*`` fields are the hex
CG apply's restriction round trip (``mult_t`` + ``mult_transpose_t``),
which that entry's ``ms`` measured before the (nd, ne) directions had
kernels of their own.  Every restriction entry carries ``hmg_launches``
([25]'s default h-MG run, setup and solve), ``d2_launches`` ([26]'s four
full-size solves), ``refine_launches`` ([27]) and ``example_launches``
([28], the six example runs summed); the ``gather_transpose`` and
``segment_sum`` entries ``refined_*`` fields (float32, [25]'s refined fine
level), the ``gather_sum`` entry ``refined_round_trip_*``; the
``fused_diffusion`` entry the same launch fields.  Every restriction entry
carries ``hyperelastic_launches`` ([30]'s main solve), ``wave_launches``
([31]'s n=126 steps) and ``rest_launches`` ([32]'s card runs); the
``fused_diffusion`` entry ``wave_launches`` and ``rest_launches``.  The
restriction, ``fused_diffusion`` and ``take_rows`` entries carry
``dg_launches`` ([33]'s 100 float32 steps), ``sipg_launches`` ([34]'s
solve), ``pdg_launches`` ([35]) and ``condense_launches`` ([36]'s
condensed solve); the ``take_rows`` and ``segment_sum`` entries carry
``dg_*`` fields, their float32 numbers at [33]'s interior-face read and
slot list.  The restriction and ``fused_diffusion`` entries carry
``ex3_ams_launches`` and ``ex3_jacobi_launches`` ([38]'s two solves),
``magnetic_launches`` ([39]'s steps), ``hdiv_launches`` ([40]'s Darcy and
ADS solves), ``vecfe_rest_launches`` ([41]'s card runs) and
``pvecfe_launches`` ([42]); the ``gather_sum`` and ``segment_sum`` entries
``ex3_*`` fields, their float32 numbers on [38]'s ND map (2,097,152 × 12).
Every restriction entry carries ``nc_launches`` ([43]'s solve) and
``pnc_launches`` ([44]'s sharded run), the ``fused_diffusion`` entry
``pnc_launches``; the ``gather_sum`` and
``segment_sum`` entries ``nc_map_*`` fields, their float32 numbers on
[43]'s (n_slaves, width) master map, and ``nc_p_*`` / ``nc_pt_*``, P's
and Pᵀ's times whole against their plain versions.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

L = 0.04
MFEM_THETA_MAX = 1.21339844      # bench_baseline.json, cardiac-hex n=126
MFEM_CG_ITERS = 16.0
# bench_baseline.json, cardiac-tet rows (FULL assembly)
MFEM_TET66 = dict(theta_max=1.19519539, cg_iters=39.78, s_step=42.2357)
MFEM_TET32 = dict(theta_max=2.39986753, cg_iters=22.0, ne=108_941, ndof=150_037)
# θ_max after three steps on tet n=32 from the JAX package, float64 on the
# CPU, partial-assembly apply: ``python tests/test_torch_ell.py --n 32``
JAX_TET32_THETA_MAX = 1.43921577
# θ_max after three steps on the 48³ lattice from the JAX package, float64
# on the CPU (collapsed qdata, affine apply; 5 CG iterations in every solve):
# ``PYTHONPATH=. python tests/test_torch_cartesian.py --n 48``
JAX_LATTICE48 = dict(theta_max=0.20514715, cg_per_solve=5.0)
# the branch (collapsed, affine) JAX takes there in float32: neither, its
# diffusion qdata deviate 4.6371e-05 from W ⊗ d (rtol 1e-5):
# ``PYTHONPATH=. python tests/test_torch_cartesian.py --n 48 --dtype float32``
JAX_LATTICE48_F32_BRANCH = (False, False)
MFEM_LATTICE48_S_STEP = 5.3171   # bench_baseline.json, n=48, order 2
# the masked n=126 lattice: hexes, lattice dofs, active dofs (MFEM's ndof)
MASKED126 = (1_000_188, 8_129_143, 8_092_657)
SETTINGS = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0,
                ess_bdr=[1, 2, 3, 4, 5, 6], rel_tol=1e-5, max_iter=300,
                fused_setup=True, theta_form=True, dot_mode="auto",
                cg_variant="classic")
GAMMA = 0.25 * 0.435866521508458999416019   # dt · a_ii of SDIRK33
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
# non-tensor-core peaks, H100 SXM data sheet
FLOPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
KERNELS = {
    "gather_sum": dict(
        source="cardiac_ablation_ecm2_tpu_torch/csrc/gather_sum.cu",
        replaces="cardiac_ablation_ecm2_tpu/ops/block_gather.py:170"),
    "gather_transpose": dict(
        source="cardiac_ablation_ecm2_tpu_torch/csrc/gather_sum.cu",
        replaces="cardiac_ablation_ecm2_tpu/ops/block_gather.py:170"),
    "segment_sum": dict(
        source="cardiac_ablation_ecm2_tpu_torch/csrc/gather_sum.cu",
        replaces="cardiac_ablation_ecm2_tpu/ops/block_gather.py:170"),
    "ell_spmv": dict(
        source="cardiac_ablation_ecm2_tpu_torch/csrc/ell_spmv.cu",
        replaces="cardiac_ablation_ecm2_tpu/ops/ell.py:118"),
    "fused_diffusion": dict(
        source="cardiac_ablation_ecm2_tpu_torch/csrc/fused_diffusion.cu",
        replaces="cardiac_ablation_ecm2_tpu/ops/pallas_kernels.py:101"),
    "take_along_rows": dict(
        source="cardiac_ablation_ecm2_tpu_torch/csrc/gather_probes.cu",
        replaces="benchmarks/gather_micro3.py:55",
        also_replaces=["benchmarks/gather_micro4.py:46"]),
    "take_along_lanes": dict(
        source="cardiac_ablation_ecm2_tpu_torch/csrc/gather_probes.cu",
        replaces="benchmarks/gather_micro3.py:88",
        also_replaces=["benchmarks/gather_micro4.py:80"]),
    "take_rows": dict(
        source="cardiac_ablation_ecm2_tpu_torch/csrc/gather_probes.cu",
        replaces="benchmarks/gather_micro4.py:121",
        also_replaces=["benchmarks/gather_micro4.py:163"]),
}
#: the restriction's kernels, one CUDA source
RESTRICTION_KERNELS = ("gather_sum", "gather_transpose", "segment_sum")
#: the probe kernels; take_flat (probe p1, benchmarks/gather_micro2.py:80)
#: is one launch of gather_sum
PROBE_KERNELS = ("take_along_rows", "take_along_lanes", "take_rows")
#: the probe whose shape the kernels line reports for each
PROBE_LINE = {"take_along_rows": "T1", "take_along_lanes": "T2", "take_rows": "U3"}
#: what the probe kernels' times and bounds are: their sources stay in L2
#: across the queued calls, so the HBM byte bound is not one they must respect
PROBE_MEASURES = ("ms: one of 20 calls queued back to back, sources (at most 12 MB) "
                  "resident in the 50 MB L2; bound_ms: the least bytes over the HBM "
                  "rate, a bound these L2-resident calls need not respect")
# the coupled app's settings ([12]): cardiac mesh attributes 2 = electrode
# notch, 3 = ground pad, 1 = outer surface at body temperature
ABLATION = dict(electrode_bdr=[2], ground_bdr=[3], body_bdr=[1], voltage=30.0,
                sigma=0.54)
ABLATION_DT = 0.5


def sigma_of_T(Tq):
    """σ(T) of the coupled runs: +1.5% per °C above 37 °C."""
    return 0.54 * (1.0 + 0.015 * (Tq - 37.0))


def k_of_T(Tq):
    return 0.54 * (1.0 + 0.02 * (Tq - 37.0))


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bits(t):
    """The tensor's bit patterns, for bitwise comparisons."""
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def source(x):
    """Gaussian volumetric source at the electrode tip (bench.py)."""
    r2 = sum((x[..., i] - L / 2) ** 2 for i in range(3))
    return 2e7 * torch.exp(-r2 / (2 * 0.003 ** 2))


def lattice_source(x):
    """bench.py's broad source on the lattice: amplitude 1e6, width² (L/8)²."""
    r2 = sum((x[..., i] - L / 2) ** 2 for i in range(3))
    return 1e6 * torch.exp(-r2 / (L / 8) ** 2)


def time_ms(fn, reps=20):
    """Median CUDA-event time of ``fn`` in milliseconds, after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_device():
    from cardiac_ablation_ecm2_tpu_torch.utils.config import require_cuda

    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")
    return dev


def phase_build():
    from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg
    from cardiac_ablation_ecm2_tpu_torch.ops import ell
    from cardiac_ablation_ecm2_tpu_torch.ops import fused_diffusion as fd
    from cardiac_ablation_ecm2_tpu_torch.ops import gather_probes as gp
    from cardiac_ablation_ecm2_tpu_torch.utils import native

    t0 = time.perf_counter()
    builds = (native.lib, bg.build, ell.build, fd.build, gp.build)
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = [f.result() for f in [pool.submit(b) for b in builds]]
    print(f"[1] build: host library and four CUDA sources in parallel, "
          f"{time.perf_counter() - t0:.2f} s")
    for name, lib in (("gather_sum.cu", libs[1]), ("ell_spmv.cu", libs[2]),
                      ("gather_probes.cu", libs[4])):
        report = [ln.split("ptxas info    : ", 1)[-1] for ln in
                  getattr(lib, "build_log", "").splitlines()
                  if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
        print(f"[1] ptxas -v, {name}: " + ("; ".join(report) if report else
                                            "not rebuilt in this run"))


class KernelCheck:
    """Collects kernel-vs-plain comparisons on the card."""

    def __init__(self, dev):
        self.dev = dev
        self.max_abs_err = {}
        self.times = {}
        self.round_trip = {}

    def compare(self, name, label, kernel, plain, args, least=None, old=None,
                library=None, tag="[2]"):
        """``kernel(*args)`` against ``plain(*args)``, bitwise.  With
        ``least`` (the least bytes of the call: map, source and output
        once), also the median times of kernel, plain version and
        ``library`` (one PyTorch call computing the same function), and the
        bound at the card's HBM rate under the least-work count and, where
        given, under the ``old`` count.  Returns the kernel's output."""
        out = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        self.max_abs_err[name] = max(self.max_abs_err.get(name, 0.0),
                                     float((out - ref).abs().max()))
        check(torch.equal(bits(out), bits(ref)),
              f"{label}: {name} bitwise equal to plain")
        msg = f"{tag} {label}: {name} bitwise equal to plain"
        if least is not None:
            ms = time_ms(lambda: kernel(*args))
            plain_ms = time_ms(lambda: plain(*args))
            lib_ms = time_ms(library) if library is not None else None
            bound = least / HBM_BYTES_PER_S * 1e3
            msg += (f"; kernel {ms:.4f} ms ({least / ms / 1e6:.1f} GB/s of least "
                    f"work), plain {plain_ms:.4f} ms")
            if lib_ms is not None:
                msg += f", library {lib_ms:.4f} ms"
            msg += f"; least work {least / 1e6:.1f} MB, bound {bound:.4f} ms"
            old_bound = None
            if old is not None:
                old_bound = old / HBM_BYTES_PER_S * 1e3
                msg += f" (old count {old / 1e6:.1f} MB, {old_bound:.4f} ms)"
            self.times[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=bound, old_bound_ms=old_bound)
        print(msg)
        return out


def restriction_bytes(ne, nd, ndof, elsize, planes=None):
    """Least bytes of one restriction direction (the (ne, nd) int32 map or
    slot list, the source and the output, each once) and, with ``planes``
    (the E→L multiplicity planes), the old count: every (planes, ndof)
    index, the source and the output."""
    least = ne * nd * 4 + (ne * nd + ndof) * elsize
    old = None if planes is None else planes * ndof * 4 + (ne * nd + ndof) * elsize
    return least, old


def phase_kernel_random(kc):
    from cardiac_ablation_ecm2_tpu_torch.fem.restriction import scatter_slots
    from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg

    rng = np.random.default_rng(0)
    nsrc, nout = 1_000_003, 4_000_037
    flat = rng.integers(0, nsrc, nout)
    flat[flat % 97 == 3] += 1                    # empty segments
    flat[:60] = 5                                # a long one
    slots, offsets = (torch.as_tensor(a, device=kc.dev)
                      for a in scatter_slots(flat, nsrc + 17))
    ne = 148_151                                 # a last tile of 55 elements
    for dtype in (torch.float32, torch.float64):
        es = torch.tensor([], dtype=dtype).element_size()
        src = torch.as_tensor(rng.standard_normal(nsrc), dtype=dtype,
                              device=kc.dev)
        src[::101] = -0.0
        for J in (1, 8):
            idx = torch.as_tensor(rng.integers(0, nsrc + 1, (J, nout)),
                                  dtype=torch.int32, device=kc.dev)
            kc.compare("gather_sum", f"random J={J} {str(dtype)[6:]}",
                       bg.gather_sum, bg.gather_sum_plain, (src, idx),
                       least=idx.numel() * 4 + (nsrc + nout) * es)
        g = torch.as_tensor(rng.integers(0, nsrc + 1, (ne, 27)),
                            dtype=torch.int32, device=kc.dev)
        kc.compare("gather_transpose", f"random (ne, nd)=({ne}, 27) "
                   f"{str(dtype)[6:]}", bg.gather_transpose,
                   bg.gather_transpose_plain, (src, g),
                   least=restriction_bytes(ne, 27, nsrc, es)[0])
        e = torch.as_tensor(rng.standard_normal(nout), dtype=dtype, device=kc.dev)
        e[::101] = -0.0
        kc.compare("segment_sum", f"random {nout} slots into {nsrc + 17} "
                   f"segments {str(dtype)[6:]}", bg.segment_sum,
                   bg.segment_sum_plain, (e, slots, offsets),
                   least=nout * 4 + (nsrc + 18) * 8 + (nout + nsrc + 17) * es)


def check_restriction(kc, r, what, tag, seed, timed=False):
    """Every kernel and layout of the restriction ``r`` (gather-sum and
    transposing gather L→E, segment-sum E→L from either layout) bitwise
    against its plain version on seeded random inputs, in float32 and
    float64; with ``timed``, the float32 calls are timed against their
    plain versions and library calls."""
    from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg

    J = int((r.offsets[1:] - r.offsets[:-1]).max())
    gen = torch.Generator(device=kc.dev).manual_seed(seed)
    g, gT = r.g[0].long(), r.gm.T.reshape(-1).long()
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype)[6:]
        u = torch.randn(r.ndof, generator=gen, device=kc.dev, dtype=dtype)
        ue = torch.randn(r.ne * r.nd, generator=gen, device=kc.dev, dtype=dtype)
        least, old = restriction_bytes(r.ne, r.nd, r.ndof, u.element_size(), J)
        t = timed and dtype == torch.float32
        lte = dict(least=least, old=least) if t else {}
        etl = dict(least=least, old=old) if t else {}
        kc.compare("gather_sum", f"{what}L->E (ne,nd) {dt}", bg.gather_sum,
                   bg.gather_sum_plain, (u, r.g), tag=tag,
                   library=lambda: u.index_select(0, g), **lte)
        kc.compare("gather_transpose", f"{what}L->E (nd,ne) {dt}",
                   bg.gather_transpose, bg.gather_transpose_plain, (u, r.gm),
                   tag=tag, library=lambda: u.index_select(0, gT), **lte)
        kc.compare("segment_sum", f"{what}E->L (ne,nd) {dt}", bg.segment_sum,
                   bg.segment_sum_plain, (ue, r.slots, r.offsets), tag=tag,
                   library=lambda: torch.zeros_like(u).index_add_(0, g, ue), **etl)
        kc.compare("segment_sum", f"{what}E->L (nd,ne) {dt}", bg.segment_sum,
                   bg.segment_sum_plain, (ue, r.slotsT, r.offsets), tag=tag,
                   library=lambda: torch.zeros_like(u).index_add_(0, gT, ue), **etl)
        del u, ue
    del g, gT
    torch.cuda.empty_cache()


def phase_kernel_restriction(kc, fes):
    """The restriction of the 995,336-hex mesh in all four layouts, float32
    (timed) and float64; the hex CG apply's round trip."""
    from cardiac_ablation_ecm2_tpu_torch.fem.restriction import ElementRestriction

    t0 = time.perf_counter()
    r = ElementRestriction(fes.gather_map, fes.ndof, kc.dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    J = int((r.offsets[1:] - r.offsets[:-1]).max())
    print(f"[2] restriction map and slot lists for {fes.ndof} dofs built in "
          f"{build_s:.2f} s; multiplicity up to {J}")
    check_restriction(kc, r, "", "[2]", seed=1, timed=True)
    gen = torch.Generator(device=kc.dev).manual_seed(2)
    trip = [kc.times[k] for k in ("L->E (nd,ne) float32", "E->L (nd,ne) float32")]
    u = torch.randn(fes.ndof, generator=gen, device=kc.dev)
    kc.round_trip = {f"round_trip_{f}": sum(t[f] for t in trip)
                     for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "old_bound_ms")}
    kc.round_trip["round_trip_chained_ms"] = time_ms(
        lambda: r.mult_transpose_t(r.mult_t(u)))
    rt = {k[len("round_trip_"):]: v for k, v in kc.round_trip.items()}
    print(f"[2] hex CG apply's restriction round trip (mult_t + "
          f"mult_transpose_t), float32: {rt['ms']:.4f} ms (chained "
          f"{rt['chained_ms']:.4f} ms), plain {rt['plain_ms']:.4f} ms, library "
          f"{rt['library_ms']:.4f} ms; bound {rt['bound_ms']:.4f} ms least work, "
          f"{rt['old_bound_ms']:.4f} ms old count")


def run_steps(op, steps, dt=0.25):
    from cardiac_ablation_ecm2_tpu_torch.linalg import ode
    from cardiac_ablation_ecm2_tpu_torch.models import bioheat

    step = bioheat.make_stepper(op, ode.select("sdirk33"))
    T = torch.zeros(op.fes.ndof, dtype=op.dtype, device=op.device)
    t = 0.0
    for _ in range(steps):
        T, t = step(T, t, dt)
    return T


def small_cuda_vs_cpu(label, fes, dev, **kw):
    """Three float64 steps on CUDA and on CPU tensors: θ within 1e-10
    relative and equal CG iterations in every stage solve.  Each side runs
    twice, and whether it repeated itself bit for bit is printed."""
    from cardiac_ablation_ecm2_tpu_torch.models.bioheat import BioheatOperator

    ops = [BioheatOperator(fes, q_met=source, dtype="float64", device=d,
                           **dict(SETTINGS, **kw)) for d in (dev, "cpu")]
    (Tg, Tg2), (Tc, Tc2) = ([run_steps(op, 3).cpu() for _ in range(2)]
                            for op in ops)
    rel = float((Tg - Tc).abs().max() / Tc.abs().max())
    print(f"{label} f64, {fes.ndof} dofs: CUDA vs CPU theta rel diff {rel:.3e}, "
          f"CG iterations {ops[0].cg_iterations} vs {ops[1].cg_iterations}; "
          f"CPU threads {torch.get_num_threads()}; "
          f"second run bitwise equal to the first: CUDA "
          f"{torch.equal(Tg, Tg2)}, CPU {torch.equal(Tc, Tc2)}")
    # where the two sides part (ROADMAP Queue 3: [3] read ~8e-10 on some
    # machines with equal CG counts): setup arrays and one application of
    # each operator to the CPU side's θ
    parts = {name: (getattr(ops[0], name), getattr(ops[1], name))
             for name in ("b_const", "Mrc_diag", "A_diag", "Mrc_qd", "K_qd")}
    parts["residual(theta)"] = (ops[0].residual(Tc.to(dev)), ops[1].residual(Tc))
    parts["stage apply(theta)"] = (ops[0]._stage_apply(GAMMA)(Tc.to(dev)),
                                   ops[1]._stage_apply(GAMMA)(Tc))
    print(f"{label} CUDA vs CPU rel diff of "
          + ", ".join(f"{k} {float((a.cpu() - b).abs().max() / b.abs().max()):.3e}"
                      for k, (a, b) in parts.items()))
    check(rel <= 1e-10, f"{label} kernel path within 1e-10 of the plain path")
    check(ops[0].cg_iterations == ops[1].cg_iterations,
          f"{label} equal CG iterations per stage")


def phase_small_end_to_end(dev):
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh

    fes = FESpace(make_cardiac_hex_mesh(16, lengths=(L, L, L / 2),
                                        electrode_radius=0.004), 2)
    small_cuda_vs_cpu("[3] hex n=16", fes, dev)


def timed_steps(op, T=None):
    """One warm-up step and two steps timed with CUDA events (the protocol
    of MFEM's reference program) from ``T`` (default θ = 0); returns (θ or
    T, s/step, host-clock s/step)."""
    from cardiac_ablation_ecm2_tpu_torch.linalg import ode
    from cardiac_ablation_ecm2_tpu_torch.models import bioheat

    step = bioheat.make_stepper(op, ode.select("sdirk33"))
    if T is None:
        T = torch.zeros(op.fes.ndof, dtype=op.dtype, device=op.device)
    T, t = step(T, 0.0, 0.25)                    # warm-up step
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    a.record()
    for _ in range(2):
        T, t = step(T, t, 0.25)
    b.record()
    torch.cuda.synchronize()
    return T, a.elapsed_time(b) / 1e3 / 2, (time.perf_counter() - h0) / 2


def start_main_path():
    """Every launch count to 0 and a fresh peak-memory reading, just before
    a main path is driven."""
    from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg
    from cardiac_ablation_ecm2_tpu_torch.ops import ell
    from cardiac_ablation_ecm2_tpu_torch.ops import fused_diffusion as fd
    from cardiac_ablation_ecm2_tpu_torch.ops import gather_probes as gp

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in RESTRICTION_KERNELS:
        getattr(bg, name).launches = 0
    ell.ell_spmv.launches = 0
    fd.diffusion_apply.launches = 0
    for name in PROBE_KERNELS + ("take_flat",):
        getattr(gp, name).launches = 0


def main_path_launches():
    from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg
    from cardiac_ablation_ecm2_tpu_torch.ops import ell
    from cardiac_ablation_ecm2_tpu_torch.ops import fused_diffusion as fd
    from cardiac_ablation_ecm2_tpu_torch.ops import gather_probes as gp

    out = {name: getattr(bg, name).launches for name in RESTRICTION_KERNELS}
    out.update(ell_spmv=ell.ell_spmv.launches,
               fused_diffusion=fd.diffusion_apply.launches)
    out.update({name: getattr(gp, name).launches
                for name in PROBE_KERNELS + ("take_flat",)})
    return out


def report_run(tag, op, T, theta_ref, ref_name="MFEM"):
    """Print and return (θ_max, its per solve, rel diff to the reference)
    after checking θ is finite and of the expected shape."""
    check(T.shape == (op.fes.ndof,) and bool(torch.isfinite(T).all()),
          f"{tag} finite θ of the expected shape")
    theta_max = float(T.max())
    its = op.cg_iterations
    per_solve = sum(its) / len(its)
    rel = abs(theta_max - theta_ref) / theta_ref
    print(f"{tag} CG iterations per solve {per_solve:.2f} {its}")
    print(f"{tag} theta_max {theta_max:.8f}, rel diff to {ref_name} "
          f"{theta_ref} = {rel:.3e}")
    return theta_max, per_solve, rel


def phase_main(dev, mesh, fes, host_s):
    """Setup and three steps of the benchmark configuration in float32;
    returns the launch counts of this run, CG per solve and s/step."""
    from cardiac_ablation_ecm2_tpu_torch.models import bioheat

    start_main_path()
    t0 = time.perf_counter()
    op = bioheat.BioheatOperator(fes, q_met=source, dtype="float32",
                                 device=dev, **SETTINGS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(op._lane is not None and op._aff is None,
          "warped hexes take the per-quadrature-point lane-major path")
    T, s_step, host_step = timed_steps(op)
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"[4] cardiac hex n=126 order 2 f32: {mesh.ne} elements, "
          f"{fes.ndof} dofs")
    print(f"[4] host setup: mesh {host_s[0]:.2f} s, FESpace {host_s[1]:.2f} s; "
          f"device setup (operator incl. restriction planes) {setup_s:.2f} s")
    print(f"[4] s/step {s_step:.6f} (CUDA events; host clock {host_step:.6f}), "
          f"{fes.ndof / s_step:.1f} DOF/s; MFEM CPU 145.408 s/step")
    _, per_solve, rel = report_run("[4]", op, T, MFEM_THETA_MAX)
    print(f"[4] launches: gather_sum {launches['gather_sum']}, "
          f"gather_transpose {launches['gather_transpose']}, segment_sum "
          f"{launches['segment_sum']}, fused diffusion "
          f"{launches['fused_diffusion']}; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB")
    check(rel <= 2e-3, "theta_max within 2e-3 of MFEM")
    check(abs(per_solve - MFEM_CG_ITERS) <= 2, "CG iterations within 16 ± 2")
    for name in RESTRICTION_KERNELS:
        check(launches[name] > 0, f"the main path launched {name}")
    check(launches["fused_diffusion"] > 0,
          "the main path's residual launched the fused diffusion kernel")
    check_operator_diffusion("[4]", "hex n=126 K_qd", op)
    return launches, per_solve, s_step


def cardiac_tet_mesh(n):
    """The cardiac tet mesh n and its host seconds."""
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_tet_mesh

    t0 = time.perf_counter()
    mesh = make_cardiac_tet_mesh(n, lengths=(L, L, L / 2), electrode_radius=0.004)
    return mesh, time.perf_counter() - t0


def tet_space(n, built=None):
    """Cardiac tet mesh and its order-2 space, with the host seconds of
    each; ``built`` is the (mesh, seconds) of :func:`cardiac_tet_mesh`
    when a worker process made it."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace

    mesh, mesh_s = cardiac_tet_mesh(n) if built is None else built
    t1 = time.perf_counter()
    fes = FESpace(mesh, 2)
    return mesh, fes, (mesh_s, time.perf_counter() - t1)


def ell_bound(pair, elsize):
    """Least bytes of one SpMV (the int32 column and one weight of every
    entry of one matrix; row id, x and y once per row), the old count
    (both weight planes) and the bound of each at the card's HBM rate, in
    ms; the ~3 flops per entry need far less at 67 TFLOP/s."""
    least = pair.nnz * (4 + elsize) + pair.n * (4 + 2 * elsize)
    old = pair.nnz * (4 + 2 * elsize) + pair.n * (4 + 2 * elsize)
    return least, old, least / HBM_BYTES_PER_S * 1e3, old / HBM_BYTES_PER_S * 1e3


def phase_tet_restriction(kc, fes):
    """The n=66 tet space's E→L, which the tet main path runs in setup
    (right-hand side, diagonals): as 46 multiplicity planes on the
    gather-sum (the sentinel-plane form) and as the segment-sum, float32
    and float64,
    each bitwise equal to its plain version and the two equal in value."""
    from cardiac_ablation_ecm2_tpu_torch.fem.restriction import (
        ElementRestriction,
        scatter_planes,
    )
    from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg

    r = ElementRestriction(fes.gather_map, fes.ndof, kc.dev)
    planes = torch.as_tensor(scatter_planes(fes.gather_map.reshape(-1), fes.ndof),
                             device=kc.dev)
    J = planes.shape[0]
    g = r.g[0].long()
    gen = torch.Generator(device=kc.dev).manual_seed(2)
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype)[6:]
        ue = torch.randn(r.ne * r.nd, generator=gen, device=kc.dev, dtype=dtype)
        least, old = restriction_bytes(r.ne, r.nd, r.ndof, ue.element_size(), J)
        kw = dict(least=least, old=old) if dtype == torch.float32 else {}
        lib = lambda: torch.zeros(r.ndof, dtype=dtype, device=kc.dev).index_add_(
            0, g, ue)
        a = kc.compare("gather_sum", f"tet E->L (ne,nd) on {J} planes {dt}",
                       bg.gather_sum, bg.gather_sum_plain, (ue, planes),
                       library=lib, tag="[5]", **kw)
        b = kc.compare("segment_sum", f"tet E->L (ne,nd) segment-sum {dt}",
                       bg.segment_sum, bg.segment_sum_plain,
                       (ue, r.slots, r.offsets), library=lib, tag="[5]", **kw)
        check(torch.equal(a, b), f"tet E->L {dt}: planes and segment-sum equal")


def assemble_pair(fes, dev):
    """FULL assembly of M_ρc, K and M_ω on ``dev`` (scipy CSR)."""
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm

    return [BilinearForm(fes, dev).add_domain_integrator(kind, c).assemble_matrix()
            for kind, c in (("mass", SETTINGS["rho_c"]), ("diffusion", SETTINGS["k"]),
                            ("mass", SETTINGS["w_cb"]))]


def phase_ell_kernel(dev, fes):
    """FULL assembly twice (bitwise repeatable), then the SELL kernel on the
    stage plane against its plain version on the n=66 pair; returns the
    float32 numbers for the kernels line."""
    from cardiac_ablation_ecm2_tpu_torch.ops import ell

    t0 = time.perf_counter()
    M, K, Mw = assemble_pair(fes, dev)
    t1 = time.perf_counter()
    again = assemble_pair(fes, dev)
    for X, Y, name in zip((M, K, Mw), again, ("M_rc", "K", "M_w")):
        check(np.array_equal(X.indptr, Y.indptr)
              and np.array_equal(X.indices, Y.indices)
              and np.array_equal(X.data.view(np.int64), Y.data.view(np.int64)),
              f"FULL assembly of {name} bitwise repeatable")
    print(f"[5] FULL assembly of M_rc, K, M_w ({M.nnz} nnz each): "
          f"{t1 - t0:.2f} s; assembled again: bitwise equal")
    A = K + Mw
    rng = np.random.default_rng(7)
    x64 = rng.standard_normal(fes.ndof)
    out = {"max_abs_err": 0.0}
    C = (M + GAMMA * A).tocsr()
    C.sort_indices()
    for dtype in (torch.float64, torch.float32):
        dt = str(dtype)[6:]
        t0 = time.perf_counter()
        pair = ell.MultiELLPair.from_csr_pair(M, A, dtype, dev)
        torch.cuda.synchronize()
        pair_s = time.perf_counter() - t0
        x = torch.as_tensor(x64, dtype=dtype, device=dev)
        plane = pair.combined(1.0, GAMMA)
        ref = ell.ell_spmv_plain(plane, x)
        y1 = ell.ell_spmv(plane, x)
        torch.cuda.synchronize()
        out["max_abs_err"] = max(out["max_abs_err"], float((y1 - ref).abs().max()))
        check(torch.equal(bits(y1), bits(ref)),
              f"ell_spmv {dt}: kernel bitwise equal to its plain version")
        mats = {}
        for ib in (torch.int64, torch.int32):
            mats[ib] = torch.sparse_csr_tensor(
                torch.as_tensor(C.indptr, dtype=ib, device=dev),
                torch.as_tensor(C.indices, dtype=ib, device=dev),
                torch.as_tensor(C.data, dtype=dtype, device=dev), size=C.shape)
        lib_err = float((torch.mv(mats[torch.int32], x) - y1).abs().max()
                        / y1.abs().max())
        least, old, bound, old_bound = ell_bound(pair, x.element_size())
        print(f"[5] ell_spmv {dt}: n={pair.n} nnz={pair.nnz} slots="
              f"{pair.cols.numel()} (padding {pair.padding:.4f}; the width "
              f"buckets of 8 it replaced padded 0.10, from PERF.md), "
              f"{pair.slice_ptr.numel() - 1} slices of "
              f"{ell.SLICE}, sorting window {ell.SIGMA}, widest {pair.max_width}; "
              f"pair packed in {pair_s:.2f} s; kernel bitwise equal to plain; "
              f"cuSPARSE rel diff {lib_err:.2e}")
        ms = time_ms(lambda: ell.ell_spmv(plane, x))
        form_ms = time_ms(lambda: pair.combined(1.0, GAMMA))
        plain_ms = time_ms(lambda: ell.ell_spmv_plain(plane, x))
        lib_ms = {ib: time_ms(lambda: torch.mv(m, x)) for ib, m in mats.items()}
        print(f"[5] ell_spmv {dt}: kernel {ms:.4f} ms ({least / ms / 1e6:.1f} "
              f"GB/s of least work; forming the plane, once per solve, "
              f"{form_ms:.4f} ms), plain {plain_ms:.4f} ms, cuSPARSE torch.mv "
              f"int64 indices {lib_ms[torch.int64]:.4f} ms, int32 {lib_ms[torch.int32]:.4f} ms; "
              f"least work {least / 1e6:.1f} MB, bound {bound:.4f} ms (old count "
              f"{old / 1e6:.1f} MB, {old_bound:.4f} ms)")
        if dtype == torch.float32:
            out.update(ms=ms, plain_ms=plain_ms, library_ms=min(lib_ms.values()),
                       bound_ms=bound)
        del pair, plane, mats
    return out


def phase_tet_small(dev):
    from cardiac_ablation_ecm2_tpu_torch.models import bioheat

    _, fes, _ = tet_space(12)
    small_cuda_vs_cpu("[6] tet n=12", fes, dev, assembled_apply="ell")
    mesh, fes, _ = tet_space(32)
    check((mesh.ne, fes.ndof) == (MFEM_TET32["ne"], MFEM_TET32["ndof"]),
          "tet n=32 mesh size")
    op = bioheat.BioheatOperator(fes, q_met=source, dtype="float32", device=dev,
                                 assembled_apply="ell", **SETTINGS)
    T = run_steps(op, 3)
    print(f"[6] tet n=32 f32: {mesh.ne} tets, {fes.ndof} dofs; MFEM "
          f"{MFEM_TET32['cg_iters']} CG iterations per solve, theta_max "
          f"{MFEM_TET32['theta_max']} (a stale row: PERF.md)")
    _, _, rel = report_run("[6] tet n=32", op, T, JAX_TET32_THETA_MAX,
                           "the JAX package")
    check(rel <= 2e-3, "tet n=32 theta_max within 2e-3 of the JAX package's")


def phase_tet_main(dev, mesh, fes, host_s):
    """``BENCH_MESH=cardiac-tet BENCH_N=66 BENCH_ELL=1``: setup and three
    steps in float32; returns the launch counts of this run and its s/step,
    θ_max and CG per solve."""
    from cardiac_ablation_ecm2_tpu_torch.models import bioheat

    start_main_path()
    t0 = time.perf_counter()
    op = bioheat.BioheatOperator(fes, q_met=source, dtype="float32",
                                 device=dev, assembled_apply="ell", **SETTINGS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(op._ell is not None, "tets take the assembled-ELL apply")
    T, s_step, host_step = timed_steps(op)
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    sec = op.setup_seconds
    print(f"[7] cardiac tet n=66 order 2 f32, assembled ELL: {mesh.ne} tets, "
          f"{fes.ndof} dofs, {op._ell.nnz} nnz")
    print(f"[7] host setup: mesh {host_s[0]:.2f} s, FESpace {host_s[1]:.2f} s; "
          f"operator {setup_s:.2f} s = partial-assembly setup {sec['pa']:.2f} s "
          f"+ FULL assembly {sec['ell_assembly']:.2f} s + ELL pair and residual "
          f"plane {sec['ell_pair']:.2f} s (padding {op._ell.padding:.4f}) + "
          f"restriction and basis")
    print(f"[7] s/step {s_step:.6f} (CUDA events; host clock {host_step:.6f}), "
          f"{fes.ndof / s_step:.1f} DOF/s; MFEM CPU {MFEM_TET66['s_step']} s/step")
    _, per_solve, rel = report_run("[7]", op, T, MFEM_TET66["theta_max"])
    print(f"[7] ell-kernel launches {launches['ell_spmv']}, restriction kernel "
          f"launches (setup) " + ", ".join(f"{k} {launches[k]}"
                                          for k in RESTRICTION_KERNELS)
          + f"; max_memory_allocated {peak / 2**30:.3f} GiB")
    check(rel <= 2e-3, "tet n=66 theta_max within 2e-3 of MFEM")
    check(abs(per_solve - MFEM_TET66["cg_iters"]) <= 0.15 * MFEM_TET66["cg_iters"],
          "tet n=66 CG iterations per solve within 15% of MFEM's 39.78")
    check(launches["ell_spmv"] > 0, "the tet main path launched the ELL kernel")
    return launches, dict(s_step=s_step, theta_max=float(T.max()),
                          per_solve=per_solve)


def phase_tet_pa(kc, dev, mesh, fes, host_s, ell):
    """[16] ``BENCH_MESH=cardiac-tet BENCH_N=66`` on the partial-assembly
    path, on [7]'s mesh and space (``ell``: [7]'s s/step, θ_max and CG per
    solve): tet n=12 CUDA against CPU first, then setup and three steps in
    float32, then the restriction's kernels at this path's shapes.  Returns
    the launch counts of the run."""
    from cardiac_ablation_ecm2_tpu_torch.models import bioheat

    t0 = time.perf_counter()
    _, small, _ = tet_space(12)
    small_cuda_vs_cpu("[16] tet n=12 partial assembly", small, dev)
    del small
    start_main_path()
    t1 = time.perf_counter()
    op = bioheat.BioheatOperator(fes, q_met=source, dtype="float32",
                                 device=dev, **SETTINGS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t1
    check(op._ell is None and op._lane is not None,
          "[16] tets take a partial-assembly lane-major apply")
    apply = "affine (vertex factors)" if op._aff is not None else "per-point lane-major"
    T, s_step, host_step = timed_steps(op)
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"[16] cardiac tet n=66 order 2 f32, partial assembly: {mesh.ne} tets, "
          f"{fes.ndof} dofs; apply taken: {apply}")
    print(f"[16] host setup ([7]'s): mesh {host_s[0]:.2f} s, FESpace "
          f"{host_s[1]:.2f} s; operator {setup_s:.2f} s (partial-assembly "
          f"setup {op.setup_seconds['pa']:.2f} s); max_memory_allocated "
          f"{peak / 2**30:.3f} GiB")
    print(f"[16] s/step {s_step:.6f} (CUDA events; host clock {host_step:.6f}), "
          f"{fes.ndof / s_step:.1f} DOF/s; [7] ELL {ell['s_step']:.6f} s/step "
          f"in this run; MFEM CPU {MFEM_TET66['s_step']} s/step")
    theta_max, per_solve, rel = report_run("[16]", op, T, MFEM_TET66["theta_max"])
    print(f"[16] CG per solve {per_solve:.2f} beside [7]'s {ell['per_solve']:.2f} "
          f"and MFEM's {MFEM_TET66['cg_iters']}; theta_max rel diff to [7]'s "
          f"{ell['theta_max']:.8f}: "
          f"{abs(theta_max - ell['theta_max']) / ell['theta_max']:.3e}")
    print(f"[16] launches: " + ", ".join(f"{k} {launches[k]}"
                                         for k in RESTRICTION_KERNELS)
          + f", ell_spmv {launches['ell_spmv']}, fused diffusion "
          f"{launches['fused_diffusion']}")
    check(rel <= 2e-3, "[16] tet n=66 theta_max within 2e-3 of MFEM")
    for name in ("gather_transpose", "segment_sum"):
        check(launches[name] > 0, f"[16] the tet partial-assembly path launched {name}")
    r = op.restr
    del op, T
    torch.cuda.empty_cache()
    check_restriction(kc, r, "tet ", "[16]", seed=16, timed=True)
    print(f"[16] phase {time.perf_counter() - t0:.1f} s")
    return launches


def phase_ablation_tet(dev, mesh, host_s):
    """[17] The coupled app on the tet mesh: tet n=12 CUDA against CPU,
    then [12b]'s run on [7]'s mesh."""
    t0 = time.perf_counter()
    small, _, _ = tet_space(12)
    phase_ablation_small(dev, small, "[17]", "cardiac tet n=12")
    phase_ablation_main(dev, mesh, host_s[0], "[17]", "cardiac tet n=66",
                        "[7]'s mesh", RESTRICTION_KERNELS)
    print(f"[17] phase {time.perf_counter() - t0:.1f} s")


def phase_modes(dev, fes, hex_run):
    """[18] The bioheat step's merged CG and bfloat16 qdata on [4]'s space
    (``hex_run``: [4]'s CG per solve and s/step), then one explicit RK4
    step CUDA against CPU at n=16.  Returns the launches of the bf16 run
    and the bf16 kernel's numbers for the kernels line."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg import ode
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
    from cardiac_ablation_ecm2_tpu_torch.models import bioheat

    t0 = time.perf_counter()
    per_solve4, s_step4 = hex_run
    out = {}
    for mode, kw in (("merged CG", dict(cg_variant="merged")),
                     ("bf16 qdata", dict(qdata_bf16=True))):
        start_main_path()
        op = bioheat.BioheatOperator(fes, q_met=source, dtype="float32",
                                     device=dev, **dict(SETTINGS, **kw))
        T, s_step, _ = timed_steps(op)
        launches = main_path_launches()
        print(f"[18] hex n=126 {mode}: s/step {s_step:.6f} (CUDA events) beside "
              f"[4]'s {s_step4:.6f}")
        _, per_solve, rel = report_run(f"[18] {mode}", op, T, MFEM_THETA_MAX)
        print(f"[18] {mode}: CG per solve {per_solve:.2f} beside [4]'s "
              f"{per_solve4:.2f}; launches fused diffusion "
              f"{launches['fused_diffusion']}")
        check(rel <= 2e-3, f"[18] {mode}: theta_max within 2e-3 of MFEM")
        if "qdata_bf16" in kw:
            check(op.K_qd.dtype == torch.bfloat16,
                  "[18] the bf16 run's K_qd is bfloat16")
            check(launches["fused_diffusion"] > 0,
                  "[18] the bf16 run launched the bf16-qdata fused diffusion")
            gen = torch.Generator(device=dev).manual_seed(18)
            e = torch.randn(fes.mesh.ne, op.db.n1d ** 3, generator=gen,
                            device=dev)
            err, numbers = check_diffusion("hex n=126 bf16 K_qd", op.db,
                                           op.K_qd, e, timed=True, tag="[18]")
            out = {f"bf16_{k}": v for k, v in numbers.items() if k != "bound_by"}
            out.update(bf16_max_abs_err=err,
                       bf16_launches=launches["fused_diffusion"])
        del op, T
    small = FESpace(make_cardiac_hex_mesh(16, lengths=(L, L, L / 2),
                                          electrode_radius=0.004), 2)
    ops = [bioheat.BioheatOperator(small, q_met=source, dtype="float64", device=d,
                                   **SETTINGS) for d in (dev, "cpu")]
    theta = torch.rand(small.ndof, generator=torch.Generator().manual_seed(18),
                       dtype=torch.float64) * 0.5
    Ts = [ode.select("rk4").step(op, theta.to(op.device) * op.ess_mask,
                                 0.0, 0.01)[0].cpu() for op in ops]
    rel = float((Ts[0] - Ts[1]).abs().max() / Ts[1].abs().max())
    print(f"[18] explicit RK4 step (mult), hex n=16 f64, {small.ndof} dofs: "
          f"CUDA vs CPU rel diff {rel:.3e}, CG iterations "
          f"{ops[0].cg_iterations} vs {ops[1].cg_iterations}")
    check(rel <= 1e-10, "[18] explicit step: CUDA within 1e-10 of the CPU")
    check(ops[0].cg_iterations == ops[1].cg_iterations,
          "[18] explicit step: equal CG iterations")
    print(f"[18] phase {time.perf_counter() - t0:.1f} s")
    return out


def diffusion_bound(ne, n1, nq1, dtype, qdtype=None):
    """Least bytes of one fused diffusion apply (e read, y written, the six
    qdata planes of ``qdtype``, by default ``dtype``, read, each once), its
    operations (the sum-factorized chain: six 1D passes and the packed-D
    product) and the bound in ms, the larger of bytes over the HBM rate and
    operations over the type's peak."""
    nd, nq = n1 ** 3, nq1 ** 3
    s1, s2 = n1 * n1 * nq1, n1 * nq1 * nq1
    elsize = torch.tensor([], dtype=dtype).element_size()
    qsize = torch.tensor([], dtype=qdtype or dtype).element_size()
    nbytes = ne * (2 * nd * elsize + 6 * nq * qsize)
    flops = ne * 2 * (2 * s1 * n1 + 3 * s2 * n1 + 3 * nq * n1 + 3 * s2 * nq1
                      + 3 * s1 * nq1 + 2 * nd * nq1) + ne * nq * 15
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[dtype] * 1e3
    return nbytes, flops, max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                                else "operations")


def cublas_composition(db, qd, e):
    """Gᵀ(D·(G e)) as three steps of library calls, a yardstick only: one
    (ne, nd) @ (nd, 3nq) matmul on the stacked Kronecker gradient matrix,
    the packed-D product, one (ne, 3nq) @ (3nq, nd) matmul."""
    from cardiac_ablation_ecm2_tpu_torch.ops import lanemajor

    S = torch.cat(lanemajor.lane_basis(db).G, dim=0)      # (3nq, nd)
    ST = S.T.contiguous()
    nq = S.shape[0] // 3

    def run():
        t = e @ ST
        gx, gy, gz = t[:, :nq], t[:, nq:2 * nq], t[:, 2 * nq:]
        D = torch.cat([qd[0] * gx + qd[3] * gy + qd[4] * gz,
                       qd[3] * gx + qd[1] * gy + qd[5] * gz,
                       qd[4] * gx + qd[5] * gy + qd[2] * gz], dim=1)
        return D @ S

    return run


def check_diffusion(label, db, qd, e, timed=False, tag="[8]"):
    """The fused kernel against its plain version: within 1e-5·max|y| in
    float32, 1e-12·max|y| in float64.  Returns (max abs error, and with
    ``timed`` the kernel, plain, composition and bound times)."""
    from cardiac_ablation_ecm2_tpu_torch.ops import fused_diffusion as fd

    tol = 1e-5 if e.dtype == torch.float32 else 1e-12
    y = fd.diffusion_apply(db, qd, e)
    ref = fd.diffusion_apply_plain(db, qd, e)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    rel = err / float(ref.abs().max())
    msg = (f"{tag} {label}: ne={e.shape[0]} n1={db.n1d} nq1={db.nq1d} "
           f"{str(e.dtype)[6:]} (qdata {str(qd.dtype)[6:]}), kernel vs plain "
           f"{rel:.2e} of max|y|")
    check(rel <= tol, f"{label}: fused diffusion within {tol:g} of plain")
    if not timed:
        print(msg)
        return err, None
    ms = time_ms(lambda: fd.diffusion_apply(db, qd, e))
    plain_ms = time_ms(lambda: fd.diffusion_apply_plain(db, qd, e))
    comp = cublas_composition(db, qd, e)
    comp_err = float((comp() - ref).abs().max()) / float(ref.abs().max())
    lib_ms = time_ms(comp)
    nbytes, flops, bound, by = diffusion_bound(e.shape[0], db.n1d, db.nq1d,
                                               e.dtype, qd.dtype)
    print(msg + f"; kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s, "
          f"{flops / ms / 1e6:.1f} GFLOP/s), plain {plain_ms:.4f} ms, cuBLAS "
          f"composition {lib_ms:.4f} ms (rel diff {comp_err:.1e}); "
          f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP; bound "
          f"{bound:.4f} ms ({by})")
    return err, dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bound, bound_by=by)


def phase_diffusion_kernel(dev):
    """[8] before the lattice paths: random inputs at every shape the kernel
    takes, a shape it does not, and pallas_profile.py's 48³ shape."""
    from cardiac_ablation_ecm2_tpu_torch.fem.basis import make_dof_to_quad
    from cardiac_ablation_ecm2_tpu_torch.fem.cartesian import CartesianFESpace
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import element_node_coords
    from cardiac_ablation_ecm2_tpu_torch.fem.geom_factors import (
        compute_geometric_factors,
    )
    from cardiac_ablation_ecm2_tpu_torch.fem.geometry import Geometry
    from cardiac_ablation_ecm2_tpu_torch.fem.quadinterp import device_basis
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.ops import diffusion
    from cardiac_ablation_ecm2_tpu_torch.ops import fused_diffusion as fd

    rng = np.random.default_rng(8)
    ne = 4_099
    for n1, nq1 in fd.SHAPES:
        for dtype in (torch.float32, torch.float64):
            db = device_basis(make_dof_to_quad(Geometry.CUBE, n1 - 1, nq1),
                              dtype, dev)
            e = torch.as_tensor(rng.standard_normal((ne, n1 ** 3)),
                                dtype=dtype, device=dev)
            qd = torch.as_tensor(rng.standard_normal((6, ne, nq1 ** 3)),
                                 dtype=dtype, device=dev)
            check_diffusion("random", db, qd, e)
    db = device_basis(make_dof_to_quad(Geometry.CUBE, 5, 6), torch.float32, dev)
    try:
        fd.diffusion_apply(db, torch.zeros(6, 3, 216, device=dev),
                           torch.zeros(3, 216, device=dev))
    except ValueError as ex:
        print(f"[8] unsupported shape raises: {ex}")
    else:
        check(False, "fused diffusion raises on order 5")
    mesh = make_cartesian_3d(48, 48, 48)
    fes = CartesianFESpace(mesh, 2, (48, 48, 48))
    d2q = fes.dof_to_quad(4)                    # quad_extra 1: nq1 = 4
    gf = compute_geometric_factors(element_node_coords(mesh, 2), d2q,
                                   torch.float32, dev)
    qd = diffusion.setup_packed(gf)
    db = device_basis(d2q, torch.float32, dev)
    e = torch.as_tensor(rng.random((mesh.ne, 27)), dtype=torch.float32,
                        device=dev)
    check_diffusion("48^3 unit lattice, pallas_profile.py's shape", db, qd, e,
                    timed=True)


def check_operator_diffusion(tag, label, op, qd=None, timed=False):
    """The fused kernel against its plain version on a main path's own
    basis and diffusion qdata (``qd``, by default the operator's ``K_qd``:
    the residual's shapes) with a random E-vector, in float32 and float64;
    run after that path's launch counts were read.  Returns the max abs
    error and, with ``timed``, the float32 numbers of the kernels line."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import basis_for

    qd = op.K_qd if qd is None else qd
    gen = torch.Generator(device=op.device).manual_seed(8)
    e = torch.randn(op.fes.mesh.ne, op.db.n1d ** 3, generator=gen,
                    device=op.device)
    err32, numbers = check_diffusion(label, op.db, qd, e, timed=timed,
                                     tag=tag)
    db64 = basis_for(op.fes, torch.float64, op.device)
    err64, _ = check_diffusion(label, db64, qd.double(), e.double(), tag=tag)
    return max(err32, err64), numbers


def separable_deviation(op):
    """max |q/W − mean_q(q/W)| / max |mean_q(q/W)| of the operator's
    diffusion qdata: what the affine detector holds to rtol 1e-5."""
    r = op._qkT / op.db.W[:, None]
    d = r.mean(dim=-2, keepdim=True)
    return float((r - d).abs().max() / d.abs().max())


def phase_lattice48(dev):
    """[9] bench.py's default: setup and three float32 steps on the 48³
    lattice; returns the launch counts of this run and its θ."""
    from cardiac_ablation_ecm2_tpu_torch.fem.cartesian import CartesianFESpace
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.models import bioheat

    t0 = time.perf_counter()
    mesh = make_cartesian_3d(48, 48, 48, L, L, L)
    t1 = time.perf_counter()
    fes = CartesianFESpace(mesh, 2, (48, 48, 48), (L, L, L))
    t2 = time.perf_counter()
    check((mesh.ne, fes.ndof) == (110_592, 912_673), "48^3 lattice size")
    start_main_path()
    t3 = time.perf_counter()
    op = bioheat.BioheatOperator(fes, q_met=lattice_source, dtype="float32",
                                 device=dev, collapse_uniform_qdata=True,
                                 **SETTINGS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t3
    branch = (op.collapsed, op._aff is not None)
    T, s_step, host_step = timed_steps(op)
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    dev_txt = ("-" if op.collapsed or op._aff is not None
               else f"{separable_deviation(op):.4e}")
    print(f"[9] 48^3 lattice order 2 f32: {mesh.ne} hexes, {fes.ndof} dofs; "
          f"branch collapsed {branch[0]}, affine {branch[1]} (JAX float32: "
          f"{JAX_LATTICE48_F32_BRANCH}); diffusion qdata separable deviation "
          f"{dev_txt}")
    print(f"[9] host setup: mesh {t1 - t0:.2f} s, CartesianFESpace "
          f"{t2 - t1:.2f} s; device setup (operator) {setup_s:.2f} s")
    print(f"[9] s/step {s_step:.6f} (CUDA events; host clock {host_step:.6f}), "
          f"{fes.ndof / s_step:.1f} DOF/s; MFEM CPU {MFEM_LATTICE48_S_STEP} "
          f"s/step")
    _, per_solve, rel = report_run("[9]", op, T, JAX_LATTICE48["theta_max"],
                                   "the JAX package (f64, CPU)")
    print(f"[9] fused diffusion launches {launches['fused_diffusion']}, "
          f"restriction kernel launches "
          f"{sum(launches[k] for k in RESTRICTION_KERNELS)}, max_memory_allocated "
          f"{peak / 2**30:.3f} GiB")
    check(branch == JAX_LATTICE48_F32_BRANCH, "48^3 takes JAX's float32 branch")
    check(rel <= 2e-3, "48^3 theta_max within 2e-3 of the JAX package's")
    check(abs(per_solve - JAX_LATTICE48["cg_per_solve"]) <= 1,
          "48^3 CG iterations per solve within 1 of JAX's")
    check(launches["fused_diffusion"] > 0
          and not any(launches[k] for k in RESTRICTION_KERNELS),
          "the 48^3 residual launched the fused diffusion kernel, and no "
          "gather ran (structured restriction)")
    check_operator_diffusion("[9]", "48^3 lattice K_qd", op)
    return launches, T


def masked_space(n):
    """The masked cardiac-hex lattice n: mesh, CartesianFESpace, the
    operator's mask arguments and the active-dof count, with host seconds."""
    from cardiac_ablation_ecm2_tpu_torch.fem.cartesian import CartesianFESpace
    from cardiac_ablation_ecm2_tpu_torch.fem.masked_lattice import (
        masked_lattice_active_count,
        masked_lattice_essential,
    )
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_lattice

    t0 = time.perf_counter()
    mesh, keep, ns = make_cardiac_hex_lattice(n, lengths=(L, L, L / 2),
                                              electrode_radius=0.004)
    t1 = time.perf_counter()
    fes = CartesianFESpace(mesh, 2, ns, (L, L, L / 2))
    kw = dict(ess_bdr=None, elem_mask=keep.astype(np.float32),
              ess_dofs=masked_lattice_essential(ns, 2, keep))
    active = masked_lattice_active_count(ns, 2, keep)
    return mesh, fes, kw, active, (t1 - t0, time.perf_counter() - t1)


def phase_masked(dev):
    """[10] ``BENCH_MESH=cardiac-hex BENCH_STRUCTURED=1``: n=10 in float64
    on CUDA against the CPU, then setup and three float32 steps at n=126;
    returns the operator and the launch counts of the n=126 run."""
    from cardiac_ablation_ecm2_tpu_torch.models import bioheat

    _, fes, kw, _, _ = masked_space(10)
    small_cuda_vs_cpu("[10] masked lattice n=10", fes, dev, **kw)
    mesh, fes, kw, active, host_s = masked_space(126)
    check((mesh.ne, fes.ndof, active) == MASKED126,
          "masked n=126: 1,000,188 hexes, 8,129,143 lattice dofs, 8,092,657 "
          "active (MFEM's ndof)")
    start_main_path()
    t0 = time.perf_counter()
    op = bioheat.BioheatOperator(fes, q_met=source, dtype="float32", device=dev,
                                 **dict(SETTINGS, **kw))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(op._lane is not None and op._aff is None,
          "the warped lattice takes the per-quadrature-point lane-major path")
    T, s_step, host_step = timed_steps(op)
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"[10] masked cardiac-hex lattice n=126 order 2 f32: {mesh.ne} "
          f"lattice hexes ({int(kw['elem_mask'].sum())} kept), {fes.ndof} "
          f"lattice dofs, {active} active, {len(kw['ess_dofs'])} pinned")
    print(f"[10] host setup: lattice {host_s[0]:.2f} s, CartesianFESpace and "
          f"masks {host_s[1]:.2f} s; device setup (operator) {setup_s:.2f} s")
    print(f"[10] s/step {s_step:.6f} (CUDA events; host clock "
          f"{host_step:.6f}), {active / s_step:.1f} DOF/s on the active dofs; "
          f"MFEM CPU 145.408 s/step (carved mesh)")
    _, per_solve, rel = report_run("[10]", op, T, MFEM_THETA_MAX)
    print(f"[10] fused diffusion launches {launches['fused_diffusion']} "
          f"(3 per step and 1 in setup), restriction kernel launches "
          f"{sum(launches[k] for k in RESTRICTION_KERNELS)}, max_memory_allocated "
          f"{peak / 2**30:.3f} GiB")
    check(rel <= 2e-3, "masked theta_max within 2e-3 of MFEM")
    check(abs(per_solve - MFEM_CG_ITERS) <= 2,
          "masked CG iterations within 16 ± 2")
    check(launches["fused_diffusion"] > 0,
          "the masked main path launched the fused diffusion kernel")
    check(not any(launches[k] for k in RESTRICTION_KERNELS),
          "the masked main path launched no gather (structured restriction)")
    return op, launches


def probe_bytes(p):
    """Least bytes of one probe call: the indices and the output once, and
    each source element the indices touch once (a gather does no
    arithmetic, so bytes bound it)."""
    data, idx = p.args
    if p.kernel == "take_rows":
        touched = torch.unique(idx).numel() * data.shape[1]
        nout = idx.numel() * data.shape[1]
    elif p.kernel == "take_along_rows":
        cols = torch.arange(data.shape[1], device=idx.device)
        touched = torch.unique(idx.long() * data.shape[1] + cols).numel()
        nout = idx.numel()
    elif p.kernel == "take_along_lanes":
        rows = torch.arange(data.shape[0], device=idx.device)[:, None]
        touched = torch.unique(rows * data.shape[1] + idx.long()).numel()
        nout = idx.numel()
    else:                                           # take_flat
        touched, nout = torch.unique(idx).numel(), idx.numel()
    return idx.numel() * 4 + (touched + nout) * data.element_size()


def check_probe(p, args, ref, label):
    """The probe's kernel against its plain version and its numpy
    reference, bitwise; returns the largest |kernel − plain|."""
    out = p.fn(*args)
    plain = p.plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(bits(out), bits(plain)),
          f"{label}: kernel bitwise equal to plain")
    check(np.array_equal(out.cpu().numpy().view(np.uint8),
                         np.ascontiguousarray(ref).view(np.uint8)),
          f"{label}: kernel bitwise equal to the probe's numpy reference")
    return float((out - plain).abs().max())


#: a shape for every branch of the two redesigned probe kernels that the
#: probes' own shapes do not reach (csrc/gather_probes.cu): take_along_rows
#: (R, C, B) with strips of w = 4 floats (R in (7,264, 14,528]; doubles
#: w = 2) and the direct branch for R above 58,112 floats at B >= 2R (u1
#: takes the direct branch for B < 2R); take_along_lanes (B, W, K) with
#: rows wider than the 48 KB staged tile
PROBE_BRANCHES = (("take_along_rows", "strip w=4 (float32), w=2 (float64)",
                   (10_000, 128, 20_480)),
                  ("take_along_rows", "direct, R > 58,112", (60_000, 16, 120_000)),
                  ("take_along_lanes", "direct, row wider than 48 KB",
                   (64, 16_384, 128)))


def check_probe_branches(dev):
    """[11] Each shape of ``PROBE_BRANCHES`` through the public wrapper,
    float32 and float64, bitwise equal to the plain version and to numpy's
    ``take_along_axis``."""
    from cardiac_ablation_ecm2_tpu_torch.benchmarks.gather_micro import Probe
    from cardiac_ablation_ecm2_tpu_torch.ops import gather_probes as gp

    rng = np.random.default_rng(11)
    for kind, branch, shape in PROBE_BRANCHES:
        axis = 0 if kind == "take_along_rows" else 1
        if axis == 0:
            R, C, B = shape
            data_np, idx_np = rng.standard_normal((R, C)), rng.integers(0, R, (B, C))
        else:
            B, W, K = shape
            data_np, idx_np = rng.standard_normal((B, W)), rng.integers(0, W, (B, K))
        idx = torch.as_tensor(idx_np, dtype=torch.int32, device=dev)
        p = Probe(kind, getattr(gp, kind), (), plain=getattr(gp, kind + "_plain"))
        for dt, ndt in ((torch.float32, np.float32), (torch.float64, np.float64)):
            d = data_np.astype(ndt)
            ref = np.take_along_axis(d, idx_np, axis=axis)
            check_probe(p, (torch.as_tensor(d, device=dev), idx), ref,
                        f"{kind} {branch} {shape} {dt}")
        print(f"[11] {kind} {branch}: {tuple(data_np.shape)}<-{tuple(idx_np.shape)} "
              f"bitwise equal to plain and to numpy (float32, float64)")


def phase_probes(dev):
    """[11] The probes' main path, then every probe kernel at every probe
    shape and at the branch shapes; returns the kernels line's numbers of
    the three probe kernels (with U1's and U2's under their probe names)
    and the main path's launch counts."""
    from cardiac_ablation_ecm2_tpu_torch.benchmarks import gather_micro

    start_main_path()
    results = gather_micro.run(48, 2, dev)
    launches = main_path_launches()
    print(f"[11] probe main path (gather_micro.run, n=48 order 2): launches "
          + ", ".join(f"{k} {launches[k]}" for k in PROBE_KERNELS
                      + ("take_flat", "gather_sum")))
    check(all(r["err"] in (None, 0.0) for r in results),
          "every probe output equals its numpy reference")
    for k in PROBE_KERNELS + ("take_flat", "gather_sum"):
        check(launches[k] > 0, f"the probe main path launched {k}")
    floor = gather_micro.cuda_ms(lambda: torch.cuda._sleep(0))
    print(f"[11] launch floor: an empty kernel (torch.cuda._sleep(0)), device "
          f"time per call, 20 queued: {floor:.4f} ms")
    numbers = {}
    for p in gather_micro.probes(48, 2, dev):
        if p.kernel is None:
            continue
        label = f"{p.name} {tuple(p.args[0].shape)}<-{tuple(p.args[1].shape)}"
        err = check_probe(p, p.args, p.ref, label)
        args64 = (p.args[0].double(), p.args[1])
        err = max(err, check_probe(p, args64, p.ref.astype(np.float64),
                                   label + " float64"))
        ms = gather_micro.cuda_ms(lambda: p.fn(*p.args))
        plain_ms = gather_micro.cuda_ms(lambda: p.plain(*p.args))
        lib_ms = gather_micro.cuda_ms(p.library)
        one_ms = time_ms(lambda: p.fn(*p.args))
        nbytes = probe_bytes(p)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"[11] {label}: bitwise equal to plain and to numpy (float32, "
              f"float64); device time per call, 20 queued: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s; {ms / floor:.2f}x the launch "
              f"floor), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms; one "
              f"call with its launch {one_ms:.4f} ms; {nbytes / 1e6:.2f} MB "
              f"least, bound {bound:.4f} ms (bytes)")
        timed = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                     bound_by="bytes")
        if p.kernel in PROBE_LINE:
            if p.name.startswith(PROBE_LINE[p.kernel]):
                numbers[p.kernel] = dict(numbers.get(p.kernel, {}), **timed)
            elif p.kernel in ("take_along_rows", "take_along_lanes"):
                # U1 and U2 (each width): their probe's own numbers
                numbers.setdefault(p.kernel, {}).setdefault("probes", {})[
                    p.name] = dict(timed, launch_floor_ms=floor)
            numbers.setdefault(p.kernel + "_err", 0.0)
            numbers[p.kernel + "_err"] = max(numbers[p.kernel + "_err"], err)
    check_probe_branches(dev)
    for k in PROBE_KERNELS:
        numbers[k]["max_abs_err"] = numbers.pop(k + "_err")
        numbers[k]["launches"] = launches[k]
    return numbers


def rel_diff(a, b):
    return float((a.cpu() - b).abs().max() / b.abs().max())


def phase_ablation_small(dev, mesh, tag="[12a]", what="cardiac hex n=16"):
    """[12a] The coupled app on a small mesh (cardiac hex n=16; [17]: tet
    n=12) in float64, CUDA against CPU tensors, with σ(T) re-solved every
    step and with k(T)."""
    from cardiac_ablation_ecm2_tpu_torch.models.ablation import AblationSim

    for label, extra in (("sigma(T)", dict(sigma_T=sigma_of_T, resolve_every=1)),
                         ("k(T)", dict(k_T=k_of_T))):
        sims = [AblationSim(mesh=mesh, dtype="float64", device=d, **ABLATION,
                            **extra) for d in (dev, "cpu")]
        # the coupled run starts after one plain step: at the uniform T_a, σ(T)
        # is a constant, Φ does not change, and the first re-solve would
        # start at its solution and iterate on round-off, whose CG count
        # differs between summation orders
        outs = []
        for s in sims:
            T, om, t = s.step(*s.initial_state(), 0.0, ABLATION_DT)
            outs.append(s.run(t + 2 * ABLATION_DT, ABLATION_DT, T, om, t0=t))
        fields = {"phi": (sims[0].rf.phi, sims[1].rf.phi),
                  "SAR": (sims[0].rf.sar_q, sims[1].rf.sar_q),
                  "T": (outs[0][0], outs[1][0]), "omega": (outs[0][1], outs[1][1])}
        counts = [(s.rf.iterations, s.op.cg_iterations) for s in sims]
        if "resolve_every" in extra:
            fields["phi re-solved"] = (sims[0].phi, sims[1].phi)
            fields["SAR re-solved"] = (sims[0].sar_q, sims[1].sar_q)
            counts = [c + (s.rf_op.cg_iterations,) for c, s in zip(counts, sims)]
        rels = {k: rel_diff(*v) for k, v in fields.items()}
        print(f"{tag} ablation {label}, {what} f64, {sims[0].fes.ndof} "
              f"dofs: CUDA vs CPU rel diff "
              + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
              + f"; CG (RF solve, stages, re-solves) CUDA {counts[0]} CPU {counts[1]}")
        check(max(rels.values()) <= 1e-10,
              f"{tag} {label}: CUDA within 1e-10 of the CPU")
        check(counts[0] == counts[1], f"{tag} {label}: equal CG counts")


def rf_system_check(sim):
    """The RF solve's true relative residual ‖B − A_c Φ‖/‖B‖ of the
    constrained system it solved, and Φᵀ A Φ of the unconstrained
    partially assembled operator (float64 sums)."""
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
    from cardiac_ablation_ecm2_tpu_torch.ops.operators import form_linear_system

    fes, phi = sim.fes, sim.rf.phi
    A = BilinearForm(fes, phi.device).add_domain_integrator(
        "diffusion", sim.sigma).assemble(sim.dtype).operator()
    ess_e = fes.essential_dofs(sim.electrode_bdr)
    ess = np.unique(np.concatenate([ess_e, fes.essential_dofs(sim.ground_bdr)]))
    x_bc = torch.zeros_like(phi)
    x_bc[torch.as_tensor(ess_e, dtype=torch.int64, device=phi.device)] = sim.voltage
    Ac, B = form_linear_system(A, ess, x_bc, torch.zeros_like(phi))
    res = float((B - Ac.mult(phi)).double().norm() / B.double().norm())
    return res, float(torch.dot(phi.double(), A.mult(phi).double()))


def phase_ablation_main(dev, mesh, mesh_s, tag="[12b]",
                        what="cardiac hex n=126", mesh_of="the [4] mesh",
                        kernels=RESTRICTION_KERNELS + ("fused_diffusion",)):
    """[12b] The coupled app at full width on the [4] mesh ([17]: on [7]'s
    tet mesh); ``kernels`` must have launched.  Returns the launch counts
    of this run."""
    from cardiac_ablation_ecm2_tpu_torch.models import rf_laplace
    from cardiac_ablation_ecm2_tpu_torch.models.ablation import AblationSim

    start_main_path()
    sim = AblationSim(mesh=mesh, dtype="float32", device=dev, rel_tol=1e-5,
                      sigma_T=sigma_of_T, resolve_every=1, **ABLATION)
    sec, fes, rf = sim.setup_seconds, sim.fes, sim.rf
    T, om = sim.initial_state()
    oms = [om]
    T, om, t = sim.step(T, om, 0.0, ABLATION_DT)          # warm-up step
    oms.append(om)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(2):
        T, om, t = sim.step(T, om, t, ABLATION_DT)
        oms.append(om)
    b.record()
    torch.cuda.synchronize()
    s_step = a.elapsed_time(b) / 1e3 / 2
    t0 = time.perf_counter()
    phi, sar_q, info = sim.rf_op.resolve(sim.rf_op.sigma_of_T_q(sim.sigma_T, T),
                                         rf.phi)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    T, om, t = sim.step_coupled(T, om, t, ABLATION_DT, sar_q)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    oms.append(om)
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    res, phi_a_phi = rf_system_check(sim)
    P = float(rf_laplace.total_power(fes, rf.sar_q))
    T_max, om_max = float(T.max()), float(om.max())
    print(f"{tag} coupled RF ablation, {what} order 2 f32: {mesh.ne} "
          f"elements, {fes.ndof} dofs; electrode 2, ground 3, body 1, 30 V")
    print(f"{tag} setup: mesh {mesh_s:.2f} s ({mesh_of}), space "
          f"{sec['space']:.2f} s, RF solve {sec['rf_solve']:.2f} s ({rf.iterations} "
          f"CG iterations, converged {rf.converged}, true relative residual "
          f"{res:.3e}), operators {sec['operator']:.2f} s")
    print(f"{tag} s/step {s_step:.6f} (CUDA events, 2 steps after 1 warm-up; stage "
          f"CG {sim.op.cg_iterations}); coupled step: sigma(T) re-solve "
          f"{t1 - t0:.3f} s ({info.iterations} CG iterations, converged "
          f"{info.converged}) + step {t2 - t1:.3f} s")
    print(f"{tag} T_max {T_max:.6f} C, max omega {om_max:.6e}, lesion volume "
          f"{sim.lesion_volume(om):.6e} m^3, P = total_power {P:.6f} W, "
          f"Phi^T A Phi {phi_a_phi:.6f} W, max_memory_allocated "
          f"{peak / 2**30:.3f} GiB")
    print(f"{tag} launches: " + ", ".join(
        f"{k} {launches[k]}" for k in kernels)
          + "; no MFEM reference exists for the coupled app, so none is held")
    check(res <= 1e-5, f"{tag} RF true relative residual <= 1e-5")
    check(abs(P - phi_a_phi) <= 1e-4 * abs(phi_a_phi),
          f"{tag} P equals Phi^T A Phi within 1e-4")
    check(bool(torch.isfinite(T).all()) and T_max > sim.T_a,
          f"{tag} T finite and T_max > T_a")
    check(all(bool(torch.isfinite(o).all()) and bool((o >= 0).all()) for o in oms),
          f"{tag} omega finite and >= 0")
    check(all(bool((b >= a).all()) for a, b in zip(oms, oms[1:])),
          f"{tag} omega non-decreasing")
    for name in kernels:
        check(launches[name] > 0, f"{tag} the coupled path launched {name}")
    return launches


# the Poisson problem of [13]: the RF solve's conductivity and boundaries
# (electrode 2, ground 3) with a unit source
POISSON = dict(order=2, rhs=1.0, kappa=0.54, ess_bdr=[2, 3], rel_tol=1e-5,
               max_iter=5000)
POISSON_PRECONDITIONERS = ("jacobi", "chebyshev", "lor")
# ex16's parameters ([14]; examples/ex16_heat.py and the operator's defaults)
EX16 = dict(kappa=0.5, alpha=0.01, rel_tol=1e-10, max_iter=500)
EX16_DT = 0.01


def poisson_residual(fes, dev):
    """``u ↦ ‖B − A_c u‖/‖B‖``, the true relative residual of [13]'s
    constrained system, assembled and applied in float64 (a float32
    evaluation adds rounding of its own), rebuilt from the space's cached
    factors."""
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf
    from cardiac_ablation_ecm2_tpu_torch.ops.operators import form_linear_system

    A = BilinearForm(fes, dev).add_domain_integrator(
        "diffusion", POISSON["kappa"]).assemble("float64").operator()
    b = domain_lf(fes, POISSON["rhs"], dtype="float64", device=dev)
    Ac, B = form_linear_system(A, fes.essential_dofs(POISSON["ess_bdr"]),
                               torch.zeros_like(b), b)
    return lambda u: float((B - Ac.mult(u.double())).norm() / B.norm())


def phase_poisson(kc, dev, mesh, fes):
    """[13] Poisson on the [4] mesh in float32 with each of the JAX
    package's device preconditioners; after the ``"lor"`` solve's launches
    are read, the kernels of its two restrictions (the LOR sub-hexes', the
    order-1 space's) are held to their plain versions.  Returns the launch
    counts of the three solves together, and for [23] the space, the
    float64 reference, the true-residual function and the counts.  ``fes``
    is [4]'s order-2 space of ``mesh`` (its host build is [4]'s)."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import restriction_for
    from cardiac_ablation_ecm2_tpu_torch.models import poisson

    t0 = time.perf_counter()
    restriction_for(fes, dev)
    torch.cuda.synchronize()
    restr_s = time.perf_counter() - t0
    print(f"[13] Poisson -div(0.54 grad u) = 1, u = 0 on attributes 2, 3, the [4] "
          f"cardiac hex mesh, order 2 f32: {mesh.ne} hexes, {fes.ndof} dofs ([4]'s "
          f"space); restriction (shared by the three solves) {restr_s:.2f} s")
    total = dict.fromkeys(RESTRICTION_KERNELS + ("fused_diffusion",), 0)
    runs = {}
    for pre in POISSON_PRECONDITIONERS:
        start_main_path()
        r = poisson.solve(mesh, preconditioner=pre, dtype="float32", device=dev,
                          fes=fes, **POISSON)
        launches = main_path_launches()
        peak = torch.cuda.max_memory_allocated()
        for k in total:
            total[k] += launches[k]
        sec = r.setup_seconds
        print(f"[13] {pre}: setup operator {sec['operator']:.3f} s + "
              f"preconditioner {sec['preconditioner']:.3f} s, solve "
              f"{r.solve_seconds:.3f} s ({r.solve_seconds / max(r.iterations, 1) * 1e3:.3f}"
              f" ms an iteration), {r.iterations} CG iterations, converged "
              f"{r.converged}, max_memory_allocated {peak / 2**30:.3f} GiB; "
              f"launches " + ", ".join(f"{k} {launches[k]}" for k in total))
        mg = r.multigrid
        if mg is not None:
            nsub = mg.levels[1].A.__self__.A_e.shape[0]
            print(f"[13] lor: nsub {nsub}, {mg.cycles} V-cycles ("
                  f"{r.solve_seconds / mg.cycles * 1e3:.3f} ms each with its CG "
                  f"iteration, {mg.coarse_iters} coarse CG iterations at most); "
                  f"setup split "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in mg.setup_seconds.items()))
            check(nsub == mesh.ne * 8, "[13] one LOR sub-hex per lattice cell")
            check(mg.cycles == r.iterations + 1, "[13] one V-cycle per PCG step")
            fine = mg.levels[1]
            check_restriction(kc, fine.A.__self__.restr, "LOR sub-hex ", "[13]",
                              seed=13)
            check_restriction(kc, fine.prolongate.__self__.Rc, "order-1 ",
                              "[13]", seed=14)
        check(r.converged, f"[13] {pre} converged")
        check(r.u.shape == (fes.ndof,) and bool(torch.isfinite(r.u).all()),
              f"[13] {pre}: finite u of the expected shape")
        runs[pre] = (r.iterations, r.u)
        del r, mg
    # the float64 reference: Jacobi-PCG at rel_tol 1e-10 (not Chebyshev,
    # whose float64 run stops early at this size: models/poisson.solve)
    start_main_path()
    ref = poisson.solve(mesh, preconditioner="jacobi", dtype="float64",
                        device=dev, fes=fes, **dict(POISSON, rel_tol=1e-10,
                                                    max_iter=10000))
    u_ref = ref.u
    check(ref.converged, "[13] the float64 reference converged")
    residual = poisson_residual(fes, dev)
    res = {k: residual(v[1]) for k, v in runs.items()}
    res_ref, floor = residual(u_ref), residual(u_ref.float())
    print(f"[13] float64 reference (jacobi, rel_tol 1e-10): {ref.iterations} CG "
          f"iterations, solve {ref.solve_seconds:.3f} s, true relative residual "
          f"{res_ref:.3e}; rounding it to float32 alone leaves {floor:.3e}")
    del ref
    its = {k: v[0] for k, v in runs.items()}
    scale = float(u_ref.abs().max())
    errs = {k: float((v[1].double() - u_ref).abs().max()) / scale
            for k, v in runs.items()}
    diffs = {k: float((v[1] - runs["jacobi"][1]).abs().max()) / scale
             for k, v in runs.items()}
    print(f"[13] iterations {its}; true relative residual (float64 evaluation) "
          + ", ".join(f"{k} {v:.3e}" for k, v in res.items())
          + f"; max|u - u_ref|/max|u_ref| " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + f"; max|u - u_jacobi|/max|u| " + ", ".join(
              f"{k} {v:.3e}" for k, v in diffs.items())
          + f"; max|u| {scale:.6e}; launches of the three float32 solves "
          + ", ".join(f"{k} {v}" for k, v in total.items()))
    check(res_ref <= 1e-6, "[13] the float64 reference's true residual <= 1e-6")
    check(max(errs.values()) <= 1e-4,
          "[13] each float32 solution within 1e-4 max|u| of the float64 one")
    check(its["lor"] < its["jacobi"] / 2, "[13] lor iterations < jacobi / 2")
    check(its["chebyshev"] <= its["jacobi"], "[13] chebyshev iterations <= jacobi")
    check(max(diffs.values()) <= 1e-3, "[13] the three solutions within 1e-3 max|u|")
    for name in RESTRICTION_KERNELS:
        check(total[name] > 0, f"[13] the Poisson solves launched {name}")
    return total, (fes, u_ref, residual, its)


def phase_heat(kc, dev, n=100):
    """[14] ex16 nonlinear heat: the n³ unit cube (80³, cut from 100³),
    order 2, float32, SDIRK33; after its launches are read, the
    restriction's kernels and the fused diffusion apply on the last
    state's κ(u) qdata are held to their plain versions.  Returns the
    launch counts of its run."""
    from cardiac_ablation_ecm2_tpu_torch.fem import gridfunction as gf
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg import ode
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.models import heat
    from cardiac_ablation_ecm2_tpu_torch.ops import diffusion

    t0 = time.perf_counter()
    mesh = make_cartesian_3d(n, n, n)
    t1 = time.perf_counter()
    fes = FESpace(mesh, 2)
    t2 = time.perf_counter()
    check((mesh.ne, fes.ndof) == (n ** 3, (2 * n + 1) ** 3), "[14] mesh size")
    start_main_path()
    t3 = time.perf_counter()
    op = heat.ConductionOperator(fes, dtype="float32", device=dev, **EX16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t3

    def u0(x):
        return torch.exp(-20.0 * ((x - 0.5) ** 2).sum(-1))

    u = gf.project(fes, u0, "float32", dev)
    norms = [float(gf.l2_norm(fes, u.double(), dtype="float64"))]
    step = heat.make_stepper(op, ode.select("sdirk33"))
    u, t = step(u, 0.0, EX16_DT)                          # warm-up step
    norms.append(float(gf.l2_norm(fes, u.double(), dtype="float64")))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(2):
        a.record()
        u, t = step(u, t, EX16_DT)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        norms.append(float(gf.l2_norm(fes, u.double(), dtype="float64")))
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    s_step = sum(ms) / 2 / 1e3
    print(f"[14] ex16 heat, {n}^3 unit cube order 2 f32: {mesh.ne} hexes, "
          f"{fes.ndof} dofs; kappa 0.5 + 0.01 u, dt {EX16_DT}, SDIRK33, rel_tol "
          f"{EX16['rel_tol']}")
    print(f"[14] host setup: mesh {t1 - t0:.2f} s, FESpace {t2 - t1:.2f} s; "
          f"operator {setup_s:.2f} s")
    print(f"[14] s/step {s_step:.6f} (CUDA events, 2 steps after 1 warm-up: "
          + ", ".join(f"{m / 1e3:.6f}" for m in ms) + f"); stage CG "
          f"{op.cg_iterations}; ||u||_L2 after each step "
          + ", ".join(f"{v:.9e}" for v in norms)
          + f"; max_memory_allocated {peak / 2**30:.3f} GiB; launches "
          + ", ".join(f"{k} {launches[k]}" for k in
                      RESTRICTION_KERNELS + ("fused_diffusion",)))
    check(u.shape == (fes.ndof,) and bool(torch.isfinite(u).all()),
          "[14] finite u of the expected shape")
    check(max(op.cg_iterations) < EX16["max_iter"],
          "[14] every stage solve converged before max_iter")
    check(all(b <= a for a, b in zip(norms, norms[1:])),
          "[14] ||u||_L2 non-increasing")
    for name in ("fused_diffusion", "gather_sum", "segment_sum"):
        check(launches[name] > 0, f"[14] the heat path launched {name}")
    # the path's kernels against their plain versions at its own shapes:
    # the restriction, and the diffusion apply on κ(u)'s qdata
    check_restriction(kc, op.restr, f"ex16 {n}^3 ", "[14]", seed=15)
    qd = diffusion.setup_packed(op.gf, op._kappa_q(u))
    check_operator_diffusion("[14]", f"ex16 {n}^3 kappa(u) qdata", op, qd=qd)
    return launches


def phase_entry(dev):
    """[15] The torch ``entry()`` on the card and on the CPU, float64 and
    float32 (the configured dtype): θ = T − 37 within 1e-10·max|θ| in
    float64, T within 1e-6·max|T| (ten float32 ulps at 37) in float32."""
    from cardiac_ablation_ecm2_tpu_torch.entry import entry
    from cardiac_ablation_ecm2_tpu_torch.utils.config import config, configure

    old = config.dtype
    try:
        for dtype, tol in (("float64", 1e-10), ("float32", 1e-6)):
            configure(dtype=dtype)
            outs = []
            for d in (dev, "cpu"):
                fn, args = entry(device=d)
                T, t = fn(*args)
                check(T.shape == args[0].shape and bool(torch.isfinite(T).all())
                      and float(T.max()) > 37.0 and float(t) == 0.5,
                      f"[15] entry {dtype} on {d}: finite T above 37 C, t = 0.5")
                outs.append(T.cpu())
            diff = float((outs[0] - outs[1]).abs().max())
            if dtype == "float64":
                rel = diff / float((outs[1] - 37.0).abs().max())
            else:
                rel = diff / float(outs[1].abs().max())
            print(f"[15] entry() {dtype}, {outs[0].numel()} dofs: T_max "
                  f"{float(outs[0].max()):.8f} (card), max |card - CPU| "
                  f"{diff:.3e}, relative {rel:.3e} (of max|T - 37| in float64, "
                  f"of max|T| in float32)")
            check(rel <= tol, f"[15] entry {dtype}: card within {tol} of the CPU")
    finally:
        configure(dtype=old)


# [19]: the BP harness's modes, each with its full-size elements a side
# (about 2.1M dofs at every order; tets and ELL cut, PERF.md section 4)
# cut from 128, 128, 96 to 80, 80, 64 (the vector-FE phases [38]-[42]
# need the time; PERF.md section 4)
BP_MODES = (("hex", {}, 80), ("hex structured", dict(structured=True), 80),
            ("tet", dict(simplex=True), 64), ("hex --ell", dict(ell=True), 64),
            ("tet --ell", dict(ell=True, simplex=True), 64))
BP_KERNELS = ("gather_transpose", "segment_sum", "ell_spmv")
# [20]: ex2's cantilever (x = 0 fixed, attribute 5; the load on x = 8,
# attribute 3), order 2, float64.  rel_tol 1e-9: CG stops on the Jacobi-
# weighted (r, z), which at 1e-8 leaves ||B - A u|| at 1.36e-8 ||B|| on a
# 64x8x8 rehearsal (float64, CPU), above the 1e-8 the phase holds
ELASTICITY = dict(order=2, fixed_bdr=(5,), force_bdr=(3,), dtype="float64",
                  rel_tol=1e-9, max_iter=20000)
# the main beam and its dofs, cut from 128x16x16 (839,619 dofs):
# the vector-FE phases [38]-[42] need the time
EX2_BEAM, EX2_DOFS = (96, 12, 12), 361_875
# [14]: the ex16 cube's side, cut from 100 (8,120,601 dofs)
EX16_N = 80
# [21]: -0.01 lap u + (1, 0.5, 0.25).grad u = 1, 0.01 du/dn + u = 0
CONVECTION = dict(eps=0.01, vel=(1.0, 0.5, 0.25), robin=1.0, rel_tol=1e-6,
                  restart=50, max_iter=2000)


def ell_plane_bound(op, elsize):
    """Least bytes of one single-plane SpMV (each entry's int32 column and
    weight, each row's id and y, x once) and their bound at the HBM rate
    in ms; ~2 flops an entry need far less at 67 TFLOP/s."""
    least = op.nnz * (4 + elsize) + op.n * (4 + elsize) + op.m * elsize
    return least, least / HBM_BYTES_PER_S * 1e3


def pa_against_ell(r, dev, dtype, tol, tag):
    """The PA operator of the run's space against its FULL-assembled ELL
    operator on a seeded random vector, within ``tol``·max|y|."""
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm

    kind = "mass" if r["bench"] == "BP1" else "diffusion"
    pa = BilinearForm(r["fes"], dev).add_domain_integrator(kind).assemble(dtype)
    gen = torch.Generator(device=dev).manual_seed(19 + r["order"])
    x = torch.randn(r["fes"].ndof, generator=gen, device=dev, dtype=r["x"].dtype)
    y = pa.mult(x)
    err = float((r["op"].mult(x) - y).abs().max() / y.abs().max())
    check(err <= tol, f"{tag} {r['bench']} order {r['order']}: PA and ELL agree "
          f"within {tol} max|y| ({err:.2e})")
    return err


def check_ell_plane(op, seed, what):
    """``ell_spmv`` on the plane ``op`` bitwise against its plain version
    on a seeded random vector; returns (x, y, plain's y)."""
    from cardiac_ablation_ecm2_tpu_torch.ops import ell

    gen = torch.Generator(device=op.w.device).manual_seed(seed)
    x = torch.randn(op.m, generator=gen, device=op.w.device, dtype=op.w.dtype)
    y, ref = ell.ell_spmv(op, x), ell.ell_spmv_plain(op, x)
    torch.cuda.synchronize()
    check(torch.equal(bits(y), bits(ref)), f"{what}: ell_spmv (widest row "
          f"{op.max_width}) bitwise equal to plain")
    return x, y, ref


def check_sum_duplicates(kc, fes, dev, what):
    """The segment-sum of FULL assembly's duplicate entries (BP3's element
    matrices of ``fes``, float64 values as ``assemble_matrix`` sums them)
    bitwise against its plain version."""
    from cardiac_ablation_ecm2_tpu_torch.ops import bilinearform as bf
    from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg

    form = bf.BilinearForm(fes, dev).add_domain_integrator("diffusion")
    keys, vals = bf._element_entries(fes, form, form._terms, False,
                                     torch.float32, 1)
    _, slots, offsets = bf.duplicate_segments(keys)
    del keys
    kc.compare("segment_sum", f"{what}FULL assembly's duplicate sum "
               f"({vals.numel()} entries into {offsets.numel() - 1}) float64",
               bg.segment_sum, bg.segment_sum_plain, (vals, slots, offsets),
               tag="[19]")
    del vals, slots, offsets
    torch.cuda.empty_cache()


def check_bp_plane(r, dev):
    """``ell_spmv`` on a BP ELL plane (hex order 4: rows up to 729 wide)
    bitwise against its plain version, float32, timed against plain and
    cuSPARSE ``torch.mv`` with the bound; returns the numbers."""
    from cardiac_ablation_ecm2_tpu_torch.ops import ell

    op, A = r["op"], r["matrix"]
    x, y, ref = check_ell_plane(op, 29, "[19] hex order-4 BP3 plane")
    C = torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr, dtype=torch.int32, device=dev),
        torch.as_tensor(A.indices, dtype=torch.int32, device=dev),
        torch.as_tensor(A.data, dtype=op.w.dtype, device=dev), size=A.shape)
    least, bound = ell_plane_bound(op, x.element_size())
    ms = time_ms(lambda: ell.ell_spmv(op, x))
    plain_ms = time_ms(lambda: ell.ell_spmv_plain(op, x), reps=5)
    lib_ms = time_ms(lambda: torch.mv(C, x))
    print(f"[19] ell_spmv on the hex order-4 BP3 plane float32: n={op.n} nnz="
          f"{op.nnz}, widest row {op.max_width}, padding {op.padding:.4f}; "
          f"bitwise equal to plain; kernel {ms:.4f} ms ({least / ms / 1e6:.1f} "
          f"GB/s of least work), plain {plain_ms:.4f} ms, cuSPARSE torch.mv "
          f"(int32) {lib_ms:.4f} ms; least work {least / 1e6:.1f} MB, bound "
          f"{bound:.4f} ms")
    return dict(bp_ms=ms, bp_plain_ms=plain_ms, bp_library_ms=lib_ms,
                bp_bound_ms=bound, bp_max_abs_err=float((y - ref).abs().max()),
                bp_shape=f"hex order 4 BP3, n={op.n}, nnz={op.nnz}, "
                         f"width {op.max_width}")


def add_launches(total, got):
    return dict(got) if total is None else {k: total[k] + got[k] for k in got}


def phase_bp(kc, dev):
    """[19] The CEED BP harness (``benchmarks/bp.run``), BP1 and BP3 at
    orders 1-4, float32, Jacobi, 100 fixed CG iterations, in every mode;
    first each mode at n=4 in float64 on CUDA and on CPU tensors.  The
    launch counts are zeroed before each (mode, order)'s ``bp.run`` and
    read just after it; the kernels are held at that run's shapes after
    the read.  Returns the summed launches and the numbers for the kernels
    line."""
    from cardiac_ablation_ecm2_tpu_torch.benchmarks import bp
    from cardiac_ablation_ecm2_tpu_torch.fem.build import restriction_for

    t0 = time.perf_counter()
    worst = pa_worst = 0.0
    for label, kw, _ in BP_MODES:
        card = bp.run((1, 2, 3, 4), 4, "float64", 8, device=dev, **kw)
        cpu = bp.run((1, 2, 3, 4), 4, "float64", 8, device="cpu", **kw)
        for a, b in zip(card, cpu):
            rel = rel_diff(a["x"], b["x"])
            worst = max(worst, rel)
            check(rel <= 1e-10 and a["cg_iters"] == b["cg_iters"],
                  f"[19] {label} {a['bench']} order {a['order']} n=4 f64: CUDA "
                  f"within 1e-10 of the CPU ({rel:.2e})")
            if kw.get("ell"):
                pa_worst = max(pa_worst, pa_against_ell(a, dev, "float64", 1e-12,
                                                        "[19] n=4 f64"))
        del card, cpu
    print(f"[19] n=4 float64, 8 CG iterations, every mode and order: CUDA "
          f"against CPU tensors max rel diff {worst:.3e}; PA against ELL on "
          f"the ELL spaces {pa_worst:.3e} (8 iterations: the default 100 "
          f"reach exact convergence and 0/0 on these 125-729-dof spaces)")
    numbers, launches = {}, None
    for label, kw, n in BP_MODES:
        for order in (1, 2, 3, 4):
            start_main_path()
            runs = bp.run((order,), n, "float32", 100, device=dev, **kw)
            launches = add_launches(launches, main_path_launches())
            what = f"BP {label} order {order}"
            for r in runs:
                # BP1's residual underflows float32 inside the 100 fixed
                # iterations and the next step divides 0 by 0, in the JAX
                # harness as here: its x is reported, BP3's held finite
                finite = bool(torch.isfinite(r["x"]).all())
                if r["bench"] == "BP3":
                    check(finite, f"[19] {label} BP3 order {order}: finite x")
                ran = ", ".join(f"{k} {v}" for k, v in r["launches"].items() if v)
                extra = ""
                if r["padding"] is not None:
                    check_ell_plane(r["op"], 19 + order, f"[19] {what} {r['bench']}")
                    err = pa_against_ell(r, dev, "float32", 1e-5, "[19]")
                    extra = (f"; SELL padding {r['padding']:.4f}, widest "
                             f"{r['op'].max_width}, ell_spmv bitwise equal to "
                             f"plain, PA vs ELL {err:.2e}")
                lane = getattr(r["op"], "lane", None)
                if lane is not None:
                    extra += ("; lane path " + ("affine" if lane.aff_terms
                                                else "per point"))
                print(f"[19] {label} {r['bench']} order {order} n={max(2, n // order)}: "
                      f"{r['ndof']} dofs, x {'finite' if finite else 'NaN (0/0)'}, "
                      f"{r['MDof_per_s']} MDof/s "
                      f"({r['seconds_exact']:.4f} s for {r['cg_iters']} CG, CUDA "
                      f"events), setup {r['setup_s']:.2f} s, peak "
                      f"{r['peak_bytes'] / 2**30:.3f} GiB, launches "
                      f"{ran or 'none'}{extra}")
            fes = runs[0]["fes"]
            if kw.get("ell"):
                check_sum_duplicates(kc, fes, dev, f"{what} ")
            elif not kw.get("structured"):      # Cartesian: no gather kernels
                check_restriction(kc, restriction_for(fes, dev), f"{what} ",
                                  "[19]", seed=19 + order, timed=order == 4)
            if label == "hex --ell" and order == 4:
                numbers.update(check_bp_plane(runs[1], dev))
            del runs, fes
    print(f"[19] launches of the full-size runs (counts zeroed before each "
          f"bp.run and read after it, summed): "
          + ", ".join(f"{k} {launches[k]}" for k in BP_KERNELS))
    for k in BP_KERNELS:
        check(launches[k] > 0, f"[19] the BP runs launched {k}")
    print(f"[19] phase {time.perf_counter() - t0:.1f} s")
    return launches, numbers


def elasticity_residual(res, dev):
    """||B - A_c u|| / ||B|| of an elasticity result, float64."""
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import boundary_lf_vector
    from cardiac_ablation_ecm2_tpu_torch.ops.operators import form_linear_system

    fes = res.fes
    A = BilinearForm(fes, dev).add_domain_integrator(
        "elasticity", (1.0, 1.0)).assemble("float64").operator()
    b = boundary_lf_vector(fes, [0.0, 0.0, -1e-2], ELASTICITY["force_bdr"],
                           dtype="float64", device=dev)
    ess = np.concatenate([fes.essential_dofs(ELASTICITY["fixed_bdr"]).astype(np.int64)
                          + c * fes.ndof_scalar for c in range(3)])
    Ac, B = form_linear_system(A, ess, torch.zeros_like(b), b)
    return float(torch.linalg.norm(B - Ac.mult(res.u)) / torch.linalg.norm(B))


def phase_elasticity(kc, dev):
    """[20] ex2 elasticity (``models/elasticity.solve``) on the EX2_BEAM
    beam of length 8, order 2, vdim 3, float64; first a 16x2x2 beam on
    CUDA and on CPU tensors, and the PA apply against the FULL-assembled
    matrix (on the ELL kernel) on a 64x8x8 beam; after the solve, its
    domain and boundary restrictions bitwise.  Returns the launches."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import (
        bdr_restriction_for, restriction_for)
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.models import elasticity
    from cardiac_ablation_ecm2_tpu_torch.ops import ell
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm

    t0 = time.perf_counter()
    small = [elasticity.solve(make_cartesian_3d(16, 2, 2, sx=8.0), device=d,
                              **ELASTICITY) for d in (dev, "cpu")]
    rel = rel_diff(small[0].u, small[1].u)
    check(rel <= 1e-10 and small[0].iterations == small[1].iterations,
          f"[20] 16x2x2 beam: CUDA within 1e-10 of the CPU ({rel:.2e}), equal CG")
    fes = FESpace(make_cartesian_3d(64, 8, 8, sx=8.0), 2, vdim=3)
    form = BilinearForm(fes, dev).add_domain_integrator("elasticity", (1.0, 1.0))
    t1 = time.perf_counter()
    A = form.assemble_matrix("float64")
    full_s = time.perf_counter() - t1
    E = ell.MultiELLOperator.from_csr(A, "float64", device=dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    x = torch.randn(fes.ndof, generator=gen, device=dev, dtype=torch.float64)
    y = form.assemble("float64").mult(x)
    full_err = float((E.mult(x) - y).abs().max() / y.abs().max())
    check(full_err <= 1e-10, f"[20] PA apply within 1e-10 of the FULL matrix's "
          f"({full_err:.2e})")
    print(f"[20] 16x2x2 beam f64: CUDA vs CPU rel diff {rel:.3e}, CG "
          f"{small[0].iterations} both; 64x8x8 beam ({fes.ndof} dofs): FULL "
          f"assembly {full_s:.2f} s, {A.nnz} nnz, PA apply vs the matrix on "
          f"ell_spmv {full_err:.3e}")
    del E, A, form, fes, small
    mesh = make_cartesian_3d(*EX2_BEAM, sx=8.0)
    t1 = time.perf_counter()
    FESpace(mesh, ELASTICITY["order"], vdim=3)      # timed alone, thrown away
    fes_s = time.perf_counter() - t1
    start_main_path()
    t1 = time.perf_counter()
    res = elasticity.solve(mesh, device=dev, **ELASTICITY)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    check(res.fes.ndof == EX2_DOFS, f"[20] {EX2_DOFS:,} dofs")
    check(res.converged and bool(torch.isfinite(res.u).all()), "[20] converged")
    true_res = elasticity_residual(res, dev)
    tip = float(res.displacement()[:, 2].min())
    print(f"[20] ex2 cantilever {'x'.join(map(str, EX2_BEAM))} (length 8) order 2 vdim 3 f64: "
          f"{res.fes.ndof} dofs; Jacobi-PCG rel_tol {ELASTICITY['rel_tol']}: "
          f"{res.iterations} iterations in {secs:.2f} s (space, operator, "
          f"right-hand side and solve; the space alone {fes_s:.2f} s on the "
          f"host; {secs / res.iterations * 1e3:.3f} ms an iteration), true "
          f"residual {true_res:.3e} of ||B||; tip deflection (min u_z) "
          f"{tip:.6f}; peak {peak / 2**30:.3f} GiB; launches "
          + ", ".join(f"{k} {launches[k]}" for k in RESTRICTION_KERNELS))
    check(true_res <= 1e-8, "[20] true residual <= 1e-8 ||B||")
    for k in ("gather_sum", "segment_sum"):
        check(launches[k] > 0, f"[20] the elasticity solve launched {k}")
    check_restriction(kc, restriction_for(res.fes, dev), "beam ", "[20]", seed=21)
    check_restriction(kc, bdr_restriction_for(res.fes, dev), "beam boundary ",
                      "[20]", seed=22)
    print(f"[20] phase {time.perf_counter() - t0:.1f} s")
    return launches


def convection_problem(n, dtype, dev):
    """[21]'s operator, right-hand side and space on the n^3 unit cube."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf

    c = CONVECTION
    fes = FESpace(make_cartesian_3d(n, n, n), 2)
    A = (BilinearForm(fes, dev).add_domain_integrator("diffusion", c["eps"])
         .add_domain_integrator("convection", None, vector_coeff=c["vel"])
         .add_boundary_integrator("mass", c["robin"]).assemble(dtype))
    return fes, A, domain_lf(fes, 1.0, dtype=dtype, device=dev)


def solve_convection(A, b):
    from cardiac_ablation_ecm2_tpu_torch.linalg.smoothers import jacobi
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import gmres

    c = CONVECTION
    return gmres(A.mult, b, M=jacobi(A.diagonal()), rel_tol=c["rel_tol"],
                 restart=c["restart"], max_iter=c["max_iter"])


def phase_gmres(kc, dev):
    """[21] Convection-diffusion with a Robin boundary by restarted GMRES,
    the 64^3 unit cube, order 2, float32; first n=6 in float64 on CUDA and
    on CPU tensors; after the solve, its domain and boundary restrictions
    bitwise.  Returns the launches."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import (
        bdr_restriction_for, restriction_for)

    t0 = time.perf_counter()
    sols = []
    for d in (dev, "cpu"):
        _, A, b = convection_problem(6, "float64", d)
        sols.append(solve_convection(A, b))
    rel = rel_diff(sols[0][0], sols[1][0])
    check(rel <= 1e-10 and sols[0][1].iterations == sols[1][1].iterations,
          f"[21] n=6 f64: CUDA within 1e-10 of the CPU ({rel:.2e}), equal GMRES "
          f"iterations")
    start_main_path()
    t1 = time.perf_counter()
    fes, A, b = convection_problem(64, "float32", dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    x, info = solve_convection(A, b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    check(fes.ndof == 2_146_689, "[21] 2,146,689 dofs")
    r = b.double() - A.mult(x).double()
    true_res = float(torch.linalg.norm(r) / torch.linalg.norm(b.double()))
    affine = [k for k, _ in A.lane.aff_terms] if A.lane is not None else []
    print(f"[21] n=6 f64: CUDA vs CPU rel diff {rel:.3e}, GMRES "
          f"{sols[0][1].iterations} both")
    print(f"[21] convection-diffusion-Robin 64^3 order 2 f32: {fes.ndof} dofs; "
          f"setup {setup_s:.2f} s; GMRES(50) Jacobi rel_tol "
          f"{CONVECTION['rel_tol']}: {info.iterations} iterations in {secs:.2f} s "
          f"({secs / max(info.iterations, 1) * 1e3:.3f} ms each), converged "
          f"{info.converged}, true residual {true_res:.3e} of ||b||; "
          f"convection on the affine lane path: {'convection' in affine} "
          f"(affine terms {affine or 'none'}); peak {peak / 2**30:.3f} GiB; "
          f"launches " + ", ".join(f"{k} {launches[k]}" for k in RESTRICTION_KERNELS))
    check(info.converged and bool(torch.isfinite(x).all()), "[21] converged")
    check(true_res <= 1e-5, "[21] true residual <= 1e-5 ||b||")
    for k in ("gather_transpose", "segment_sum"):
        check(launches[k] > 0, f"[21] the GMRES solve launched {k}")
    del A
    check_restriction(kc, restriction_for(fes, dev), "64^3 order 2 ", "[21]",
                      seed=23)
    check_restriction(kc, bdr_restriction_for(fes, dev), "64^3 boundary ",
                      "[21]", seed=24)
    print(f"[21] phase {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# [22]-[24]: the sharded paths (parallel/), world size 1 over NCCL
# ---------------------------------------------------------------------------

#: the sharded runs' settings: bench.py's solver settings in T form
PAR = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0, ess_bdr=[1, 2, 3, 4, 5, 6],
           rel_tol=1e-5, max_iter=300)


#: JAX's sharded Chebyshev bound: 12 power steps on D⁻¹A
PAR_POWER_DEFAULT = 12
#: [22c]'s runs: (preconditioner, power steps).  At 12 steps the bound
#: falls short on the n=126 stage operator (it does from n=64 on the CPU:
#: T off by 45% of the rise); 60 steps bound it, and those runs are held
PAR_PRECONDS = (("chebyshev", 12), ("chebyshev", 60), ("pmg", 12), ("pmg", 60))
#: [23]'s runs, likewise: at 12 steps "pmg" stops after 6 CG iterations
#: with u 8e-3 of max|u| off
PAR_POISSON = (("pmg", 12), ("pmg", 60), ("lor", 12), ("lor", 60))


def dress_source(x):
    """tools/dress_rehearsal.py:90-92's source, 1e6·exp(−r²/(L/8)²), centred
    on the L × L × L/2 mesh."""
    c = (L / 2, L / 2, L / 4)
    r2 = sum((x[..., i] - c[i]) ** 2 for i in range(3))
    return 1e6 * torch.exp(-r2 / (L / 8) ** 2)


def par_steps(sim, timed=False):
    """Three sharded SDIRK33 steps of dt 0.25 from T_a; with ``timed``, the
    last two between CUDA events: (T, s/step, host s/step)."""
    T, t = sim.T0, 0.0
    for _ in range(1 if timed else 3):
        T, t = sim.step(T, t, 0.25)
    if not timed:
        return T
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    a.record()
    for _ in range(2):
        T, t = sim.step(T, t, 0.25)
    b.record()
    torch.cuda.synchronize()
    return T, a.elapsed_time(b) / 1e3 / 2, (time.perf_counter() - h0) / 2


def serial_T_steps(fes, dev, dtype, **kw):
    """The serial ``BioheatOperator`` in T form on the sharded runs' source,
    three steps from T_a (``timed_steps``): (T, s/step, its CG counts)."""
    from cardiac_ablation_ecm2_tpu_torch.models import bioheat

    op = bioheat.BioheatOperator(fes, q_met=dress_source, dtype=dtype, device=dev,
                                 **dict(SETTINGS, theta_form=False, **kw))
    T, s_step, _ = timed_steps(op, torch.full((fes.ndof,), PAR["T_a"],
                                              dtype=op.dtype, device=dev))
    return T, s_step, op.cg_iterations


def par_expected_launches(its, setup_sums=3):
    """The launches the sharded Jacobi step implies for stage CG counts
    ``its``: per stage the residual's A (one L→E, one fused diffusion, one
    E→L) and k + 1 stage applies (M_ρc and A, each one L→E and one E→L; the
    fused diffusion once), beside the setup's three E→L sums."""
    applies = sum(k + 1 for k in its)
    return dict(gather_sum=len(its) + 2 * applies,
                segment_sum=setup_sums + len(its) + 2 * applies,
                fused_diffusion=len(its) + applies)


def par_bioheat(mesh, fes, dev, dtype, timed=False, gather=False, **kw):
    """The sharded bioheat step at world size 1 in this process (NCCL on the
    card, gloo on the CPU), the process group closed again afterwards:
    (sim, T) with the rank's local T, or the global one gathered to rank 0
    (``gather``), or with ``timed`` (sim, (T, s/step, host s/step))."""
    from cardiac_ablation_ecm2_tpu_torch.parallel import bioheat as pbio
    from cardiac_ablation_ecm2_tpu_torch.parallel import launch

    def body(rank, world, d):
        sim = pbio.setup(mesh, order=2, q_src=dress_source, dtype=dtype,
                         device=d, fes=fes, **dict(PAR, **kw))
        out = par_steps(sim, timed=timed)
        return sim, (torch.as_tensor(sim.gather(out)) if gather else out)

    return launch.run_single(body, dev)


def check_coarse_levels(kc, dev, tag, ctx, qd_fn, seed, lor_restr=None):
    """After a sharded p-MG or LOR run's launch counts were read: each
    coarse level's local restriction (into its nloc + 1 dofs, trash slot
    included) bitwise, and ``fused_diffusion`` on the level's packed,
    weight-scaled qdata as the V-cycle built them (``qd_fn``); with
    ``lor_restr``, the LOR sub-element restriction bitwise too."""
    import types

    for li, lv in enumerate(ctx.levels):
        p = ctx.orders[li]
        check_restriction(kc, lv.local.restr, f"sharded order-{p} coarse local ",
                          tag, seed=seed + li)
        _, qdf = qd_fn(lv.gf, li, lv.db)
        check_operator_diffusion(tag, f"sharded order-{p} coarse qdata (packed, "
                                 f"weight-scaled)", types.SimpleNamespace(
                                     K_qd=qdf, db=lv.db, fes=lv.pf.fes, device=dev))
        del qdf
    if lor_restr is not None:
        check_restriction(kc, lor_restr, "sharded LOR sub-hex local ", tag,
                          seed=seed + 9)
    torch.cuda.empty_cache()


def phase_par_small(dev):
    """[22a] hex n=16 float64, three steps at rel_tol 1e-10: the card
    (NCCL) against the CPU (gloo), and against the serial T-form
    operator."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh

    fes = FESpace(make_cardiac_hex_mesh(16, lengths=(L, L, L / 2),
                                        electrode_radius=0.004), 2)
    tight = dict(rel_tol=1e-10, max_iter=500)
    (sg, Tg), (sc, Tc) = (par_bioheat(fes.mesh, fes, d, "float64", gather=True,
                                      **tight) for d in (dev, "cpu"))
    Ts, _, its_s = serial_T_steps(fes, dev, "float64", **tight)
    card_cpu = float((Tg - Tc).abs().max())
    card_ser = float((Tg - Ts.cpu()).abs().max())
    print(f"[22a] sharded hex n=16 f64, world 1, {fes.ndof} dofs: card (NCCL) vs "
          f"CPU (gloo) max|dT| {card_cpu:.3e}, CG {sg.cg_iterations} vs "
          f"{sc.cg_iterations}; vs the serial T-form operator max|dT| "
          f"{card_ser:.3e} (its CG {its_s}); T_max {float(Tg.max()):.8f}")
    check(card_cpu <= 1e-10, "[22a] card within 1e-10 of the CPU")
    check(sg.cg_iterations == sc.cg_iterations, "[22a] equal CG counts card/CPU")
    check(card_ser <= 1e-8, "[22a] sharded within 1e-8 of the serial step")


def phase_par_main(kc, dev, mesh, fes):
    """[22b] the sharded step on [4]'s mesh and space, float32 Jacobi,
    against the serial T-form step; then the rank's restriction and fused
    diffusion at its shapes; [22c] Chebyshev and p-multigrid.  Returns the
    launch counts of the Jacobi run (setup and three steps)."""
    import types

    from cardiac_ablation_ecm2_tpu_torch.linalg import ode

    t0 = time.perf_counter()
    start_main_path()
    sim, (T, s_step, host_step) = par_bioheat(mesh, fes, dev, "float32",
                                              timed=True)
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    its = sim.cg_iterations
    sec = sim.setup_seconds
    expect = par_expected_launches(its)
    print(f"[22b] sharded hex n=126 order 2 f32, world 1 over NCCL: {mesh.ne} "
          f"hexes, {fes.ndof} dofs (nloc {sim.local.nloc} + trash slot); "
          f"setup: host tables and restriction {sec['tables']:.2f} s, device "
          f"{sec['device']:.2f} s")
    print(f"[22b] s/step {s_step:.6f} (CUDA events; host clock {host_step:.6f}); "
          f"CG per stage {its}; max_memory_allocated {peak / 2**30:.3f} GiB")
    print(f"[22b] launches (setup + 3 steps): " + ", ".join(
        f"{k} {launches[k]} (implied {expect[k]})" for k in expect)
          + f", gather_transpose {launches['gather_transpose']}")
    Tn = T[:-1]
    check(Tn.shape == (fes.ndof,) and bool(torch.isfinite(Tn).all()),
          "[22b] finite T of the expected shape")
    for k, v in expect.items():
        check(launches[k] == v, f"[22b] {k} launched as the code implies")
    K_qd, db = sim.K_qd, sim.db
    r = sim.local.restr
    del sim
    Ts, s_ser, its_s = serial_T_steps(fes, dev, "float32")
    rise = float(Ts.max()) - 37.0
    diff = float((Tn - Ts).abs().max())
    print(f"[22b] serial T-form step on the same mesh: s/step {s_ser:.6f} "
          f"(sharded / serial {s_step / s_ser:.3f}), CG {its_s}; max|T - "
          f"T_serial| {diff:.3e} = {diff / rise:.3e} of the rise {rise:.6f}")
    check(diff <= 1e-3 * rise, "[22b] within 1e-3 of the serial step's rise")
    check(all(abs(a - b) <= 1 for a, b in zip(its, its_s)) and len(its) == len(its_s),
          "[22b] CG counts within 1 of the serial step's, stage by stage")
    del Ts, T
    torch.cuda.empty_cache()
    check_restriction(kc, r, "sharded local (trash slot included) ", "[22b]", seed=22)
    check_operator_diffusion("[22b]", "sharded K_qd (packed, weight-scaled)",
                             types.SimpleNamespace(K_qd=K_qd, db=db, fes=fes,
                                                   device=dev))
    del K_qd, r
    gamma = float(ode.select("sdirk33").tableau.a[0, 0]) * 0.25
    for i, (pre, power) in enumerate(PAR_PRECONDS):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start_main_path()
        sim, (T, s_pre, _) = par_bioheat(mesh, fes, dev, "float32", timed=True,
                                         precond=pre, cheb_power_iters=power)
        got = main_path_launches()
        d = float((T[:-1] - Tn).abs().max())
        held = power > PAR_POWER_DEFAULT
        print(f"[22c] sharded hex n=126 f32 {pre}, {power} power steps"
              + (" (JAX's default)" if not held else "")
              + f": setup {sim.setup_seconds['tables']:.2f} + "
              f"{sim.setup_seconds['device']:.2f} s, s/step {s_pre:.6f} (Jacobi's / "
              f"this {s_step / s_pre:.3f}), CG per stage {sim.cg_iterations}; "
              f"max|T - T_jacobi| {d:.3e} = {d / rise:.3e} of the rise; "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
              + "; launches " + ", ".join(
                  f"{k} {got[k]}" for k in RESTRICTION_KERNELS + ("fused_diffusion",))
              + ("" if held or d <= 1e-3 * rise else
                 "; NOT within 1e-3 of the rise: the short power bound makes the "
                 "smoother indefinite and CG stops on (r, z) <= 0 (ROADMAP Queue 3)"))
        check(bool(torch.isfinite(T).all()), f"[22c] {pre}: finite T")
        if held:
            check(d <= 1e-3 * rise,
                  f"[22c] {pre} ({power} power steps) within 1e-3 of the rise of "
                  f"Jacobi's T")
        for k in ("gather_sum", "segment_sum", "fused_diffusion"):
            check(got[k] > 0, f"[22c] {pre} launched {k}")
        if sim.pmg is not None:
            check_coarse_levels(kc, dev, "[22c]", sim.pmg,
                                sim.coarse_qdata(gamma), seed=40 + 10 * i)
        del sim, T
    print(f"[22b-c] phase {time.perf_counter() - t0:.1f} s")
    return launches


def phase_par_tet(kc, dev, mesh, fes):
    """[22d] the sharded step on [7]'s tet n=66 mesh and space (the config-5
    rehearsal's mesh), float32 Jacobi: setup, s/step, CG; then the rank's
    restriction at nd = 10 bitwise."""
    start_main_path()
    sim, (T, s_step, host_step) = par_bioheat(mesh, fes, dev, "float32",
                                              timed=True)
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    sec = sim.setup_seconds
    print(f"[22d] sharded tet n=66 order 2 f32, world 1: {mesh.ne} tets, "
          f"{fes.ndof} dofs; setup: host tables and restriction "
          f"{sec['tables']:.2f} s, device {sec['device']:.2f} s; s/step "
          f"{s_step:.6f} (host clock {host_step:.6f}); CG per stage "
          f"{sim.cg_iterations}; T_max {float(T.max()):.6f}; launches "
          + ", ".join(f"{k} {launches[k]}" for k in RESTRICTION_KERNELS)
          + f", fused diffusion {launches['fused_diffusion']}; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB")
    check(T.shape == (fes.ndof + 1,) and bool(torch.isfinite(T).all())
          and float(T.max()) > 37.0, "[22d] finite T that the source heats")
    check(max(sim.cg_iterations) < PAR["max_iter"], "[22d] every stage converged")
    expect = par_expected_launches(sim.cg_iterations)
    for k in ("gather_sum", "segment_sum"):
        check(launches[k] == expect[k], f"[22d] {k} launched as the code implies")
    check(launches["fused_diffusion"] == 0, "[22d] tets run no fused diffusion")
    r = sim.local.restr
    del sim, T
    torch.cuda.empty_cache()
    check_restriction(kc, r, "sharded tet local ", "[22d]", seed=23)


def phase_par_poisson(kc, dev, mesh, ref):
    """[23] the sharded Poisson solve on [13]'s problem and space, float32,
    with ``"pmg"`` and ``"lor"`` (JAX's 12 power steps, and 60):
    iterations, seconds and the true relative residual; the 60-step
    solutions held to [13]'s float64 reference as [13] holds its own."""
    from cardiac_ablation_ecm2_tpu_torch.parallel import launch
    from cardiac_ablation_ecm2_tpu_torch.parallel import poisson as ppoisson
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    fes, u_ref, residual, its13 = ref
    scale = float(u_ref.abs().max())
    for i, (pre, power) in enumerate(PAR_POISSON):
        start_main_path()

        def body(rank, world, d):
            t0 = time.perf_counter()
            s = ppoisson.setup(
                mesh, order=2, rhs=lambda x: torch.ones_like(x[..., 0]),
                kappa=lambda x: torch.full_like(x[..., 0], POISSON["kappa"]),
                ess_bdr=POISSON["ess_bdr"], rel_tol=POISSON["rel_tol"],
                max_iter=POISSON["max_iter"], dtype="float32", device=d,
                precond=pre, cheb_power_iters=power, fes=fes)
            setup_s = elapsed(t0, d)
            t1 = time.perf_counter()
            u, its, _ = s.solve()
            return u, its, setup_s, elapsed(t1, d), s

        u, its, setup_s, solve_s, s = launch.run_single(body, dev)
        launches = main_path_launches()
        u = torch.as_tensor(u, device=dev)
        res = residual(u)
        err = float((u.double() - u_ref).abs().max()) / scale
        held = power > PAR_POWER_DEFAULT
        print(f"[23] sharded Poisson f32 {pre}, {power} power steps"
              + (" (JAX's default)" if not held else "")
              + f", world 1: setup {setup_s:.3f} s, solve {solve_s:.3f} s, {its} "
              f"CG iterations ([13] serial: {its13}), true relative residual "
              f"{res:.3e}, max|u - u_ref|/max|u_ref| {err:.3e}; launches "
              + ", ".join(f"{k} {launches[k]}"
                          for k in RESTRICTION_KERNELS + ("fused_diffusion",))
              + ("" if held or err <= 1e-4 else
                 "; NOT within 1e-4 max|u|: the short power bound (ROADMAP "
                 "Queue 3)"))
        check(bool(torch.isfinite(u).all()) and its < POISSON["max_iter"],
              f"[23] {pre}: finite u and a stop before max_iter")
        if held:
            check(err <= 1e-4, f"[23] {pre} ({power} power steps) within 1e-4 "
                  f"max|u| of the float64 reference")
        for k in ("gather_sum", "segment_sum", "fused_diffusion"):
            check(launches[k] > 0, f"[23] {pre} launched {k}")
        check_coarse_levels(kc, dev, "[23]", s.pmg, s.coarse_qdata,
                            seed=80 + 10 * i, lor_restr=s.lor_restr)
        del s, u


def phase_par_lattice(dev, theta48):
    """[24] the z-slab lattice stepper on the 48³ lattice at world size 1,
    float32, against [9]'s serial θ (``theta48``); its quadrature has p + 2
    points a direction (the JAX module's), [9]'s p + 1 (quad_extra 0)."""
    from cardiac_ablation_ecm2_tpu_torch.parallel import cartesian_bioheat as pcb
    from cardiac_ablation_ecm2_tpu_torch.parallel import launch
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    start_main_path()

    def body(rank, world, d):
        t0 = time.perf_counter()
        sim = pcb.setup(48, 48, 48, order=2, lengths=(L, L, L),
                        q_src=lattice_source, rel_tol=PAR["rel_tol"],
                        max_iter=PAR["max_iter"], dtype="float32", device=d,
                        **{k: PAR[k] for k in ("rho_c", "k", "w_cb", "T_a")})
        setup_s = elapsed(t0, d)
        T, s_step, host_step = par_steps(sim, timed=True)
        return sim.gather(T), setup_s, s_step, host_step, sim.cg_iterations

    T, setup_s, s_step, host_step, its = launch.run_single(body, dev)
    launches = main_path_launches()
    T = torch.as_tensor(T, device=dev)
    diff = float((T - 37.0 - theta48).abs().max())
    rise = float(theta48.max())
    print(f"[24] z-slab lattice 48^3 f32, world 1: setup {setup_s:.2f} s, s/step "
          f"{s_step:.6f} (host clock {host_step:.6f}); CG per stage {its}; "
          f"max|T - 37 - theta_[9]| {diff:.3e} = {diff / rise:.3e} of [9]'s "
          f"theta_max {rise:.6f}; fused diffusion launches "
          f"{launches['fused_diffusion']}, restriction kernel launches "
          f"{sum(launches[k] for k in RESTRICTION_KERNELS)}")
    check(T.shape == theta48.shape and bool(torch.isfinite(T).all()),
          "[24] finite T of the lattice's shape")
    check(diff <= 1e-2 * rise, "[24] within 1e-2 of [9]'s rise (other quadrature)")
    check(launches["fused_diffusion"] > 0
          and not any(launches[k] for k in RESTRICTION_KERNELS),
          "[24] the fused diffusion kernel ran, and no gather (structured)")


# ----------------------------------------------------------------------------
# [25]-[28]: the mesh core (refinement, h-multigrid, 2D forms, the examples)
# ----------------------------------------------------------------------------

#: [25]: float32 PCG as [13]; the fine level's Jacobi-PCG needs ~600 steps
HMG = dict(rel_tol=1e-5, max_iter=5000)
#: make_h_multigrid's smoothers take the JAX package's 20 power steps; the
#: held run rebuilds them from the same transfers with 60
HMG_POWER = 60
#: [26]: ex1's rel_tol in float64; Jacobi-PCG needs ~3,600 steps at 1024²
#: (111, 224, 450 at 32², 64², 128² on the CPU); the side D2_N, cut from
#: 1024 (the vector-FE phases [38]-[42] need the time)
D2 = dict(rel_tol=1e-10, max_iter=50_000)
D2_N = 512


def constrained_diffusion(fes, dev, dtype):
    """−Δ on ``fes`` with u = 0 on every boundary attribute (PA, the
    lane-major apply), wrapped as the constrained operator."""
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
    from cardiac_ablation_ecm2_tpu_torch.ops.operators import ConstrainedOperator

    A = BilinearForm(fes, dev).add_domain_integrator("diffusion").assemble(dtype)
    return ConstrainedOperator.wrap(A.operator(), fes.essential_dofs(), dtype, dev)


def unit_rhs(fes, A, dev, dtype):
    """b = (1, v), zero at the constrained dofs."""
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf

    return domain_lf(fes, 1.0, dtype=dtype, device=dev) * A.mask


def true_residual(fes, dev):
    """``u ↦ ‖b − A_c u‖/‖b‖`` of −Δu = 1, u = 0 on the boundary, assembled
    and applied in float64, and that b."""
    A = constrained_diffusion(fes, dev, "float64")
    b = unit_rhs(fes, A, dev, "float64")
    return (lambda u: float((b - A.mult(u.double())).norm() / b.norm())), b


def h_multigrid(meshes, spaces, dev, dtype):
    """make_h_multigrid over ``meshes`` (coarse → fine) with the constrained
    diffusion operators (kept by space, so the fine one is the CG's):
    (multigrid, operators, setup seconds)."""
    from cardiac_ablation_ecm2_tpu_torch.linalg.multigrid import make_h_multigrid
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    ops = {}
    by_mesh = {id(m): s for m, s in zip(meshes, spaces)}
    t0 = time.perf_counter()
    mg = make_h_multigrid(
        meshes, lambda m: by_mesh[id(m)],
        lambda f: ops.setdefault(id(f), constrained_diffusion(f, dev, dtype)),
        ess_factory=lambda f: f.essential_dofs(), dtype=dtype, device=dev)
    return mg, [ops[id(s)] for s in spaces], elapsed(t0, dev)


def rebuilt_levels(mg, ops, power_iters):
    """The hierarchy's levels with Chebyshev smoothers rebuilt from
    ``power_iters`` power steps: the same operators, transfers and
    essential dofs (no new API: what [22c] does for the sharded p-MG)."""
    from cardiac_ablation_ecm2_tpu_torch.linalg.multigrid import MGLevel, Multigrid
    from cardiac_ablation_ecm2_tpu_torch.linalg.smoothers import chebyshev

    return Multigrid(levels=[
        MGLevel(lv.A, chebyshev(op.mult, op.diagonal(), order=3,
                                power_iters=power_iters),
                lv.prolongate, lv.restrict_t, lv.ess)
        for lv, op in zip(mg.levels, ops)])


def pcg(A, b, M, dev, **kw):
    """(x, iterations, converged, CUDA-synchronized seconds)."""
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    t0 = time.perf_counter()
    x, info = cg(A.mult, b, M=M, **kw)
    return x, info.iterations, info.converged, elapsed(t0, dev)


def phase_hmg(kc, dev):
    """[25] −Δu = 1, u = 0 on the boundary, on the cardiac hex mesh n=32
    refined twice (16,305 → 130,440 → 1,043,520 hexes), order 2, float32:
    h-multigrid PCG with make_h_multigrid's smoothers (20 power steps,
    printed and flagged where it falls short), then with the levels
    rebuilt at 60 steps (held), and Jacobi-PCG; after each run's launches
    are read, every level's restriction bitwise, the fine one timed.
    Returns the default run's launches, the spaces and the fine transfer
    for [27], and the fine restriction's round trip."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import restriction_for
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.smoothers import jacobi
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    meshes = [make_cardiac_hex_mesh(32, lengths=(L, L, L / 2),
                                    electrode_radius=0.004)]
    for _ in range(2):
        meshes.append(meshes[-1].uniform_refinement())
    mesh_s = time.perf_counter() - t0
    spaces, space_s = [], []
    for m in meshes:
        t0 = time.perf_counter()
        spaces.append(FESpace(m, 2))
        space_s.append(time.perf_counter() - t0)
    fes = spaces[-1]
    check(tuple(m.ne for m in meshes) == (16_305, 130_440, 1_043_520),
          "[25] the refined hierarchy's sizes")
    print(f"[25] cardiac hex n=32 refined twice: {[m.ne for m in meshes]} hexes, "
          f"order 2: {[s.ndof for s in spaces]} dofs; host: maker and two "
          f"refinements {mesh_s:.2f} s, FESpaces "
          + ", ".join(f"{t:.2f}" for t in space_s) + " s")
    start_main_path()
    mg, ops, setup_s = h_multigrid(meshes, spaces, dev, "float32")
    A = ops[-1]
    b = unit_rhs(fes, A, dev, "float32")
    x20, its20, conv20, solve20 = pcg(A, b, mg.preconditioner(), dev, **HMG)
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    residual, _ = true_residual(fes, dev)
    runs = {"h-MG, 20 power steps": (x20, its20, conv20, setup_s, solve20, peak,
                                     launches)}
    ht = mg.levels[1].prolongate.__self__         # 16,305 → 130,440, for [27]
    start_main_path()
    t0 = time.perf_counter()
    mg60 = rebuilt_levels(mg, ops, HMG_POWER)
    setup60 = time.perf_counter() - t0
    x60, its60, conv60, solve60 = pcg(A, b, mg60.preconditioner(), dev, **HMG)
    runs[f"h-MG, {HMG_POWER} power steps"] = (
        x60, its60, conv60, setup60, solve60, torch.cuda.max_memory_allocated(),
        main_path_launches())
    del mg60
    start_main_path()
    t0 = time.perf_counter()
    M = jacobi(A.diagonal())
    setupj = time.perf_counter() - t0
    xj, itsj, convj, solvej = pcg(A, b, M, dev, **HMG)
    runs["Jacobi"] = (xj, itsj, convj, setupj, solvej,
                      torch.cuda.max_memory_allocated(), main_path_launches())
    scale = float(xj.abs().max())
    for name, (x, its, conv, s_set, s_solve, pk, got) in runs.items():
        d = float((x - xj).abs().max()) / scale
        held = name != "h-MG, 20 power steps"
        print(f"[25] {name}: setup {s_set:.3f} s, solve {s_solve:.3f} s "
              f"({s_solve / max(its, 1) * 1e3:.3f} ms an iteration), {its} CG "
              f"iterations, converged {conv}, true relative residual (float64 "
              f"evaluation) {residual(x):.3e}, max|u - u_jacobi|/max|u| {d:.3e}, "
              f"max_memory_allocated {pk / 2**30:.3f} GiB; launches "
              + ", ".join(f"{k} {got[k]}" for k in RESTRICTION_KERNELS + (
                  "fused_diffusion",))
              + ("" if held or d <= 1e-3 else
                 "; NOT within 1e-3 max|u| of Jacobi's: the 20-step bound falls "
                 "short and the smoother is indefinite (ROADMAP Queue 3)"))
        check(bool(torch.isfinite(x).all()) and x.shape == (fes.ndof,),
              f"[25] {name}: finite u of the expected shape")
        if held:
            check(conv, f"[25] {name} converged")
            check(d <= 1e-3, f"[25] {name} within 1e-3 max|u| of Jacobi's")
    check(its60 < itsj / 5, "[25] h-MG (60 steps) under a fifth of Jacobi's count")
    for k in RESTRICTION_KERNELS:
        check(launches[k] > 0, f"[25] the h-MG run launched {k}")
    del runs, x20, x60, xj, M, A, b, ops, mg, residual
    torch.cuda.empty_cache()
    for i, s in enumerate(spaces):
        fine = i == len(spaces) - 1
        check_restriction(kc, restriction_for(s, dev),
                          "refined fine " if fine else f"refined level-{i} ",
                          "[25]", seed=250 + i, timed=fine)
    r = restriction_for(fes, dev)
    gen = torch.Generator(device=dev).manual_seed(25)
    u = torch.randn(fes.ndof, generator=gen, device=dev)
    trip = [kc.times[f"refined fine {k} float32"]
            for k in ("L->E (nd,ne)", "E->L (nd,ne)")]
    rt = {f: sum(t[f] for t in trip) for f in ("ms", "plain_ms", "library_ms",
                                               "bound_ms")}
    rt["chained_ms"] = time_ms(lambda: r.mult_transpose_t(r.mult_t(u)))
    print(f"[25] the refined fine level's restriction round trip (mult_t + "
          f"mult_transpose_t, {fes.mesh.ne} x 27 into {fes.ndof} dofs), float32: "
          f"{rt['ms']:.4f} ms (chained {rt['chained_ms']:.4f} ms), plain "
          f"{rt['plain_ms']:.4f} ms, library {rt['library_ms']:.4f} ms, bound "
          f"{rt['bound_ms']:.4f} ms; [2]'s n=126 (995,336 x 27, Morton order) "
          f"{kc.round_trip['round_trip_ms']:.4f} ms (chained "
          f"{kc.round_trip['round_trip_chained_ms']:.4f} ms)")
    del u
    print(f"[25] phase {time.perf_counter() - t_phase:.1f} s")
    return launches, spaces, ht, rt


def warp2d(x):
    """A smooth map of the unit square onto itself (the sides stay put)."""
    return np.stack([x[..., 0] + 0.08 * np.sin(2 * np.pi * x[..., 1])
                     * x[..., 0] * (1.0 - x[..., 0]),
                     x[..., 1] + 0.08 * np.sin(2 * np.pi * x[..., 0])
                     * x[..., 1] * (1.0 - x[..., 1])], axis=-1)


def poisson_2d_cases(n, coarse=None):
    """[26]'s meshes at n × n: quads, triangles, curved quads (geometry
    order 2), and the h-MG hierarchy from ``coarse`` × ``coarse`` quads."""
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import (
        curve_mesh,
        make_cartesian_2d,
        make_cartesian_2d_tri,
    )

    quads = make_cartesian_2d(n, n)
    hier = [make_cartesian_2d(coarse, coarse)]
    while hier[-1].ne < quads.ne:
        hier.append(hier[-1].uniform_refinement())
    return dict(quad=quads, tri=make_cartesian_2d_tri(n, n),
                curved=curve_mesh(quads, warp2d, 2)), hier


def solve_2d(kind, mesh, dev, fes=None, hier=None, hier_spaces=None):
    """One [26] solve in float64: Jacobi-PCG through ``models/poisson`` (ex1's
    path), or h-MG PCG over ``hier``: (space, u, iterations, setup s, solve
    s)."""
    from cardiac_ablation_ecm2_tpu_torch.models import poisson
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    if hier is None:
        r = poisson.solve(mesh, order=2, rhs=1.0, dtype="float64", device=dev,
                          fes=fes, **D2)
        check(r.converged, f"[26] {kind} Jacobi-PCG converged")
        return (r.fes, r.u, r.iterations,
                r.setup_seconds["operator"] + r.setup_seconds["preconditioner"],
                r.solve_seconds)
    mg, ops, setup_s = h_multigrid(hier, hier_spaces, dev, "float64")
    t0 = time.perf_counter()
    b = unit_rhs(hier_spaces[-1], ops[-1], dev, "float64")
    setup_s += elapsed(t0, dev)
    x, its, conv, solve_s = pcg(ops[-1], b, mg.preconditioner(), dev, **D2)
    check(conv, f"[26] {kind} h-MG PCG converged")
    return hier_spaces[-1], x, its, setup_s, solve_s


def phase_2d(kc, dev):
    """[26] ex1 on 2D meshes in float64 at rel_tol 1e-10: first n=16 on the
    card against the CPU (equal CG counts, 1e-10); then D2_N² quads with
    Jacobi-PCG and with h-MG over (D2_N/16)² refined four times, D2_N² triangles
    and the curved quads with Jacobi-PCG: seconds, counts, the true
    residual (held ≤ 1e-6) and ∫u = (b, u) across the runs; after each
    run's launches are read, the restriction of each space it ran on
    bitwise (every level of the h-MG run).  Returns the
    launches of the four full-size solves, summed."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import restriction_for
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace

    t_phase = time.perf_counter()
    small, hier = poisson_2d_cases(16, coarse=4)
    for kind in ("quad", "h-MG", "tri", "curved"):
        outs = []
        for d in (dev, "cpu"):
            if kind == "h-MG":
                outs.append(solve_2d(kind, None, d, hier=hier, hier_spaces=[
                    FESpace(m, 2) for m in hier]))
            else:
                outs.append(solve_2d(kind, small[kind], d))
        rel = float((outs[0][1].cpu() - outs[1][1]).abs().max()
                    / outs[1][1].abs().max())
        print(f"[26] n=16 {kind} f64: card vs CPU rel diff {rel:.3e}, CG "
              f"{outs[0][2]} vs {outs[1][2]}")
        check(rel <= 1e-10 and outs[0][2] == outs[1][2],
              f"[26] n=16 {kind}: card within 1e-10 of the CPU, equal CG counts")
    t0 = time.perf_counter()
    full, hier = poisson_2d_cases(D2_N, coarse=D2_N // 16)
    mesh_s = time.perf_counter() - t0
    total = dict.fromkeys(RESTRICTION_KERNELS + ("fused_diffusion",), 0)
    integrals = {}
    for kind in ("quad", "h-MG", "tri", "curved"):
        t0 = time.perf_counter()
        if kind == "h-MG":
            spaces = [FESpace(m, 2) for m in hier]
            fes = spaces[-1]
        else:
            spaces, fes = None, FESpace(full[kind], 2)
        space_s = time.perf_counter() - t0
        start_main_path()
        fes, u, its, setup_s, solve_s = solve_2d(
            kind, full.get(kind), dev, fes=fes, hier=hier if spaces else None,
            hier_spaces=spaces)
        got = main_path_launches()
        peak = torch.cuda.max_memory_allocated()
        for k in total:
            total[k] += got[k]
        residual, b = true_residual(fes, dev)
        res = residual(u)
        integrals[kind] = float(b.dot(u))
        print(f"[26] {kind} {D2_N}^2 order 2 f64: {fes.mesh.ne} elements, {fes.ndof} "
              f"dofs; host FESpace{'s' if spaces else ''} {space_s:.2f} s; setup "
              f"{setup_s:.3f} s, solve {solve_s:.3f} s ({solve_s / its * 1e3:.3f} ms "
              f"an iteration), {its} CG iterations, true relative residual "
              f"{res:.3e}, (b, u) {integrals[kind]:.12e}, max_memory_allocated "
              f"{peak / 2**30:.3f} GiB; launches "
              + ", ".join(f"{k} {got[k]}" for k in total))
        check(u.shape == (fes.ndof,) and bool(torch.isfinite(u).all()),
              f"[26] {kind}: finite u of the expected shape")
        # CG stops on the preconditioned residual √(r, z): ‖b − Au‖/‖b‖
        # lands above rel_tol by a factor the preconditioner sets
        check(res <= 1e-6, f"[26] {kind}: true relative residual <= 1e-6")
        # Jacobi-PCG's applies run the (nd, ne) directions; the h-MG
        # transfers add the element-major L→E
        for k in RESTRICTION_KERNELS[int(kind != "h-MG"):]:
            check(got[k] > 0, f"[26] {kind} launched {k}")
        if kind == "h-MG":
            check(its < 100, "[26] h-MG PCG under 100 iterations")
        del u, residual, b
        torch.cuda.empty_cache()
        # every level's map the run gathered on (the curved quads share
        # the quads' map)
        if kind == "h-MG":
            for i, s in enumerate(spaces):
                check_restriction(kc, restriction_for(s, dev),
                                  f"2D h-MG level-{i} ({s.mesh.ne} quads) ",
                                  "[26]", seed=2600 + i)
        elif kind != "curved":
            check_restriction(kc, restriction_for(fes, dev), f"2D {kind} ",
                              "[26]", seed=260 + len(integrals))
        del fes, spaces
    rel = {k: abs(v - integrals["quad"]) / abs(integrals["quad"])
           for k, v in integrals.items() if k != "quad"}
    print(f"[26] (b, u) = the integral of u against the quads' Jacobi run: "
          f"h-MG (the same grid, numbered by refinement) {rel['h-MG']:.3e}, "
          f"triangles {rel['tri']:.3e}, curved quads (the same square) "
          f"{rel['curved']:.3e}; host meshes {mesh_s:.2f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    check(rel["h-MG"] <= 1e-8, "[26] the quad solutions' (b, u) agree within 1e-8")
    check(max(rel["tri"], rel["curved"]) <= 1e-6,
          "[26] the triangles' and the curved quads' (b, u) within 1e-6")
    return total


def phase_prefine(kc, dev, spaces, ht):
    """[27] parallel/refine.refine_uniform at world size 1 over NCCL: [25]'s
    16,305-hex order-2 ParFESpace to 130,440 hexes (cut from 130,440 →
    1,043,520), the prolongation of a seeded float32 field against [25]'s
    serial HTransfer ``ht`` between those levels (1e-6 max|u|); then the
    rank's coarse and fine local restrictions bitwise.  Returns the
    prolongation's launches."""
    from cardiac_ablation_ecm2_tpu_torch.parallel import launch, pfespace
    from cardiac_ablation_ecm2_tpu_torch.parallel.refine import refine_uniform
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    pf = pfespace.build(spaces[0], 1)
    pf_f, pt = refine_uniform(pf)
    host_s = time.perf_counter() - t0
    check(np.array_equal(pf_f.fes.gather_map, spaces[1].gather_map),
          "[27] the sharded refinement numbers the fine dofs as [25]'s")
    check(np.array_equal(pf_f.loc2glob[0], np.arange(spaces[1].ndof)),
          "[27] world 1: local dofs are global dofs")
    uc = np.random.default_rng(27).standard_normal(spaces[0].ndof)
    start_main_path()

    def body(rank, world, d):
        t0 = time.perf_counter()
        lt = pt.local(rank, d, "float32")
        setup_s = elapsed(t0, d)
        uc_loc = torch.as_tensor(pfespace.scatter_global(pf, uc)[rank],
                                 dtype=torch.float32, device=d)
        t0 = time.perf_counter()
        uf = lt.prolongate(uc_loc)
        first_s = elapsed(t0, d)
        t0 = time.perf_counter()
        again = lt.prolongate(uc_loc)
        return (uf, again, setup_s, first_s, elapsed(t0, d), lt.coarse.restr,
                lt.fine.restr)

    uf, again, setup_s, first_s, warm_s, restr_c, restr_f = launch.run_single(
        body, dev)
    launches = main_path_launches()
    serial = ht.prolongate(torch.as_tensor(uc, dtype=torch.float32, device=dev))
    scale = float(serial.abs().max())
    err = float((uf[:-1] - serial).abs().max()) / scale
    print(f"[27] sharded refinement, world 1 over NCCL: {spaces[0].mesh.ne} -> "
          f"{pf_f.fes.mesh.ne} hexes, {pf_f.nloc} fine local dofs; host tables "
          f"and refinement {host_s:.2f} s, the rank's transfer {setup_s:.2f} s; "
          f"prolongation {first_s * 1e3:.3f} ms (counts included), "
          f"{warm_s * 1e3:.3f} ms again; max|u_par - u_serial|/max|u| {err:.3e}; "
          f"launches " + ", ".join(f"{k} {launches[k]}" for k in RESTRICTION_KERNELS))
    check(err <= 1e-6, "[27] the sharded prolongation within 1e-6 of the serial")
    check(torch.equal(uf, again), "[27] the second prolongation repeats the first")
    check(float(uf[-1]) == 0.0, "[27] the trash slot reads 0")
    for k in ("gather_sum", "segment_sum"):
        check(launches[k] > 0, f"[27] the prolongation launched {k}")
    del uf, again, serial
    torch.cuda.empty_cache()
    check_restriction(kc, restr_c, "sharded coarse local (trash slot included) ",
                      "[27]", seed=270)
    check_restriction(kc, restr_f, "sharded refined fine local (trash slot included) ",
                      "[27]", seed=27)
    print(f"[27] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


#: [28]: the examples at their defaults, and ex16 on hexes (the examples'
#: one path to the fused diffusion kernel: the defaults are 2D, and the
#: ablation demo's cube is affine, so its stiffness takes the collapsed
#: lane path, as in the JAX package), each through its ``main`` in a
#: subprocess that then prints its launch counts
EXAMPLE_RUNS = (("ex1_poisson", ()), ("ex2_elasticity", ()), ("ex16_heat", ()),
           ("ex26_multigrid", ()), ("ablation_demo", ()),
           ("ex16_heat", ("-m", "inline-hex-8")))
EXAMPLE_RUN = """
import json, sys
from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg
from cardiac_ablation_ecm2_tpu_torch.ops import fused_diffusion as fd
import importlib
importlib.import_module("cardiac_ablation_ecm2_tpu_torch.examples."
                        + sys.argv[1]).main(sys.argv[2:])
print("LAUNCHES " + json.dumps(dict(
    {k: getattr(bg, k).launches for k in ("gather_sum", "gather_transpose",
                                          "segment_sum")},
    fused_diffusion=fd.diffusion_apply.launches)))
"""
#: the start of each example's last line
EXAMPLE_LAST = {"ex1_poisson": "ndof=1089  CG iters=",
               "ex2_elasticity": "ndof=102  CG iters=",
               "ex16_heat": "t=0.1000  |u|_L2=",
               "ex26_multigrid": "solutions agree: True",
               "ablation_demo": "t=  10.0s  Tmax="}


def phase_examples(kc, dev):
    """[28] the five torch example programs on the card at their defaults,
    and ex16 on hexes, run together as subprocesses: each must exit 0 and
    print its line; then the restriction kernels at their spaces' shapes
    and the fused diffusion kernel at ex16 hex-8's, against plain.
    Returns the launches summed over the six runs."""
    import os
    import sys

    from cardiac_ablation_ecm2_tpu_torch.examples.ex2_elasticity import beam_quad
    from cardiac_ablation_ecm2_tpu_torch.fem.basis import make_dof_to_quad
    from cardiac_ablation_ecm2_tpu_torch.fem.build import (
        bdr_restriction_for,
        restriction_for,
    )
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.fem.geometry import Geometry
    from cardiac_ablation_ecm2_tpu_torch.fem.quadinterp import device_basis
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import (
        make_cartesian_2d,
        make_cartesian_3d,
    )
    from cardiac_ablation_ecm2_tpu_torch.utils.config import Config

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    procs = {" ".join((name,) + args): (name, subprocess.Popen(
        [sys.executable, "-c", EXAMPLE_RUN, name, *args], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, args in EXAMPLE_RUNS}
    total = dict.fromkeys(RESTRICTION_KERNELS + ("fused_diffusion",), 0)
    hex_fd = 0
    for label, (name, p) in procs.items():
        try:
            out, err = p.communicate(timeout=300)
        finally:
            p.kill()
        lines = out.strip().splitlines()
        for line in lines[:-1]:
            print(f"[28] {label}: {line}")
        check(p.returncode == 0, f"[28] {label} exits 0 (stderr: {err[-2000:]})")
        got = json.loads(lines[-1][len("LAUNCHES "):])
        print(f"[28] {label} launches: " + ", ".join(f"{k} {v}" for k, v in got.items()))
        check(lines[-2].startswith(EXAMPLE_LAST[name]),
              f"[28] {label} prints its line")
        for k in total:
            total[k] += got[k]
        if label != name:
            hex_fd = got["fused_diffusion"]
    check(hex_fd > 0, "[28] ex16 on hexes launched fused_diffusion")
    for k in RESTRICTION_KERNELS:
        check(total[k] > 0, f"[28] the examples launched {k}")
    quad16 = make_cartesian_2d(16, 16)
    cube = make_cartesian_3d(6, 6, 6, 0.02, 0.02, 0.02)
    hex8 = make_cartesian_3d(8, 8, 8)
    for i, (what, fes) in enumerate((
            ("ex1/ex16 quad-16 order 2 ", FESpace(quad16, 2)),
            ("ex26 quad-16 order 4 ", FESpace(quad16, 4)),
            ("ex26 quad-16 order 1 ", FESpace(quad16, 1)),
            ("ex2 beam order 2 ", FESpace(beam_quad(), 2, vdim=2)),
            ("ablation demo 6^3 order 2 ", FESpace(cube, 2)),
            ("ex16 hex-8 order 2 ", FESpace(hex8, 2)))):
        check_restriction(kc, restriction_for(fes, dev), what, "[28]", seed=280 + i)
    fes = FESpace(beam_quad(), 2, vdim=2)
    check_restriction(kc, bdr_restriction_for(fes, dev), "ex2 beam boundary ",
                      "[28]", seed=286)
    rng = np.random.default_rng(28)
    nq1 = 3 + Config().quad_extra          # the examples' default quadrature
    for dtype in (torch.float32, torch.float64):
        db = device_basis(make_dof_to_quad(Geometry.CUBE, 2, nq1), dtype, dev)
        e = torch.as_tensor(rng.standard_normal((hex8.ne, 27)), dtype=dtype,
                            device=dev)
        qd = torch.as_tensor(rng.standard_normal((6, hex8.ne, nq1 ** 3)),
                             dtype=dtype, device=dev)
        check_diffusion("ex16 hex-8's shape (random)", db, qd, e, tag="[28]")
    print(f"[28] phase {time.perf_counter() - t_phase:.1f} s")
    return total


# [30]: ex10 hyperelasticity on [20]'s beam cross-section and length (x = 0
# fixed, attribute 5; the traction on x = 8, attribute 3), order 2, float64,
# JAX's solve defaults.  The traction pulls along the beam: JAX's line
# search keeps only steps that lower ||F||, and a transverse load that
# bends this 8:1 beam raises ||F|| on the first full Newton step at any
# load whose ||F0|| lies above the residual's round-off floor, so Newton
# crawls (PERF.md)
HYPER = dict(mu=1.0, kappa=10.0, fixed_bdr=(5,), force_bdr=(3,), dtype="float64")
HYPER_LOAD = (1e-2, 0.0, 0.0)
HYPER_TINY = (1e-4, 0.0, 0.0)        # the small-strain check against ex2
HYPER_SMALL = (32, 4, 4)             # its beam (cut from 64x8x8)
# the main run's beam: 48x6x6 at order 2, a cut of [20]'s 128x16x16
# (839,619 dofs), whose solve was predicted over ~120 s on one H100
# (PERF.md), and then of 96x12x12 (361,875 dofs; 75.3-114.9 s a phase):
# the vector-FE phases [38]-[42] need the time
HYPER_MAIN = (48, 6, 6)
# [31]: ex23 on [4]'s mesh; dt against h ~ 3.2e-4 gives c0 K ~ 2.5 M
WAVE = dict(c2=1.0, max_iter=500)
WAVE_DT = 1e-3


def wave_u0(x):
    """A smooth initial displacement on the cardiac box (0, L)² × (0, L/2)."""
    return (torch.sin(np.pi * x[..., 0] / L) * torch.sin(np.pi * x[..., 1] / L)
            * torch.sin(2 * np.pi * x[..., 2] / L))


def check_restriction_functions(r, label, dtype, gen):
    """[29] The restriction's autograd Functions on the card: the forward
    of each direction bitwise the kernel called directly, its backward
    bitwise the other direction's kernel, its jvp bitwise the kernel on the
    tangent; each Function call launches its kernel once."""
    from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg

    dev = r.g.device

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    def launches():
        return tuple(getattr(bg, k).launches for k in RESTRICTION_KERNELS)

    ne, nd, n = r.ne, r.nd, r.ndof
    cases = (
        # (name, Function, input, kernel on an input, adjoint kernel on a cotangent)
        ("mult", r.mult, rnd(n), lambda x: bg.gather_sum(x, r.g).view(ne, nd),
         lambda g: bg.segment_sum(g.reshape(-1), r.slots, r.offsets), 0),
        ("mult_t", r.mult_t, rnd(n), lambda x: bg.gather_transpose(x, r.gm),
         lambda g: bg.segment_sum(g.reshape(-1), r.slotsT, r.offsets), 1),
        ("mult_transpose", r.mult_transpose, rnd(ne, nd),
         lambda x: bg.segment_sum(x.reshape(-1), r.slots, r.offsets),
         lambda g: bg.gather_sum(g, r.g).view(ne, nd), 2),
        ("mult_transpose_t", r.mult_transpose_t, rnd(nd, ne),
         lambda x: bg.segment_sum(x.reshape(-1), r.slotsT, r.offsets),
         lambda g: bg.gather_transpose(g, r.gm), 2),
    )
    for name, fn, x, kern, adj, k in cases:
        b0 = launches()
        y = fn(x)
        check(launches()[k] == b0[k] + 1, f"[29] {label} {name} launched its kernel")
        check(torch.equal(bits(y), bits(kern(x))), f"[29] {label} {name} forward")
        g = rnd(*y.shape)
        xg = x.clone().requires_grad_(True)
        yg = fn(xg)
        check(yg.grad_fn is not None, f"[29] {label} {name} has a grad_fn")
        b0 = launches()
        (gx,) = torch.autograd.grad(yg, xg, g)
        kb = 2 if k < 2 else (0 if name == "mult_transpose" else 1)
        check(launches()[kb] == b0[kb] + 1, f"[29] {label} {name} backward launched")
        check(torch.equal(bits(gx), bits(adj(g))), f"[29] {label} {name} backward")
        t = rnd(*x.shape)
        b0 = launches()
        _, ty = torch.func.jvp(fn, (x,), (t,))
        check(launches()[k] == b0[k] + 2, f"[29] {label} {name} jvp launched twice")
        check(torch.equal(bits(ty), bits(kern(t))), f"[29] {label} {name} jvp")
    print(f"[29] {label} {str(dtype)[6:]}: mult, mult_t, mult_transpose, "
          f"mult_transpose_t forward, backward and jvp bitwise equal to the "
          f"kernels, one launch each, a grad_fn on every output")


def phase_restriction_derivatives(dev, spaces):
    """[29] The restriction's derivatives through the kernels at the main
    paths' shapes, a grad through them, and gradcheck in float64."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import restriction_for
    from cardiac_ablation_ecm2_tpu_torch.fem.restriction import ElementRestriction
    from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(29)
    for label, fes in spaces:
        r = restriction_for(fes, dev)
        for dtype in (torch.float32, torch.float64):
            check_restriction_functions(r, label, dtype, gen)
        torch.cuda.empty_cache()
    # a gradient through the kernels (the loss of a plain ctypes call, which
    # would leave no grad_fn, cannot come back silently)
    r = restriction_for(spaces[-1][1], dev)
    u = torch.randn(r.ndof, generator=gen, device=dev, dtype=torch.float64,
                    requires_grad=True)
    loss = (r.mult(u) ** 2).sum()
    check(loss.grad_fn is not None, "[29] the loss through mult has a grad_fn")
    b0 = bg.segment_sum.launches
    loss.backward()
    check(bg.segment_sum.launches == b0 + 1, "[29] the backward launched segment_sum")
    ref = bg.segment_sum((2 * r.mult(u.detach())).reshape(-1), r.slots, r.offsets)
    gerr = float((u.grad - ref).abs().max() / ref.abs().max())
    check(gerr == 0.0, f"[29] grad of ||R u||^2 equals R^T(2 R u) ({gerr:.1e})")
    rng = np.random.default_rng(29)
    gm = rng.integers(0, 40, (9, 8))
    gm[1, :3] = 39
    rs = ElementRestriction(gm, 40, dev)
    shapes = {"mult": (40,), "mult_t": (40,), "mult_transpose": (9, 8),
              "mult_transpose_t": (8, 9)}
    b0 = [getattr(bg, k).launches for k in RESTRICTION_KERNELS]
    for name, shape in shapes.items():
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float64,
                        requires_grad=True)
        f = getattr(rs, name)
        check(torch.autograd.gradcheck(f, (x,), check_forward_ad=True),
              f"[29] gradcheck {name}")
        check(torch.autograd.gradgradcheck(f, (x,), check_fwd_over_rev=True),
              f"[29] gradgradcheck {name}")
    got = [getattr(bg, k).launches - b for k, b in zip(RESTRICTION_KERNELS, b0)]
    check(all(n > 0 for n in got), "[29] gradcheck ran on the kernels")
    print(f"[29] grad of ||R u||^2 on the beam through the kernels: grad_fn "
          f"{type(loss.grad_fn).__name__}, equal to R^T(2 R u) bitwise; gradcheck "
          f"and gradgradcheck (reverse, forward, forward-over-reverse) in float64 "
          f"on a (9, 8) map on the card pass, kernel launches "
          + ", ".join(f"{k} {n}" for k, n in zip(RESTRICTION_KERNELS, got)))
    print(f"[29] phase {time.perf_counter() - t0:.1f} s")


def counts_close(a, b):
    """Krylov counts on two devices: equal but for round-off, within 3
    each.  A count moves under a 1e-15 relative change of an apply where
    its residual crosses the threshold slowly; the card and the CPU have
    differed by at most 2 (PERF.md, PR 13)."""
    return len(a) == len(b) and all(abs(x - y) <= 3 for x, y in zip(a, b))


def hyper_problem(fes, load, dev):
    from cardiac_ablation_ecm2_tpu_torch.models.hyperelastic import HyperelasticProblem

    return HyperelasticProblem(fes=fes, force=np.array(load), device=dev, **HYPER)


def beam_space(shape, length=8.0):
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d

    return FESpace(make_cartesian_3d(*shape, sx=length), 2, vdim=3)


def tangent_ms(prob, u):
    """Median CUDA-event ms at u of one tangent apply as ``torch.func.jvp``
    of the residual (``newton``'s default, the primal re-run each apply),
    of one apply of ``prob.tangent`` (what ``solve`` uses: one backward
    pass through the gradient's graph) and of building that graph."""
    from cardiac_ablation_ecm2_tpu_torch.linalg.newton import jacobian_action

    v = torch.ones_like(u)
    v[prob.ess] = 0.0
    J, T = jacobian_action(prob.residual, u), prob.tangent(u)
    return (time_ms(lambda: J(v), reps=5), time_ms(lambda: T(v), reps=10),
            time_ms(lambda: prob.tangent(u), reps=5))


def phase_hyperelastic(kc, dev, beam_fes):
    """[30] ex10 hyperelastic Newton (``models/hyperelastic.py``); returns
    the launches of the main solve."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import bdr_restriction_for
    from cardiac_ablation_ecm2_tpu_torch.models import elasticity

    t0 = time.perf_counter()
    small = [hyper_problem(beam_space((16, 2, 2)), HYPER_LOAD, d) for d in (dev, "cpu")]
    (ug, ig), (uc, ic) = [p.solve() for p in small]
    rel = rel_diff(ug, uc)
    check(ig.converged and rel <= 1e-10 and ig.iterations == ic.iterations
          and counts_close(ig.linear_iterations, ic.linear_iterations),
          f"[30] 16x2x2 beam: CUDA within 1e-10 of the CPU ({rel:.2e}), equal "
          f"Newton counts, CG counts within round-off ({ig} / {ic})")
    print(f"[30] 16x2x2 beam f64: CUDA vs CPU rel diff {rel:.3e}, Newton "
          f"{ig.iterations} both, CG per step {list(ig.linear_iterations)} on the "
          f"card, {list(ic.linear_iterations)} on the CPU "
          f"({time.perf_counter() - t0:.1f} s)")
    # the small-strain check against ex2 (32x4x4, cut from 64x8x8), and
    # the tangent apply's time
    fes64 = beam_space(HYPER_SMALL)
    p64 = hyper_problem(fes64, HYPER_TINY, dev)
    u64, i64 = p64.solve()
    lam = HYPER["kappa"] - 2.0 * HYPER["mu"] / 3
    lin = elasticity.solve(fes64.mesh, order=2, lam=lam, mu=HYPER["mu"],
                           fixed_bdr=HYPER["fixed_bdr"], force_bdr=HYPER["force_bdr"],
                           force=HYPER_TINY, rel_tol=1e-10, dtype="float64", device=dev)
    d_lin = lin.displacement()
    lin_rel = float(np.abs(p64.displacement(u64) - d_lin).max() / np.abs(d_lin).max())
    check(i64.converged and lin_rel < 5e-3,
          f"[30] {'x'.join(map(str, HYPER_SMALL))} small strain within 5e-3 of ex2's "
          f"solve ({lin_rel:.2e})")
    jvp64, lin64, build64 = tangent_ms(p64, u64)
    print(f"[30] {'x'.join(map(str, HYPER_SMALL))} ({fes64.ndof} dofs), traction "
          f"{HYPER_TINY}: Newton "
          f"{i64.iterations}, CG {list(i64.linear_iterations)}; within {lin_rel:.2e} "
          f"of ex2's linear elasticity (lambda = kappa - 2mu/3, CG {lin.iterations}); "
          f"tangent apply {lin64:.3f} ms (jvp of the residual {jvp64:.3f} ms, the "
          f"graph built in {build64:.3f} ms)")
    del p64, lin, fes64
    torch.cuda.empty_cache()

    start_main_path()
    t1 = time.perf_counter()
    prob = hyper_problem(beam_fes, HYPER_LOAD, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t1
    F0 = float(torch.linalg.norm(prob.residual(torch.zeros_like(prob.b))))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    u, info = prob.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t1
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    check(u.shape == (beam_fes.ndof,) and bool(torch.isfinite(u).all()),
          "[30] finite displacement of the expected shape")
    Fn = float(torch.linalg.norm(prob.residual(u)))
    jvp_ms, ms, build_ms = tangent_ms(prob, u)
    applies = sum(info.linear_iterations)
    print(f"[30] ex10 beam {'x'.join(map(str, HYPER_MAIN))} order 2 vdim 3 f64: "
          f"{beam_fes.ndof} dofs, traction {HYPER_LOAD} on x = 8; setup "
          f"{setup_s:.2f} s; Newton {info.iterations} iterations (converged "
          f"{info.converged}), CG per Newton step {list(info.linear_iterations)}; "
          f"solve {solve_s:.2f} s; tangent apply {ms:.3f} ms (CUDA events; "
          f"{applies} applies, {applies * ms / 1e3:.1f} s of the solve; the graph "
          f"built in {build_ms:.3f} ms a Newton step; as a jvp of the residual "
          f"{jvp_ms:.3f} ms); "
          f"||F|| {F0:.3e} -> {Fn:.3e} (drop {Fn / F0:.2e}); tip u_x "
          f"{float(prob.displacement(u)[:, 0].max()):.6e}; peak "
          f"{peak / 2**30:.3f} GiB; launches "
          + ", ".join(f"{k} {launches[k]}" for k in RESTRICTION_KERNELS))
    check(info.converged and Fn <= 1e-9 * F0,
          "[30] converged, final residual <= rel_tol x the initial one")
    for k in ("gather_sum", "segment_sum"):
        check(launches[k] > 0, f"[30] the Newton solve launched {k}")
    # the kernels at the tables the solve ran on: the beam's map (L->E and
    # E->L of every residual and tangent apply) and its boundary faces'
    # (the traction's linear form)
    shape = "x".join(map(str, HYPER_MAIN))
    check_restriction(kc, prob.restr, f"ex10 beam {shape} ", "[30]", seed=30)
    check_restriction(kc, bdr_restriction_for(beam_fes, dev),
                      f"ex10 beam {shape} boundary ", "[30]", seed=300)
    print(f"[30] phase {time.perf_counter() - t0:.1f} s")
    return launches, dict(shape=HYPER_MAIN, tangent_ms=ms, jvp_ms=jvp_ms, solve_s=solve_s,
                          newton=info.iterations, cg=list(info.linear_iterations))


def wave_steps(op, n, dt, T=None):
    """n Newmark steps from (wave_u0, 0); the per-step (mass, implicit) CG
    counts."""
    from cardiac_ablation_ecm2_tpu_torch.fem.gridfunction import project
    from cardiac_ablation_ecm2_tpu_torch.linalg.ode2 import select2
    from cardiac_ablation_ecm2_tpu_torch.models.wave import make_stepper

    step = make_stepper(op, select2("newmark"))
    u = project(op.fes, wave_u0, op.dtype, op.device) if T is None else T[0]
    v = torch.zeros_like(u) if T is None else T[1]
    t, counts = 0.0, []
    for _ in range(n):
        u, v, t = step(u, v, t, dt)
        counts.append((op.mass_info.iterations, op.implicit_info.iterations))
        check(op.mass_info.converged and op.implicit_info.converged,
              "wave solves converged")
    return u, v, counts


def phase_wave(kc, dev, hex_fes):
    """[31] ex23's wave equation under Newmark (``models/wave.py``) on the
    cardiac hex mesh; returns the launches of the n=126 steps."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
    from cardiac_ablation_ecm2_tpu_torch.models.wave import WaveOperator

    t0 = time.perf_counter()
    fes16 = FESpace(make_cardiac_hex_mesh(16, lengths=(L, L, L / 2),
                                          electrode_radius=0.004), 2)
    runs = []
    for d in (dev, "cpu"):
        op = WaveOperator(fes16, rel_tol=1e-10, dtype="float64", device=d, **WAVE)
        u, v, counts = wave_steps(op, 3, WAVE_DT)
        runs.append((u, counts))
    rel = rel_diff(runs[0][0], runs[1][0])
    check(rel <= 1e-10 and runs[0][1] == runs[1][1],
          f"[31] n=16: CUDA within 1e-10 of the CPU ({rel:.2e}), equal CG counts")
    print(f"[31] cardiac hex n=16 f64 ({fes16.ndof} dofs): CUDA vs CPU rel diff "
          f"{rel:.3e}, CG (mass, implicit) per step {runs[0][1]} both")
    del runs, fes16

    start_main_path()
    t1 = time.perf_counter()
    op = WaveOperator(hex_fes, rel_tol=1e-5, dtype="float32", device=dev, **WAVE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t1
    u, v, warm = wave_steps(op, 1, WAVE_DT)
    E0 = op.energy(u, v)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    u, v, counts = wave_steps(op, 3, WAVE_DT, (u, v))
    b.record()
    torch.cuda.synchronize()
    s_step = a.elapsed_time(b) / 1e3 / 3
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated()
    E3 = op.energy(u, v)
    check(u.shape == (hex_fes.ndof,) and bool(torch.isfinite(u).all())
          and bool(torch.isfinite(v).all()), "[31] finite u, v of the expected shape")
    drift = abs(E3 - E0) / abs(E0)
    print(f"[31] ex23 wave on cardiac hex n=126 order 2 f32: {hex_fes.ndof} dofs, "
          f"dt {WAVE_DT}, Newmark beta 1/4; setup {setup_s:.2f} s; s/step "
          f"{s_step:.6f} (CUDA events, 3 steps after a warm-up); CG per mass "
          f"solve {[c[0] for c in counts]}, per implicit solve "
          f"{[c[1] for c in counts]} (warm-up {warm[0]}); energy "
          f"{E0:.6e} -> {E3:.6e}, drift {drift:.2e}; peak {peak / 2**30:.3f} GiB; "
          f"launches " + ", ".join(f"{k} {launches[k]}" for k in
                                   RESTRICTION_KERNELS + ("fused_diffusion",)))
    check(drift <= 1e-3, "[31] the discrete energy kept within 1e-3")
    for k in ("gather_sum", "segment_sum", "fused_diffusion"):
        check(launches[k] > 0, f"[31] the wave steps launched {k}")
    check_restriction(kc, op.restr, "wave n=126 ", "[31]", seed=31)
    check_operator_diffusion("[31]", "wave n=126 K_qd", op)
    print(f"[31] phase {time.perf_counter() - t0:.1f} s")
    return launches, dict(s_step=s_step, cg=counts)


def both(label, fn, dev, rtol=1e-10, tag="[32]"):
    """``fn(device)`` on the card and on the CPU: every tensor it returns
    within ``rtol`` relative, every count equal (the Krylov counts that
    ``fn`` returns in ``Krylov`` or ``Newton``, inside Newton solves or on
    the ill-conditioned SIMP systems, within ``counts_close``); prints the
    seconds."""
    t0 = time.perf_counter()
    outs = []
    for d in (dev, "cpu"):
        ts, counts = fn(d)
        outs.append(([t.detach().cpu() for t in ts], counts))
    (tg, cg_), (tc, cc) = outs
    rels = [rel_diff(a, b) for a, b in zip(tg, tc)]
    rel = max(rels)

    def same(a, b):
        if isinstance(a, Krylov):
            return counts_close(a, b)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a == b

    check(rel <= rtol and same(cg_, cc), f"{tag} {label}: CUDA within {rtol:g} of "
          f"the CPU (each output: {', '.join(f'{r:.2e}' for r in rels)}), equal "
          f"counts ({cg_} / {cc})")

    def brief(c):
        if isinstance(c, Newton):
            return f"Newton {c.iterations} {list(c.linear)}"
        if isinstance(c, Krylov):
            return list(c)
        if isinstance(c, (list, tuple)) and len(c) > 12:
            return f"<{len(c)} solves, {sum(c)} iterations>"
        if isinstance(c, (list, tuple)):
            return [brief(x) for x in c]
        return c

    sides = "both" if cg_ == cc else f"on the card, {brief(cc)} on the CPU"
    print(f"{tag} {label}: rel diff {rel:.3e}, counts {brief(cg_)} {sides}, "
          f"{time.perf_counter() - t0:.2f} s")


class Krylov(tuple):
    """Krylov counts compared by ``counts_close``, not for equality."""


class Newton(tuple):
    """A Newton solve's counts: (iterations, linear counts per step)."""

    def __new__(cls, info):
        return super().__new__(cls, (info.iterations, Krylov(info.linear_iterations)))

    iterations = property(lambda self: self[0])
    linear = property(lambda self: self[1])


def _dense(d, seed, n=40, kind="nonsym"):
    rng = np.random.default_rng(seed)
    if kind == "indefinite":
        Q, _ = np.linalg.qr(rng.random((n, n)))
        A = Q @ np.diag(np.linspace(1.0, 50.0, n)) @ Q.T
        A[:10] *= -1.0
        A = 0.5 * (A + A.T)
    elif kind == "spd":
        A = rng.random((n, n))
        A = A @ A.T + n * np.eye(n)
    else:
        A = np.eye(n) * 4 + 0.3 * rng.standard_normal((n, n))
    At = torch.as_tensor(A, device=d)
    return At, torch.as_tensor(rng.standard_normal(n), device=d)


def rest_krylov(d):
    from cardiac_ablation_ecm2_tpu_torch.linalg import krylov_extra as kx
    from cardiac_ablation_ecm2_tpu_torch.linalg.newton import lbfgs

    A, b = _dense(d, 2, 30, "indefinite")
    x1, i1 = kx.minres(lambda v: A @ v, b, rel_tol=1e-11, max_iter=300)
    A, b = _dense(d, 4)
    x2, i2 = kx.bicgstab(lambda v: A @ v, b, M=lambda r: r / torch.diagonal(A),
                         rel_tol=1e-12, max_iter=300)
    state = {"k": 0}
    dg = torch.diagonal(A)

    def M(v):
        state["k"] += 1
        z = v / dg
        for _ in range(1 + state["k"] % 3):
            z = z + (v - A @ z) / dg
        return z

    x3, i3 = kx.fgmres(lambda v: A @ v, b, M=M, rel_tol=1e-12, restart=20,
                       max_iter=200)
    A, b = _dense(d, 0, 12, "spd")
    x4, i4 = lbfgs(lambda u: A @ u - b, torch.zeros_like(b), rel_tol=1e-10,
                   max_iter=100)
    return (x1, x2, x3, x4), [i.iterations for i in (i1, i2, i3, i4)]


def rest_ode2(d):
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.fem.gridfunction import project
    from cardiac_ablation_ecm2_tpu_torch.linalg.ode2 import GeneralizedAlpha2Solver, SIASolver
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.models.wave import WaveOperator

    op = WaveOperator(FESpace(make_cartesian_3d(4, 4, 4), 2), rel_tol=1e-12,
                      dtype="float64", device=d)
    u = project(op.fes, lambda x: torch.sin(np.pi * x[..., 0]) * torch.sin(
        np.pi * x[..., 1]) * torch.sin(np.pi * x[..., 2]), "float64", d)
    v, t, counts = torch.zeros_like(u), 0.0, []
    ga = GeneralizedAlpha2Solver.from_rho(0.5)
    a = ga.init(op, u, v, t)
    ua, va = u, v
    for _ in range(3):
        ua, va, a, t = ga.step(op, ua, va, a, t, 0.01)
        counts.append(op.implicit_info.iterations)

    class Separable:
        def velocity(self, t, p):
            return p

        def force(self, t, q):
            f = op.mult(t, q, None)
            counts.append(op.mass_info.iterations)
            return f

    q, p = u, torch.zeros_like(u)
    for _ in range(2):
        q, p, t = SIASolver(4).step(Separable(), q, p, t, 0.01)
    return (ua, va, q, p), counts


def rest_models(d):
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d, make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.models.eikonal import EikonalSolver
    from cardiac_ablation_ecm2_tpu_torch.models.incompressible import IncompressibleHyperelastic

    inc = IncompressibleHyperelastic(
        make_cartesian_3d(1, 1, 1), order=2, mu=1.0, device=d, dtype="float64",
        ess=[(0, [5], 0.0), (0, [3], 0.2), (1, [2], 0.0), (2, [1], 0.0)])
    x, ix = inc.solve(rel_tol=1e-9)
    eik = EikonalSolver(make_cartesian_2d(6, 6), order=2, p_schedule=(2.0, 3.0),
                        dtype="float64", device=d)
    u, _ = eik.solve()
    counts = [Newton(ix)] + [Newton(i) for i in eik.infos]
    return (x, u), counts


def rest_topopt_obstacle(d):
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.obstacle import obstacle_solve
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import Mesh, make_cartesian_2d
    from cardiac_ablation_ecm2_tpu_torch.models.topopt import TopOpt
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf

    m0 = make_cartesian_2d(12, 6)
    V = m0.vertices.copy()
    V[:, 0] *= 2.0
    to = TopOpt(Mesh(geom=m0.geom, vertices=V, elements=m0.elements,
                     attributes=m0.attributes, boundary=m0.boundary,
                     bdr_attributes=m0.bdr_attributes),
                volfrac=0.4, filter_radius=0.3, dtype="float64", device=d)
    rho, u, cgs = torch.full((to.mesh.ne,), 0.4, dtype=torch.float64, device=d), None, []
    for _ in range(3):
        rho, u, _ = to.step(rho, u)
        cgs.append(to.info.iterations)
    # SIMP's contrast (E_min 1e-4) leaves CG counts within round-off
    # (56, 54, 58 on the card against 56, 54, 57 on the CPU)
    counts = [Krylov(cgs)]
    fes = FESpace(make_cartesian_2d(12, 12), 1)
    A = BilinearForm(fes, d).add_domain_integrator("diffusion").assemble("float64")
    b = domain_lf(fes, -8.0, dtype="float64", device=d)
    fm = torch.zeros(fes.ndof, dtype=torch.float64, device=d)
    fm[torch.as_tensor(fes.essential_dofs(), device=d)] = 1.0
    uo, lam, outer = obstacle_solve(A.mult, b, torch.full_like(b, -0.08),
                                    diag=A.diagonal(), fixed_mask=fm)
    counts += [outer, list(obstacle_solve.cg_iterations)]
    return (rho, u, uo, lam), counts


def rest_spectral(d):
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg import fractional
    from cardiac_ablation_ecm2_tpu_torch.linalg.lobpcg import lobpcg
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d
    from cardiac_ablation_ecm2_tpu_torch.models.spde import sample_matern_field
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf

    fes = FESpace(make_cartesian_2d(8, 8), 2)
    A = BilinearForm(fes, d).add_domain_integrator("diffusion").assemble("float64")
    M = BilinearForm(fes, d).add_domain_integrator("mass").assemble("float64")
    m = torch.ones(fes.ndof, dtype=torch.float64, device=d)
    m[torch.as_tensor(fes.essential_dofs(), device=d)] = 0.0
    Am = lambda v: A.mult(v * m) * m + v * (1 - m)
    Mm = lambda v: M.mult(v * m) * m + v * (1 - m)
    dA, dM = A.diagonal() * m + (1 - m), M.diagonal() * m + (1 - m)
    b = domain_lf(fes, lambda x: torch.sin(np.pi * x[..., 0]) * torch.sin(np.pi * x[..., 1]),
                  dtype="float64", device=d) * m
    uf = fractional.fractional_solve(Am, Mm, dA, dM, 0.5, b, lam_min=2 * np.pi ** 2 / 4,
                                     lam_max=1e5, k=0.45)
    counts = [list(fractional.fractional_apply.cg_iterations)]
    fes1 = FESpace(make_cartesian_2d(8, 8), 1)
    w = torch.randn((fes1.mesh.ne, fes1.gather_map.shape[1], 1),
                    generator=torch.Generator().manual_seed(32), dtype=torch.float64)
    us = sample_matern_field(fes1, w, nu=0.5, ell=0.15, dtype="float64", device=d)
    X0 = torch.randn((fes.ndof, 5), generator=torch.Generator().manual_seed(0),
                     dtype=torch.float64)
    res = lobpcg(Am, lambda v: Mm(v) * m, fes.ndof, 5, precond=lambda r: r / dA,
                 iters=40, X0=X0.to(d), constraint=lambda v: v * m)
    return (uf, us, res.eigenvalues), counts


def rest_constrained(d):
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg import constrained as cs
    from cardiac_ablation_ecm2_tpu_torch.linalg.blockilu import block_ilu0
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import Mesh, make_cartesian_2d
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import boundary_lf_vector

    m0 = make_cartesian_2d(8, 8)
    V = m0.vertices.copy()
    V[:, 0] = V[:, 0] + (1.0 - V[:, 0]) * 0.3 * V[:, 1]
    fes = FESpace(Mesh(geom=m0.geom, vertices=V, elements=m0.elements,
                       attributes=m0.attributes, boundary=m0.boundary,
                       bdr_attributes=m0.bdr_attributes), 1, vdim=2)
    A = BilinearForm(fes, d).add_domain_integrator("elasticity", (1.0, 1.0)).assemble("float64")
    b = boundary_lf_vector(fes, np.array([-5e-2, 0.0]), bdr_marker=[2], dtype="float64",
                           device=d)
    B = cs.build_normal_constraints(fes, [1, 4], dtype="float64", device=d)
    dg = A.diagonal()
    xe, le, ie = cs.eliminate_constrained_solve(A.mult, B, b, M=lambda v: v / dg,
                                                rel_tol=1e-12, max_iter=4000)
    xs, ls, is_ = cs.schur_constrained_solve(A.mult, B, b, Adiag=dg, rel_tol=1e-12,
                                             max_iter=8000)
    xp, lp, ip = cs.penalty_constrained_solve(A.mult, B, b, penalty=1e4,
                                              M=lambda v: v / dg, rel_tol=1e-12,
                                              max_iter=8000)
    # BlockILU(0) as a preconditioner: the 2D grid of 3x3 blocks
    rng = np.random.default_rng(2)
    nx, bs = 5, 3
    n = nx * nx * bs
    Ad = np.zeros((n, n))
    for i in range(nx):
        for j in range(nx):
            k = i * nx + j
            q = rng.standard_normal((bs, bs))
            Ad[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs] = q @ q.T + 8 * np.eye(bs)
            for (i2, j2) in ((i + 1, j), (i, j + 1)):
                if i2 < nx and j2 < nx:
                    k2 = i2 * nx + j2
                    o = 0.6 * rng.standard_normal((bs, bs))
                    Ad[k * bs:(k + 1) * bs, k2 * bs:(k2 + 1) * bs] = o
                    Ad[k2 * bs:(k2 + 1) * bs, k * bs:(k + 1) * bs] = o.T
    rows, cols, blocks = [], [], []
    for i in range(nx * nx):
        for j in range(nx * nx):
            blk = Ad[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs]
            if np.any(blk != 0):
                rows.append(i)
                cols.append(j)
                blocks.append(blk)
    P = block_ilu0(np.stack(blocks), np.array(rows), np.array(cols), nx * nx,
                   dtype="float64", device=d)
    At = torch.as_tensor(Ad, device=d)
    xb, ib = cg(lambda v: At @ v, torch.as_tensor(rng.standard_normal(n), device=d),
                M=P.apply, rel_tol=1e-10, max_iter=500)
    # MINRES on the saddle point to 1e-12 counts within round-off (125 on
    # the card against 124 on the CPU)
    return (xe, le, xs, xp, xb), [ie.iterations, Krylov([is_.iterations]),
                                  ip.iterations, ib.iterations]


def rest_navier(d):
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.models.navier import NavierSolver

    def u0(x):
        x = np.asarray(x)
        return np.stack([np.sin(np.pi * x[..., 0]) ** 2 * np.sin(2 * np.pi * x[..., 1]),
                         -np.sin(2 * np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]) ** 2,
                         0 * x[..., 0]], axis=-1)

    ns = NavierSolver(make_cartesian_3d(4, 4, 2), order=2, kin_vis=0.05,
                      vel_bc=lambda x: np.zeros(np.asarray(x).shape[:-1] + (3,)),
                      dtype="float64", device=d)
    u, p = ns.initial_state(u0)
    hist, counts = (u,), []
    for i in range(3):
        u, p = ns._make_step(0.005, min(i + 1, 2))(hist, p, ns.u_bc, ns.b_f)
        counts.append([info.iterations for info in ns.last_infos])
        hist = (u, hist[0])
    return (u, p), counts


REST = (("minres, bicgstab, fgmres, lbfgs (dense, the JAX tests' systems)", rest_krylov),
        ("GeneralizedAlpha2Solver (rho 0.5) and SIASolver (order 4) on the wave "
         "operator, 4^3 hexes order 2", rest_ode2),
        ("incompressible (one hex, uniaxial 1.2, GMRES) and eikonal (6x6, p = 2, 3)",
         rest_models),
        ("topopt (12x6, three OC steps) and obstacle_solve (12x12)", rest_topopt_obstacle),
        ("fractional_solve, sample_matern_field (given draws), lobpcg (given X0), "
         "8x8", rest_spectral),
        ("eliminate / schur / penalty constrained solves (ex28 trapezoid) and "
         "BlockILU-PCG", rest_constrained),
        ("navier 3D (4x4x2 order 2, three steps)", rest_navier))


def phase_rest(dev):
    """[32] the rest of the slice on the card against the CPU; returns the
    launches of the card's runs."""
    t0 = time.perf_counter()
    start_main_path()
    for label, fn in REST:
        both(label, fn, dev)
    launches = main_path_launches()
    print(f"[32] launches on the card's runs: "
          + ", ".join(f"{k} {launches[k]}" for k in
                      RESTRICTION_KERNELS + ("fused_diffusion",)))
    for k in ("gather_sum", "segment_sum", "fused_diffusion"):
        check(launches[k] > 0, f"[32] the card's runs launched {k}")
    print(f"[32] phase {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# [33]-[37]: DG, static condensation and complex forms
# ---------------------------------------------------------------------------

#: [33] / [34]: the 48³ unit cube
DG_N = 48
#: [33]: RK3-SSP steps and step; [35] runs the first DG_PAR_STEPS
DG_STEPS, DG_DT, DG_PAR_STEPS = 100, 1e-3, 10
#: [34]: the SIPG solve's tolerance and cap (~15·n Jacobi-PCG steps at n³,
#: order 2, on a CPU rehearsal up to n = 16)
SIPG_TOL, SIPG_MAX_ITER = 1e-6, 10_000
#: the kernels of the DG paths
DG_KERNELS = ("take_rows", "segment_sum", "gather_sum", "gather_transpose",
              "fused_diffusion")


def dg_velocity(x):
    """(1, 0.5, 0.25), or (1, 0.5) in 2D."""
    v = torch.zeros_like(x)
    v[..., 0], v[..., 1] = 1.0, 0.5
    if x.shape[-1] == 3:
        v[..., 2] = 0.25
    return v


def dg_pulse(x):
    """The root ex9 example's Gaussian pulse, centred at (0.3, 0.3, 0.3)."""
    return torch.exp(-sum((x[..., i] - 0.3) ** 2 for i in range(3)) / 0.005)


def dg_zero(x):
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def dg_one(x):
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


def dg_launches():
    got = main_path_launches()
    return {k: got[k] for k in DG_KERNELS}


def rk3_steps(op, u, n, t=0.0, dt=DG_DT):
    from cardiac_ablation_ecm2_tpu_torch.linalg import ode

    solver = ode.select("rk3_ssp")
    for _ in range(n):
        u, t = solver.step(op, u, t, dt)
    return u


def check_face_route(kc, F, tag, label, seed, timed=False, tables=()):
    """``take_rows`` at every face group of the ``FaceSum`` ``F`` (on seeded
    random element arrays, and on each (name, table) of ``tables``, rows
    read by the path such as BR2's mass inverses) and ``segment_sum`` at
    every slot list ``F`` built (the apply's, a right-hand side's),
    bitwise against their plain versions, float32 and float64; with
    ``timed`` the float32 interior-face read and the apply's sum are timed
    against plain and the library calls (``index_select``,
    ``index_add_``)."""
    from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg
    from cardiac_ablation_ecm2_tpu_torch.ops import gather_probes as gp

    gen = torch.Generator(device=kc.dev).manual_seed(seed)
    full = (True,) * len(F.idx)
    F.slots(full)
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype)[6:]
        t = timed and dtype == torch.float32
        u = torch.randn(F.ne, F.width, generator=gen, device=kc.dev, dtype=dtype)
        es = u.element_size()
        for name, table in (("", u),) + tuple(tables):
            table = table.to(dtype).reshape(table.shape[0], -1).contiguous()
            for g in range(1, len(F.idx)):
                idx = F.idx[g]
                if idx.numel() == 0:           # world 1 has no cross faces
                    continue
                rows = idx.long()
                least = idx.numel() * (4 + 2 * table.shape[1] * es)
                kc.compare("take_rows", f"{label} {name}face group {g} {dt}", gp.take_rows,
                           gp.take_rows_plain, (table, idx), tag=tag,
                           library=lambda: table.index_select(0, rows),
                           **(dict(least=least) if t and g == 1 and not name else {}))
        for present, (slots, offsets) in F.slot_lists.items():
            nseg, nslot = offsets.numel() - 1, slots.numel()
            src = torch.randn(nslot, generator=gen, device=kc.dev, dtype=dtype)
            timed_sum = t and present == full
            extra = {}
            if timed_sum:
                target = torch.empty(nslot, dtype=torch.int64, device=kc.dev)
                target[slots.long()] = torch.repeat_interleave(
                    torch.arange(nseg, device=kc.dev), offsets[1:] - offsets[:-1])
                extra = dict(least=nslot * (4 + es) + (nseg + 1) * 8 + nseg * es,
                             library=lambda: torch.zeros(
                                 nseg, dtype=src.dtype, device=src.device).index_add_(
                                     0, target, src))
            what = "face sum" if present == full else "face sum " + "".join(
                "1" if p else "0" for p in present)
            kc.compare("segment_sum", f"{label} {what} {dt}", bg.segment_sum,
                       bg.segment_sum_plain, (src, slots, offsets), tag=tag, **extra)
            del src
        del u
    torch.cuda.empty_cache()


def dg_mass(op, u):
    """∫u (float64 sums of the float32 or float64 values)."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import geom_factors_for
    from cardiac_ablation_ecm2_tpu_torch.fem.quadinterp import eval_values

    gf = geom_factors_for(op.fes, op.db.nq1d, op.dtype, op.device)
    uq = eval_values(op.db, u.view(op.ne, -1))
    return float((gf.wdet.double() * uq.double()).sum())


def phase_dg_advection(kc, dev):
    """[33] DG advection on the 48³ cube, order 3; returns the space, the
    launches, the serial float32 state after DG_PAR_STEPS steps and the
    kernels line's numbers."""
    import copy

    from cardiac_ablation_ecm2_tpu_torch.fem.build import face_data_for
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import L2FESpace
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_advection import DGAdvection, project_l2

    t_phase = time.perf_counter()
    small = L2FESpace(make_cartesian_3d(12, 12, 12), 3)
    outs = []
    for d in (dev, "cpu"):
        op = DGAdvection(small, dg_velocity, inflow=dg_zero, nq1d=4,
                         dtype="float64", device=d)
        outs.append(rk3_steps(op, project_l2(small, dg_pulse, "float64", d), 5).cpu())
    rel = rel_diff(outs[0], outs[1])
    check(rel <= 1e-12, f"[33] 12^3 order 3 f64: CUDA within 1e-12 of the CPU ({rel:.2e})")
    print(f"[33] 12^3 order 3 f64 ({small.ndof} dofs), 5 RK3 steps: CUDA vs CPU "
          f"rel diff {rel:.3e}")

    mesh = make_cartesian_3d(DG_N, DG_N, DG_N)
    fes = L2FESpace(mesh, 3)
    check((mesh.ne, fes.ndof) == (110_592, 7_077_888), "[33] 48^3 order 3 sizes")
    t0 = time.perf_counter()
    fd = face_data_for(fes, 4)
    host_s = time.perf_counter() - t0
    check((len(fd.elem0), len(fd.b_elem)) == (324_864, 13_824), "[33] face counts")
    del fd
    start_main_path()
    t0 = time.perf_counter()
    op = DGAdvection(fes, dg_velocity, inflow=dg_zero, nq1d=4, dtype="float32",
                     device=dev)
    u0 = project_l2(fes, dg_pulse, "float32", dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    u = rk3_steps(op, u0, 1)                           # warm-up step
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    u = u0
    a.record()
    u = rk3_steps(op, u, DG_PAR_STEPS)
    u_par = u.clone()
    u = rk3_steps(op, u, DG_STEPS - DG_PAR_STEPS, t=DG_PAR_STEPS * DG_DT)
    b.record()
    b.synchronize()
    s_step = a.elapsed_time(b) / 1e3 / DG_STEPS
    launches = dg_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_mult = time_ms(lambda: op.mult(0.0, u), reps=10)
    check(u.shape == (fes.ndof,) and bool(torch.isfinite(u).all()),
          "[33] finite u of the expected shape")
    m0, m1 = dg_mass(op, u0), dg_mass(op, u)
    check(abs(m1 - m0) <= 1e-4 * abs(m0), f"[33] integral of u kept to 1e-4 "
          f"({m0:.9e} -> {m1:.9e})")
    ones = copy.copy(op)
    ones.g_in = torch.ones_like(op.g_in)
    one = rk3_steps(ones, torch.ones(fes.ndof, device=dev), DG_PAR_STEPS)
    fs = float((one - 1.0).abs().max())
    for k in ("take_rows", "segment_sum"):
        check(launches[k] > 0, f"[33] the DG steps launched {k}")
    print(f"[33] DG advection 48^3 order 3 nq1d 4 f32: {mesh.ne} hexes, {fes.ndof} "
          f"dofs, 324,864 interior + 13,824 boundary faces; host face tables "
          f"{host_s:.2f} s, device setup {setup_s:.2f} s")
    print(f"[33] {DG_STEPS} RK3-SSP steps dt {DG_DT}: s/step {s_step:.6f} (CUDA "
          f"events), ms per mult {ms_mult:.4f}, peak {peak:.3f} GiB; launches "
          f"take_rows {launches['take_rows']}, segment_sum {launches['segment_sum']}, "
          f"gather_sum {launches['gather_sum']}")
    print(f"[33] integral of u {m0:.9e} -> {m1:.9e} (rel {abs(m1 - m0) / abs(m0):.2e}), "
          f"max u {float(u.max()):.6f}; free stream in float32 max|u - 1| "
          f"{fs:.2e} after {DG_PAR_STEPS} steps")
    del ones
    op64 = DGAdvection(fes, dg_velocity, inflow=dg_zero, nq1d=4, dtype="float64",
                       device=dev)
    u64 = rk3_steps(op64, project_l2(fes, dg_pulse, "float64", dev), DG_STEPS)
    d64 = float((u.double() - u64).abs().max() / u64.abs().max())
    ones64 = copy.copy(op64)
    ones64.g_in = torch.ones_like(op64.g_in)
    one = rk3_steps(ones64, torch.ones(fes.ndof, dtype=torch.float64, device=dev),
                    DG_PAR_STEPS)
    fs64 = float((one - 1.0).abs().max())
    check(fs64 <= 1e-5, f"[33] float64: u = 1 with inflow 1 kept to 1e-5 ({fs64:.2e})")
    check(d64 <= 1e-4, f"[33] float32 within 1e-4 max|u| of float64 ({d64:.2e})")
    print(f"[33] float32 vs float64 run: {d64:.3e} of max|u|; free stream in "
          f"float64 max|u - 1| {fs64:.2e} after {DG_PAR_STEPS} steps")
    del op64, u64, ones64, one
    y1, y2 = op.mult(0.0, u), op.mult(0.0, u)
    check(torch.equal(y1, y2), "[33] two applies bitwise equal")
    check_face_route(kc, op.faces, "[33]", "48^3 order 3", seed=33, timed=True)
    numbers = {k: kc.times[f"48^3 order 3 {w} float32"] for k, w in (
        ("take_rows", "face group 1"), ("segment_sum", "face sum"))}
    del op, u, u0, y1, y2
    torch.cuda.empty_cache()
    print(f"[33] phase {time.perf_counter() - t_phase:.1f} s")
    return fes, launches, u_par, numbers


class plain_kernels:
    """Within the block, the DG face route and the diffusion apply take
    the kernels' plain versions (on CUDA tensors too)."""

    def __enter__(self):
        from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg
        from cardiac_ablation_ecm2_tpu_torch.ops import diffusion as dmod
        from cardiac_ablation_ecm2_tpu_torch.ops import face_sum
        from cardiac_ablation_ecm2_tpu_torch.ops import fused_diffusion as fd
        from cardiac_ablation_ecm2_tpu_torch.ops import gather_probes as gp

        self.saved = [(face_sum, "take_rows", gp.take_rows_plain),
                      (face_sum, "segment_sum", bg.segment_sum_plain),
                      (dmod, "diffusion_apply", fd.diffusion_apply_plain)]
        self.saved = [(m, n, getattr(m, n), f) for m, n, f in self.saved]
        for m, n, _, f in self.saved:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for m, n, old, _ in self.saved:
            setattr(m, n, old)


def sipg_rhs(op, f=1.0):
    """∫ f v + the weak Dirichlet g = 0 terms."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import geom_factors_for
    from cardiac_ablation_ecm2_tpu_torch.fem.quadinterp import eval_values_t

    gf = geom_factors_for(op.fes, op.db.nq1d, op.dtype, op.device)
    return (eval_values_t(op.db, gf.wdet * f).reshape(-1)
            + op.dirichlet_rhs(dg_zero))


def phase_sipg(kc, dev):
    """[34] SIPG Poisson on the 48³ cube, order 2; returns the space, the
    launches, the CG count and the solution."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import face_data_for
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import L2FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_diffusion import DGDiffusion, DGDiffusionBR2
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    t_phase = time.perf_counter()
    fes = L2FESpace(make_cartesian_3d(DG_N, DG_N, DG_N), 2)
    check(fes.ndof == 2_985_984, "[34] 48^3 order 2: 2,985,984 dofs")
    t0 = time.perf_counter()
    face_data_for(fes, 3, with_gradients=True)
    host_s = time.perf_counter() - t0
    start_main_path()
    t0 = time.perf_counter()
    op = DGDiffusion(fes, kappa=1.0, penalty=10.0, nq1d=3, dtype="float32", device=dev)
    A = op.operator()
    b = sipg_rhs(op)
    diag = A.diagonal()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = cg(A.mult, b, M=lambda r: r / diag, rel_tol=SIPG_TOL,
                 max_iter=SIPG_MAX_ITER)
    solve_s = elapsed(t0, dev)
    launches = dg_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(info.converged and x.shape == (fes.ndof,) and bool(torch.isfinite(x).all()),
          "[34] converged, finite u of the expected shape")
    for k in ("take_rows", "segment_sum", "fused_diffusion"):
        check(launches[k] > 0, f"[34] the SIPG solve launched {k}")
    # the float32 iterate's true residual stalls far above 1e-5 (x in
    # float32 alone leaves eps32·‖A‖‖x‖; 4.6e-4 at 16³ on a CPU rehearsal):
    # the residual bound is held on the same solve in float64, and the
    # float32 solution to the float64 one
    op64 = DGDiffusion(fes, kappa=1.0, penalty=10.0, nq1d=3, dtype="float64",
                       device=dev)
    b64 = sipg_rhs(op64)
    d64 = op64.diagonal()
    t0 = time.perf_counter()
    x64, info64 = cg(op64.mult, b64, M=lambda r: r / d64, rel_tol=SIPG_TOL,
                     max_iter=SIPG_MAX_ITER)
    s64 = elapsed(t0, dev)
    res = float(torch.linalg.norm(b64 - op64.mult(x64)) / torch.linalg.norm(b64))
    res32 = float(torch.linalg.norm(b64 - op64.mult(x.double())) / torch.linalg.norm(b64))
    dx = float((x.double() - x64).abs().max() / x64.abs().max())
    del op64, b64, d64, x64
    check(info64.converged and res <= 1e-5,
          f"[34] float64 solve: true relative residual <= 1e-5 ({res:.2e})")
    check(dx <= 1e-4, f"[34] float32 solution within 1e-4 max|u| of float64 ({dx:.2e})")
    print(f"[34] SIPG Poisson 48^3 order 2 nq1d 3 f32, f = 1, g = 0, penalty 10: "
          f"{fes.ndof} dofs; host face tables {host_s:.2f} s, device setup "
          f"{setup_s:.2f} s; Jacobi-PCG to {SIPG_TOL:g}: {info.iterations} "
          f"iterations in {solve_s:.3f} s ({solve_s / info.iterations * 1e3:.3f} ms "
          f"each), peak {peak:.3f} GiB; its true relative residual {res32:.3e} "
          f"(float64 evaluation)")
    print(f"[34] the same solve in float64: {info64.iterations} iterations in "
          f"{s64:.3f} s, true relative residual {res:.3e}; the float32 solution "
          f"{dx:.3e} of max|u| off it")
    print(f"[34] launches: " + ", ".join(f"{k} {launches[k]}" for k in DG_KERNELS))
    gen = torch.Generator(device=dev).manual_seed(34)
    e = torch.randn(fes.mesh.ne, fes.nd_elem, generator=gen, device=dev)
    check_diffusion("SIPG 48^3 order 2 volume qdata", op.db, op.vol_qd, e, tag="[34]")
    check(torch.equal(A.mult(x), A.mult(x)), "[34] two applies bitwise equal")
    check_face_route(kc, op.faces, "[34]", "48^3 order 2", seed=340)
    del op, A, b, diag, e
    # BR2: the float32 apply timed; the apply held to its plain path in
    # float64 (in float32 fused_diffusion's rounding, 2e-7 of the volume
    # term, is 4.4e-5 of the cancelling sum at this size)
    br = DGDiffusionBR2(fes, kappa=1.0, nq1d=3, dtype="float32", device=dev)
    br_ms = time_ms(lambda: br.mult(x), reps=5)
    del br
    br = DGDiffusionBR2(fes, kappa=1.0, nq1d=3, dtype="float64", device=dev)
    y = br.mult(x.double())
    with plain_kernels():
        y_plain = br.mult(x.double())
    d = float((y - y_plain).abs().max() / y_plain.abs().max())
    check(d <= 1e-10, f"[34] BR2 apply within 1e-10 of its plain path ({d:.2e})")
    check_face_route(kc, br.faces, "[34]", "BR2 48^3 order 2", seed=341,
                     tables=(("M^-1 rows ", br.Minv),))
    print(f"[34] BR2 apply (eta {br.eta:g}) at 2,985,984 dofs: float32 {br_ms:.3f} ms; "
          f"float64 {d:.3e} of max|y| off its plain path")
    del br, y, y_plain
    torch.cuda.empty_cache()
    print(f"[34] phase {time.perf_counter() - t_phase:.1f} s")
    return fes, launches, info.iterations, x


def _par_dg_rank(rank, world, d, adv_fes, sipg_fes):
    """[35]'s rank body: [33]'s problem for DG_PAR_STEPS steps and [34]'s
    SIPG solve, sharded."""
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_advection import project_l2
    from cardiac_ablation_ecm2_tpu_torch.parallel import dg as pdg

    t0 = time.perf_counter()
    par = pdg.setup(adv_fes, dg_velocity, inflow=dg_zero, nq1d=4, dtype="float32",
                    device=d)
    u = par.scatter(project_l2(adv_fes, dg_pulse, "float32", d))
    u = rk3_steps(par, u, DG_PAR_STEPS)
    s = pdg.setup_sipg(sipg_fes, kappa=1.0, penalty=10.0, g=dg_zero, f_rhs=dg_one,
                       nq1d=3, dtype="float32", device=d)
    x, info = s.solve(rel_tol=SIPG_TOL, max_iter=SIPG_MAX_ITER)
    torch.cuda.synchronize()
    return (par.gather(u), s.gather(x), info.iterations, time.perf_counter() - t0,
            (par.faces, s.faces))


def phase_par_dg(kc, dev, adv_fes, u_ser, sipg_fes, sipg_its, x_ser):
    """[35] parallel/dg at world size 1 over NCCL against [33] and [34];
    then the ranks' face reads and sums bitwise against plain."""
    from cardiac_ablation_ecm2_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    start_main_path()
    u, x, its, secs, faces = launch.run_single(
        lambda r, w, d: _par_dg_rank(r, w, d, adv_fes, sipg_fes))
    launches = dg_launches()
    du = float(np.abs(u - u_ser.double().cpu().numpy()).max() / float(u_ser.abs().max()))
    dx = float(np.abs(x - x_ser.double().cpu().numpy()).max() / float(x_ser.abs().max()))
    check(du <= 1e-6, f"[35] sharded advection within 1e-6 of the serial ({du:.2e})")
    check(its == sipg_its, f"[35] sharded SIPG takes the serial CG count ({its}, "
          f"{sipg_its})")
    for k in ("take_rows", "segment_sum", "fused_diffusion"):
        check(launches[k] > 0, f"[35] the sharded runs launched {k}")
    print(f"[35] parallel/dg, world 1 over NCCL: {DG_PAR_STEPS} steps of [33] within "
          f"{du:.3e} of the serial, SIPG {its} CG (serial {sipg_its}), u {dx:.3e} off; "
          f"{secs:.1f} s in the rank; launches " + ", ".join(
              f"{k} {launches[k]}" for k in DG_KERNELS))
    for F, what in zip(faces, ("sharded 48^3 order 3", "sharded 48^3 order 2")):
        check_face_route(kc, F, "[35]", what, seed=350)
    del faces
    print(f"[35] phase {time.perf_counter() - t0:.1f} s")
    return launches


def _masked(op, mask):
    return lambda v: op(v * (1 - mask)) * (1 - mask) + v * mask


def ex22_solve(n, dev, order=2, omega=2.0, sigma=1.0):
    """ex22 problem 0 on n × n quads, Hermitian, float64: (L2 error, GMRES
    iterations, seconds, complex dofs)."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import gmres
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d
    from cardiac_ablation_ecm2_tpu_torch.ops import complex_fem as cf
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    fes = FESpace(make_cartesian_2d(n, n), order)
    amp = 1.0 + 0.5j
    lam = 2 * np.pi ** 2 - omega ** 2 + 1j * omega * sigma
    s = lambda x: torch.sin(np.pi * x[..., 0]) * torch.sin(np.pi * x[..., 1])
    kw = dict(dtype="float64", device=dev)
    sq = cf.SesquilinearForm(fes, device=dev)
    sq.add_domain_integrator("diffusion", 1.0, None)
    sq.add_domain_integrator("mass", -omega ** 2, omega * sigma)
    A = sq.assemble("float64")
    b = cf.cstack(domain_lf(fes, lambda x: (lam * amp).real * s(x), **kw),
                  domain_lf(fes, lambda x: (lam * amp).imag * s(x), **kw))
    ess = fes.essential_dofs([1, 2, 3, 4])
    Ac, B = cf.form_complex_linear_system(A, ess, torch.zeros_like(b), b)
    mask = torch.zeros(fes.ndof, dtype=torch.float64, device=dev)
    mask[torch.as_tensor(ess, dtype=torch.int64, device=dev)] = 1.0
    M = cf.complex_jacobi(A, ess_mask=mask)
    t0 = time.perf_counter()
    z, info = gmres(Ac.mult, B, M=M, rel_tol=1e-12, max_iter=4000, restart=200)
    secs = elapsed(t0, dev)
    check(info.converged and bool(torch.isfinite(z).all()), f"[36] ex22 {n}^2 converged")
    u = cf.ComplexGridFunction.from_vec(fes, z)
    err = u.l2_error(lambda x: amp.real * s(x), lambda x: amp.imag * s(x))
    return err, info.iterations, secs, fes.ndof


def phase_condense_complex(kc, dev):
    """[36] static condensation of order-4 Poisson on 32³ and ex22 problem
    0 on 256² and 512² quads; returns the condensed solve's launches."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import restriction_for
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
    from cardiac_ablation_ecm2_tpu_torch.ops.condense import (
        StaticCondensation,
        element_matrices,
    )
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fes = FESpace(make_cartesian_3d(32, 32, 32), 4)
    host_s = time.perf_counter() - t0
    check(fes.ndof == 2_146_689, "[36] 32^3 order 4: 2,146,689 dofs")
    kw = dict(dtype=torch.float64, device=dev)
    b = domain_lf(fes, lambda x: torch.sin(x[..., 0]) + x[..., 1] * x[..., 2], **kw)
    ess = torch.as_tensor(fes.essential_dofs(None), dtype=torch.int64, device=dev)
    mask = torch.zeros(fes.ndof, **kw)
    mask[ess] = 1.0
    A = BilinearForm(fes, dev).add_domain_integrator("diffusion").assemble("float64")
    dA = torch.where(mask > 0, 1.0, A.diagonal())
    t0 = time.perf_counter()
    x_full, info_full = cg(_masked(A.mult, mask), b * (1 - mask), M=lambda r: r / dA,
                           rel_tol=1e-12, max_iter=20_000)
    full_s = elapsed(t0, dev)
    del A, dA
    start_main_path()
    t0 = time.perf_counter()
    sc = StaticCondensation(fes, element_matrices(fes, diffusion_coeff=1.0, **kw))
    sc.A_e = None                                   # the (ne, nd, nd) matrices
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    smask = torch.zeros(sc.n_iface, **kw)
    smask[torch.as_tensor(sc.essential_dofs(None), dtype=torch.int64, device=dev)] = 1.0
    dS = torch.where(smask > 0, 1.0, sc.diagonal())
    t0 = time.perf_counter()
    xf, info = cg(_masked(sc.mult, smask), sc.reduce_rhs(b) * (1 - smask),
                  M=lambda r: r / dS, rel_tol=1e-12, max_iter=20_000)
    x_cond = sc.recover(xf, b)
    cond_s = elapsed(t0, dev)
    launches = dg_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    err = float((x_full - x_cond).abs().max() / x_full.abs().max())
    check(sc.n_iface == 1_261_953, "[36] 1,261,953 interface dofs")
    check(info.converged and info_full.converged, "[36] both solves converged")
    check(err <= 1e-8, f"[36] condensed solve within 1e-8 max|u| of the full ({err:.2e})")
    for k in ("gather_sum", "segment_sum"):
        check(launches[k] > 0, f"[36] the condensed solve launched {k}")
    print(f"[36] condensed Poisson 32^3 order 4 f64: {fes.ndof} dofs, {sc.n_iface} on "
          f"the interface; host FESpace {host_s:.2f} s; uncondensed Jacobi-PCG "
          f"{info_full.iterations} CG in {full_s:.3f} s; condensation setup "
          f"{setup_s:.2f} s, condensed {info.iterations} CG + recovery in "
          f"{cond_s:.3f} s, {err:.3e} of max|u| off the full solve, peak "
          f"{peak:.3f} GiB; launches " + ", ".join(f"{k} {launches[k]}"
                                                   for k in DG_KERNELS))
    check_restriction(kc, sc.r_f, "condensed interface ", "[36]", seed=36)
    del sc, x_full, x_cond, xf, b, mask, smask, dS
    restriction_for(fes, dev)
    fes.__dict__.pop("_restrictions", None)
    fes.__dict__.pop("_geom_factors", None)
    torch.cuda.empty_cache()
    errs = {}
    for n in (256, 512):
        err, its, secs, ndof = ex22_solve(n, dev)
        errs[n] = err
        print(f"[36] ex22 problem 0, {n}^2 quads order 2 f64 (Hermitian): {ndof} "
              f"complex dofs, Jacobi-GMRES(200) {its} iterations in {secs:.3f} s, "
              f"L2 error {err:.6e}")
        torch.cuda.empty_cache()
    rate = float(np.log2(errs[256] / errs[512]))
    check(rate >= 2.6, f"[36] ex22 L2 rate 256^2 -> 512^2 >= 2.6 ({rate:.3f})")
    print(f"[36] ex22 L2 rate {rate:.3f}")
    print(f"[36] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def rest_dg(d, keep):
    """[37]'s cases, each fn() -> (tensors, counts) on device ``d``;
    ``keep(op)`` is given each DG operator built."""
    from cardiac_ablation_ecm2_tpu_torch.fem import estimators
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace, L2FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg import ode
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d
    from cardiac_ablation_ecm2_tpu_torch.models.advection_diffusion import (
        DGAdvectionDiffusion,
    )
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_advection import project_l2
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_diffusion import DGDiffusionBR2
    from cardiac_ablation_ecm2_tpu_torch.ops.dg_elasticity import DGElasticity
    from cardiac_ablation_ecm2_tpu_torch.ops.hyperbolic import HyperbolicDG

    kw = dict(dtype=torch.float64, device=d)
    sines = lambda x: 2 * np.pi ** 2 * torch.sin(np.pi * x[..., 0]) * torch.sin(
        np.pi * x[..., 1])

    def br2():
        fes = L2FESpace(make_cartesian_2d(8, 8), 2)
        op = keep(DGDiffusionBR2(fes, **kw))
        from cardiac_ablation_ecm2_tpu_torch.fem.build import geom_factors_for
        from cardiac_ablation_ecm2_tpu_torch.fem.quadinterp import eval_values_t

        gf = geom_factors_for(fes, None, "float64", d)
        b = eval_values_t(op.db, gf.wdet * sines(gf.x)).reshape(-1) + op.dirichlet_rhs(
            lambda x: torch.zeros(x.shape[:-1], dtype=x.dtype))
        dg = op.diagonal()
        x, info = cg(op.mult, b, M=lambda r: r / dg, rel_tol=1e-11, max_iter=4000)
        return [x], Krylov([info.iterations])

    def elasticity():
        fes = L2FESpace(make_cartesian_2d(4, 4), 2)
        A = keep(DGElasticity(fes, lam=1.5, mu=1.0, **kw))
        b = A.dirichlet_rhs(lambda x: torch.stack(
            [0.3 * x[..., 0] - 0.2 * x[..., 1] + 0.1, 0.5 * x[..., 1] + 0.4 * x[..., 0]], -1))
        dg = A.diagonal()
        u, info = cg(A.mult, b, M=lambda r: r / dg, rel_tol=1e-13, max_iter=6000)
        return [u], Krylov([info.iterations])

    def hyperbolic():
        out = []
        for law, n in (("burgers", 24), ("euler", 6)):
            fes = L2FESpace(make_cartesian_2d(n, 4 if law == "burgers" else n,
                                              2.0 if law == "burgers" else 1.0,
                                              0.2 if law == "burgers" else 1.0), 1)
            op = keep(HyperbolicDG(fes, law=law, **kw))
            if law == "burgers":
                u = project_l2(fes, lambda x: 0.5 + 0.4 * torch.sin(np.pi * x[..., 0]), **kw)
            else:                        # density ripples at pressure 1
                rho = 1.0 + 0.1 * torch.arange(fes.ndof, **kw).remainder(7) / 7
                E = 1.0 / 0.4 + 0.5 * rho * 0.13
                u = torch.stack([rho, 0.3 * rho, 0.2 * rho, E], -1).reshape(-1)
            out.append(rk3_steps(op, u, 5, dt=0.005))
        return out, 0

    def imex():
        fes = L2FESpace(make_cartesian_2d(12, 12), 1)
        op = DGAdvectionDiffusion(fes, dg_velocity, epsilon=5e-3, rel_tol=1e-12, **kw)
        keep(op.adv)
        keep(op.dif)
        u = project_l2(fes, lambda x: torch.exp(-((x[..., 0] - 0.4) ** 2
                                                  + (x[..., 1] - 0.5) ** 2) / 0.01), **kw)
        step = ode.select("imex_rk2")
        t = 0.0
        for _ in range(4):
            u, t = step.step(op, u, t, 0.01)
        return [u], Krylov(op.cg_iterations)

    def estimates():
        fes = FESpace(make_cartesian_2d(16, 16), 2)
        u = torch.as_tensor(np.sin(3 * fes.dof_coords[:, 0]) * np.exp(fes.dof_coords[:, 1]),
                            device=d)
        return [torch.as_tensor(f(fes, u)) for f in (
            estimators.zz_estimator, estimators.kelly_estimator,
            estimators.lszz_estimator)], 0

    return br2, elasticity, hyperbolic, imex, estimates


REST_DG = ("BR2 Poisson 8x8 order 2", "DG elasticity 4x4 order 2",
           "Burgers 24x4 and Euler 6x6, 5 RK3 steps", "IMEX advection-diffusion 12x12",
           "ZZ, Kelly and LSZZ estimators 16x16")


def phase_rest_dg(kc, dev):
    """[37] the rest of the DG modules on the card against the CPU, then every
    face table of the card's operators bitwise against plain; returns the
    launches of the card's runs."""
    t0 = time.perf_counter()
    start_main_path()
    ops = []

    def keep(op):
        if op.device.type == "cuda":
            ops.append(op)
        return op

    for i, label in enumerate(REST_DG):
        both(label, lambda d: rest_dg(d, keep)[i](), dev, tag="[37]")
    launches = dg_launches()
    print(f"[37] launches on the card's runs: "
          + ", ".join(f"{k} {launches[k]}" for k in DG_KERNELS))
    for k in ("take_rows", "segment_sum", "gather_sum"):
        check(launches[k] > 0, f"[37] the card's runs launched {k}")
    for n, op in enumerate(ops):
        check_face_route(kc, op.faces, "[37]", type(op).__name__, seed=370 + n,
                         tables=(("M^-1 rows ", op.Minv),)
                         if type(op).__name__ == "DGDiffusionBR2" else ())
    print(f"[37] phase {time.perf_counter() - t0:.1f} s")
    return launches


# ----------------------------------------------------------------------------
# vector FE: ex3 with AMS, magnetic diffusion, H(div), the rest, sharded ND
# ----------------------------------------------------------------------------

#: [38]: the 2³ mesh refined to EX3_N³ (2,097,152 hexes at 128); the L2
#: error rate is taken between EX3_N/2 and EX3_N; Jacobi's CG cap
EX3_N = 128
EX3_SIZES = (2_097_152, 6_390_144, 2_146_689)      # hexes, ND dofs, H1 dofs
EX3_JACOBI_CAP = 4000
EX3_REL_TOL = 1e-6
EX3_SMALL_N = 8
#: the ex3 driver's run; its CPU side (43.7 s on 8 threads) starts with [38]
#: on EX3_DRIVER_CPU_THREADS threads and runs beside the card's work
EX3_DRIVER_N = 32
EX3_DRIVER_CPU_THREADS = 4
#: [39] the cardiac hex mesh, its small card-vs-CPU twin, the steps
MAG_N, MAG_SMALL_N, MAG_STEPS, MAG_DT = 126, 8, 3, 1e-6
#: [40] Darcy on DARCY_N³, ADS up to ADS_N³, the hybridized cases
DARCY_N, ADS_N, HYB_HEX_N, HYB_TET_N = 64, 32, 12, 4
#: [42] the sharded ND solve on PVEC_N³
PVEC_N = 64
VECFE_KERNELS = RESTRICTION_KERNELS + ("fused_diffusion",)


def vecfe_launches():
    got = main_path_launches()
    return {k: got[k] for k in VECFE_KERNELS}


def launch_line(launches):
    return ", ".join(f"{k} {launches[k]}" for k in VECFE_KERNELS)


def peak_gib():
    return torch.cuda.max_memory_allocated() / 2 ** 30


def rel_residual(A, x, b):
    """‖b − A x‖ / ‖b‖ in float64."""
    r = (b - A(x)).double()
    return float(r.norm() / b.double().norm())


def ex3_system(nd, dev, dtype, rhs):
    """The ex3 operator curl curl + mass on ``nd`` with the essential rows
    masked: (op, A, diag, b)."""
    from cardiac_ablation_ecm2_tpu_torch.examples.ex3_maxwell import masked_system
    from cardiac_ablation_ecm2_tpu_torch.ops.vecfe import build_nd_operator, vecfe_linear_form

    op = build_nd_operator(nd, mass_coeff=1.0, curlcurl_coeff=1.0, dtype=dtype, device=dev)
    A, dg, b = masked_system(op, nd.essential_dofs(None), vecfe_linear_form(op, rhs))
    return op, A, dg, b


class LaunchLedger:
    """The AMS-PCG solve's launches, accounted for call by call: each
    callable the solve reaches that launches a kernel (the ND operator, G,
    Gᵀ, Π, Πᵀ, and every V-cycle level's operator, smoother, prolongation
    and restriction) is wrapped to count its calls and the kernel launches
    of each call.  Each callable must launch the same kernels on every
    call, and the solve's launch counts must equal the sum over the
    callables of calls times launches a call."""

    def __init__(self):
        from cardiac_ablation_ecm2_tpu_torch.ops import block_gather as bg
        from cardiac_ablation_ecm2_tpu_torch.ops import fused_diffusion as fd

        self.fns = [getattr(bg, k) for k in RESTRICTION_KERNELS] + [fd.diffusion_apply]
        self.calls, self.per_call, self.uneven = {}, {}, set()

    def counts(self):
        return tuple(f.launches for f in self.fns)

    def wrap(self, name, fn):
        self.calls.setdefault(name, 0)

        def counted(*args):
            before = self.counts()
            out = fn(*args)
            got = tuple(a - b for a, b in zip(self.counts(), before))
            if self.per_call.setdefault(name, got) != got:
                self.uneven.add(name)
            self.calls[name] += 1
            return out

        return counted

    def install(self, A, M):
        """Wrap A, the AMS transfers and both hierarchies' levels in place;
        returns the counted (A, M)."""
        class Incidence:            # G with a counted call and transpose
            def __init__(s, G):
                s.fwd, s.t = self.wrap("G", G), self.wrap("Gt", G.t)

            def __call__(s, x):
                return s.fwd(x)

        tr = M.parts["transfer"]
        tr.G, tr.pi, tr.pi_t = Incidence(tr.G), self.wrap("pi", tr.pi), self.wrap(
            "pi_t", tr.pi_t)
        self.mgs = {k: M.parts[k] for k in ("mg_grad", "mg_pi")}
        for k, mg in self.mgs.items():
            for i, lvl in enumerate(mg.levels):
                for f in ("A", "smoother", "prolongate", "restrict_t"):
                    if getattr(lvl, f) is not None:
                        setattr(lvl, f, self.wrap(f"{k} {i} {f}", getattr(lvl, f)))
        self.cycles0 = {k: mg.cycles for k, mg in self.mgs.items()}
        m_calls = [0]

        def counted_M(r):
            m_calls[0] += 1
            return M(r)

        self.m_calls = m_calls
        return self.wrap("A", A), counted_M

    def check(self, its, dim, launches):
        """The structure of ``its`` AMS-PCG iterations and the exact sum;
        returns a line for the log."""
        n = its + 1                          # applies of A and of M
        cyc = {k: mg.cycles - self.cycles0[k] for k, mg in self.mgs.items()}
        c = self.calls
        check(c["A"] == n and self.m_calls[0] == n,
              f"[38] AMS-PCG: {n} operator and preconditioner applies")
        check(c["G"] == c["Gt"] == n and c["pi"] == c["pi_t"] == dim * n,
              f"[38] AMS: one G, Gᵀ and {dim} Π, Πᵀ an application")
        check(cyc == dict(mg_grad=n, mg_pi=dim * n),
              f"[38] AMS: one gradient and {dim} Π V-cycles an application ({cyc})")
        for k, mg in self.mgs.items():
            for i in range(1, len(mg.levels)):
                got = [c[f"{k} {i} {f}"] for f in ("A", "smoother", "prolongate",
                                                   "restrict_t")]
                check(got == [2 * cyc[k], 2 * cyc[k], cyc[k], cyc[k]],
                      f"[38] {k} level {i}: two operator applies and smoother "
                      f"sweeps, one prolongation and restriction a V-cycle ({got})")
        check(not self.uneven, f"[38] every counted callable launches the same "
              f"kernels on every call ({sorted(self.uneven)})")
        total = [sum(c[k] * self.per_call.get(k, (0,) * 4)[j] for k in c)
                 for j in range(4)]
        names = RESTRICTION_KERNELS + ("fused_diffusion",)
        want = [launches[k] for k in names]
        check(total == want, f"[38] AMS-PCG launches {want} equal the sum over its "
              f"callables of calls × launches a call {total}")
        coarse = {k: c[f"{k} 0 A"] for k in self.mgs}
        return (f"[38] AMS launch ledger: {n} applies of A and of the AMS, "
                f"{dim * n} Π/Πᵀ pairs, V-cycles {cyc}, coarse CG operator "
                f"applies {coarse}; " + ", ".join(
                    f"{k} {t}" for k, t in zip(names, total))
                + " = the counts read after the solve")


def ex3_ams(meshes, dev, dtype, rel_tol, jacobi_cap, ledger=None):
    """ex3's --ams problem on meshes[-1]: Jacobi-PCG and AMS-PCG.  Returns
    the x's, counts, seconds, setup split, launches and the objects; with
    a ``LaunchLedger`` the AMS solve's launches are accounted for."""
    from cardiac_ablation_ecm2_tpu_torch.examples.ex3_maxwell import ams_rhs
    from cardiac_ablation_ecm2_tpu_torch.fem.fe_vector import NDSpace
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.ams import make_ams
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    out = {}
    t0 = time.perf_counter()
    mesh = meshes[-1]
    nd, h1 = NDSpace(mesh), FESpace(mesh, 1)
    out["host_s"] = time.perf_counter() - t0
    from cardiac_ablation_ecm2_tpu_torch.examples.ex3_maxwell import masked_system
    from cardiac_ablation_ecm2_tpu_torch.ops.vecfe import build_nd_operator, vecfe_linear_form

    t0 = time.perf_counter()
    op = build_nd_operator(nd, mass_coeff=1.0, curlcurl_coeff=1.0, dtype=dtype, device=dev)
    out["op_s"] = elapsed(t0, dev)
    t0 = time.perf_counter()
    A, dg, b = masked_system(op, nd.essential_dofs(None), vecfe_linear_form(op, ams_rhs))
    out["rhs_s"] = elapsed(t0, dev)
    t0 = time.perf_counter()
    bdr = sorted(set(mesh.bdr_attributes.tolist()))
    M = make_ams(nd, h1, A, dg, ess_bdr=bdr, meshes=meshes, dtype=dtype, device=dev)
    out["ams_s"] = elapsed(t0, dev)
    out["setup_peak"] = peak_gib() if torch.device(dev).type == "cuda" else 0.0
    for name, prec, cap in (("jacobi", lambda r: r / dg, jacobi_cap), ("ams", M, 500)):
        op_fn = A
        if name == "ams" and ledger is not None:
            op_fn, prec = ledger.install(A, M)
        start_main_path()
        t0 = time.perf_counter()
        x, info = cg(op_fn, b, M=prec, rel_tol=rel_tol, max_iter=cap)
        out[name] = dict(x=x, its=info.iterations, converged=info.converged,
                         s=elapsed(t0, dev), launches=vecfe_launches(),
                         res=rel_residual(A, x, b))
    out.update(nd=nd, h1=h1, op=op, A=A, b=b, M=M)
    return out


def ex3_small(d):
    """[38] at EX3_SMALL_N³, float64: AMS's x and count, Jacobi's count.
    Jacobi-PCG to 1e-10 takes ~117 steps here, in CG's round-off regime:
    the card stopped at 116 where the CPU stopped at 118 (a card test), so
    its count is held within ``counts_close`` and its x not at
    1e-10."""
    from cardiac_ablation_ecm2_tpu_torch.examples.ex3_maxwell import hierarchy

    r = ex3_ams(hierarchy(EX3_SMALL_N), d, torch.float64, 1e-10, 8000)
    return [r["ams"]["x"]], [Krylov([r["jacobi"]["its"]]), r["ams"]["its"]]


def gradient_field(x):
    """E = ∇(sin πx sin πy sin πz)/π of host points: tangential trace 0,
    curl E = 0, so curl curl E + E = E; each component varies along its own
    axis.  ``torch`` points give a tensor."""
    m = torch if torch.is_tensor(x) else np
    s, c = m.sin(np.pi * x), m.cos(np.pi * x)
    return m.stack([c[..., 0] * s[..., 1] * s[..., 2], s[..., 0] * c[..., 1] * s[..., 2],
                    s[..., 0] * s[..., 1] * c[..., 2]], -1)


def sine_field(x):
    """ex3's E_i = sin πx_j sin πx_k, of host points or a tensor."""
    m = torch if torch.is_tensor(x) else np
    s = m.sin(np.pi * x)
    return m.stack([s[..., 1] * s[..., 2], s[..., 2] * s[..., 0], s[..., 0] * s[..., 1]], -1)


def ex3_l2_errors(nd, dev):
    """L2 errors on ``nd`` in float64 (a float32 solve's own error, ~1e-5
    at 128³, would hide the discretization's) of two exact fields: ex3's
    sine product (f = (2π² + 1)E, a discrete eigenmode of the uniform
    lattice, one Jacobi-PCG iteration) and :func:`gradient_field` (f = E).
    The fields and the error are evaluated on the card; the right-hand
    sides at host points (the linear forms' convention).  Returns
    [(error, CG count)] in that order."""
    from cardiac_ablation_ecm2_tpu_torch.examples.ex3_maxwell import masked_system
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.ops.vecfe import build_nd_operator, vecfe_linear_form

    op = build_nd_operator(nd, 1.0, 1.0, dtype=torch.float64, device=dev)
    out = []
    for field, scale in ((sine_field, 2 * np.pi ** 2 + 1), (gradient_field, 1.0)):
        A, dg, b = masked_system(op, nd.essential_dofs(None), vecfe_linear_form(
            op, lambda x: scale * field(x)))
        x, info = cg(A, b, M=lambda r: r / dg, rel_tol=1e-10, max_iter=EX3_JACOBI_CAP)
        d2 = ((op.values(x) - field(op.gf.x)) ** 2).sum(dim=-1)
        out.append((float((op.gf.wdet * d2).sum().sqrt()), info.iterations))
        del A, dg, b, x, d2
    return out


EX3_RUN = ["-m", "cardiac_ablation_ecm2_tpu_torch.examples.ex3_maxwell", "--ams",
           "-n", str(EX3_DRIVER_N)]


def start_ex3_driver(*extra, threads=None):
    """The ex3 driver in a subprocess (``threads``: its CPU threads)."""
    import sys

    env = dict(os.environ)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    return subprocess.Popen([sys.executable] + EX3_RUN + list(extra), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)


def ex3_driver_lines(proc, what):
    """The lines of a driver run that :func:`start_ex3_driver` started."""
    try:
        out, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    check(proc.returncode == 0, f"[38] ex3 driver {what} ran ({err[-400:]})")
    return out.strip().splitlines()


def phase_ex3(kc, dev):
    """[38] ex3 with AMS on the 2³ → 128³ hierarchy; returns the launches of
    the AMS and Jacobi solves and the kernels line's ND-map numbers.  The
    ex3 driver's runs go on beside the phase's own work (the CPU one from the
    start, the card one after the solves) and are stopped if it fails."""
    drivers = [start_ex3_driver("--cpu", threads=EX3_DRIVER_CPU_THREADS)]
    try:
        return ex3_checks(kc, dev, drivers)
    finally:
        for p in drivers:
            if p.poll() is None:
                p.kill()
                p.wait()


def ex3_checks(kc, dev, drivers):
    """[38]'s body; ``drivers`` holds the ex3 driver's CPU run and gets its card
    run."""
    from cardiac_ablation_ecm2_tpu_torch.examples.ex3_maxwell import hierarchy
    from cardiac_ablation_ecm2_tpu_torch.fem.build import restriction_for
    from cardiac_ablation_ecm2_tpu_torch.fem.fe_vector import NDSpace

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    meshes = hierarchy(EX3_N)
    mesh_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ledger = LaunchLedger()
    r = ex3_ams(meshes, dev, torch.float32, EX3_REL_TOL, EX3_JACOBI_CAP, ledger)
    t_card = time.perf_counter()
    drivers.append(start_ex3_driver())
    nd, h1, op = r["nd"], r["h1"], r["op"]
    check((meshes[-1].ne, nd.ndof, h1.ndof) == EX3_SIZES,
          f"[38] {EX3_N}^3: {EX3_SIZES[0]:,} hexes, {EX3_SIZES[1]:,} ND dofs, "
          f"{EX3_SIZES[2]:,} H1 dofs")
    jac, ams = r["jacobi"], r["ams"]
    for name, s in (("Jacobi", jac), ("AMS", ams)):
        print(f"[38] {name}-PCG to {EX3_REL_TOL:g}: {s['its']} CG, {s['s']:.2f} s, "
              f"{1e3 * s['s'] / max(s['its'], 1):.2f} ms/iteration, true residual "
              f"{s['res']:.3e}, converged {s['converged']}; launches "
              + launch_line(s["launches"]))
    capped = not jac["converged"]
    print(f"[38] Jacobi {'hit' if capped else 'stayed under'} its cap of "
          f"{EX3_JACOBI_CAP} CG iterations")
    dx = float((ams["x"] - jac["x"]).abs().max() / jac["x"].abs().max())
    print(f"[38] AMS against Jacobi: {dx:.3e} of max|x|")
    # float32 bounds: an iterate's true residual carries eps32 times the
    # curl-curl operator's condition (~1e6 at 128³), and Jacobi's ~1,000
    # steps drift further; each solve's own tolerance is 1e-6
    check(ams["converged"] and ams["res"] <= 1e-3,
          f"[38] AMS-PCG converged, true residual {ams['res']:.2e} (≤ 1e-3)")
    check(dx <= 1e-2, "[38] the AMS and Jacobi solutions agree within 1e-2 of max|x|")
    check(4 * ams["its"] <= jac["its"], f"[38] AMS takes at most a quarter of "
          f"Jacobi's iterations ({ams['its']} against {jac['its']})")
    lj, la = jac["launches"], ams["launches"]
    check(lj["gather_sum"] == jac["its"] + 1 and lj["segment_sum"] == jac["its"] + 1,
          f"[38] Jacobi launches: one gather_sum and one segment_sum per apply "
          f"({jac['its'] + 1} applies)")
    print(ledger.check(ams["its"], meshes[-1].dim, la))
    mg = r["M"].parts["mg_grad"]
    print(f"[38] setup: mesh hierarchy {mesh_s:.1f} s, host spaces and tables "
          f"{r['host_s']:.1f} s, device operator {r['op_s']:.1f} s, right-hand side "
          f"and diagonal {r['rhs_s']:.1f} s (host numpy at the points), AMS (two "
          f"{len(mg.levels)}-level h-MG hierarchies) {r['ams_s']:.1f} s; peak "
          f"{r['setup_peak']:.2f} GiB after setup, {peak_gib():.2f} GiB after the "
          f"solves (the two (ne, 27, 3, 12) terms: "
          f"{2 * meshes[-1].ne * 27 * 36 * 4 / 1e9:.2f} GB)")
    # the maps the phase launched on: the ND map, the AMS edge map and the
    # H1 levels of both hierarchies (they share their spaces)
    maps = [(op.restr, "ex3 ND map ", True),
            (r["M"].parts["transfer"].restr, "ex3 AMS edge map ", False)]
    maps += [(restriction_for(f, dev), f"ex3 H1 level {i} ", False) for i, f in enumerate(
        sorted(r["M"].parts["spaces"].values(), key=lambda f: f.mesh.ne))]
    del r, op
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fine = ex3_l2_errors(nd, dev)
    torch.cuda.empty_cache()
    coarse = ex3_l2_errors(NDSpace(meshes[-2]), dev)
    rates = [float(np.log2(c[0] / f[0])) for c, f in zip(coarse, fine)]
    for name, c, f, rate in zip(("ex3's sine product", "the gradient field"), coarse,
                                fine, rates):
        print(f"[38] L2 error of {name}: {c[0]:.4e} at {EX3_N // 2}^3 ({c[1]} CG), "
              f"{f[0]:.4e} at {EX3_N}^3 ({f[1]} CG), rate {rate:.3f}")
    # ex3's E_i = sin πx_j sin πx_k is constant along x_i, where ND₁ on hexes
    # holds the bilinear interpolant of E_i: its error is second order; the
    # gradient field's components vary along their own axes: first order
    check(1.9 <= rates[0] <= 2.1, "[38] ex3's field converges at rate 2 (in [1.9, 2.1])")
    check(0.9 <= rates[1] <= 1.1, "[38] the gradient field converges at ND₁'s first "
          "order (rate in [0.9, 1.1])")
    print(f"[38] L2 errors {time.perf_counter() - t0:.1f} s")
    both(f"ex3 --ams {EX3_SMALL_N}^3 float64", ex3_small, dev, tag="[38]")
    t0 = time.perf_counter()
    card = ex3_driver_lines(drivers[1], "on the card")
    card_s = time.perf_counter() - t_card
    cpu = ex3_driver_lines(drivers[0], "--cpu")
    counts = [[int(w) for w in ln.split() if w.isdigit()] for ln in (card[1], cpu[1])]
    check(card[0] == cpu[0] and counts_close(*counts),
          f"[38] ex3 driver --ams -n {EX3_DRIVER_N}: {card} on the card, {cpu} on the CPU")
    print(f"[38] ex3 driver on the card: {' | '.join(card)} ({card_s:.1f} s since it "
          f"started after the solves); on the CPU ({EX3_DRIVER_CPU_THREADS} threads, "
          f"started with the phase): {' | '.join(cpu)}; waited "
          f"{time.perf_counter() - t0:.1f} s for both")
    for i, (rr, what, timed) in enumerate(maps):
        check_restriction(kc, rr, what, "[38]", seed=380 + i, timed=timed)
    del maps
    numbers = {k: {f: kc.times[f"ex3 ND map {lab} float32"][f]
                   for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
               for k, lab in (("gather_sum", "L->E (ne,nd)"),
                              ("segment_sum", "E->L (ne,nd)"))}
    print(f"[38] phase {time.perf_counter() - t_phase:.1f} s")
    return la, lj, numbers


def mag_source(x):
    """J_s of host points: a Gaussian current along z about the electrode's
    axis (x, y) = (L/2, L/2)."""
    r2 = (x[..., 0] - L / 2) ** 2 + (x[..., 1] - L / 2) ** 2
    z = np.zeros_like(r2)
    return np.stack([z, z, 1e3 * np.exp(-r2 / (L / 8) ** 2)], axis=-1)


def mag_run(mesh, d, dtype, rel_tol, steps=MAG_STEPS):
    """MAG_STEPS SDIRK33 steps of magnetic diffusion from A = 0, PEC on every
    boundary attribute: (nd, operator, A, host seconds, setup seconds, step
    seconds)."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fe_vector import NDSpace
    from cardiac_ablation_ecm2_tpu_torch.linalg import ode
    from cardiac_ablation_ecm2_tpu_torch.models.magnetic_diffusion import (
        MagneticDiffusionOperator,
    )
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    t0 = time.perf_counter()
    nd = NDSpace(mesh)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = MagneticDiffusionOperator(nd, sigma=1.0, nu=1.0, source=mag_source,
                                   ess_bdr=sorted(set(mesh.bdr_attributes.tolist())),
                                   rel_tol=rel_tol, max_iter=4000, dtype=dtype, device=d)
    setup_s = elapsed(t0, d)
    A = torch.zeros(nd.ndof, dtype=dtype, device=d)
    solver, t = ode.select("sdirk33"), 0.0
    t0 = time.perf_counter()
    for _ in range(steps):
        A, t = solver.step(op, A, t, MAG_DT)
    return nd, op, A, host_s, setup_s, elapsed(t0, d)


def mag_small(d):
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh

    mesh = make_cardiac_hex_mesh(MAG_SMALL_N, lengths=(L, L, L / 2), electrode_radius=0.004)
    _, op, A, *_ = mag_run(mesh, d, torch.float64, 1e-12)
    return [A], Krylov(op.cg_iterations)


def phase_magnetic(kc, dev, mesh):
    """[39] magnetic diffusion on the cardiac hex mesh n=126 (float32, PEC,
    Jacobi-PCG), the discrete div-curl invariant, n=8 card against CPU;
    returns the main run's launches."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fe_vector import RTSpace
    from cardiac_ablation_ecm2_tpu_torch.ops.vecfe import discrete_curl, discrete_divergence

    t_phase = time.perf_counter()
    start_main_path()
    nd, op, A, host_s, setup_s, step_s = mag_run(mesh, dev, torch.float32, 1e-5)
    launches = vecfe_launches()
    its = op.cg_iterations
    check(len(its) == 3 * MAG_STEPS and all(0 < i < 4000 for i in its),
          f"[39] every stage solve converged under the cap ({its})")
    check(bool(torch.isfinite(A).all()) and float(A.abs().max()) > 0,
          "[39] A is finite and nonzero")
    check(launches["gather_sum"] >= sum(its) and launches["segment_sum"] >= sum(its),
          "[39] the steps launched gather_sum and segment_sum")
    print(f"[39] magnetic diffusion on the cardiac hex mesh n={MAG_N}: {mesh.ne:,} hexes, "
          f"{nd.ndof:,} ND0 dofs; {MAG_STEPS} SDIRK33 steps of {MAG_DT:g}: "
          f"{step_s / MAG_STEPS:.3f} s/step, CG per stage {its} (mean "
          f"{np.mean(its):.1f}); setup: host space {host_s:.1f} s, operators "
          f"{setup_s:.1f} s; peak {peak_gib():.2f} GiB; launches " + launch_line(launches))
    t0 = time.perf_counter()
    rt = RTSpace(mesh)
    C = discrete_curl(nd, rt, device=dev, dtype=torch.float32)
    D = discrete_divergence(rt, device=dev, dtype=torch.float32)
    B = C(A)
    flux = D.op(B)                # ∫_K div B = D(B)·|K|, the net flux out of K
    ratio = float(flux.double().norm() / B.double().norm())
    ratio_max = float(flux.abs().max() / B.abs().max())
    print(f"[39] div-curl: {rt.ndof:,} RT0 faces, ‖∫_K div B‖ {ratio:.3e} of ‖B·n‖ "
          f"(max {ratio_max:.3e} of max), {time.perf_counter() - t0:.1f} s")
    check(ratio <= 1e-6, f"[39] B = curl A is divergence-free: ‖∫_K div B‖ = "
          f"{ratio:.2e} ‖B·n‖ (≤ 1e-6; float32 sums of ±face fluxes)")
    maps = [(op.M.restr, "n=126 ND map "), (D.op.restr, "n=126 RT map "),
            (C.restr, "n=126 curl map ")]
    del op, A, B, flux
    torch.cuda.empty_cache()
    both(f"magnetic diffusion cardiac n={MAG_SMALL_N} float64", mag_small, dev, tag="[39]")
    for i, (rr, what) in enumerate(maps):
        check_restriction(kc, rr, what, "[39]", seed=390 + i)
    print(f"[39] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def darcy_f(x):
    return np.stack([x[..., 1], 1 - x[..., 0], x[..., 0] * x[..., 2]], -1)


def darcy_g(x):
    return 3 * np.pi ** 2 * np.prod(np.sin(np.pi * x), axis=-1)


def hyb_f(x):
    return np.stack([np.sin(x[..., 0]) + x[..., 1], np.cos(x[..., 1]) - 0.5 * x[..., 0],
                     x[..., 2] ** 2], axis=-1)


def hybridized_against_plain(space, dev, tag, label):
    """``hybridize_hdiv`` against the unhybridized Jacobi-PCG solve of
    mass + 0.8 div-div (float64): the restrictions it launched on."""
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.ops.hybridization import hybridize_hdiv
    from cardiac_ablation_ecm2_tpu_torch.ops.vecfe import build_rt_operator, vecfe_linear_form

    t0 = time.perf_counter()
    op = build_rt_operator(space, 1.0, 0.8, nq1d=4, dtype=torch.float64, device=dev)
    b = vecfe_linear_form(op, hyb_f)
    dg = op.diagonal()
    u, info = cg(op.mult, b, M=lambda r: r / dg, rel_tol=1e-10, max_iter=20_000)
    hy = hybridize_hdiv(space, op)
    uh, _, hinfo = hy.solve(hyb_f, rel_tol=1e-10, max_iter=20_000)
    err = float((uh - u).abs().max() / u.abs().max())
    check(info.converged and hinfo.converged and err <= 1e-5,
          f"{tag} hybridized {label} within 1e-5 of the plain solve ({err:.2e})")
    print(f"{tag} hybridization {label}: {space.ndof:,} dofs, {hy.nlam:,} multipliers, "
          f"interface CG {hinfo.iterations} against {info.iterations} plain, "
          f"{err:.2e} of max|u|, {time.perf_counter() - t0:.2f} s")
    return [(op.restr, f"hybridization {label} map "),
            (hy.lam, f"hybridization {label} multiplier map ")]


def phase_hdiv(kc, dev):
    """[40] Darcy on DARCY_N³, ADS-PCG up to ADS_N³ against Jacobi, the two
    hybridized cases; returns the Darcy and ADS solves' launches."""
    from cardiac_ablation_ecm2_tpu_torch.examples.ex3_maxwell import hierarchy, masked_system
    from cardiac_ablation_ecm2_tpu_torch.fem.build import restriction_for
    from cardiac_ablation_ecm2_tpu_torch.fem.fe_vector import NDSpace, RTSpace
    from cardiac_ablation_ecm2_tpu_torch.fem.fe_vector_ho import RTSpaceHO
    from cardiac_ablation_ecm2_tpu_torch.fem.fe_vector_simplex import RTSimplexSpace
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.ams import make_ads
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d, make_cartesian_3d_tet
    from cardiac_ablation_ecm2_tpu_torch.models import darcy
    from cardiac_ablation_ecm2_tpu_torch.ops.vecfe import build_rt_operator, vecfe_linear_form
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    t_phase = time.perf_counter()
    start_main_path()
    t0 = time.perf_counter()
    mesh = make_cartesian_3d(DARCY_N, DARCY_N, DARCY_N)
    res = darcy.solve(mesh, f_vec=darcy_f, g_fn=darcy_g, rel_tol=1e-6, max_iter=20_000,
                      dtype=torch.float32, device=dev)
    secs = elapsed(t0, dev)
    launches = vecfe_launches()
    sysd = darcy.system(res.rt, res.l2, darcy_f, darcy_g, torch.float32, dev)
    x = torch.cat([res.u, -res.p])
    rel = rel_residual(sysd.op.mult, x, sysd.rhs)
    print(f"[40] Darcy {DARCY_N}^3: {res.rt.ndof:,} RT0 + {res.l2.ndof:,} L2 dofs, MINRES "
          f"{res.iterations} iterations, {secs:.2f} s (spaces included), true residual "
          f"{rel:.3e}; launches " + launch_line(launches))
    check(res.converged and rel <= 1e-4, f"[40] Darcy MINRES converged (true residual "
          f"{rel:.2e})")
    maps = [(sysd.M.restr, "Darcy RT map "), (restriction_for(res.l2, dev), "Darcy L2 map ")]
    del res, sysd, x
    t0 = time.perf_counter()
    meshes = hierarchy(ADS_N)
    m = meshes[-1]
    rt, ndsp, h1 = RTSpace(m), NDSpace(m), FESpace(m, 1)
    op = build_rt_operator(rt, 1.0, 1.0, dtype=torch.float32, device=dev)
    A, dg, b = masked_system(op, rt.essential_dofs(None), vecfe_linear_form(op, hyb_f))
    M = make_ads(rt, ndsp, h1, A, dg, ess_bdr=sorted(set(m.bdr_attributes.tolist())),
                 meshes=meshes, dtype=torch.float32, device=dev)
    setup_s = elapsed(t0, dev)
    out = {}
    for name, prec in (("Jacobi", lambda r: r / dg), ("ADS", M)):
        start_main_path()
        t0 = time.perf_counter()
        x, info = cg(A, b, M=prec, rel_tol=1e-6, max_iter=4000)
        out[name] = (info.iterations, elapsed(t0, dev), rel_residual(A, x, b),
                     vecfe_launches())
    (ij, sj, rj, _), (ia, sa, ra, la) = out["Jacobi"], out["ADS"]
    print(f"[40] div-div + mass on {ADS_N}^3 ({rt.ndof:,} RT0 dofs, {len(meshes)} levels): "
          f"Jacobi {ij} CG {sj:.2f} s (residual {rj:.2e}), ADS {ia} CG {sa:.2f} s "
          f"(residual {ra:.2e}); ADS setup {setup_s:.2f} s; launches " + launch_line(la))
    # float32 true residuals: eps32 times the div-div operator's condition
    check(ia < ij and ra <= 1e-3, f"[40] ADS-PCG takes fewer iterations than Jacobi "
          f"({ia} against {ij}), true residual {ra:.2e} ≤ 1e-3")
    maps += [(op.restr, "ADS RT map "), (M.parts["transfer"].restr, "ADS face map "),
             (M.parts["curl"].restr, "ADS curl map "),
             (M.parts["ams"].parts["transfer"].restr, "ADS edge map ")]
    maps += [(restriction_for(f, dev), f"ADS H1 level {i} ") for i, f in enumerate(
        sorted(M.parts["spaces"].values(), key=lambda f: f.mesh.ne))]
    del op, A, M
    maps += hybridized_against_plain(RTSpaceHO(make_cartesian_3d(*(HYB_HEX_N,) * 3), 2),
                                     dev, "[40]", f"RT_2 hex {HYB_HEX_N}^3")
    maps += hybridized_against_plain(RTSimplexSpace(make_cartesian_3d_tet(*(HYB_TET_N,) * 3), 2),
                                     dev, "[40]", f"RT_2 tet {HYB_TET_N}^3")
    for i, (rr, what) in enumerate(maps):
        check_restriction(kc, rr, what, "[40]", seed=400 + i)
    print(f"[40] phase {time.perf_counter() - t_phase:.1f} s")
    return {k: launches[k] + la[k] for k in VECFE_KERNELS}


def _gen_like(n, seed, d, cols=None):
    gen = torch.Generator().manual_seed(seed)
    shape = (n,) if cols is None else (n, cols)
    return torch.randn(shape, generator=gen, dtype=torch.float64).to(d)


def rest_vecfe(d):
    """[41]'s cases on device ``d`` (float64), each a function returning
    (tensors, counts)."""
    from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector_ho as ho
    from cardiac_ablation_ecm2_tpu_torch.fem import fe_vector_simplex as sx
    from cardiac_ablation_ecm2_tpu_torch.fem.fe_vector import NDSpace, RTSpace
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace, L2FESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.maxwell_eigen import maxwell_eigenvalues
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import gmres
    from cardiac_ablation_ecm2_tpu_torch.mesh import mesh as mk
    from cardiac_ablation_ecm2_tpu_torch.ops import complex_fem as cf
    from cardiac_ablation_ecm2_tpu_torch.ops import mixed_vecfe as mx
    from cardiac_ablation_ecm2_tpu_torch.ops import vecfe as vf
    from cardiac_ablation_ecm2_tpu_torch.ops import vecfe_r as vr

    kw = dict(dtype=torch.float64, device=d)

    def applies(ops, seed):
        out = []
        for i, op in enumerate(ops):
            x = _gen_like(getattr(op, "ndof_trial", getattr(op, "ndof", 0)), seed + i, d)
            out.append(op.mult(x))
            if hasattr(op, "mult_t"):
                out.append(op.mult_t(_gen_like(op.ndof_test, seed + 50 + i, d)))
            elif hasattr(op, "diagonal"):
                out.append(op.diagonal())
        return out

    def eig():
        sp = ho.NDSpaceHO(mk.make_cartesian_2d(4, 4), 2)
        r = maxwell_eigenvalues(sp, FESpace(sp.mesh, 2), k=3, iters=40,
                                X0=_gen_like(sp.ndof, 41, "cpu", 3), **kw)
        return [torch.as_tensor(r.eigenvalues)], 0

    def mixed():
        m = mk.make_cartesian_3d(3, 3, 3)
        nd, rt = ho.NDSpaceHO(m, 2), ho.RTSpaceHO(m, 2)
        h1, l2, v = FESpace(m, 2), L2FESpace(m, 1), FESpace(m, 2, vdim=3)
        V = np.array([0.3, -0.5, 0.8])
        ops = [mx.mixed_vector_gradient(h1, nd, nq1d=4, **kw),
               mx.mixed_vector_weak_divergence(nd, h1, nq1d=4, **kw),
               mx.mixed_vector_mass(nd, rt, nq1d=4, **kw),
               mx.mixed_vector_curl(nd, rt, nq1d=4, **kw),
               mx.mixed_weak_curl(rt, nd, nq1d=4, **kw),
               mx.vectorfe_divergence(rt, l2, nq1d=4, **kw),
               mx.vector_divergence(v, FESpace(m, 1), **kw),
               mx.mixed_cross_product(v, v, V, **kw),
               mx.mixed_cross_curl(NDSpace(m), v, V, **kw)]
        return applies(ops, 410), 0

    def restricted():
        ops = []
        for m in (mk.make_cartesian_2d(4, 4), mk.make_cartesian_2d_tri(3, 3)):
            ops += [vr.build_nd_r2d_operator(vr.NDR2DSpace(m, 2), np.eye(3) + 0.1, 1.3, **kw),
                    vr.build_rt_r2d_operator(vr.RTR2DSpace(m, 2), 0.9, 1.7, **kw)]
        ops.append(vr.build_nd_r1d_operator(vr.NDR1DSpace(np.linspace(0, 1, 9), 2),
                                            1.2, 0.8, **kw))
        return applies(ops, 420), 0

    def spaces():
        ops = []
        for p in (1, 2, 3):
            for m, cls in ((mk.make_cartesian_3d(2, 2, 2), ho), (mk.make_cartesian_2d(3, 3), ho),
                           (mk.make_cartesian_3d_tet(2, 2, 1), sx),
                           (mk.make_cartesian_2d_tri(3, 2), sx)):
                if cls is ho:
                    nds, rts = ho.NDSpaceHO(m, p), ho.RTSpaceHO(m, p)
                else:
                    nds, rts = sx.NDSimplexSpace(m, p), sx.RTSimplexSpace(m, p)
                ops += [vf.build_nd_operator(nds, 1.3, 0.7, nq1d=p + 2, **kw),
                        vf.build_rt_operator(rts, 1.3, 0.7, nq1d=p + 2, **kw)]
        m = mk.make_cartesian_3d(2, 2, 2)
        ops += [vf.build_nd_operator(NDSpace(m), 1.0, 1.0, **kw),
                vf.build_rt_operator(RTSpace(m), 1.0, 1.0, **kw)]
        return applies(ops, 430), 0

    def ex22():
        omega, sigma = 1.5, 0.8
        sp = ho.NDSpaceHO(mk.make_cartesian_3d(2, 2, 2), 2)
        from cardiac_ablation_ecm2_tpu_torch.examples.ex3_maxwell import exact_field

        op_r = vf.build_nd_operator(sp, -omega ** 2, 1.0, nq1d=4, **kw)
        op_i = vf.build_nd_operator(sp, omega * sigma, None, nq1d=4, **kw)
        A = cf.ComplexOperator(op_r, op_i, sp.ndof)
        cr = 2 * np.pi ** 2 - omega ** 2
        b = cf.cstack(vf.vecfe_linear_form(op_r, lambda x: cr * exact_field(x)),
                      vf.vecfe_linear_form(op_r, lambda x: omega * sigma * exact_field(x)))
        ess = sp.essential_dofs(None)
        Ac, B = cf.form_complex_linear_system(A, ess, torch.zeros_like(b), b)
        mask = torch.zeros(sp.ndof, **kw)
        mask[torch.as_tensor(ess, dtype=torch.int64, device=d)] = 1.0
        z, info = gmres(Ac.mult, B, M=cf.complex_jacobi(A, ess_mask=mask), rel_tol=1e-11,
                        max_iter=4000, restart=250)
        return [z], info.iterations

    def ex25():
        k, pml_x = np.pi, 3.0
        cpml = 2.0 * 5.0 / k

        def d0(x):
            return 1.0 + 1j * cpml * np.maximum(np.asarray(x.cpu())[..., 0] - pml_x, 0.0)

        def mass_c(x):
            dd = d0(x)
            z = np.zeros_like(dd)
            return -k ** 2 * np.stack([np.stack([1.0 / dd, z], -1),
                                       np.stack([z, dd], -1)], -2)

        sp = ho.NDSpaceHO(mk.make_cartesian_2d(8, 2, 4.0, 1.0), 2)
        mats = [vf.build_nd_operator(sp, lambda x, f=f: f(mass_c(x)),
                                     lambda x, f=f: f(1.0 / d0(x)), nq1d=4, **kw)
                .assemble_matrix().toarray() for f in (np.real, np.imag)]
        return [torch.as_tensor(a) for a in mats], 0

    return eig, mixed, restricted, spaces, ex22, ex25


REST_VECFE = ("Maxwell eigenvalues ND_2 4x4 (LOBPCG, 40 iterations)",
              "the mixed family on 3^3 (nine operators, mult and mult_t)",
              "ND/RT_R2D on quads and triangles, ND_R1D",
              "ND/RT operators at orders 1-3 on hexes, quads, tets, triangles",
              "ex22 problem 1 on ND_2 2^3 (GMRES)", "ex25 PML beam 8x2 ND_2")


def phase_rest_vecfe(dev):
    """[41] the rest of the slice at the JAX tests' sizes, card against CPU in
    float64; returns the card runs' launches."""
    t0 = time.perf_counter()
    start_main_path()
    for i, label in enumerate(REST_VECFE):
        both(label, lambda d: rest_vecfe(d)[i](), dev, tag="[41]")
    launches = vecfe_launches()
    print(f"[41] launches on the card's runs: " + launch_line(launches))
    for k in ("gather_sum", "segment_sum"):
        check(launches[k] > 0, f"[41] the card's runs launched {k}")
    print(f"[41] phase {time.perf_counter() - t0:.1f} s")
    return launches


def pvec_rhs(x):
    return np.stack([np.ones_like(x[..., 0]), x[..., 1], x[..., 0]], axis=-1)


def _pvec_rank(rank, world, dev, space):
    """[42]'s rank body: the sharded Jacobi and AMS solves (u, count,
    seconds) and the rank's restrictions."""
    from cardiac_ablation_ecm2_tpu_torch.parallel import pvecfe
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    out, restr = {}, []
    for prec in ("jacobi", "ams"):
        pv = pvecfe.setup(space, mass_coeff=1.0, curlcurl_coeff=1.0, rhs_fn=pvec_rhs,
                          ess_bdr=sorted(set(space.mesh.bdr_attributes.tolist())),
                          rel_tol=1e-6, max_iter=4000, precond=prec,
                          dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        u, its, _ = pv.solve()
        out[prec] = (u, its, elapsed(t0, dev))
        restr.append(pv.local.restr)
        if pv.ams is not None:
            restr.append(pv.ams["h1_restr"])
    return out, restr


def phase_pvecfe(kc, dev):
    """[42] the sharded ND solve at world 1 over NCCL on PVEC_N³ against the
    serial port; returns the sharded runs' launches."""
    from cardiac_ablation_ecm2_tpu_torch.fem.fe_vector import NDSpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    mesh = make_cartesian_3d(PVEC_N, PVEC_N, PVEC_N)
    nd = NDSpace(mesh)
    op, A, dg, b = ex3_system(nd, dev, torch.float32, pvec_rhs)
    x, info = cg(A, b, M=lambda r: r / dg, rel_tol=1e-6, max_iter=4000)
    x = x.double().cpu().numpy()
    del op, A, dg, b
    start_main_path()
    out, restr = launch.run_single(lambda r, w, d: _pvec_rank(r, w, d, nd))
    launches = vecfe_launches()
    scale = np.abs(x).max()
    # the Jacobi pair is one operator and one preconditioner (1e-5); the
    # in-shard AMS iterate is another solve to rel_tol 1e-6 in float32, as
    # far from the serial one as the operator's condition lets it be (1e-3)
    for prec, (u, its, secs) in out.items():
        err = float(np.abs(u - x).max() / scale)
        print(f"[42] sharded ND {PVEC_N}^3 ({nd.ndof:,} dofs) world 1 over NCCL, {prec}: "
              f"{its} CG, {secs:.2f} s, {err:.2e} of max|u| from the serial Jacobi-PCG "
              f"({info.iterations} CG)")
        tol = 1e-5 if prec == "jacobi" else 1e-3
        check(err <= tol, f"[42] sharded {prec} within {tol:g} of the serial port "
              f"({err:.2e})")
    check(out["jacobi"][1] == info.iterations, "[42] sharded Jacobi takes the serial count")
    check(out["ams"][1] < out["jacobi"][1], "[42] the in-shard AMS takes fewer iterations")
    print(f"[42] launches " + launch_line(launches))
    for i, (rr, what) in enumerate(zip(restr, ("local ND map (Jacobi) ", "local ND map (AMS) ",
                                               "local H1 map (AMS) "))):
        check_restriction(kc, rr, what, "[42]", seed=420 + i)
    print(f"[42] phase {time.perf_counter() - t0:.1f} s")
    return launches


# [43]-[44]: the NC slice.  [43] is an NC-refined cardiac hex RF-Laplace
# solve (the JAX drivers' composition): make_cardiac_hex_mesh(NC_N), make_nc,
# then isotropic 2:1 rounds on the centroids within NC_ROUNDS mm of the
# electrode centre; order 2, the diffusion PA operator, PᵀAP, the electrode
# (attribute 2) at 1 and the ground pad (3) at 0, cg with M the identity in
# float32 to rel_tol 1e-6.  NC_N is cut from 64 (341,965 hexes, 2,745,961
# conforming dofs) to 48: at 64 the script took 1,204.5 s on a slow host,
# over its 1,200-s limit (PERF.md section 4 gives the saving).
NC_N = 48
NC_SMALL_N = 24
NC_ROUNDS = (10.0, 7.0)
NC_CENTRE = np.array([20.0, 20.0, 20.0])
NC_SOLVE = dict(rel_tol=1e-6, max_iter=4000)
# [44]'s float64 card-against-CPU solve: with M the identity, CG at this
# size (~700 iterations) amplifies round-off, so two runs 1e-15 apart end
# 8e-7 of max|u| apart at rel_tol 1e-6, 1.4e-10 at 1e-10 and 2.1e-12 at
# 1e-12 with equal counts (CPU, float64)
NC_SMALL_TOL = 1e-12
NC_SMALL_THREADS = 1
NC_DRIVERS = (("ex15_dynamic_amr", ()), ("boundary_layer_amr", ()))
NC_DRIVER_LAST = {"ex15_dynamic_amr": "step 4: elements=",
                  "boundary_layer_amr": "rounds=3: elements="}


def nc_refined(n):
    """``make_cardiac_hex_mesh(n)``, ``make_nc`` and the electrode rounds:
    (nc, host seconds of the mesh, of make_nc and of each round)."""
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
    from cardiac_ablation_ecm2_tpu_torch.mesh.ncmesh import make_nc, refine_hexes

    t = [time.perf_counter()]
    mesh = make_cardiac_hex_mesh(n)
    t.append(time.perf_counter())
    nc = make_nc(mesh)
    t.append(time.perf_counter())
    for r in NC_ROUNDS:
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        nc, _ = refine_hexes(nc, np.linalg.norm(cent - NC_CENTRE, axis=1) < r)
        t.append(time.perf_counter())
    return nc, np.diff(t)


def nc_rf_system(sp, dev, dtype):
    """The RF-Laplace system on the NC space ``sp``: the masked PᵀAP operator,
    its right-hand side, the lifted boundary values and the broken operator."""
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm

    A_L = BilinearForm(sp.fes, dev).add_domain_integrator("diffusion").assemble(
        dtype=dtype)
    Ac = sp.constrained_operator(A_L.mult)
    m = torch.zeros(sp.ndof_conf, dtype=dtype, device=dev)
    xb = torch.zeros(sp.ndof_conf, dtype=dtype, device=dev)
    for attr, value in ((2, 1.0), (3, 0.0)):
        ess = torch.as_tensor(sp.essential_dofs([attr]), dtype=torch.long, device=dev)
        m[ess] = 1.0
        xb[ess] = value

    def A(v):
        return Ac(v * (1 - m)) * (1 - m) + v * m

    B = -Ac(xb) * (1 - m) + xb
    return A, B, xb, m, A_L


def nc_rf_solve(sp, dev, dtype, rel_tol):
    """(u, CG count, true relative residual) of the RF-Laplace solve."""
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg

    A, B, _, _, _ = nc_rf_system(sp, dev, dtype)
    x, info = cg(A, B, M=lambda r: r, rel_tol=rel_tol, max_iter=NC_SOLVE["max_iter"])
    return x, info.iterations, rel_residual(A, x, B)


def nc_small_cpu():
    """[44]'s CPU side, run in a worker process from the start of the
    script on NC_SMALL_THREADS threads (its float64 CG to 1e-12 takes 1–3
    minutes on 2–4 threads), so that it is done long before [44] and takes
    little from the phases it runs beside: (the n = NC_SMALL_N NC mesh, its
    host seconds, u as numpy, the CG count, the true residual)."""
    from cardiac_ablation_ecm2_tpu_torch.fem.ncfespace import NCFESpace
    from cardiac_ablation_ecm2_tpu_torch.utils.config import configure

    torch.set_num_threads(NC_SMALL_THREADS)
    configure(quad_extra=0)
    nc, host_s = nc_refined(NC_SMALL_N)
    x, its, res = nc_rf_solve(NCFESpace(nc, 2, device="cpu"), "cpu", torch.float64,
                              NC_SMALL_TOL)
    return nc, host_s, x.numpy(), its, res


def start_nc_drivers():
    """The slice's two drivers at their defaults on the card, as subprocesses
    (``EXAMPLE_RUN``: each prints its launches last)."""
    import sys

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    return {name: subprocess.Popen(
        [sys.executable, "-c", EXAMPLE_RUN, name, *args], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in NC_DRIVERS}


def phase_nc_main(kc, dev):
    """[43] the NC-refined cardiac hex RF-Laplace solve; returns (the NC
    space, its broken PA operator, the solve's launches, the kernels line's
    P/Pᵀ numbers)."""
    from cardiac_ablation_ecm2_tpu_torch.fem.build import restriction_for
    from cardiac_ablation_ecm2_tpu_torch.fem.estimators import zz_estimator
    from cardiac_ablation_ecm2_tpu_torch.fem.ncfespace import (
        NCFESpace,
        prolongate_plain,
        restrict_t_plain,
    )
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg

    t_phase = time.perf_counter()
    nc, host_s = nc_refined(NC_N)
    t0 = time.perf_counter()
    sp = NCFESpace(nc, 2, device=dev)
    torch.cuda.synchronize()
    ncfes_s = time.perf_counter() - t0
    print(f"[43] host: make_cardiac_hex_mesh({NC_N}) {host_s[0]:.2f} s, "
          f"make_nc {host_s[1]:.2f} s, rounds "
          f"{host_s[2]:.2f} s and {host_s[3]:.2f} s, NCFESpace {ncfes_s:.2f} s")
    print(f"[43] {nc.mesh.ne:,} hexes; hanging: {len(nc.constraints):,} edge, "
          f"{len(nc.face_constraints):,} face, {len(nc.half_face_constraints):,} "
          f"half-face ({nc.n_hanging:,}); {sp.n_slaves:,} slave dofs (width "
          f"{sp.slave_masters.shape[1]}), {sp.ndof_conf:,} conforming of "
          f"{sp.fes.ndof_scalar:,} broken order-2 dofs")
    check(nc.mesh.ne > 100_000 and sp.n_slaves > 0 and len(nc.face_constraints) > 0,
          "[43] the NC mesh is refined and has face hangers")
    t0 = time.perf_counter()
    A, B, xb, m, A_L = nc_rf_system(sp, dev, torch.float32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    ledger = LaunchLedger()
    A_counted = ledger.wrap("A", A)
    start_main_path()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    x, info = cg(A_counted, B, M=lambda r: r, **NC_SOLVE)
    b.record()
    torch.cuda.synchronize()
    launches = {k: v for k, v in main_path_launches().items() if k in RESTRICTION_KERNELS}
    peak = peak_gib()
    its = info.iterations
    solve_s = a.elapsed_time(b) / 1e3
    res = rel_residual(A, x, B)
    print(f"[43] device set-up {setup_s:.2f} s; cg {its} iterations in {solve_s:.3f} s, "
          f"{solve_s * 1e3 / its:.4f} ms an iteration; true residual of PᵀAP {res:.3e}; "
          f"peak {peak:.2f} GiB")
    check(info.converged and res <= 1e-3, f"[43] converged, true residual ≤ 1e-3 ({res:.2e})")
    bc_err = float(((x - xb) * m).abs().max())
    check(bool(torch.isfinite(x).all()) and float(x.min()) > -0.05
          and float(x.max()) < 1.05 and bc_err <= 1e-4,
          f"[43] u finite, in [0, 1] up to order-2 overshoot, the boundary values "
          f"kept ({bc_err:.1e})")
    n_app = ledger.calls["A"]
    per = dict(zip(RESTRICTION_KERNELS, ledger.per_call["A"][:3]))
    print(f"[43] launches {', '.join(f'{k} {launches[k]}' for k in RESTRICTION_KERNELS)}; "
          f"{n_app} applies of PᵀAP, each {per}")
    check(n_app == its + 1 and not ledger.uneven, "[43] one apply an iteration and one "
          "for the first residual, each launching the same kernels")
    check(per == dict(gather_sum=1, gather_transpose=1, segment_sum=2),
          f"[43] an apply: P's gather, the PA gather and sum, Pᵀ's segment-sum ({per})")
    check(all(launches[k] == n_app * per[k] for k in RESTRICTION_KERNELS),
          "[43] the launches equal the applies times the launches an apply")

    # P and Pᵀ at this shape: kernel path against the plain one, bitwise
    gen = torch.Generator(device=dev).manual_seed(43)
    u = torch.randn(sp.ndof_conf, generator=gen, device=dev)
    v = torch.randn(sp.fes.ndof_scalar, generator=gen, device=dev)
    numbers = {}
    for name, fn, plain, arg in (("P", sp.prolongate, prolongate_plain, u),
                                 ("Pt", sp.restrict_t, restrict_t_plain, v)):
        got, ref = fn(arg), plain(sp, arg)
        check(torch.equal(bits(got), bits(ref)), f"[43] {name} bitwise its plain version")
        numbers[name] = (time_ms(lambda: fn(arg)), time_ms(lambda: plain(sp, arg)))
    lhs = float(sp.restrict_t(v).double() @ u.double())
    rhs = float(v.double() @ sp.prolongate(u).double())
    adj = abs(lhs - rhs) / abs(rhs)
    print(f"[43] P {numbers['P'][0]:.4f} ms (plain {numbers['P'][1]:.4f}), Pᵀ "
          f"{numbers['Pt'][0]:.4f} ms (plain {numbers['Pt'][1]:.4f}), float32; "
          f"⟨Pᵀv, u⟩ against ⟨v, Pu⟩: {adj:.2e} relative")
    check(adj <= 1e-5, f"[43] Pᵀ is P's adjoint ({adj:.2e})")
    check_restriction(kc, sp.restr, "NC master map ", "[43]", seed=430, timed=True)
    check_restriction(kc, restriction_for(sp.fes, dev), "NC broken space ", "[43]",
                      seed=431)

    eta = zz_estimator(sp.fes, sp.prolongate(x), dtype=x.dtype)
    check(eta.shape == (nc.mesh.ne,) and np.isfinite(eta).all() and eta.max() > 0,
          "[43] ZZ estimate finite")
    print(f"[43] ZZ estimator on the prolongated solution: max {eta.max():.4e}, "
          f"median {np.median(eta):.4e}, the largest at "
          f"{np.linalg.norm(nc.mesh.vertices[nc.mesh.elements[eta.argmax()]].mean(axis=0) - NC_CENTRE):.2f} "
          f"mm from the electrode centre")
    print(f"[43] phase {time.perf_counter() - t_phase:.1f} s")
    return sp, A_L, launches, dict(
        nc_p_ms=numbers["P"][0], nc_p_plain_ms=numbers["P"][1],
        nc_pt_ms=numbers["Pt"][0], nc_pt_plain_ms=numbers["Pt"][1])


def _nc_rank(rank, world, dev, sp):
    """[44]'s rank body: the sharded NC Poisson on ``sp`` (u, count, seconds)."""
    from cardiac_ablation_ecm2_tpu_torch.parallel import pnc
    from cardiac_ablation_ecm2_tpu_torch.utils.config import elapsed

    solver = pnc.setup(sp, dtype=torch.float32, device=dev, **NC_SOLVE)
    t0 = time.perf_counter()
    u, its, _ = solver.solve()
    return u, its, elapsed(t0, dev), solver.restr


def nc_poisson_serial(sp, A_L, dev):
    """The serial form of ``parallel/pnc``'s solve on the card: f = 1, u = 0 on
    the whole boundary, Jacobi-PCG with the slave rows of the diagonal folded
    into their masters with w²."""
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf

    rt = torch.float32
    Ac = sp.constrained_operator(A_L.mult)
    m = torch.ones(sp.ndof_conf, dtype=rt, device=dev)
    m[torch.as_tensor(sp.essential_dofs(), dtype=torch.long, device=dev)] = 0.0
    b = sp.restrict_t(domain_lf(sp.fes, None, dtype=rt, device=dev)) * m
    dL = A_L.diagonal()
    w = sp.weights(rt)
    dg = dL[sp._Lc] + sp.restr.mult_transpose(dL[sp._si][:, None] * w * w)
    dg = torch.where(m > 0, dg, torch.ones_like(dg))
    x, info = cg(lambda v: Ac(v * m) * m + v * (1 - m), b, M=lambda r: r / dg,
                 **NC_SOLVE)
    return x, info.iterations


def nc_forest_loop(dev):
    """test_derefine's ex15 moving-bump loop on ``dev`` in float64: the final
    forest's NC mesh, its solve, the errors and the active counts."""
    from cardiac_ablation_ecm2_tpu_torch.fem.estimators import zz_estimator
    from cardiac_ablation_ecm2_tpu_torch.fem.gridfunction import l2_error
    from cardiac_ablation_ecm2_tpu_torch.mesh.forest import (
        AMRForest,
        threshold_derefine_nc,
        threshold_refine_nc,
    )
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_2d

    forest = AMRForest(make_cartesian_2d(8, 8))
    errs, counts = [], []
    for t in (0.0, 0.25, 0.5):
        cx = 0.25 + t

        def u_ex(x, cx=cx):
            return np.exp(-80.0 * ((x[..., 0] - cx) ** 2 + (x[..., 1] - 0.5) ** 2))

        def f(x, cx=cx):
            r2 = (x[..., 0] - cx) ** 2 + (x[..., 1] - 0.5) ** 2
            return (320.0 - 25600.0 * r2) * torch.exp(-80.0 * r2)

        for _ in range(2):
            sp, uL = nc_dirichlet_solve(forest.nc(), u_ex, f, dev)
            if not threshold_refine_nc(forest, zz_estimator(sp.fes, uL), frac=0.5,
                                       max_elements=700):
                break
        sp, uL = nc_dirichlet_solve(forest.nc(), u_ex, f, dev)
        eta = zz_estimator(sp.fes, uL)
        threshold_derefine_nc(forest, eta, threshold=0.3 * eta.max())
        nc = forest.nc()
        sp, uL = nc_dirichlet_solve(nc, u_ex, f, dev)
        errs.append(float(l2_error(sp.fes, uL, lambda x, cx=cx: torch.exp(
            -80.0 * ((x[..., 0] - cx) ** 2 + (x[..., 1] - 0.5) ** 2)))))
        counts.append(len(forest.active))
    return nc, uL, errs, counts


def nc_dirichlet_solve(nc, u_exact, f, dev, p=2):
    """test_derefine's ``_solve_nc`` in float64 on ``dev``: (space, broken u)."""
    from cardiac_ablation_ecm2_tpu_torch.fem.ncfespace import NCFESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf

    f64 = dict(dtype=torch.float64, device=dev)
    sp = NCFESpace(nc, p, device=dev)
    A = BilinearForm(sp.fes, dev).add_domain_integrator("diffusion").assemble(
        dtype=torch.float64)
    AC = sp.constrained_operator(A.mult)
    ess = torch.as_tensor(sp.essential_dofs(), dtype=torch.long, device=dev)
    xb = torch.as_tensor(u_exact(sp.dof_coords), **f64)
    w = torch.zeros(sp.ndof_conf, **f64).index_copy(0, ess, xb[ess])
    b = (sp.restrict_t(domain_lf(sp.fes, f, **f64)) - AC(w)).index_copy(0, ess, xb[ess])

    def op(x):
        return AC(x.index_fill(0, ess, 0.0)).index_copy(0, ess, x[ess])

    x, info = cg(op, b, rel_tol=1e-10, max_iter=4000)
    check(info.converged, "[44] forest solve converged")
    return sp, sp.prolongate(x)


def nc_tet_case(dev):
    """The NC tet order-2 case of test_nctet (2×2×2 tets, one red round): the
    masked Poisson solve in float64 (u, count) and P/Pᵀ of a seeded vector."""
    from cardiac_ablation_ecm2_tpu_torch.fem.ncfespace import NCFESpace
    from cardiac_ablation_ecm2_tpu_torch.linalg.solvers import cg
    from cardiac_ablation_ecm2_tpu_torch.mesh.mesh import make_cartesian_3d_tet
    from cardiac_ablation_ecm2_tpu_torch.mesh.nctet import make_nc_tet, refine_tets_nc
    from cardiac_ablation_ecm2_tpu_torch.ops.bilinearform import BilinearForm
    from cardiac_ablation_ecm2_tpu_torch.ops.linearform import domain_lf

    nc = make_nc_tet(make_cartesian_3d_tet(2, 2, 2))
    cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
    nc, _ = refine_tets_nc(nc, np.linalg.norm(cent, axis=1) < 0.6)
    f64 = dict(dtype=torch.float64, device=dev)
    sp = NCFESpace(nc, 2, device=dev)
    A = BilinearForm(sp.fes, dev).add_domain_integrator("diffusion").assemble(
        dtype=torch.float64)
    AC = sp.constrained_operator(A.mult)
    m = torch.ones(sp.ndof_conf, **f64)
    m[torch.as_tensor(sp.essential_dofs(), dtype=torch.long, device=dev)] = 0.0
    k2 = 3 * np.pi ** 2
    b = sp.restrict_t(domain_lf(sp.fes, lambda x: k2 * torch.prod(
        torch.sin(np.pi * x), dim=-1), **f64)) * m
    x, info = cg(lambda v: AC(v * m) * m + v * (1 - m), b, rel_tol=1e-10, max_iter=6000)
    rng = np.random.default_rng(44)
    uc = torch.as_tensor(rng.standard_normal(sp.ndof_conf), **f64)
    vL = torch.as_tensor(rng.standard_normal(sp.fes.ndof_scalar), **f64)
    return (x.cpu().numpy(), info.iterations, sp.prolongate(uc).cpu().numpy(),
            sp.restrict_t(vL).cpu().numpy(), len(nc.tri_face_constraints))


def phase_nc_rest(kc, dev, sp, A_L, small):
    """[44] the rest of the NC slice on the card: the [43] pipeline at n =
    NC_SMALL_N in float64 against the CPU (``small``: the future of
    ``nc_small_cpu``), ``parallel/pnc`` at world 1 over NCCL on [43]'s
    space against the serial card solve, the NC tet order-2 case and the
    AMRForest loop against the CPU, the two drivers as subprocesses.
    Returns the launches of the sharded run."""
    from cardiac_ablation_ecm2_tpu_torch.fem.ncfespace import NCFESpace
    from cardiac_ablation_ecm2_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    drivers = start_nc_drivers()
    try:
        t0 = time.perf_counter()
        nc, host_s, xh, ith, _ = small.result()
        waited = time.perf_counter() - t0
        xc, itc, resc = nc_rf_solve(NCFESpace(nc, 2, device=dev), dev, torch.float64,
                                    NC_SMALL_TOL)
        xc = xc.cpu().numpy()
        err = float(np.abs(xc - xh).max() / np.abs(xh).max())
        from cardiac_ablation_ecm2_tpu_torch.mesh.ncmesh import _find_constraints_3d

        over = len(_find_constraints_3d(nc.mesh)[3])
        print(f"[44] NC RF-Laplace on make_cardiac_hex_mesh({NC_SMALL_N}) with two "
              f"rounds ({nc.mesh.ne:,} hexes, {over} over-hung faces left by the "
              f"balance, host {host_s.sum():.2f} s), float64, "
              f"rel_tol {NC_SMALL_TOL:g}: card {itc} CG (true residual {resc:.2e}), CPU "
              f"{ith} CG (waited {waited:.1f} s for its worker process); u "
              f"{err:.2e} of max|u| apart")
        check(err <= 1e-10 and abs(itc - ith) <= 2, "[44] card against CPU: u within "
              "1e-10 of max|u|, CG counts within 2")

        x_ser, its_ser = nc_poisson_serial(sp, A_L, dev)
        start_main_path()
        u, its, secs, restr = launch.run_single(lambda r, w, d: _nc_rank(r, w, d, sp))
        par_launches = vecfe_launches()
        x_ser = x_ser.double().cpu().numpy()
        err = float(np.abs(u - x_ser).max() / np.abs(x_ser).max())
        print(f"[44] parallel/pnc world 1 over NCCL on [43]'s space: {its} CG in "
              f"{secs:.2f} s against the serial card solve's {its_ser}; u {err:.2e} of "
              f"max|u| apart; launches " + launch_line(par_launches))
        check(abs(its - its_ser) <= 2 and err <= 1e-4, "[44] sharded NC Poisson: counts "
              "within 2, u within 1e-4 of max|u|")
        check(par_launches["gather_sum"] > 0 and par_launches["segment_sum"] > 0,
              "[44] the sharded NC solve launched the rank's gather and segment-sum")
        check_restriction(kc, restr, "pnc local master map ", "[44]", seed=440)

        card, cpu = nc_tet_case(dev), nc_tet_case("cpu")
        err = float(np.abs(card[0] - cpu[0]).max() / np.abs(cpu[0]).max())
        perr = max(float(np.abs(card[i] - cpu[i]).max() / np.abs(cpu[i]).max())
                   for i in (2, 3))
        print(f"[44] NC tets order 2 ({card[4]} tri-face masters), float64: card {card[1]} "
              f"CG, CPU {cpu[1]}; u {err:.2e}, P/Pᵀ {perr:.2e} of max apart")
        check(card[4] > 0 and err <= 1e-10 and abs(card[1] - cpu[1]) <= 2 and perr <= 1e-14,
              "[44] NC tets: card against CPU")

        nc_f, u_f, errs, counts = nc_forest_loop(dev)
        _, u_h = nc_dirichlet_solve(nc_f, lambda x: np.exp(
            -80.0 * ((x[..., 0] - 0.75) ** 2 + (x[..., 1] - 0.5) ** 2)),
            lambda x: (320.0 - 25600.0 * ((x[..., 0] - 0.75) ** 2 + (x[..., 1] - 0.5) ** 2))
            * torch.exp(-80.0 * ((x[..., 0] - 0.75) ** 2 + (x[..., 1] - 0.5) ** 2)), "cpu")
        ferr = float((u_f.cpu() - u_h).abs().max() / u_h.abs().max())
        print(f"[44] AMRForest ex15 loop on the card: L2 errors "
              f"{', '.join(f'{e:.3e}' for e in errs)}, active counts {counts}; the last "
              f"solve {ferr:.2e} of max|u| from the CPU's")
        check(all(e < 2e-3 for e in errs) and counts[-1] < 700
              and counts[-1] < 3 * counts[0] and ferr <= 1e-10, "[44] the forest loop")

        for name, p in drivers.items():
            try:
                so, se = p.communicate(timeout=600)
            finally:
                p.kill()
            lines = so.strip().splitlines()
            for line in lines[:-1]:
                print(f"[44] {name}: {line}")
            check(p.returncode == 0, f"[44] {name} exits 0 (stderr: {se[-2000:]})")
            check(lines[-2].startswith(NC_DRIVER_LAST[name]), f"[44] {name} prints its lines")
            got = json.loads(lines[-1][len("LAUNCHES "):])
            print(f"[44] {name} launches: " + ", ".join(f"{k} {v}" for k, v in got.items()))
            if name == "boundary_layer_amr":
                check(all(got[k] > 0 for k in RESTRICTION_KERNELS),
                      "[44] the boundary-layer driver launched the restriction kernels")
    finally:
        for p in drivers.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"[44] phase {time.perf_counter() - t_phase:.1f} s")
    return par_launches


def phase_dryrun():
    """``dryrun_multichip`` over every visible card (one spawned rank a
    card, NCCL): the sharded bioheat step, the sharded NC Poisson (a), DG
    apply (b) and ND solve (c)."""
    from cardiac_ablation_ecm2_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    out = dryrun_multichip(n)
    print(f"[dryrun] dryrun_multichip({n}), the bioheat step and parts (a)-(c): "
          f"{out.shape[0]} dofs, T_max "
          f"{out.max():.6f}, {time.perf_counter() - t0:.1f} s")


def main():
    from cardiac_ablation_ecm2_tpu_torch.fem.fespace import FESpace
    from cardiac_ablation_ecm2_tpu_torch.mesh.cardiac import make_cardiac_hex_mesh
    from cardiac_ablation_ecm2_tpu_torch.utils.config import configure

    t_start = time.perf_counter()
    dev = phase_device()
    configure(quad_extra=0)          # bench.py's setting: nq1d = p + 1
    phase_build()

    # the n=66 tet mesh's Delaunay (30-50 s on the host) runs in a worker
    # process beside the hex phases
    tet_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    tet_built = tet_pool.submit(cardiac_tet_mesh, 66)
    # [44]'s float64 CPU solve runs in a worker process from the start too
    nc_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    nc_small = nc_pool.submit(nc_small_cpu)
    kc = KernelCheck(dev)
    phase_kernel_random(kc)
    t0 = time.perf_counter()
    hex_mesh = make_cardiac_hex_mesh(126, lengths=(L, L, L / 2),
                                     electrode_radius=0.004)
    t1 = time.perf_counter()
    fes = FESpace(hex_mesh, 2)
    t2 = time.perf_counter()
    check((hex_mesh.ne, fes.ndof) == (995_336, 8_092_657), "n=126 mesh size")
    phase_kernel_restriction(kc, fes)
    phase_small_end_to_end(dev)
    hex_launches, *hex_run = phase_main(dev, hex_mesh, fes, (t1 - t0, t2 - t1))
    bf16_numbers = phase_modes(dev, fes, hex_run)
    phase_par_small(dev)
    par_launches = phase_par_main(kc, dev, hex_mesh, fes)
    mesh_s = t1 - t0
    hex_fes = fes                  # kept on the host for [29] and [31]
    for cache in ("_restrictions", "_geom_factors", "_bdr_restrictions", "_bdr_geom"):
        hex_fes.__dict__.pop(cache, None)
    del fes

    t0 = time.perf_counter()
    built = tet_built.result()
    tet_pool.shutdown()
    print(f"[7] the tet mesh from its worker process: built in {built[1]:.2f} s, "
          f"waited {time.perf_counter() - t0:.2f} s for it")
    mesh, fes, host_s = tet_space(66, built)
    check((mesh.ne, fes.ndof) == (956_820, 1_278_670), "tet n=66 mesh size")
    phase_tet_restriction(kc, fes)
    ell_numbers = phase_ell_kernel(dev, fes)
    phase_tet_small(dev)
    tet_launches, ell_run = phase_tet_main(dev, mesh, fes, host_s)
    pa_launches = phase_tet_pa(kc, dev, mesh, fes, host_s, ell_run)
    phase_par_tet(kc, dev, mesh, fes)
    del fes
    phase_ablation_tet(dev, mesh, host_s)
    del mesh

    phase_diffusion_kernel(dev)
    _, theta48 = phase_lattice48(dev)
    phase_par_lattice(dev, theta48)
    del theta48
    op, masked_launches = phase_masked(dev)
    err, fd_numbers = check_operator_diffusion("[8]", "masked n=126 K_qd", op,
                                               timed=True)
    fd_numbers["max_abs_err"] = err
    del op

    probe_numbers = phase_probes(dev)
    phase_ablation_small(dev, make_cardiac_hex_mesh(
        16, lengths=(L, L, L / 2), electrode_radius=0.004))
    phase_ablation_main(dev, hex_mesh, mesh_s)
    _, poisson_ref = phase_poisson(kc, dev, hex_mesh, hex_fes)
    phase_par_poisson(kc, dev, hex_mesh, poisson_ref)
    del hex_mesh, poisson_ref
    for cache in ("_restrictions", "_geom_factors", "_bdr_restrictions", "_bdr_geom"):
        hex_fes.__dict__.pop(cache, None)
    phase_heat(kc, dev, n=EX16_N)
    phase_entry(dev)
    bp_launches, bp_numbers = phase_bp(kc, dev)
    phase_elasticity(kc, dev)
    phase_gmres(kc, dev)
    hmg_launches, spaces, ht, refined_rt = phase_hmg(kc, dev)
    d2_launches = phase_2d(kc, dev)
    refine_launches = phase_prefine(kc, dev, spaces, ht)
    del spaces, ht
    example_launches = phase_examples(kc, dev)
    beam_fes = beam_space(HYPER_MAIN)
    phase_restriction_derivatives(dev, (("hex n=126", hex_fes), (
        f"ex10 beam {'x'.join(map(str, HYPER_MAIN))}", beam_fes)))
    hyper_launches, _ = phase_hyperelastic(kc, dev, beam_fes)
    del beam_fes
    wave_launches, _ = phase_wave(kc, dev, hex_fes)
    mag_mesh = hex_fes.mesh          # the n=126 mesh, for [39]
    del hex_fes
    rest_launches = phase_rest(dev)
    adv_fes, dg_launch, u_par, dg_numbers = phase_dg_advection(kc, dev)
    sipg_fes, sipg_launch, sipg_its, x_sipg = phase_sipg(kc, dev)
    pdg_launch = phase_par_dg(kc, dev, adv_fes, u_par, sipg_fes, sipg_its, x_sipg)
    del adv_fes, sipg_fes, u_par, x_sipg
    condense_launch = phase_condense_complex(kc, dev)
    phase_rest_dg(kc, dev)
    ams_launch, jac_launch, ex3_numbers = phase_ex3(kc, dev)
    mag_launch = phase_magnetic(kc, dev, mag_mesh)
    del mag_mesh
    hdiv_launch = phase_hdiv(kc, dev)
    vrest_launch = phase_rest_vecfe(dev)
    pvec_launch = phase_pvecfe(kc, dev)
    nc_sp, nc_A, nc_launch, nc_numbers = phase_nc_main(kc, dev)
    pnc_launch = phase_nc_rest(kc, dev, nc_sp, nc_A, nc_small)
    nc_pool.shutdown()
    del nc_sp, nc_A
    phase_dryrun()

    print(f"total {time.perf_counter() - t_start:.1f} s")

    def dg_path_launches(k):
        """[33]-[36]'s launches of kernel k."""
        return dict(dg_launches=dg_launch[k], sipg_launches=sipg_launch[k],
                    pdg_launches=pdg_launch[k], condense_launches=condense_launch[k])

    def vecfe_path_launches(k):
        """[38]-[42]'s launches of kernel k."""
        return dict(ex3_ams_launches=ams_launch[k], ex3_jacobi_launches=jac_launch[k],
                    magnetic_launches=mag_launch[k], hdiv_launches=hdiv_launch[k],
                    vecfe_rest_launches=vrest_launch[k], pvecfe_launches=pvec_launch[k])

    # the restriction's kernels at their hex main-path shapes, float32: the
    # element-major L->E (the residual's), the L->E into (nd, ne) and the
    # E->L from it (one CG apply's round trip)
    rows = {"gather_sum": "L->E (ne,nd) float32",
            "gather_transpose": "L->E (nd,ne) float32",
            "segment_sum": "E->L (nd,ne) float32"}
    restriction = [
        dict(name=k, route="cuda", **KERNELS[k], launches=hex_launches[k],
             parallel_launches=par_launches[k],
             max_abs_err=kc.max_abs_err[k], bound_by="bytes",
             **{f: kc.times[label][f]
                for f in ("ms", "plain_ms", "bound_ms", "library_ms")})
        for k, label in rows.items()]
    # the tet partial-assembly path's (956,820 × 10) restriction ([16])
    tet_rows = {"gather_transpose": "tet L->E (nd,ne) float32",
                "segment_sum": "tet E->L (nd,ne) float32"}
    for entry in restriction:
        if entry["name"] in tet_rows:
            entry.update({f"tet_{f}": kc.times[tet_rows[entry["name"]]][f]
                          for f in ("ms", "plain_ms", "bound_ms", "library_ms")},
                         tet_launches=pa_launches[entry["name"]])
    # the gather_sum entry's ms is the element-major L->E alone; before the
    # (nd, ne) directions had kernels of their own, this entry timed the hex
    # CG apply's round trip (mult_t + mult_transpose_t, both on gather_sum),
    # which round_trip_* keeps like for like (now gather_transpose +
    # segment_sum)
    restriction[0].update(
        measures="ms: L->E (ne,nd); round_trip_*: the hex CG apply's mult_t "
                 "+ mult_transpose_t, as this entry's ms measured it before",
        **kc.round_trip)
    # the BP runs' order-4 restrictions ([19]): hex nd = 125, tet nd = 35
    bp_rows = {"gather_transpose": "L->E (nd,ne) float32",
               "segment_sum": "E->L (nd,ne) float32"}
    for entry in restriction:
        if entry["name"] in bp_rows:
            for geom in ("hex", "tet"):
                label = f"BP {geom} order 4 {bp_rows[entry['name']]}"
                entry.update({f"bp_{geom}_o4_{f}": kc.times[label][f]
                              for f in ("ms", "plain_ms", "bound_ms", "library_ms")})
            entry["bp_launches"] = bp_launches[entry["name"]]
    # the mesh core's paths ([25]-[28]) and the refined fine level's
    # restriction (1,043,520 x 27, children numbered o*ne_c + e)
    for entry in restriction:
        k = entry["name"]
        entry.update(hmg_launches=hmg_launches[k], d2_launches=d2_launches[k],
                     refine_launches=refine_launches[k],
                     example_launches=example_launches[k],
                     hyperelastic_launches=hyper_launches[k],
                     wave_launches=wave_launches[k], rest_launches=rest_launches[k],
                     **dg_path_launches(k), **vecfe_path_launches(k))
        if k in ex3_numbers:
            entry.update({f"ex3_{f}": v for f, v in ex3_numbers[k].items()})
        if k in bp_rows:
            entry.update({f"refined_{f}": kc.times[f"refined fine {bp_rows[k]}"][f]
                          for f in ("ms", "plain_ms", "bound_ms", "library_ms")})
    restriction[0].update({f"refined_round_trip_{f}": v
                           for f, v in refined_rt.items()})
    # the NC slice: [43]'s solve and [44]'s sharded run; the master map's
    # (n_slaves, width) L->E (P's read) and E->L (Pᵀ's sum), float32, and P
    # and Pᵀ whole
    nc_rows = {"gather_sum": "NC master map L->E (ne,nd) float32",
               "segment_sum": "NC master map E->L (ne,nd) float32"}
    for entry in restriction:
        k = entry["name"]
        entry.update(nc_launches=nc_launch[k], pnc_launches=pnc_launch[k])
        if k in nc_rows:
            entry.update({f"nc_map_{f}": kc.times[nc_rows[k]][f]
                          for f in ("ms", "plain_ms", "bound_ms", "library_ms")})
    restriction[0].update(nc_p_ms=nc_numbers["nc_p_ms"],
                          nc_p_plain_ms=nc_numbers["nc_p_plain_ms"])
    restriction[2].update(nc_pt_ms=nc_numbers["nc_pt_ms"],
                          nc_pt_plain_ms=nc_numbers["nc_pt_plain_ms"])
    # the DG face route's float32 numbers at [33]'s interior-face read
    # (324,864 rows of 64) and slot list (49.5M slots into 7,077,888 dofs)
    restriction[2].update({f"dg_{f}": dg_numbers["segment_sum"][f]
                           for f in ("ms", "plain_ms", "bound_ms", "library_ms")})
    probe_numbers["take_rows"].update(
        {f"dg_{f}": dg_numbers["take_rows"][f]
         for f in ("ms", "plain_ms", "bound_ms", "library_ms")},
        **dg_path_launches("take_rows"))
    print(json.dumps({"kernels": restriction + [
        dict(name="ell_spmv", route="cuda", **KERNELS["ell_spmv"],
             launches=tet_launches["ell_spmv"],
             max_abs_err=ell_numbers["max_abs_err"], ms=ell_numbers["ms"],
             plain_ms=ell_numbers["plain_ms"], bound_ms=ell_numbers["bound_ms"],
             bound_by="bytes", library_ms=ell_numbers["library_ms"],
             bp_launches=bp_launches["ell_spmv"], **bp_numbers),
        dict(name="fused_diffusion", route="cuda", **KERNELS["fused_diffusion"],
             launches=masked_launches["fused_diffusion"],
             parallel_launches=par_launches["fused_diffusion"], **fd_numbers,
             **bf16_numbers, hmg_launches=hmg_launches["fused_diffusion"],
             d2_launches=d2_launches["fused_diffusion"],
             example_launches=example_launches["fused_diffusion"],
             wave_launches=wave_launches["fused_diffusion"],
             rest_launches=rest_launches["fused_diffusion"],
             **dg_path_launches("fused_diffusion"),
             **vecfe_path_launches("fused_diffusion"),
             pnc_launches=pnc_launch["fused_diffusion"]),
    ] + [dict(name=k, route="cuda", **KERNELS[k], **probe_numbers[k],
              measures=PROBE_MEASURES) for k in PROBE_KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
