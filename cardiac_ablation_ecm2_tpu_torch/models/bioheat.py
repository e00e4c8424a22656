"""Pennes bioheat equation (counterpart of
``cardiac_ablation_ecm2_tpu/models/bioheat.py``):

    ρc ∂T/∂t = ∇·(k ∇T) − ω_b c_b (T − T_a) + Q_met(x)

discretized as M_ρc dT/dt = −(K_k + M_ω) T + M_ω T_a·1 + b(Q_met), with
essential (boundary) temperatures.  ``implicit_solve`` solves
(M_ρc + γ(K_k + M_ω)) k = rhs with k = 0 on essential dofs by Jacobi-PCG
(classic, or the single-reduction ``cg_merged``); ``mult`` is the explicit
stage M_ρc⁻¹(b − A T), a Jacobi-PCG solve with M_ρc.

Apply paths, chosen at setup as in the JAX package, on hexes and tets:

* assembled ELL (``assembled_apply="ell"``, a simplex option): M_ρc and
  A = K + M_ω are assembled to CSR (``ops/bilinearform.py``) and packed as
  one sliced-ELL pair (``ops/ell.py``); the stage operator and the residual
  are one weighted SpMV each.  The right-hand side and the Jacobi diagonals
  still come from the partial-assembly setup;
* lane-major (``transposed_apply``, the default): L→E into (nd, ne), one
  fused stacked matmul apply per quadrature point (``ops/lanemajor.py``:
  Kronecker matrices on hexes, the dense basis on tets), E→L;
* affine: with constant coefficients on straight-sided simplices the
  factors come from the vertices in float64
  (``fem/geom_factors.affine_packed_factors``); elsewhere when every qdata
  array separates numerically as W ⊗ d.  The apply then runs on reference
  matrices;
* element-major (``ops/mass.py``, ``ops/diffusion.py``): the residual
  (K + M_ω)T off the affine path, and the stage operator when
  ``transposed_apply`` is off.  On hexes its diffusion half is the fused
  kernel ``ops/fused_diffusion.py`` on the card (which also takes the
  bfloat16 qdata of ``qdata_bf16``); on tets it is the einsum chain.

A ``CartesianFESpace`` (``fem/cartesian.py``) brings its gather-free
structured restriction, which every apply then goes through;
``collapse_uniform_qdata`` shares one element's qdata when all are equal.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.coefficient import eval_coeff
from ..fem.fespace import element_node_coords
from ..fem.geom_factors import (
    affine_element_jacobians,
    affine_packed_factors,
    compute_geometric_factors,
)
from ..fem.quadinterp import eval_values_t
from ..linalg.solvers import cg, cg_merged, default_dot
from ..ops import diffusion, lanemajor, mass
from ..ops.bilinearform import BilinearForm
from ..ops.ell import MultiELLPair
from ..utils.config import config, elapsed, real_t, resolve_device


def _collapse_uniform(qd: torch.Tensor, dim: int) -> torch.Tensor:
    """Element axis ``dim`` collapsed to size 1 when every element's qdata
    equals the first element's to 1e-12 relative (a uniform lattice with
    constant coefficients), as the JAX package's ``_collapse_uniform``."""
    ref = qd.narrow(dim, 0, 1)
    scale = float(ref.abs().max())
    dev = float((qd - ref).abs().max())
    if scale > 0 and dev <= 1e-12 * scale:
        return ref.clone()
    return qd


class BioheatOperator:
    """Time-dependent operator of the Pennes equation on one device.

    Physical parameters (SI): ``rho_c`` volumetric heat capacity, ``k``
    conductivity, ``w_cb`` perfusion ω_b·c_b, ``T_a`` arterial temperature,
    ``q_met`` volumetric source (scalar or callable of the (ne, nq, 3)
    quadrature-point coordinates, written with torch operations), ``q_rf``
    the RF (Joule, SAR) source, an (ne, nq) Q-vector or a coefficient,
    added to ``q_met``.

    ``theta_form`` solves for θ = T − T_a (boundary temperature T_a), which
    keeps float32 precision on the rise; on the ELL path its right-hand
    side is (Q_met, v) alone, where the JAX package subtracts A(T_a·1)
    through the float32 apply (equal in exact arithmetic, K·1 = 0).
    ``fused_setup`` builds the
    diffusion qdata in packed form elementwise (``diffusion.setup_packed``)
    instead of packing the full matrices.  ``dot_mode`` "auto" takes plain
    dots in the working dtype when ``rel_tol`` ≥ 1e-6 and float64-accumulated
    ones otherwise.  ``elem_mask`` (ne,) zeroes inactive elements;
    ``ess_dofs`` adds explicit essential dofs.  ``collapse_uniform_qdata``
    keeps one element's qdata when every element's is equal to 1e-12
    relative (after the diagonals, before the apply is chosen, as in the JAX
    package); ``collapsed`` says whether it did.  Each solve appends its CG
    iteration count to ``cg_iterations``.  ``cg_variant`` "merged" solves
    with the single-reduction ``cg_merged`` (the same iterates, one host
    read an iteration as ``cg``).  ``qdata_bf16`` stores the diffusion
    qdata in bfloat16 off the affine path (after the diagonals; the
    products promote it to the working dtype, and the hex residual's
    kernel reads it as bfloat16).  ``assembled_apply`` "ell"
    applies the stage operator and the residual through the assembled
    sliced-ELL pair; ``setup_seconds`` then splits the setup time into the
    partial-assembly part and the ELL pair's assembly and packing.
    ``device=None`` is the card; pass ``device="cpu"`` for the CPU.
    """

    def __init__(
        self,
        fes,
        *,
        rho_c=3.6e6,
        k=0.54,
        w_cb=0.0,
        T_a: float = 37.0,
        q_met=0.0,
        q_rf=None,
        ess_bdr: Optional[Sequence[int]] = None,
        elem_mask=None,
        ess_dofs=None,
        rel_tol: float = 1e-10,
        max_iter: int = 1000,
        dtype=None,
        device=None,
        fused_setup: bool = False,
        theta_form: bool = False,
        dot_mode: str = "auto",
        cg_variant: str = "classic",
        qdata_bf16: bool = False,
        transposed_apply: bool = True,
        collapse_uniform_qdata: bool = False,
        assembled_apply: str = "off",
        arrays: Optional[dict] = None,
    ):
        if cg_variant not in ("classic", "merged"):
            raise ValueError(f"cg_variant must be 'classic' or 'merged', "
                             f"got {cg_variant!r}")
        if assembled_apply not in ("off", "ell"):
            raise ValueError(f"assembled_apply must be 'off' or 'ell', "
                             f"got {assembled_apply!r}")
        self.fes = fes
        self.rho_c, self.k, self.w_cb, self.T_a = rho_c, k, w_cb, T_a
        self.q_met, self.q_rf = q_met, q_rf
        self.ess_bdr, self.elem_mask, self.ess_dofs = ess_bdr, elem_mask, ess_dofs
        self.rel_tol, self.max_iter = rel_tol, max_iter
        self.dtype = real_t(dtype)
        self.device = resolve_device(device)
        self.fused_setup, self.theta_form = fused_setup, theta_form
        self.dot_mode = dot_mode
        self.cg_variant, self.qdata_bf16 = cg_variant, qdata_bf16
        self.transposed_apply = transposed_apply
        self.collapsed = False
        self.cg_iterations = []
        self.setup_seconds = {}

        self.restr = restriction_for(fes, self.device)
        self.db = basis_for(fes, self.dtype, self.device)
        self._ell = self._ell_A = self._lane = self._aff = None
        if arrays is None:
            # θ form on the ELL path: b_θ = b − A(T_a·1) is assembled as
            # (Q_met, v) alone, since M_ω T_a·1 − T_a(K + M_ω)·1 = −T_a K·1
            # = 0 in exact arithmetic.  The JAX package subtracts A(T_a·1)
            # through the ELL apply, where K's rows rounded to float32 leave
            # T_a-sized noise that costs the first step's solves ~50% more
            # CG iterations at n=66 (PERF.md).
            exact_theta = theta_form and assembled_apply == "ell"
            t0 = time.perf_counter()
            self._assemble(exact_theta)
            self._set_essential()
            self._diagonals()
            if collapse_uniform_qdata:
                self._collapse()
            self.setup_seconds["pa"] = elapsed(t0, self.device)
            if assembled_apply == "ell":
                self._set_ell(self._build_ell_pair())
            else:
                self._choose_apply(self.Mrc_qd, self.Mw_qd, self.K_qd)
                self._to_bf16()
            if theta_form and not exact_theta:
                # b_θ = b − A(T_a·1): computed once at setup
                ones = torch.ones(fes.ndof, dtype=self.dtype, device=self.device)
                self.b_const = self.b_const - self._A_apply(self.T_a * ones)
        else:
            self._load(arrays)

    # -- setup -------------------------------------------------------------
    def _tensor(self, a):
        return torch.tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def _assemble(self, exact_theta=False):
        """qdata, constant RHS M_ω T_a·1 + (Q_met + Q_rf, v); with
        ``exact_theta`` the θ-form RHS (Q_met + Q_rf, v) alone.  The
        geometric factors are the space's shared ones (``fem/build.py``),
        except with ``fused_setup``, which the JAX package computes from the
        node coordinates inside its setup and keeps nowhere."""
        fes = self.fes
        if self.fused_setup:
            gf = compute_geometric_factors(element_node_coords(fes.mesh, fes.order),
                                           fes.d2q, self.dtype, self.device)
        else:
            gf = geom_factors_for(fes, None, self.dtype, self.device)
        qm = mass.setup(gf, eval_coeff(self.rho_c, gf, self.dtype))
        qw = mass.setup(gf, eval_coeff(self.w_cb, gf, self.dtype))
        k_q = eval_coeff(self.k, gf, self.dtype)
        if self.fused_setup:
            qk = diffusion.setup_packed(gf, k_q)
        else:
            qk = diffusion.pack_sym(diffusion.setup(gf, k_q))
        src_q = eval_coeff(self.q_met, gf, self.dtype)
        if self.q_rf is not None:
            rf_q = eval_coeff(self.q_rf, gf, self.dtype)
            src_q = rf_q if src_q is None else src_q + rf_q
        q = torch.zeros_like(qw) if exact_theta else qw * self.T_a
        if src_q is not None:
            q = q + gf.wdet * src_q
        if self.elem_mask is not None:
            m = self._tensor(self.elem_mask)
            qm = qm * m[:, None]
            qw = qw * m[:, None]
            qk = qk * m[None, :, None]
            q = q * m[:, None]
        self.Mrc_qd, self.Mw_qd, self.K_qd = qm, qw, qk
        self.b_const = self.restr.mult_transpose(eval_values_t(self.db, q))

    def _set_essential(self):
        # ess_bdr=None/() means natural BCs everywhere
        fes = self.fes
        ess = (fes.essential_dofs(self.ess_bdr) if self.ess_bdr
               else np.zeros(0, dtype=np.int32))
        if self.ess_dofs is not None:
            ess = np.union1d(np.asarray(ess, np.int64),
                             np.asarray(self.ess_dofs, np.int64))
        self.has_ess = len(ess) > 0
        mask = np.ones(fes.ndof, dtype=np.float64)
        mask[np.asarray(ess, np.int64)] = 0.0
        self.ess_mask = self._tensor(mask)

    def _diagonals(self):
        restr, db = self.restr, self.db
        self.Mrc_diag = restr.mult_transpose(mass.diagonal(db, self.Mrc_qd))
        self.A_diag = restr.mult_transpose(
            diffusion.diagonal(db, self.K_qd) + mass.diagonal(db, self.Mw_qd))

    def _collapse(self):
        self.Mrc_qd = _collapse_uniform(self.Mrc_qd, 0)
        self.Mw_qd = _collapse_uniform(self.Mw_qd, 0)
        self.K_qd = _collapse_uniform(self.K_qd, 1)
        self.collapsed = self.K_qd.shape[1] < self.fes.mesh.ne

    def _build_ell_pair(self):
        """FULL assembly of M_ρc and A = K + M_ω (as the JAX package's
        ``_build_ell_pair``, in the configured dtype) packed as one
        sliced-ELL pair in the working dtype."""
        fes, dev = self.fes, self.device
        t0 = time.perf_counter()
        M = BilinearForm(fes, dev).add_domain_integrator(
            "mass", self.rho_c).assemble_matrix()
        A = BilinearForm(fes, dev).add_domain_integrator(
            "diffusion", self.k).assemble_matrix()
        if np.ndim(self.w_cb) != 0 or float(np.asarray(self.w_cb)) != 0.0:
            A = A + BilinearForm(fes, dev).add_domain_integrator(
                "mass", self.w_cb).assemble_matrix()
        t1 = time.perf_counter()
        pair = MultiELLPair.from_csr_pair(M, A, self.dtype, dev)
        self.setup_seconds["ell_assembly"] = t1 - t0
        self.setup_seconds["ell_pair"] = elapsed(t1, self.device)
        return pair

    def _set_ell(self, pair):
        """The ELL pair, and the residual's one-plane operator K + M_ω
        formed from it once, c0 = 0 and c1 = 1 (the stage plane's formula)."""
        self._ell = pair
        self._ell_A = None if pair is None else pair.combined(0.0, 1.0)

    def _choose_apply(self, qm, qw, qk):
        """Lane-major arrays, and the affine factors where the geometry or
        the qdata separate: the JAX package's detectors in its order, the
        vertices of a straight-sided simplex mesh in float64 first (with
        the factor k·dk formed in float64, then cast), else the numerical
        W ⊗ d check."""
        self._lane = self._aff = None
        if not (self.transposed_apply
                and lanemajor.supports(self.db, qk, "diffusion")):
            return
        self._lane = lanemajor.lane_basis(self.db)
        self._qkT = lanemajor.diffusion_qT(qk)       # (6, nq, ne)
        self._qmT = qm.T.contiguous()                # (nq, ne)
        self._qwT = qw.T.contiguous()
        if config.affine_collapse == "off" or not all(
                not callable(c) and np.ndim(c) == 0
                for c in (self.rho_c, self.k, self.w_cb)):
            return
        J = affine_element_jacobians(self.fes.mesh)
        if J is not None:
            det, dkf = affine_packed_factors(J)
            dk, dm, dw = (self._tensor(float(c) * f) for c, f in (
                (self.k, dkf), (self.rho_c, det), (self.w_cb, det)))
            if self.elem_mask is not None:
                # inactive elements contribute nothing, as in the qdata (the
                # JAX package's vertex factors leave them in)
                m = self._tensor(self.elem_mask)
                dk, dm, dw = dk * m, dm * m, dw * m
        else:
            W = self.db.W
            dk = lanemajor.separable_collapse(self._qkT, W)
            dm = lanemajor.separable_collapse(self._qmT, W)
            dw = lanemajor.separable_collapse(self._qwT, W)
        if dk is not None and dm is not None and dw is not None:
            self._aff = lanemajor.affine_ops(self.db, self._lane)
            self._dk, self._dm, self._dw = dk, dm, dw

    def _to_bf16(self):
        """``qdata_bf16``: the diffusion qdata (and its lane-major copy) in
        bfloat16, unless the affine path streams no qdata."""
        if not self.qdata_bf16 or self._aff is not None:
            return
        self.K_qd = self.K_qd.to(torch.bfloat16)
        if self._lane is not None:
            self._qkT = lanemajor.diffusion_qT(self.K_qd)

    def _load(self, arrays: dict):
        """Take the JAX operator's assembled arrays (see
        :func:`from_jax_arrays`)."""
        gm = arrays.get("gather_map")
        if gm is not None and not np.array_equal(gm, self.fes.gather_map):
            raise ValueError("dof numbering differs from the JAX space's")
        for name in ("b_const", "Mrc_diag", "A_diag", "ess_mask"):
            setattr(self, name, self._tensor(arrays[name]))
        self.has_ess = bool((self.ess_mask == 0).any())
        self._lane = self._aff = None
        if "Md" in arrays:
            import scipy.sparse as sp

            n = self.fes.ndof
            M, A = (sp.csr_matrix((arrays[k + "d"], arrays[k + "i"],
                                   arrays[k + "p"]), shape=(n, n))
                    for k in ("M", "A"))
            self._set_ell(MultiELLPair.from_csr_pair(M, A, self.dtype,
                                                     self.device))
            return
        if "_dk" in arrays:
            self._lane = lanemajor.lane_basis(self.db)
            self._aff = lanemajor.affine_ops(self.db, self._lane)
            self._dk, self._dm, self._dw = (
                self._tensor(arrays[n]) for n in ("_dk", "_dm", "_dw"))
            return
        self.Mrc_qd, self.Mw_qd, self.K_qd = (
            self._tensor(arrays[n]) for n in ("Mrc_qd", "Mw_qd", "K_qd"))
        self.collapsed = self.K_qd.shape[1] < self.fes.mesh.ne
        if self.transposed_apply:
            self._lane = lanemajor.lane_basis(self.db)
            self._qkT = lanemajor.diffusion_qT(self.K_qd)
            self._qmT = self.Mrc_qd.T.contiguous()
            self._qwT = self.Mw_qd.T.contiguous()
        self._to_bf16()

    def override(self, **kw) -> "BioheatOperator":
        """Shallow copy with some fields (qdata, right-hand side, diagonals)
        replaced, without rerunning the setup (the JAX package's
        ``override``, ex16's ``SetParameters`` rebuild).  When ``K_qd``,
        ``Mrc_qd`` or ``Mw_qd`` is replaced, the lane-major copies
        (``_qkT``/``_qmT``/``_qwT``) are refreshed from it and the affine
        factors are dropped, unless the caller replaces those too; a
        replaced ELL pair ``_ell`` brings its own residual plane.  The
        copy appends its CG counts to the same ``cg_iterations`` list."""
        clone = object.__new__(type(self))
        clone.__dict__ = {**self.__dict__, **kw}
        if "_ell" in kw and "_ell_A" not in kw:
            clone._set_ell(kw["_ell"])
        if self._lane is not None and kw.keys() & {"K_qd", "Mrc_qd", "Mw_qd"}:
            if "K_qd" in kw and "_qkT" not in kw:
                clone._qkT = lanemajor.diffusion_qT(clone.K_qd)
            if "Mrc_qd" in kw and "_qmT" not in kw:
                clone._qmT = lanemajor.mass_qT(clone.Mrc_qd)
            if "Mw_qd" in kw and "_qwT" not in kw:
                clone._qwT = lanemajor.mass_qT(clone.Mw_qd)
            if not kw.keys() & {"_dk", "_dm", "_dw"}:
                clone._aff = None
        return clone

    # -- applies -----------------------------------------------------------
    def _apply(self, qd_mass, qd_diff, v, gamma=None):
        """Element-major (qd_mass-mass + γ·diffusion) apply."""
        e = self.restr.mult(v)
        y = diffusion.apply(self.db, qd_diff, e)
        if gamma is not None:
            y = gamma * y
        return self.restr.mult_transpose(mass.apply(self.db, qd_mass, e) + y)

    def _stage_apply(self, gamma) -> Callable:
        """v ↦ (M_ρc + γ(K + M_ω)) v: one SpMV of the ELL weight plane
        M_ρc + γ(K + M_ω), or one restriction round trip with the γ-combined
        mass coefficient; the plane or coefficient is formed once per
        solve."""
        if self._ell is not None:
            return self._ell.combined(1.0, gamma).mult
        restr = self.restr
        if self._aff is not None:
            dm = self._dm + gamma * self._dw
            return lambda v: restr.mult_transpose_t(
                lanemajor.affine_mass_diffusion_apply(
                    self._aff, dm, self._dk, restr.mult_t(v), gamma))
        if self._lane is not None:
            qm = self._qmT + gamma * self._qwT
            return lambda v: restr.mult_transpose_t(
                lanemajor.mass_diffusion_apply(
                    self._lane, qm, self._qkT, restr.mult_t(v), gamma))
        qm = self.Mrc_qd + gamma * self.Mw_qd
        return lambda v: self._apply(qm, self.K_qd, v, gamma)

    def _A_apply(self, v):
        """(K_k + M_ω) v."""
        if self._ell is not None:
            return self._ell_A.mult(v)
        if self._aff is not None:
            return self.restr.mult_transpose_t(
                lanemajor.affine_mass_diffusion_apply(
                    self._aff, self._dw, self._dk, self.restr.mult_t(v)))
        return self._apply(self.Mw_qd, self.K_qd, v)

    def _Mrc_apply(self, v):
        """M_ρc v."""
        if self._ell is not None:
            return self._ell.mult0(v)
        restr = self.restr
        if self._aff is not None:
            return restr.mult_transpose_t(lanemajor.affine_mass_apply(
                self._aff, self._dm, restr.mult_t(v)))
        return restr.mult_transpose(mass.apply(self.db, self.Mrc_qd,
                                               restr.mult(v)))

    def residual(self, T):
        """RHS of M dT/dt = −A T + b."""
        return self.b_const - self._A_apply(T)

    def _dot(self):
        mode = self.dot_mode
        if mode == "auto":
            mode = "f32" if self.rel_tol >= 1e-6 else "compensated"
        return torch.dot if mode == "f32" else default_dot

    def _zero_ess(self, v):
        return v * self.ess_mask if self.has_ess else v

    def _solve(self, apply, diag, rhs):
        """Jacobi-PCG on ``apply`` restricted to the free dofs (identity on
        the constrained subspace keeps the operator SPD), ``cg`` or
        ``cg_merged`` by ``cg_variant``; appends the iteration count."""
        mask = self.ess_mask

        def lhs(v):
            z = v * mask
            return apply(z) * mask + (v - z)

        if self.has_ess:
            diag = diag * mask + (1.0 - mask)
        inv = 1.0 / diag
        solve = cg_merged if self.cg_variant == "merged" else cg
        x, info = solve(lhs, rhs, M=lambda r: inv * r, rel_tol=self.rel_tol,
                        max_iter=self.max_iter, dot=self._dot())
        self.cg_iterations.append(info.iterations)
        return self._zero_ess(x)

    # -- TimeDependentOperator protocol -------------------------------
    def mult(self, t, T):
        """The explicit stage dT/dt = M_ρc⁻¹(b − A T), 0 on essential
        dofs."""
        rhs = self._zero_ess(self.residual(T))
        return self._solve(self._Mrc_apply, self.Mrc_diag, rhs)

    def implicit_solve(self, gamma, t, T):
        """(M_ρc + γ A) k = b − A T, with k = 0 on essential dofs."""
        rhs = self._zero_ess(self.residual(T))
        return self._solve(self._stage_apply(gamma),
                           self.Mrc_diag + gamma * self.A_diag, rhs)


def from_jax_arrays(fes, arrays: dict, **params) -> BioheatOperator:
    """A port operator over the JAX operator's assembled arrays.

    ``arrays`` holds numpy copies of the JAX ``big_arrays(op)`` entries
    (``b_const``, ``Mrc_diag``, ``A_diag``, ``ess_mask``) and the operator:
    the assembled CSR pair under the keys of the JAX operator's ELL cache
    (``Md``/``Mi``/``Mp`` for M_ρc, ``Ad``/``Ai``/``Ap`` for K + M_ω), the
    qdata ``Mrc_qd``/``Mw_qd``/``K_qd``, or the affine factors
    ``_dm``/``_dw``/``_dk`` (a lattice's numerical collapse, or a tet
    mesh's geometric factors), each as the JAX operator holds it (qdata
    collapsed to one element, (1, nq) and (6, 1, nq), broadcasts); optionally
    with the JAX space's ``gather_map``, which must equal
    ``fes.gather_map``.  ``fes`` is an ``FESpace`` or a
    ``CartesianFESpace`` (then the applies take its structured
    restriction).  ``b_const`` is
    taken as is (already in θ form when the JAX operator was, and holding
    (Q_rf, v) when it had an RF source).  ``params`` are the constructor's
    keyword arguments (``rel_tol``, ``dtype``, ``device``, ...); the JAX
    operator's SAR Q-vector, passed as ``q_rf`` (a numpy array), lands on
    the operator's device as the constructor's ``q_rf`` (it is not added
    to ``b_const`` again).  The state θ needs no conversion beyond
    ``torch.as_tensor``."""
    if params.get("q_rf") is not None:
        params["q_rf"] = torch.as_tensor(
            np.asarray(params["q_rf"]), dtype=real_t(params.get("dtype")),
            device=resolve_device(params.get("device")))
    return BioheatOperator(fes, arrays=arrays, **params)


def make_stepper(op: BioheatOperator, solver) -> Callable:
    """``(T, t, dt) -> (T', t')`` for one step of ``solver`` on ``op``."""

    def step(T, t, dt):
        return solver.step(op, T, t, dt)

    return step
