"""Shared demo helpers: solver construction from CLI args, output dirs."""

from __future__ import annotations

import os

import numpy as np

from tlfea.solvers import adamw, nesterov, newton, vbd

REF_DATA = "/root/reference/data"


def _auto_coarse(system, dt, rho):
    """Frozen two-level coarse preconditioner at the rest configuration
    (production Newton config — see bench.py). Built for SVK materials,
    whose closed-form pair tangents it needs; None for other materials."""
    from tlfea.elements.assembly import node_ref
    from tlfea.materials import SVK
    from tlfea.solvers.coarse import build_coarse_precond

    if not isinstance(system.material, SVK):
        return None
    x0 = np.asarray(node_ref(system.elems))
    big = x0.shape[0] > 50_000
    return build_coarse_precond(
        system, x0, float(dt), float(rho), ranges=big,
        max_agg=1024 if big else 512,
        mm_dtype="bfloat16" if big else None,
    )


def make_solver(name: str, system, dt: float, rho: float | None):
    """Per-solver parameter sets modeled on the reference's unified beam-sag
    driver (`lib_bin/beam_sag/test_ancf3243.cc:329-399`).

    Pass rho=None to derive the ALM penalty from the problem stiffness
    (`suggest_rho`: rho ~ E*h/dt, the scale that keeps constraint
    enforcement primal-stiff rather than dual-integral — docs/ARCHITECTURE.md)."""
    if rho is None:
        from tlfea.solvers import suggest_rho

        rho = suggest_rho(system.elems, system.material, dt)
    if name == "newton":
        # Production profile (bench.py): ONE outer per step — the ALM duals
        # persist in StepState and integrate ACROSS steps, so per-step
        # re-convergence of the outer loop is wasted work (measured on the
        # 14.5k-elem item drop: max_outer=3 with an f32-unreachable
        # absolute outer_tol burned 3 outers x ~4 Newton x ~28 CG every
        # step). inner_rtol carries the convergence; Eisenstat-Walker
        # forcing (NewtonParams default) + the frozen coarse correction
        # keep the CG budget honest.
        params = newton.NewtonParams(
            dt=dt, rho=rho, inner_atol=1e-7, inner_rtol=1e-4, outer_tol=0.0,
            max_outer=1, max_inner=6, cg_rtol=1e-3, cg_max_iter=50,
        )
        return newton.stepper(params, coarse=_auto_coarse(system, dt, rho))
    if name == "nesterov":
        params = nesterov.NesterovParams(
            dt=dt, rho=rho, alpha=1e-7, inner_tol=1e-9, outer_tol=1e-8,
            max_outer=3, max_inner=20000,
        )
        return nesterov.stepper(params)
    if name == "adamw":
        params = adamw.AdamWParams(
            dt=dt, rho=rho, lr=1e-3, inner_tol=1e-8, inner_rtol=1e-8,
            outer_tol=1e-8, max_outer=3, max_inner=20000,
            convergence_check_interval=50,
        )
        return adamw.stepper(params)
    if name == "vbd":
        params = vbd.VBDParams(
            dt=dt, rho=rho, omega=1.0, inner_tol=1e-7, outer_tol=1e-8,
            max_outer=3, max_sweeps=200, convergence_check_interval=8,
        )
        structures = vbd.prepare(system, group_size=params.color_group_size)
        return vbd.stepper(params, structures)
    raise SystemExit(f"unknown solver {name!r} (newton|nesterov|adamw|vbd)")


def out_dir(name: str) -> str:
    d = os.path.join("out", name)
    os.makedirs(d, exist_ok=True)
    return d


def tip_coef_3243(n_elem: int) -> int:
    """Position-coefficient index of the last beam node."""
    return 4 * n_elem  # node (n_elem), slot 0
