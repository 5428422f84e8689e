"""Two-level preconditioner: correctness (same solution) + effectiveness
(fewer CG iterations on a stiff slender beam, the case where block-Jacobi
stalls — see .claude/skills/verify/SKILL.md rough edges)."""

import numpy as np
import pytest

import jax.numpy as jnp

from tlfea.constraints import FixedCoefs
from tlfea.elements import feat10
from tlfea.materials import SVK, lame_from_E_nu
from tlfea.simulation import gravity_force
from tlfea.solvers import System, StepState, newton
from tlfea.solvers.coarse import build_aggregates, coarse_operator
from tlfea.utils.tetmesh import box_t10_mesh


def setup():
    # Stiff slender cantilever: the hard case for block-Jacobi CG.
    nodes, conn = box_t10_mesh(1.0, 0.05, 0.05, 12, 1, 1)
    lam, mu = lame_from_E_nu(2e9, 0.0)
    mat = SVK(lam=lam, mu=mu, eta_damp=2e4, lam_damp=2e4)
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    system = System(
        elems=feat10.build(nodes, conn, rho=1000.0),
        material=mat,
        constraints=FixedCoefs.from_indices(fixed, nodes),
    )
    return nodes, system


@pytest.mark.slow
def test_frozen_coarse_precond_cuts_cg_and_preserves_solution():
    """CoarsePrecond (frozen, matmul apply, translations+rotations) on a
    stiff slender cantilever: >=4x fewer CG iterations than block-Jacobi,
    bit-comparable solution."""
    import jax.numpy as jnp

    from tlfea.constraints import FixedCoefs
    from tlfea.elements import feat10
    from tlfea.elements.assembly import lumped_mass
    from tlfea.materials import SVK, lame_from_E_nu
    from tlfea.solvers import StepState, System
    from tlfea.solvers.coarse import build_coarse_precond
    from tlfea.utils.tetmesh import box_t10_mesh

    nodes, conn = box_t10_mesh(1.0, 0.1, 0.1, 10, 1, 1)
    lam, mu = lame_from_E_nu(2e9, 0.3)
    mat = SVK(lam=lam, mu=mu, eta_damp=1e4, lam_damp=1e4)
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    system = System(
        elems=feat10.build(nodes, conn, rho=1000.0), material=mat,
        constraints=FixedCoefs.from_indices(fixed, nodes),
    )
    state = StepState.rest(system, nodes)
    f_ext = jnp.zeros((len(nodes), 3)).at[:, 2].add(lumped_mass(system.elems) * -9.81)
    params = newton.NewtonParams(
        dt=2e-3, rho=1e9, inner_atol=1e-6, max_outer=1, max_inner=4,
        cg_rtol=1e-4, cg_max_iter=2000, ew_eta_max=0.0,
    )
    coarse = build_coarse_precond(system, nodes, 2e-3, 1e9, rotations=True)

    s_bj, d_bj = newton.make_step(system, params)(state, f_ext)
    s_cp, d_cp = newton.make_step(system, params, coarse=coarse)(state, f_ext)

    assert int(d_cp["cg_iters"]) * 4 <= int(d_bj["cg_iters"]), (
        int(d_cp["cg_iters"]), int(d_bj["cg_iters"]),
    )
    scale = float(jnp.abs(s_bj.x - nodes).max())
    err = float(jnp.abs(s_cp.x - s_bj.x).max())
    assert err < 1e-5 * max(scale, 1e-12), (err, scale)


@pytest.mark.slow
def test_range_mode_matches_grid_mode():
    """ranges=True (contiguous index aggregates; reshape-sum restrict) must
    be a valid coarse correction: same converged Newton step as the dense
    spatial-grid Agg path, and a comparable CG cut. Requires a
    bandwidth-reducing node order (RCM — the production configuration) so
    contiguous ranges are
    spatially coherent; the raw box_t10_mesh order appends all mid-edge
    nodes after all corners, which scatters every range across the beam."""
    from tlfea.elements.assembly import lumped_mass
    from tlfea.elements import feat10
    from tlfea.solvers.coarse import build_coarse_precond
    from tlfea.utils.reorder import apply_node_order, rcm_order
    from tlfea.utils.tetmesh import box_t10_mesh

    nodes, conn = box_t10_mesh(1.0, 0.05, 0.05, 12, 1, 1)
    nodes, conn = apply_node_order(nodes, conn, rcm_order(conn, len(nodes)))
    lam, mu = lame_from_E_nu(2e9, 0.0)
    mat = SVK(lam=lam, mu=mu, eta_damp=2e4, lam_damp=2e4)
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    system = System(
        elems=feat10.build(nodes, conn, rho=1000.0),
        material=mat,
        constraints=FixedCoefs.from_indices(fixed, nodes),
    )
    state = StepState.rest(system, nodes)
    f_ext = jnp.zeros((len(nodes), 3)).at[:, 2].add(
        lumped_mass(system.elems) * -9.81
    )
    params = newton.NewtonParams(
        dt=2e-3, rho=1e9, inner_atol=1e-6, max_outer=1, max_inner=4,
        cg_rtol=1e-4, cg_max_iter=2000, ew_eta_max=0.0,
    )
    cp_grid = build_coarse_precond(system, nodes, 2e-3, 1e9)
    cp_rng = build_coarse_precond(system, nodes, 2e-3, 1e9, ranges=True)
    assert cp_rng.Agg is None and cp_rng.seg > 0
    # Same coarse space by construction: range mode factors the SAME
    # node-level spatial aggregation through per-slot masked reshape-sums
    # (hard whole-range assignment was measured ~1.6x worse at 100k).
    assert cp_rng.n_agg == cp_grid.n_agg

    # restrict/prolong adjointness: <R r, w> == <r, R^T w>.
    rng = np.random.default_rng(0)
    r = jnp.asarray(rng.standard_normal((len(nodes), 3)), dtype=state.x.dtype)
    w = jnp.asarray(
        rng.standard_normal(cp_rng.n_agg * 6), dtype=state.x.dtype
    )
    lhs = float(jnp.vdot(cp_rng.restrict(r), w))
    rhs = float(jnp.vdot(r, cp_rng.prolong(w)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)

    # Exact apply equivalence with dense mode (up to summation order).
    scale_a = float(jnp.abs(cp_grid.apply(r)).max())
    np.testing.assert_allclose(
        np.asarray(cp_rng.apply(r)), np.asarray(cp_grid.apply(r)),
        atol=1e-9 * scale_a,
    )

    s_g, d_g = newton.make_step(system, params, coarse=cp_grid)(state, f_ext)
    s_r, d_r = newton.make_step(system, params, coarse=cp_rng)(state, f_ext)
    s_bj, d_bj = newton.make_step(system, params)(state, f_ext)

    scale = float(jnp.abs(s_g.x - nodes).max()) + 1e-30
    err = float(jnp.abs(s_r.x - s_g.x).max()) / scale
    assert err < 1e-5, err
    # Identical coarse space -> identical CG behavior (tiny slack for fp
    # summation-order differences), and a real cut vs block-Jacobi.
    assert abs(int(d_r["cg_iters"]) - int(d_g["cg_iters"])) <= max(
        2, 0.1 * int(d_g["cg_iters"])
    ), (int(d_r["cg_iters"]), int(d_g["cg_iters"]))
    assert int(d_r["cg_iters"]) * 3 <= int(d_bj["cg_iters"]), (
        int(d_r["cg_iters"]), int(d_bj["cg_iters"]),
    )


@pytest.mark.slow
def test_mm_dtype_bf16_apply_parity_and_step():
    """mm_dtype="bfloat16" stores the apply tables in bf16 and runs the
    apply matmuls in it. The correction is preconditioner-quality: the
    apply must track the full-precision one to bf16 accuracy (one-hot
    tables are exact in bf16; Ainv rounds entrywise), the output dtype must
    match the residual's, and a Newton step preconditioned with it must
    reach the same converged solution with a comparable CG count."""
    from tlfea.solvers.coarse import build_coarse_precond

    nodes, system = setup()
    cp = build_coarse_precond(system, nodes, 5e-3, 1e9)
    cp_bf = build_coarse_precond(system, nodes, 5e-3, 1e9, mm_dtype="bfloat16")
    assert cp_bf.Ainv is None and cp_bf.Li.dtype == jnp.bfloat16
    assert cp_bf.Agg.dtype == jnp.bfloat16

    rng = np.random.default_rng(3)
    r = jnp.asarray(rng.standard_normal((len(nodes), 3)))
    z, z_bf = cp.apply(r), cp_bf.apply(r)
    assert z_bf.dtype == r.dtype
    scale = float(jnp.abs(z).max()) + 1e-30
    assert float(jnp.abs(z_bf - z).max()) < 3e-2 * scale

    # Range-mode (factored restrict) under bf16: same parity bound.
    cp_rbf = build_coarse_precond(
        system, nodes, 5e-3, 1e9, ranges=True, mm_dtype="bfloat16"
    )
    assert cp_rbf.Gc.dtype == jnp.bfloat16
    z_rbf = cp_rbf.apply(r)
    zr = build_coarse_precond(system, nodes, 5e-3, 1e9, ranges=True).apply(r)
    scale_r = float(jnp.abs(zr).max()) + 1e-30
    assert float(jnp.abs(z_rbf - zr).max()) < 3e-2 * scale_r

    f_ext = gravity_force(system)
    params = newton.NewtonParams(
        dt=5e-3, rho=1e9, inner_atol=1e-7, inner_rtol=1e-8,
        max_outer=2, max_inner=8, cg_rtol=1e-6, cg_max_iter=400,
        ew_eta_max=0.0,
    )
    s0 = StepState.rest(system, nodes)
    s1, d1 = newton.make_step(system, params, coarse=cp)(s0, f_ext)
    s2, d2 = newton.make_step(system, params, coarse=cp_bf)(s0, f_ext)
    scale = float(jnp.abs(s1.x - jnp.asarray(nodes)).max()) + 1e-30
    assert float(jnp.abs(s2.x - s1.x).max()) / scale < 1e-3
    assert int(d2["cg_iters"]) <= int(d1["cg_iters"]) * 1.3 + 2, (
        int(d2["cg_iters"]), int(d1["cg_iters"]),
    )


@pytest.mark.slow
def test_rank_truncated_coarse():
    """rank=r keeps the r smallest-eigenvalue coarse modes (whitened W, SPSD
    by construction — see CoarsePrecond.W). It must (a) stay a symmetric
    positive apply, (b) converge to the same Newton step, (c) retain most
    of the full coarse correction's CG cut on the stiff slender beam."""
    from tlfea.solvers.coarse import build_coarse_precond

    nodes, system = setup()
    cp_full = build_coarse_precond(system, nodes, 5e-3, 1e9)
    K = cp_full.Ainv.shape[0]
    r = max(6, K // 2)
    cp_rank = build_coarse_precond(system, nodes, 5e-3, 1e9, rank=r)
    assert cp_rank.Ainv is None and cp_rank.W.shape == (K, r)

    rng = np.random.default_rng(7)
    rr = jnp.asarray(rng.standard_normal((len(nodes), 3)))
    ss = jnp.asarray(rng.standard_normal((len(nodes), 3)))
    # Symmetric: <s, M r> == <r, M s>; positive: <r, M r> >= 0.
    np.testing.assert_allclose(
        float(jnp.vdot(ss, cp_rank.apply(rr))),
        float(jnp.vdot(rr, cp_rank.apply(ss))), rtol=1e-9,
    )
    assert float(jnp.vdot(rr, cp_rank.apply(rr))) >= 0.0

    f_ext = gravity_force(system)
    params = newton.NewtonParams(
        dt=5e-3, rho=1e9, inner_atol=1e-7, inner_rtol=1e-8,
        max_outer=2, max_inner=8, cg_rtol=1e-6, cg_max_iter=400,
        ew_eta_max=0.0,
    )
    s0 = StepState.rest(system, nodes)
    s_bj, d_bj = newton.make_step(system, params)(s0, f_ext)
    s_f, d_f = newton.make_step(system, params, coarse=cp_full)(s0, f_ext)
    s_r, d_r = newton.make_step(system, params, coarse=cp_rank)(s0, f_ext)
    scale = float(jnp.abs(s_f.x - jnp.asarray(nodes)).max()) + 1e-30
    assert float(jnp.abs(s_r.x - s_f.x).max()) / scale < 1e-3
    # Half the modes must keep a real cut vs block-Jacobi (the kept modes
    # are exactly the low-frequency ones that cause the bj stall).
    assert int(d_r["cg_iters"]) < 0.7 * int(d_bj["cg_iters"]), (
        int(d_r["cg_iters"]), int(d_f["cg_iters"]), int(d_bj["cg_iters"]),
    )


def test_coarse_operator_spd():
    nodes, system = setup()
    coarse = build_aggregates(nodes, target_cluster=24)
    assert coarse.n_agg >= 4
    Ac = np.asarray(
        coarse_operator(
            jnp.asarray(nodes), system.elems, system.material,
            system.constraints, coarse, 5e-3, 1e9,
        )
    )
    np.testing.assert_allclose(Ac, Ac.T, rtol=1e-10)
    w = np.linalg.eigvalsh(Ac)
    assert w.min() > 0, f"coarse operator must be SPD, min eig {w.min():.3e}"


def test_two_level_reduces_cg_and_matches():
    nodes, system = setup()
    f_ext = gravity_force(system)
    params = newton.NewtonParams(
        dt=5e-3, rho=1e9, inner_atol=1e-7, inner_rtol=1e-8,
        max_outer=2, max_inner=8, cg_rtol=1e-6, cg_max_iter=400, ew_eta_max=0.0,
    )

    s0 = StepState.rest(system, nodes)
    step_bj = newton.make_step(system, params)
    s1, d1 = step_bj(s0, f_ext)
    cg_bj = int(d1["cg_iters"])

    coarse = build_aggregates(nodes, target_cluster=24)
    step_2l = newton.make_step(system, params, coarse=coarse)
    s2, d2 = step_2l(s0, f_ext)
    cg_2l = int(d2["cg_iters"])

    # Same converged step.
    scale = float(jnp.abs(s1.x - jnp.asarray(nodes)).max()) + 1e-30
    dev = float(jnp.abs(s2.x - s1.x).max()) / scale
    assert dev < 1e-3, f"two-level step deviates {dev:.2e}"
    # Substantially fewer CG iterations.
    assert cg_2l < 0.7 * cg_bj, (
        f"two-level should cut CG count: block-Jacobi {cg_bj}, two-level {cg_2l}"
    )
