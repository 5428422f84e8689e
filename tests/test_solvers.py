"""Implicit solver tests: free fall, static sag convergence, solver parity.

Modeled on the reference's acceptance workloads (`lib_bin/beam_sag/
test_ancf3243.cc`, `test_feat10_*`): a cantilever beam fixed at one end with
a tip load, advanced by backward-Euler ALM. All solvers must agree on the
resulting trajectory because they minimize the same objective.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tlfea.constraints import FixedCoefs
from tlfea.elements import feat10
from tlfea.materials import SVK, lame_from_E_nu
from tlfea.solvers import System, StepState
from tlfea.solvers import newton, adamw, nesterov
from tlfea.utils.tetmesh import box_t10_mesh


@pytest.fixture(scope="module")
def beam():
    # Small beam: 1 x 0.1 x 0.1, clamped at x=0, soft material so it sags.
    nodes, conn = box_t10_mesh(1.0, 0.1, 0.1, 4, 1, 1)
    lam, mu = lame_from_E_nu(1e6, 0.3)
    mat = SVK(lam=lam, mu=mu, eta_damp=1e2, lam_damp=1e2)
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    cons = FixedCoefs.from_indices(fixed, nodes)
    elems = feat10.build(nodes, conn, rho=1000.0)
    system = System(elems=elems, material=mat, constraints=cons)
    return nodes, conn, system


def gravity_force(system, nodes, g=-9.81):
    from tlfea.elements.assembly import lumped_mass

    m = lumped_mass(system.elems)
    f = jnp.zeros((nodes.shape[0], 3))
    return f.at[:, 2].add(m * g)


def test_free_fall_unconstrained():
    """With no constraints and gravity only, every node accelerates at g."""
    nodes, conn = box_t10_mesh(0.4, 0.2, 0.2, 1, 1, 1)
    lam, mu = lame_from_E_nu(1e6, 0.3)
    mat = SVK(lam=lam, mu=mu)
    elems = feat10.build(nodes, conn, rho=1000.0)
    system = System(elems=elems, material=mat, constraints=None)
    state = StepState.rest(system, nodes)
    dt = 1e-3
    params = newton.NewtonParams(dt=dt, inner_atol=1e-9, max_inner=10)
    f_ext = gravity_force(system, nodes)
    n_steps = 5
    for _ in range(n_steps):
        state, diag = newton.step(system, state, params, f_ext)
    # After n steps of backward Euler with constant g: v = n*g*dt exactly.
    v = np.asarray(state.v)
    np.testing.assert_allclose(v[:, 2], n_steps * (-9.81) * dt, rtol=1e-6)
    np.testing.assert_allclose(v[:, :2], 0.0, atol=1e-8)


def test_newton_beam_sag_converges(beam):
    nodes, conn, system = beam
    state = StepState.rest(system, nodes)
    params = newton.NewtonParams(
        dt=1e-3, rho=1e10, inner_atol=1e-8, inner_rtol=1e-10, outer_tol=1e-8,
        max_outer=5, max_inner=15,
    )
    f_ext = gravity_force(system, nodes)
    for _ in range(20):
        state, diag = newton.step(system, state, params, f_ext)
    x = np.asarray(state.x)
    # Clamped nodes stay put.
    fixed = np.asarray(system.constraints.idx)
    np.testing.assert_allclose(x[fixed], nodes[fixed], atol=1e-6)
    # The tip sagged downward, but boundedly.
    tip = np.argmax(nodes[:, 0])
    assert x[tip, 2] < nodes[tip, 2] - 1e-5
    assert x[tip, 2] > nodes[tip, 2] - 0.5
    # Constraint norm small.
    assert float(diag["norm_c"]) < 1e-6


@pytest.mark.slow
def test_first_order_solvers_match_newton(beam):
    """All solvers minimize the same incremental objective. Compare the pure
    penalty subproblem (single outer iteration, lam = 0): the minimizer is
    unique, so Newton / AdamW / Nesterov must land on the same positions.

    (Across multiple outer iterations the solvers legitimately differ: Newton
    updates duals as lam += rho c while first-order solvers use
    lam += rho h c, a convention difference inherited from the reference —
    `SyncedNewton.cu:470-481` vs `SyncedNesterov.cu:335-341`.)
    """
    nodes, conn, system = beam
    f_ext = gravity_force(system, nodes)
    dt = 2e-3
    rho = 1e6

    sN = StepState.rest(system, nodes)
    pN = newton.NewtonParams(dt=dt, rho=rho, inner_atol=1e-11, max_outer=1, max_inner=25)
    for _ in range(2):
        sN, _ = newton.step(system, sN, pN, f_ext)
    xN = np.asarray(sN.x)
    scale = np.abs(xN - nodes).max() + 1e-30

    sA = StepState.rest(system, nodes)
    pA = adamw.AdamWParams(
        dt=dt, rho=rho, lr=1e-3, inner_tol=1e-12, inner_rtol=0.0,
        max_outer=1, max_inner=30000, convergence_check_interval=100,
    )
    for _ in range(2):
        sA, dA = adamw.step(system, sA, pA, f_ext)
    xA = np.asarray(sA.x)
    assert np.abs(xA - xN).max() / scale < 0.10, (
        f"AdamW deviates {np.abs(xA - xN).max() / scale:.3e} (rel to deformation)"
    )

    sG = StepState.rest(system, nodes)
    pG = nesterov.NesterovParams(
        dt=dt, rho=rho, alpha=1e-5, inner_tol=1e-12, max_outer=1, max_inner=30000
    )
    for _ in range(2):
        sG, _ = nesterov.step(system, sG, pG, f_ext)
    xG = np.asarray(sG.x)
    assert np.abs(xG - xN).max() / scale < 0.10, (
        f"Nesterov deviates {np.abs(xG - xN).max() / scale:.3e}"
    )


def test_energy_dissipation_with_damping(beam):
    """Damped free oscillation must not gain kinetic energy over time."""
    nodes, conn, system = beam
    state = StepState.rest(system, nodes)
    params = newton.NewtonParams(dt=2e-3, rho=1e8, inner_atol=1e-7, max_outer=2, max_inner=10)
    f_ext = gravity_force(system, nodes)
    ke = []
    from tlfea.elements.assembly import mass_matvec

    for _ in range(15):
        state, _ = newton.step(system, state, params, f_ext)
        ke.append(float(0.5 * jnp.sum(state.v * mass_matvec(state.v, system.elems))))
    # Kinetic energy should settle (strong damping): final < peak.
    assert ke[-1] < max(ke) + 1e-12
    assert np.isfinite(ke).all()
