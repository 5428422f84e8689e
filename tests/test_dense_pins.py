"""DensePins: dense-field pin constraints (runtime membership updates +
trace-free retargeting — reference `SetNodalFixed`/`UpdateNodalFixed`,
`FEAT10Data.cu:728-832`)."""

import numpy as np
import jax
import jax.numpy as jnp

from tlfea.constraints import DensePins, FixedCoefs
from tlfea.elements import feat10
from tlfea.materials import SVK, lame_from_E_nu
from tlfea.solvers import StepState, System, newton
from tlfea.utils.tetmesh import box_t10_mesh

DTYPE = np.float64


def _setup(cons_cls):
    nodes, conn = box_t10_mesh(1.0, 0.3, 0.3, 4, 2, 2)
    elems = feat10.build(nodes, conn, rho=1000.0, dtype=DTYPE)
    lam, mu = lame_from_E_nu(1e6, 0.3)
    mat = SVK(lam=jnp.asarray(lam, DTYPE), mu=jnp.asarray(mu, DTYPE),
              eta_damp=jnp.asarray(1e2, DTYPE), lam_damp=jnp.asarray(1e2, DTYPE))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    system = System(
        elems=elems, material=mat,
        constraints=cons_cls.from_indices(fixed, nodes.astype(DTYPE)),
    )
    return nodes.astype(DTYPE), system, fixed


def _grav(nodes):
    return jnp.zeros((nodes.shape[0], 3), DTYPE).at[:, 2].add(DTYPE(-50.0))


PARAMS = newton.NewtonParams(
    dt=DTYPE(1e-3), rho=DTYPE(1e6), inner_atol=DTYPE(1e-6), max_outer=2,
    max_inner=6, cg_rtol=DTYPE(1e-6), cg_max_iter=100,
)


def test_matches_fixed_coefs_step():
    """Same pinned set => identical converged Newton steps (XLA path)."""
    nodes, sys_fc, _ = _setup(FixedCoefs)
    _, sys_dp, _ = _setup(DensePins)
    f_ext = _grav(nodes)
    s_fc, _ = newton.step(sys_fc, StepState.rest(sys_fc, nodes), PARAMS, f_ext)
    s_dp, _ = newton.step(sys_dp, StepState.rest(sys_dp, nodes), PARAMS, f_ext)
    scale = float(jnp.abs(s_fc.x - jnp.asarray(nodes)).max()) + 1e-30
    assert float(jnp.abs(s_dp.x - s_fc.x).max()) / scale < 1e-10
    # Dense duals agree with compact duals at the pinned rows.
    cons = sys_fc.constraints
    lam_dense_at_pins = s_dp.lam[cons.idx]
    assert float(jnp.abs(lam_dense_at_pins - s_fc.lam).max()) <= 1e-8 * (
        float(jnp.abs(s_fc.lam).max()) + 1e-30
    )
    # Unpinned duals stay exactly zero (masked c).
    unpinned = np.setdiff1d(np.arange(nodes.shape[0]), np.asarray(cons.idx))
    assert float(jnp.abs(s_dp.lam[unpinned]).max()) == 0.0


def test_membership_and_target_updates_do_not_retrace():
    """Flipping WHICH nodes are pinned (with_mask/pinning) and WHERE
    (with_targets) reuses one compiled executable — fixed shapes, data-only
    changes. This is the property FixedCoefs cannot provide (resizing idx
    changes shapes)."""
    nodes, system, fixed = _setup(DensePins)
    f_ext = _grav(nodes)
    state = StepState.rest(system, nodes)

    stepf = jax.jit(lambda sys_, st: newton._step(sys_, st, PARAMS, f_ext))
    s1, _ = stepf(system, state)
    #

    sys2 = system.replace(
        constraints=system.constraints.pinning(
            np.nonzero(nodes[:, 0] > 1.0 - 1e-12)[0], True, x0=nodes
        )
    )
    s2, _ = stepf(sys2, state)
    sys3 = sys2.replace(
        constraints=sys2.constraints.with_targets(
            sys2.constraints.target + 0.001
        )
    )
    s3, _ = stepf(sys3, state)
    assert stepf._cache_size() == 1, "DensePins update must not retrace"
    # Pinning the far end changes the solution; retargeting changes it again.
    assert float(jnp.abs(s2.x - s1.x).max()) > 1e-9
    assert float(jnp.abs(s3.x - s2.x).max()) > 1e-9


def test_simulation_set_pinned_release():
    """Release pinned nodes mid-run: they must start falling under load.

    ALM pins are soft at finite rho (position leak ~ ||c|| ~ |lam|/rho per
    outer epoch), so the before-release check is RELATIVE: pinned nodes move
    orders of magnitude less than the free end, and after release the same
    nodes drop by far more than the pin leak."""
    from tlfea.simulation import Simulation
    from tlfea.solvers import suggest_rho

    nodes, system, fixed = _setup(DensePins)
    f_ext = _grav(nodes)
    rho = suggest_rho(system.elems, system.material, 1e-3)
    params = PARAMS.replace(rho=DTYPE(rho), max_outer=3, max_inner=12,
                            inner_atol=DTYPE(1e-8), cg_max_iter=200)
    sim = Simulation(system, StepState.rest(system, nodes),
                     newton.stepper(params), base_f_ext=f_ext)
    for _ in range(3):
        sim.step()
    x0 = jnp.asarray(nodes)
    pin_disp = float(jnp.abs(sim.state.x[fixed] - x0[fixed]).max())
    free_disp = float(jnp.abs(sim.state.x - x0).max())
    assert pin_disp < 1e-2 * free_disp  # pinned: essentially stationary
    z_before = float(sim.state.x[fixed, 2].mean())
    sim.set_pinned(fixed, False)
    for _ in range(5):
        sim.step()
    # Released nodes fall by far more than the residual ALM pin leak.
    assert float(sim.state.x[fixed, 2].mean()) < z_before - max(2e-3, 3 * pin_disp)
