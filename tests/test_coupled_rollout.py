"""Fused collision-coupled rollout (`newton.make_coupled_rollout`) matches
the host-driven Simulation loop step for step.

The fused scan is the production collision path (the host loop pays ~4
dispatches per step);
physics must be identical: same force evaluation point (start-of-step x, v),
same solver, same overflow semantics (OR-reduced across the scan).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tlfea.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
from tlfea.constraints import FixedCoefs
from tlfea.elements import feat10
from tlfea.materials import SVK, lame_from_E_nu
from tlfea.simulation import Simulation, gravity_force
from tlfea.solvers import System, StepState, newton
from tlfea.utils.mesh_manager import MeshManager
from tlfea.utils.pressure import distance_pressure_field
from tlfea.utils.tetmesh import box_t10_mesh


@pytest.fixture(scope="module")
def contact_problem():
    mm = MeshManager()
    n1, c1 = box_t10_mesh(0.3, 0.3, 0.12, 2, 2, 2)
    a = mm.add_mesh(n1, c1, "lower")
    b = mm.add_mesh(n1, c1, "upper")
    mm.translate_mesh(b, (0.02, 0.02, 0.11))  # overlap: contact from step 0
    for mid in (a, b):
        inst = mm.instances[mid]
        lc = mm.elements[inst.elem_offset: inst.elem_offset + inst.n_elems]
        mm.set_scalar_field(
            mid,
            distance_pressure_field(mm.mesh_nodes(mid), lc - inst.node_offset, 5e5),
        )
    nodes, conn = mm.nodes, mm.elements
    lam, mu = lame_from_E_nu(5e5, 0.3)
    mat = SVK(lam=lam, mu=mu, eta_damp=2e2, lam_damp=2e2)
    floor = np.nonzero(nodes[:, 2] < 1e-12)[0]
    system = System(
        elems=feat10.build(nodes, conn, rho=1000.0), material=mat,
        constraints=FixedCoefs.from_indices(floor, nodes),
    )
    collision = HydroelasticCollision(
        conn, mm.elem_mesh_ids(), mm.scalar_field(), window=64, max_pairs=2048,
    )
    params = newton.NewtonParams(dt=1e-3, rho=1e8, inner_atol=1e-8,
                                 max_outer=1, max_inner=8, cg_max_iter=100)
    return system, nodes, collision, params


def test_coupled_rollout_matches_simulation_loop(contact_problem):
    system, nodes, collision, params = contact_problem
    col_params = HydroelasticParams(friction=0.3)
    n_steps = 5
    f_base = gravity_force(system)

    # Host-driven reference (Simulation loop).
    sim = Simulation(system, StepState.rest(system, nodes),
                     newton.stepper(params), base_f_ext=f_base,
                     collision=collision, collision_params=col_params)
    for _ in range(n_steps):
        sim.step()
    x_ref = np.asarray(sim.state.x)
    assert sim.last_patches is not None
    assert int(np.asarray(sim.last_patches.n_contacts)) > 0, "scene must contact"

    # Fused scan.
    def force_fn(x, v):
        f, _p, ovf = collision.step(x, v, col_params)
        return f, ovf

    roll = newton.make_coupled_rollout(system, params, n_steps, force_fn)
    s, (nit, cgit), ovf = roll(StepState.rest(system, nodes), f_base)
    assert not bool(np.asarray(ovf))
    np.testing.assert_allclose(np.asarray(s.x), x_ref, rtol=1e-10, atol=1e-12)
    assert nit.shape == (n_steps,)


def test_coupled_rollout_reports_overflow(contact_problem):
    system, nodes, collision, params = contact_problem
    col_params = HydroelasticParams(friction=0.3)

    # Capacity of 1 candidate pair: guaranteed overflow in a contact scene.
    tiny = HydroelasticCollision(
        collision._init_args["conn"], collision._init_args["mesh_ids"],
        collision._init_args["pressures"], window=2, max_pairs=8,
    ) if hasattr(collision, "_init_args") else None
    if tiny is None:
        pytest.skip("collision lacks _init_args")

    def force_fn(x, v):
        f, _p, ovf = tiny.step(x, v, col_params)
        return f, ovf

    roll = newton.make_coupled_rollout(system, params, 3, force_fn)
    _s, _its, ovf = roll(StepState.rest(system, nodes),
                         gravity_force(system))
    assert bool(np.asarray(ovf)), "tiny capacity must report overflow"
