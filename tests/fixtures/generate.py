"""Generate committed trajectory fixtures (float64, CPU).

The reference's correctness strategy pins trajectories against FEniCS CSVs
(`test-scripts/validation/fenics/beam_dynamic_backward_euler.py`); dolfinx
is unavailable here, so these float64-CPU trajectories are the committed
ground truth that pins all future perf work (f32 paths, kernels, sharding
changes) to a stored trajectory, not just analytic end states.

Run:  PYTHONPATH=. python tests/fixtures/generate.py
Regenerate ONLY when the physics intentionally changes; the regression test
(tests/test_trajectory_fixtures.py) compares fresh runs against these files.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def beam_sag_trajectory(write=True):
    """Soft damped T10 cantilever under gravity: 150 steps of Newton-PCG,
    tip-node position history."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tlfea.constraints import FixedCoefs
    from tlfea.elements import feat10
    from tlfea.elements.assembly import lumped_mass
    from tlfea.materials import SVK, lame_from_E_nu
    from tlfea.solvers import StepState, System, newton
    from tlfea.utils.tetmesh import box_t10_mesh

    nodes, conn = box_t10_mesh(1.0, 0.1, 0.1, 10, 1, 1)
    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = SVK(lam=lam, mu=mu, eta_damp=1e3, lam_damp=1e3)
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    system = System(
        elems=feat10.build(nodes, conn, rho=1000.0), material=mat,
        constraints=FixedCoefs.from_indices(fixed, nodes),
    )
    state = StepState.rest(system, nodes)
    f_ext = jnp.zeros((len(nodes), 3)).at[:, 2].add(lumped_mass(system.elems) * -9.81)
    params = newton.NewtonParams(
        dt=1e-3, rho=1e8, inner_atol=1e-8, inner_rtol=1e-10, outer_tol=1e-10,
        max_outer=2, max_inner=10, cg_rtol=1e-6, cg_max_iter=500, ew_eta_max=0.0,
    )
    step = newton.make_step(system, params)
    tip = int(np.lexsort((nodes[:, 2], nodes[:, 1], -nodes[:, 0]))[0])
    rows = []
    for k in range(150):
        state, diag = step(state, f_ext)
        rows.append([k + 1, *np.asarray(state.x[tip]), *np.asarray(state.v[tip])])
    rows = np.asarray(rows)
    if write:
        np.savetxt(
            os.path.join(HERE, "beam_sag_t10_tip.csv"), rows,
            delimiter=",", header="step,x,y,z,vx,vy,vz", comments="",
            fmt=["%d"] + ["%.17e"] * 6,
        )
        print("beam_sag_t10_tip.csv written; final tip z", rows[-1][3])
    return rows


def sphere_drop_trajectory(write=True):
    """Two soft spheres, hydroelastic contact + Newton: 60 steps; history of
    the falling sphere's lowest node + total contact force."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tlfea.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
    from tlfea.constraints import FixedCoefs
    from tlfea.elements import feat10
    from tlfea.materials import SVK, lame_from_E_nu
    from tlfea.simulation import Simulation, gravity_force
    from tlfea.solvers import StepState, System, newton
    from tlfea.utils.mesh_manager import MeshManager
    from tlfea.utils.pressure import distance_pressure_field
    from tlfea.utils.tetmesh import read_tetgen

    ref = "/root/reference/data/meshes/T10"
    if not os.path.exists(os.path.join(ref, "sphere.1.node")):
        print("reference sphere mesh absent; skipping sphere fixture")
        return
    mm = MeshManager()
    nodes_s, conn_s = read_tetgen(
        os.path.join(ref, "sphere.1.node"), os.path.join(ref, "sphere.1.ele")
    )
    a = mm.add_mesh(nodes_s, conn_s, "lower")
    b = mm.add_mesh(nodes_s, conn_s, "upper")
    ext = nodes_s[:, 2].max() - nodes_s[:, 2].min()
    mm.translate_mesh(b, (0.0, 0.0, ext + 0.01))
    for mid in (a, b):
        inst = mm.instances[mid]
        local = mm.elements[inst.elem_offset:inst.elem_offset + inst.n_elems] - inst.node_offset
        mm.set_scalar_field(mid, distance_pressure_field(mm.mesh_nodes(mid), local, 1e6))

    nodes, conn = mm.nodes, mm.elements
    lam, mu = lame_from_E_nu(1e6, 0.3)
    mat = SVK(lam=lam, mu=mu, eta_damp=1e2, lam_damp=1e2)
    zmin = nodes[:, 2].min()
    fixed = np.nonzero(nodes[:, 2] < zmin + 1e-6)[0]
    system = System(
        elems=feat10.build(nodes, conn, rho=1000.0), material=mat,
        constraints=FixedCoefs.from_indices(fixed, nodes),
    )
    state = StepState.rest(system, nodes)
    params = newton.NewtonParams(
        dt=2e-4, rho=1e8, inner_atol=1e-8, inner_rtol=1e-9, outer_tol=1e-9,
        max_outer=2, max_inner=8, cg_rtol=1e-5, cg_max_iter=300, ew_eta_max=0.0,
    )
    collision = HydroelasticCollision(conn, mm.elem_mesh_ids(), mm.scalar_field(),
                                      window=64, max_pairs=4096)
    sim = Simulation(
        system, state, newton.stepper(params),
        base_f_ext=gravity_force(system),
        collision=collision,
        collision_params=HydroelasticParams(damping=0.0, friction=0.2),
    )
    inst_b = mm.instances[b]
    b_ids = np.arange(inst_b.node_offset, inst_b.node_offset + inst_b.n_nodes)
    low_b = int(b_ids[np.argmin(nodes[b_ids, 2])])
    rows = []
    for k in range(60):
        sim.step()
        xs = np.asarray(sim.state.x)
        nc = int(np.asarray(sim.last_patches.n_contacts))
        rows.append([k + 1, *xs[low_b], nc])
    rows = np.asarray(rows)
    if write:
        np.savetxt(
            os.path.join(HERE, "sphere_drop_lownode.csv"), rows,
            delimiter=",", header="step,x,y,z,n_contacts", comments="",
            fmt=["%d"] + ["%.17e"] * 3 + ["%d"],
        )
        print("sphere_drop_lownode.csv written; final z", rows[-1][3], "contacts", rows[-1][4])
    return rows


if __name__ == "__main__":
    beam_sag_trajectory()
    sphere_drop_trajectory()
