"""Self-contact demo: a hairpin-folded beam pressed onto itself.

The lower leg is clamped at its free end; the upper leg's free end is
prescribed to descend (constraint retargeting, as in the bubble-gripper
demo) until the legs make self-contact through the hydroelastic pipeline
with `enable_self_collision=True` and the grid-hash broadphase.

Exercises the reference capability `HydroelasticBroadphaseFunc.cuh:105-133`
(topological-neighbor-filtered self-collision), which no reference demo
drives either — this is the first runnable self-contact workload.

Run: python examples/self_contact_fold.py --steps=120
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from tlfea.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
from tlfea.constraints import FixedCoefs
from tlfea.elements import feat10
from tlfea.materials import SVK, lame_from_E_nu
from tlfea.simulation import Simulation
from tlfea.solvers import StepState, System, newton
from tlfea.utils import io_vtk
from tlfea.utils.cli import Cli
from tlfea.utils.pressure import distance_pressure_field
from tlfea.utils.tetmesh import hairpin_t10_mesh

from _common import make_solver, out_dir


def main():
    args = (
        Cli("hairpin self-contact fold (grid-hash broadphase, self-collision)")
        .add("steps", 120, "time steps")
        .add("dt", 1e-3, "time step [s]")
        .add("E", 2e6, "Young's modulus")
        .add("damping", 5e2, "Kelvin-Voigt damping")
        .add("press", 0.07, "total prescribed descent of the upper leg end")
        .add("friction", 0.3, "Coulomb friction")
        .add("modulus", 2e6, "hydroelastic modulus")
        .add("nx", 24, "elements along the beam")
        .add("vtk_every", 10, "export interval (0 = off)")
        .parse()
    )

    nodes, conn = hairpin_t10_mesh(leg=0.4, gap=0.06, nx=args["nx"], ny=2, nz=2)
    lam, mu = lame_from_E_nu(args["E"], 0.3)
    mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])
    low_end = np.nonzero((nodes[:, 0] > 0.39) & (nodes[:, 2] < 0.03))[0]
    up_end = np.nonzero((nodes[:, 0] > 0.39) & (nodes[:, 2] > 0.08))[0]
    pinned = np.concatenate([low_end, up_end])
    system = System(
        elems=feat10.build(nodes, conn, rho=1000.0), material=mat,
        constraints=FixedCoefs.from_indices(pinned, nodes),
    )
    print(f"{conn.shape[0]} elems, {nodes.shape[0]} nodes; "
          f"{len(low_end)} clamped, {len(up_end)} prescribed")

    collision = HydroelasticCollision(
        conn, np.zeros(conn.shape[0], np.int32),
        distance_pressure_field(nodes, conn, args["modulus"]),
        enable_self_collision=True, broadphase="grid", rest_nodes=nodes,
        max_pairs=32768,
    )
    params = newton.NewtonParams(
        dt=args["dt"], rho=1e8, inner_atol=1e-6, inner_rtol=1e-6,
        outer_tol=1e-8, max_outer=2, max_inner=8, cg_rtol=1e-4, cg_max_iter=300,
        # Default globalization (ls_max backtracking on ||g||) handles the
        # indefinite SVK tangent at contact onset — no per-scene knobs.
    )
    sim = Simulation(
        system, StepState.rest(system, nodes), newton.stepper(params),
        collision=collision,
        collision_params=HydroelasticParams(damping=2.0, friction=args["friction"]),
    )

    d = out_dir("self_contact_fold")
    targets0 = nodes[pinned].copy()
    t0 = time.time()
    for k in range(args["steps"]):
        t = targets0.copy()
        t[len(low_end):, 2] -= args["press"] * (k + 1) / args["steps"]
        sim.set_constraint_targets(jnp.asarray(t))
        sim.step()
        if k % 10 == 0:
            nc = int(np.asarray(sim.last_patches.n_contacts))
            print(f"step {k:4d} self-contacts={nc:4d}")
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            io_vtk.write_vtu_t10(
                os.path.join(d, f"fold_{k:05d}.vtu"), np.asarray(sim.state.x), conn
            )
    wall = time.time() - t0
    print(f"{args['steps']} steps in {wall:.1f}s; out in {d}/")


if __name__ == "__main__":
    main()
