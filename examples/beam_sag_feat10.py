"""T10 tetrahedral beam sag with the unified 4-solver driver.

Workload parity: reference `lib_bin/beam_sag/test_feat10_{nesterov,adamw}`
(plus Newton/VBD through the same driver). Uses the reference TetGen beam
meshes when available, otherwise the native structured mesher.

Run: python examples/beam_sag_feat10.py --solver=adamw --steps=50
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from tlfea.constraints import FixedCoefs
from tlfea.elements import feat10
from tlfea.materials import SVK, lame_from_E_nu
from tlfea.simulation import Simulation, gravity_force
from tlfea.solvers import System, StepState
from tlfea.utils import io_vtk
from tlfea.utils.cli import Cli
from tlfea.utils.tetmesh import box_t10_mesh, read_tetgen

from _common import REF_DATA, make_solver, out_dir


def load_mesh(res: int):
    node = os.path.join(REF_DATA, f"meshes/T10/resolution/beam_3x2x1_res{res}.1.node")
    ele = os.path.join(REF_DATA, f"meshes/T10/resolution/beam_3x2x1_res{res}.1.ele")
    if os.path.exists(node):
        return read_tetgen(node, ele)
    return box_t10_mesh(3.0, 2.0, 1.0, 3 * (res + 1), 2 * (res + 1), res + 1)


def main():
    args = (
        Cli("T10 beam sag (reference: lib_bin/beam_sag/test_feat10_*)")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("res", 0, "beam mesh resolution {0,2,4,8,16}")
        .add("steps", 50, "time steps")
        .add("dt", 1e-3, "time step [s]")
        .add("E", 5e6, "Young's modulus")
        .add("nu", 0.3, "Poisson ratio")
        .add("rho0", 2700.0, "density")
        .add("damping", 1e3, "Kelvin-Voigt damping")
        .add("rho_alm", 1e9, "ALM penalty")
        .add("vtk_every", 20, "VTU export interval (0 = off)")
        .parse()
    )

    nodes, conn = load_mesh(args["res"])
    print(f"mesh: {conn.shape[0]} elems, {nodes.shape[0]} nodes")
    elems = feat10.build(nodes, conn, rho=args["rho0"])
    lam, mu = lame_from_E_nu(args["E"], args["nu"])
    mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])
    fixed = np.nonzero(nodes[:, 0] < nodes[:, 0].min() + 1e-9)[0]
    system = System(
        elems=elems, material=mat, constraints=FixedCoefs.from_indices(fixed, nodes)
    )
    state = StepState.rest(system, nodes)
    f_ext = gravity_force(system)

    step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
    sim = Simulation(system, state, step, base_f_ext=f_ext)

    tip = int(np.lexsort((nodes[:, 2], nodes[:, 1], -nodes[:, 0]))[0])
    d = out_dir("beam_sag_feat10")
    hist = []
    t0 = time.time()
    for k in range(args["steps"]):
        diag = sim.step()
        tz = float(sim.state.x[tip, 2])
        hist.append((k * args["dt"], tz))
        if k % 10 == 0:
            print(f"step {k:4d} tip_z={tz:+.6f}")
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            io_vtk.write_vtu_t10(
                os.path.join(d, f"beam_{k:05d}.vtu"),
                np.asarray(sim.state.x), conn,
                displacement=np.asarray(sim.state.x) - nodes,
            )
    wall = time.time() - t0
    io_vtk.write_csv_history(
        os.path.join(d, f"tip_z_{args['solver']}_res{args['res']}.csv"), ["t", "tip_z"], hist
    )
    print(f"{args['steps']} steps in {wall:.1f}s ({args['steps']/wall:.2f} steps/s); out in {d}/")


if __name__ == "__main__":
    main()
