"""T10 beam convergence/validation study across mesh resolutions.

Workload parity: reference `lib_bin/beam_sag/test_feat10_resolution.cc`
(beam_3x2x1 at res in {0,2,4,8,16}, target-node x-history CSVs for
comparison against the FEniCSx backward-Euler ground truth,
`test-scripts/validation/fenics/beam_dynamic_backward_euler.py`).

Run: python examples/feat10_resolution_study.py --res=0,2,4 --steps=50
"""

import os
import sys

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
from tlfea.utils.tetmesh import read_tetgen

from _common import REF_DATA, make_solver, out_dir


def main():
    args = (
        Cli("T10 beam resolution study (reference: test_feat10_resolution.cc)")
        .add("res", "0,2,4", "comma-separated resolutions {0,2,4,8,16}")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("steps", 50, "time steps")
        .add("dt", 1e-3, "time step [s]")
        .add("E", 1e7, "Young's modulus")
        .add("nu", 0.3, "Poisson ratio")
        .add("rho0", 2700.0, "density")
        .add("damping", 1e3, "Kelvin-Voigt damping")
        .add("rho_alm", 1e9, "ALM penalty")
        .parse()
    )

    d = out_dir("feat10_resolution")
    for res in [int(r) for r in args["res"].split(",")]:
        node = os.path.join(REF_DATA, f"meshes/T10/resolution/beam_3x2x1_res{res}.1.node")
        ele = os.path.join(REF_DATA, f"meshes/T10/resolution/beam_3x2x1_res{res}.1.ele")
        if not os.path.exists(node):
            print(f"res {res}: mesh not found, skipping")
            continue
        nodes, conn = read_tetgen(node, ele)
        print(f"res {res}: {conn.shape[0]} elems, {nodes.shape[0]} nodes")

        elems = feat10.build(nodes, conn, rho=args["rho0"])
        lam, mu = lame_from_E_nu(args["E"], args["nu"])
        mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])
        fixed = np.nonzero(nodes[:, 0] < nodes[:, 0].min() + 1e-9)[0]
        system = System(
            elems=elems, material=mat, constraints=FixedCoefs.from_indices(fixed, nodes)
        )
        state = StepState.rest(system, nodes)
        step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
        sim = Simulation(system, state, step, base_f_ext=gravity_force(system))

        # Track the node closest to the beam tip center (the reference tracks
        # a fixed target point, `test_feat10_resolution.cc:246-253`).
        target = np.array([nodes[:, 0].max(), 1.0, 0.5])
        track = int(np.argmin(np.linalg.norm(nodes - target, axis=1)))

        hist = []
        for k in range(args["steps"]):
            sim.step()
            p = np.asarray(sim.state.x[track])
            hist.append((k * args["dt"], p[0], p[1], p[2]))
        io_vtk.write_csv_history(
            os.path.join(d, f"track_res{res}.csv"), ["t", "x", "y", "z"], hist
        )
        print(f"  final track position: {hist[-1][1:]} -> {d}/track_res{res}.csv")


if __name__ == "__main__":
    main()
