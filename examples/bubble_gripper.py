"""Two soft bubble grippers clamp a deformable item via prescribed motion.

Workload parity: reference `lib_bin/collision_system/
test_bubble_gripper_bunny(_floor).cc` — gripper bodies driven by
`UpdatePositions` + `UpdateConstraintTargets` each step on a close/hold/
reopen schedule (`test_bubble_gripper_bunny.cc:420-459`), hydroelastic
contact with the grasped object.

Run: python examples/bubble_gripper.py --steps=120
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from tlfea.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
from tlfea.constraints import DensePins
from tlfea.elements import feat10
from tlfea.materials import SVK, lame_from_E_nu
from tlfea.simulation import Simulation
from tlfea.solvers import System, StepState
from tlfea.utils import io_vtk
from tlfea.utils.cli import Cli
from tlfea.utils.mesh_manager import MeshManager
from tlfea.utils.pressure import distance_pressure_field
from tlfea.utils.tetmesh import box_t10_mesh, read_tetgen

from _common import REF_DATA, make_solver, out_dir


def main():
    args = (
        Cli("bubble gripper (reference: test_bubble_gripper_bunny.cc)")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("steps", 120, "time steps")
        .add("dt", 5e-4, "time step [s]")
        .add("E", 5e5, "Young's modulus")
        .add("nu", 0.4, "Poisson ratio")
        .add("rho0", 1000.0, "density")
        .add("damping", 1e2, "Kelvin-Voigt damping")
        .add("friction", 0.6, "Coulomb friction")
        .add("modulus", 5e5, "hydroelastic modulus")
        .add("rho_alm", 1e9, "ALM penalty")
        .add("close_frac", 0.4, "fraction of steps closing")
        .add("hold_frac", 0.3, "fraction of steps holding")
        .add("close_speed", 0.08, "gripper closing speed [m/s]")
        .add("vtk_every", 30, "export interval (0 = off)")
        .parse()
    )

    mm = MeshManager()
    # Two gripper pads (soft boxes) flanking a central item.
    pad_nodes, pad_conn = box_t10_mesh(0.08, 0.3, 0.3, 1, 3, 3)
    item_node = os.path.join(REF_DATA, "meshes/T10/sphere.1.node")
    if os.path.exists(item_node):
        item = mm.load_mesh(item_node, item_node.replace(".node", ".ele"), "item")
    else:
        inodes, iconn = box_t10_mesh(0.25, 0.25, 0.25, 2, 2, 2)
        item = mm.add_mesh(inodes, iconn, "item")
    inodes = mm.mesh_nodes(item)
    ic = 0.5 * (inodes.max(axis=0) + inodes.min(axis=0))
    ext = inodes.max(axis=0) - inodes.min(axis=0)

    gap = 0.02
    left = mm.add_mesh(pad_nodes, pad_conn, "left_pad")
    mm.translate_mesh(left, (ic[0] - ext[0] / 2 - gap - 0.08, ic[1] - 0.15, ic[2] - 0.15))
    right = mm.add_mesh(pad_nodes, pad_conn, "right_pad")
    mm.translate_mesh(right, (ic[0] + ext[0] / 2 + gap, ic[1] - 0.15, ic[2] - 0.15))

    for mid in range(len(mm.instances)):
        inst = mm.instances[mid]
        local_conn = mm.elements[inst.elem_offset : inst.elem_offset + inst.n_elems] - inst.node_offset
        mm.set_scalar_field(
            mid, distance_pressure_field(mm.mesh_nodes(mid), local_conn, args["modulus"])
        )

    nodes, conn = mm.nodes, mm.elements
    print(f"scene: {conn.shape[0]} elems, {nodes.shape[0]} nodes")

    elems = feat10.build(nodes, conn, rho=args["rho0"])
    lam, mu = lame_from_E_nu(args["E"], args["nu"])
    mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])

    # Driven nodes: the outer faces of both pads (prescribed motion).
    ln = mm.mesh_nodes(left)
    rn = mm.mesh_nodes(right)
    l_ids = np.arange(mm.instances[left].node_offset, mm.instances[left].node_offset + ln.shape[0])
    r_ids = np.arange(mm.instances[right].node_offset, mm.instances[right].node_offset + rn.shape[0])
    l_drive = l_ids[ln[:, 0] < ln[:, 0].min() + 1e-9]
    r_drive = r_ids[rn[:, 0] > rn[:, 0].max() - 1e-9]
    driven = np.concatenate([l_drive, r_drive])
    # DensePins: membership + targets as dense fields, so per-step
    # retargeting (the close/hold/reopen schedule) and re-pinning are
    # data-only — no retrace.
    system = System(
        elems=elems, material=mat, constraints=DensePins.from_indices(driven, nodes)
    )
    state = StepState.rest(system, nodes)

    collision = HydroelasticCollision(
        conn, mm.elem_mesh_ids(), mm.scalar_field(), window=256, max_pairs=8192
    )
    step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
    sim = Simulation(
        system, state, step,
        collision=collision,
        collision_params=HydroelasticParams(friction=args["friction"]),
    )

    n_close = int(args["close_frac"] * args["steps"])
    n_hold = int(args["hold_frac"] * args["steps"])
    # Full-field target (DensePins): rows outside `driven` are inert.
    target = nodes.copy()
    nl = len(l_drive)
    d = out_dir("bubble_gripper")
    t0 = time.time()
    for k in range(args["steps"]):
        # Close / hold / reopen schedule (reference: :420+).
        if k < n_close:
            dx = args["close_speed"] * args["dt"]
        elif k < n_close + n_hold:
            dx = 0.0
        else:
            dx = -args["close_speed"] * args["dt"]
        target[l_drive, 0] += dx
        target[r_drive, 0] -= dx
        sim.set_constraint_targets(target)
        diag = sim.step()
        if k % 20 == 0:
            nc = int(np.asarray(sim.last_patches.n_contacts)) if sim.last_patches is not None else 0
            print(f"step {k:4d} contacts={nc:5d} |c|={float(diag['norm_c']):.1e}")
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            io_vtk.write_vtu_t10(os.path.join(d, f"grip_{k:05d}.vtu"), np.asarray(sim.state.x), conn)
    wall = time.time() - t0
    print(f"{args['steps']} steps in {wall:.1f}s; out in {d}/")


if __name__ == "__main__":
    main()
