"""Deformable item dropped onto a deformable floor, switchable collision
backend.

Workload parity: reference `lib_bin/collision_system/test_item_drop.cc`
(dragon/armadillo/openbox onto a deformable floor, `--collision=hydro|deme`
switch behind the CollisionSystem interface; everything device-resident).
The DEM backend requires the external DEM-Engine dependency and is exposed
through the same interface (`tlfea.collision.dem_bridge`); without the
dependency it reports unavailability.

Run: python examples/item_drop.py --item=dragon --steps=50
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
from tlfea.simulation import Simulation, gravity_force
from tlfea.solvers import System, StepState
from tlfea.utils import io_vtk
from tlfea.utils.cli import Cli
from tlfea.utils.mesh_manager import MeshManager
from tlfea.utils.pressure import distance_pressure_field
from tlfea.utils.tetmesh import box_t10_mesh

from _common import REF_DATA, make_solver, out_dir


def main():
    args = (
        Cli("item drop (reference: lib_bin/collision_system/test_item_drop.cc)")
        .add("item", "sphere", "sphere|dragon|armadillo|openbox|box")
        .add("collision", "hydro", "hydro|deme")
        .add("solver", "newton", "newton|nesterov|adamw|vbd")
        .add("steps", 50, "time steps")
        .add("dt", 2e-4, "time step [s]")
        .add("E", 1e6, "Young's modulus")
        .add("nu", 0.3, "Poisson ratio")
        .add("rho0", 1000.0, "density")
        .add("damping", 1e2, "Kelvin-Voigt damping")
        .add("friction", 0.4, "Coulomb friction")
        .add("modulus", 1e6, "hydroelastic modulus")
        .add("dem_E", 2e6, "DEM contact Young's modulus (collision=deme; "
                           "reference default DEME_CONTACT_E=2e6)")
        .add("dem_nu", 0.3, "DEM contact Poisson ratio (DEME_CONTACT_NU)")
        .add("dem_cor", 0.0, "DEM contact restitution (DEME_CONTACT_COR)")
        .add("dem_kn", 0.0, "raw DEM normal stiffness override (0 = derive "
                            "from dem_E/dem_nu/dem_cor)")
        .add("dem_cn", 0.0, "raw DEM normal damping override")
        .add("rho_alm", 1e8, "ALM penalty")
        .add("drop_height", 0.05, "initial gap above the floor")
        .add("window", 256, "broadphase window")
        .add("max_pairs", 8192, "narrowphase pair capacity")
        .add("vtk_every", 20, "export interval (0 = off)")
        .parse()
    )

    mm = MeshManager()
    item_paths = {
        "dragon": ("meshes/T10/item_drop/dragon.node", "meshes/T10/item_drop/dragon.ele"),
        "armadillo": ("meshes/T10/item_drop/armadillo.node", "meshes/T10/item_drop/armadillo.ele"),
        "openbox": ("meshes/T10/item_drop/openbox.node", "meshes/T10/item_drop/openbox.ele"),
        "sphere": ("meshes/T10/sphere.1.node", "meshes/T10/sphere.1.ele"),
    }
    if args["item"] in item_paths:
        node = os.path.join(REF_DATA, item_paths[args["item"]][0])
        ele = os.path.join(REF_DATA, item_paths[args["item"]][1])
    else:
        node = None
    if node and os.path.exists(node):
        item = mm.load_mesh(node, ele, args["item"])
    else:
        nodes_i, conn_i = box_t10_mesh(0.3, 0.3, 0.3, 2, 2, 2)
        item = mm.add_mesh(nodes_i, conn_i, "box_item")

    # Deformable floor sized to the item footprint.
    inodes = mm.mesh_nodes(item)
    ext = inodes.max(axis=0) - inodes.min(axis=0)
    fl_x, fl_y = 2.5 * ext[0], 2.5 * ext[1]
    fl_h = 0.2 * ext[2]
    # nz >= 2 is load-bearing: with one element through the thickness every
    # corner node is on the surface, so the floor's per-tet affine pressure
    # fields are identically zero and hydro contact silently never fires
    # (see tests/test_sharding.py).
    floor_nodes, floor_conn = box_t10_mesh(fl_x, fl_y, fl_h, 6, 6, 2)
    floor = mm.add_mesh(floor_nodes, floor_conn, "floor")
    mm.translate_mesh(
        floor,
        (
            inodes[:, 0].min() - 0.75 * ext[0],
            inodes[:, 1].min() - 0.75 * ext[1],
            inodes[:, 2].min() - fl_h - args["drop_height"],
        ),
    )
    item_npz = (node or "").replace(".node", ".npz").replace(".1.npz", ".1.uncompressed.npz")
    for mid in (item, floor):
        if mid == item and node and os.path.exists(item_npz):
            # Reference NPZ scene asset: corner-vertex pressures.
            mm.load_corner_pressures_from_npz(mid, item_npz)
            continue
        inst = mm.instances[mid]
        local_conn = mm.elements[inst.elem_offset : inst.elem_offset + inst.n_elems] - inst.node_offset
        mm.set_scalar_field(
            mid, distance_pressure_field(mm.mesh_nodes(mid), local_conn, args["modulus"])
        )

    # Finalize with band-minimizing node relabeling (the dragon's natural
    # TetGen order has bandwidth ~26k), which keeps each element's gathers
    # and scatters local in memory.
    scene = mm.scene(reorder=True)
    nodes, conn = scene.nodes, scene.conn
    print(f"scene: {conn.shape[0]} elems, {nodes.shape[0]} nodes")

    elems = feat10.build(nodes, conn, rho=args["rho0"])
    lam, mu = lame_from_E_nu(args["E"], args["nu"])
    mat = SVK(lam=lam, mu=mu, eta_damp=args["damping"], lam_damp=args["damping"])
    # Clamp the floor underside.
    zmin = nodes[:, 2].min()
    fixed = np.nonzero(nodes[:, 2] < zmin + 1e-9)[0]
    system = System(
        elems=elems, material=mat, constraints=FixedCoefs.from_indices(fixed, nodes)
    )
    state = StepState.rest(system, nodes)

    if args["collision"] == "hydro":
        collision = HydroelasticCollision(
            conn, scene.elem_mesh_ids, scene.pressures,
            window=args["window"], max_pairs=args["max_pairs"],
            rest_nodes=nodes,  # enables the two-level block broadphase
        )
        print(f"broadphase mode: {collision.mode}")
        col_params = HydroelasticParams(friction=args["friction"])
    elif args["collision"] == "deme":
        # Native on-device DEM (DEM-Engine-style sphere contacts): every
        # surface vertex carries a contact sphere; spring-dashpot +
        # regularized Coulomb friction between meshes.
        from tlfea.collision.dem import (
            DemParams, NodeSphereDem, dem_params_from_material,
            node_sphere_radii,
        )

        surf_tris = [scene.surface_triangles(mid) for mid in range(len(mm.instances))]
        collision = NodeSphereDem(nodes, surf_tris)
        if args["dem_kn"] > 0:
            col_params = DemParams(kn=args["dem_kn"], cn=args["dem_cn"],
                                   mu=args["friction"])
        else:
            # Material-derived contact params (parameter-comparable to the
            # reference's DEME runs, DEME_CONTACT_E/NU/COR defaults):
            # characteristic sphere = median surface-node radius, node mass
            # = median lumped mass over the contact spheres.
            from tlfea.elements.assembly import lumped_mass

            all_tris = np.concatenate([np.asarray(t) for t in surf_tris])
            radii = node_sphere_radii(nodes, all_tris)
            surf_ids = np.unique(all_tris.reshape(-1))
            m_node = np.asarray(lumped_mass(elems))[surf_ids]
            col_params = dem_params_from_material(
                args["dem_E"], args["dem_nu"], args["dem_cor"],
                radius=float(np.median(radii[surf_ids])),
                mass=float(np.median(m_node)), mu=args["friction"],
            )
            print(f"DEM material map: E={args['dem_E']:.3g} nu={args['dem_nu']}"
                  f" cor={args['dem_cor']} -> kn={float(col_params.kn):.4g}"
                  f" cn={float(col_params.cn):.4g}")
    else:
        raise SystemExit("--collision must be hydro or deme")
    step = make_solver(args["solver"], system, args["dt"], args["rho_alm"])
    sim = Simulation(
        system, state, step, base_f_ext=gravity_force(system),
        collision=collision, collision_params=col_params,
    )

    d = out_dir("item_drop")
    t0 = time.time()
    for k in range(args["steps"]):
        if k == 1:  # steady-state rate: step 0 carries jit compiles
            t0 = time.time()
        diag = sim.step()
        if k % 10 == 0:
            nc = int(np.asarray(sim.last_patches.n_contacts)) if sim.last_patches is not None else 0
            it = {kk: int(np.asarray(sim.last_diag[kk]))
                  for kk in ("outer_iters", "newton_iters", "cg_iters")
                  if kk in sim.last_diag}
            print(f"step {k:4d} contacts={nc:5d} {it}", flush=True)
        if args["vtk_every"] and k % args["vtk_every"] == 0:
            io_vtk.write_vtu_t10(os.path.join(d, f"scene_{k:05d}.vtu"), np.asarray(sim.state.x), conn)
    wall = time.time() - t0
    n_timed = max(args["steps"] - 1, 1)
    print(f"{n_timed} steady-state steps in {wall:.1f}s "
          f"({n_timed/wall:.2f} steps/s; first step carries compiles); "
          f"out in {d}/")


if __name__ == "__main__":
    main()
