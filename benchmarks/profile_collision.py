"""Collision pipeline cost on the device, measured the production way: the
full broadphase -> narrowphase -> forces pipeline chained inside one
lax.scan, so per-dispatch host cost is excluded. The reference's sub-ms GPU
phase prints (`test_sphere_drop_collision.cc:448-473`) are device-side; the
comparable number here is the in-scan per-step cost. Needs a GPU.

    python benchmarks/profile_collision.py

Scene: two 256-elem T10 spheres (reference mesh; two boxes when the
reference data is absent), dense-cross broadphase (the auto choice for 2
meshes) and SAP for comparison.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import bench
from tlfea.utils.compile_cache import enable_compile_cache

bench.require_accelerator()
enable_compile_cache()

from tlfea.collision.broadphase import (
    compact_pairs, find_pairs, find_pairs_dense, setup_broadphase,
    setup_dense_cross,
)
from tlfea.collision.forces import patch_forces
from tlfea.collision.narrowphase import compute_patches
from tlfea.utils.mesh_manager import MeshManager
from tlfea.utils.pressure import distance_pressure_field
from tlfea.utils.tetmesh import box_t10_mesh

REF = "/root/reference/data/meshes/T10"
mm = MeshManager()
if os.path.exists(os.path.join(REF, "sphere.1.node")):
    a = mm.load_mesh(os.path.join(REF, "sphere.1.node"),
                     os.path.join(REF, "sphere.1.ele"), "a")
    b = mm.load_mesh(os.path.join(REF, "sphere.1.node"),
                     os.path.join(REF, "sphere.1.ele"), "b")
else:
    print("reference meshes absent: two boxes instead of two spheres")
    n0, c0 = box_t10_mesh(0.5, 0.5, 0.5, 4, 4, 2)
    a, b = mm.add_mesh(n0, c0, "a"), mm.add_mesh(n0, c0, "b")
za = mm.mesh_nodes(a)[:, 2]
# overlap slightly so the narrowphase has real work
mm.translate_mesh(b, (0.0, 0.0, (za.max() - za.min()) * 0.92))
for mid in (a, b):
    inst = mm.instances[mid]
    conn_local = mm.elements[inst.elem_offset: inst.elem_offset + inst.n_elems] - inst.node_offset
    mm.set_scalar_field(mid, distance_pressure_field(mm.mesh_nodes(mid), conn_local, 1e6))

nodes, conn, mesh_ids = mm.nodes, mm.elements, mm.elem_mesh_ids()
pressures = mm.scalar_field()
dtype = np.float32
x0 = jnp.asarray(nodes, dtype)
v0 = jnp.zeros_like(x0)
print(f"scene: {conn.shape[0]} elems, {nodes.shape[0]} nodes")

MAX_PAIRS = 4096
bp = setup_broadphase(conn, mesh_ids, window=256, margin=0.0)
cross = setup_dense_cross(conn, mesh_ids)
press = jnp.asarray(pressures, dtype)

N = 50


def timeit_scan(name, phase_fn):
    """phase_fn(x) -> f; scan it N times with a trivial state perturbation
    so XLA cannot hoist the work out of the loop."""

    @jax.jit
    def run(x):
        def body(carry, _):
            x = carry
            f = phase_fn(x)
            # fold the output back into x so every iteration depends on the last
            x = x + 1e-12 * f
            return x, jnp.sum(f)

        xf, s = jax.lax.scan(body, x, None, length=N)
        return xf, s

    out = run(x0)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = run(x0)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / N * 1e3
    print(f"{name:38s} {ms:8.3f} ms/step")
    return ms


def full_dense(x):
    pairs, valid, _ = find_pairs_dense(bp, x, cross)
    pairs, valid, _ = compact_pairs(pairs, valid, MAX_PAIRS)
    patches = compute_patches(x, press, bp.corners, pairs, valid, bp.mesh_ids, False)
    return patch_forces(patches, x, v0, bp.corners, damping=dtype(0.0), friction=dtype(0.3))


def full_sap(x):
    pairs, valid, _ = find_pairs(bp, x, False)
    pairs, valid, _ = compact_pairs(pairs, valid, MAX_PAIRS)
    patches = compute_patches(x, press, bp.corners, pairs, valid, bp.mesh_ids, False)
    return patch_forces(patches, x, v0, bp.corners, damping=dtype(0.0), friction=dtype(0.3))


def broad_only(x):
    pairs, valid, _ = find_pairs_dense(bp, x, cross)
    pairs, valid, _ = compact_pairs(pairs, valid, MAX_PAIRS)
    # return something force-shaped for the scan contract
    return jnp.zeros_like(x) + valid.sum() * 0.0


def broad_narrow(x):
    pairs, valid, _ = find_pairs_dense(bp, x, cross)
    pairs, valid, _ = compact_pairs(pairs, valid, MAX_PAIRS)
    patches = compute_patches(x, press, bp.corners, pairs, valid, bp.mesh_ids, False)
    return jnp.zeros_like(x).at[0, 0].add(jnp.sum(patches.area))


# how much narrowphase work is actually happening?
pairs, valid, _ = find_pairs_dense(bp, x0, cross)
pairs, valid, _ = compact_pairs(pairs, valid, MAX_PAIRS)
print(f"active candidate pairs: {int(valid.sum())} / {MAX_PAIRS} capacity")

timeit_scan("full pipeline (dense broadphase)", full_dense)
timeit_scan("full pipeline (SAP broadphase)", full_sap)
timeit_scan("broadphase+compact only (dense)", broad_only)
timeit_scan("broad+narrow (dense)", broad_narrow)

# smaller narrowphase capacity: cost should drop if capacity-bound
MAX_PAIRS = 1024
timeit_scan("full dense, max_pairs=1024", full_dense)
MAX_PAIRS = 4096
