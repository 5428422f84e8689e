"""Hydroelastic collision pipeline tests.

Mirrors the reference's `lib_utest/utest_collision.cc` invariants:
patch validity (unit normals), Newton's-third-law net contact force ~ 0, and
a two-body overlap scenario producing separating forces.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tlfea.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
from tlfea.utils.pressure import distance_pressure_field
from tlfea.utils.tetmesh import box_t10_mesh


def two_box_scene(gap=-0.2):
    """Two unit boxes overlapping by |gap| along x (gap < 0 -> overlap)."""
    nodes_a, conn_a = box_t10_mesh(1.0, 1.0, 1.0, 2, 2, 2)
    nodes_b, conn_b = box_t10_mesh(1.0, 1.0, 1.0, 2, 2, 2)
    nodes_b = nodes_b + np.array([1.0 + gap, 0.0, 0.0])
    nodes = np.vstack([nodes_a, nodes_b])
    conn = np.vstack([conn_a, conn_b + nodes_a.shape[0]])
    mesh_ids = np.concatenate(
        [np.zeros(conn_a.shape[0], dtype=np.int32), np.ones(conn_b.shape[0], dtype=np.int32)]
    )
    pa = distance_pressure_field(nodes_a, conn_a, modulus=1e5)
    pb = distance_pressure_field(nodes_b, conn_b, modulus=1e5)
    pressures = np.concatenate([pa, pb])
    return nodes, conn, mesh_ids, pressures


@pytest.fixture(scope="module")
def overlapping():
    nodes, conn, mesh_ids, pressures = two_box_scene(gap=-0.2)
    col = HydroelasticCollision(conn, mesh_ids, pressures, window=64)
    return nodes, conn, mesh_ids, col


def test_patches_found_and_unit_normals(overlapping):
    nodes, conn, mesh_ids, col = overlapping
    patches = col.patches(jnp.asarray(nodes))
    use = np.asarray(patches.valid & patches.valid_orientation)
    assert use.sum() > 0, "overlapping boxes must produce contact patches"
    normals = np.asarray(patches.normal)[use]
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-6)
    # Drake convention: g_A > 0 and g_B > 0 on valid-orientation patches.
    assert (np.asarray(patches.g_A)[use] > 0).all()
    assert (np.asarray(patches.g_B)[use] > 0).all()
    # Patch areas positive and bounded by the overlap cross-section (1 x 1).
    areas = np.asarray(patches.area)[use]
    assert (areas > 0).all() and areas.max() <= 1.0 + 1e-6


def test_net_contact_force_is_zero(overlapping):
    """Newton's third law: sum of all contact forces ~ 0
    (reference: `utest_collision.cc:321-323`)."""
    nodes, conn, mesh_ids, col = overlapping
    f, patches, overflow = col.step(jnp.asarray(nodes))
    assert not bool(overflow)
    f = np.asarray(f)
    fscale = np.abs(f).max() + 1e-30
    assert np.abs(f.sum(axis=0)).max() / fscale < 1e-10


def test_forces_separate_bodies(overlapping):
    """Mesh A (low x) gets pushed -x, mesh B +x."""
    nodes, conn, mesh_ids, col = overlapping
    f, patches, _ = col.step(jnp.asarray(nodes))
    f = np.asarray(f)
    n_a = (np.asarray(mesh_ids) == 0).sum()  # elements of A
    # Identify nodes per mesh by connectivity.
    nodes_a = np.unique(np.asarray(conn)[np.asarray(mesh_ids) == 0])
    nodes_b = np.unique(np.asarray(conn)[np.asarray(mesh_ids) == 1])
    fx_a = f[nodes_a, 0].sum()
    fx_b = f[nodes_b, 0].sum()
    assert fx_a < 0 and fx_b > 0
    np.testing.assert_allclose(fx_a, -fx_b, rtol=1e-9)


def test_no_contact_when_separated():
    nodes, conn, mesh_ids, pressures = two_box_scene(gap=0.3)
    col = HydroelasticCollision(conn, mesh_ids, pressures, window=64)
    f, patches, overflow = col.step(jnp.asarray(nodes))
    assert int(np.asarray(patches.n_contacts)) == 0
    np.testing.assert_allclose(np.asarray(f), 0.0, atol=1e-12)


def test_damping_reduces_approaching_pressure(overlapping):
    nodes, conn, mesh_ids, col = overlapping
    x = jnp.asarray(nodes)
    nodes_b = np.unique(np.asarray(conn)[np.asarray(mesh_ids) == 1])
    v = np.zeros_like(nodes)
    v[nodes_b, 0] = -1.0  # B moving toward A
    f0, _, _ = col.step(x, jnp.asarray(v), HydroelasticParams(damping=0.0))
    fd, _, _ = col.step(x, jnp.asarray(v), HydroelasticParams(damping=0.5))
    # Approaching motion: v_rel·n < 0 -> damped pressure LARGER (1 - d*v_n > 1).
    assert float(jnp.abs(fd).sum()) > float(jnp.abs(f0).sum())

    v[nodes_b, 0] = 1.0  # separating
    fs, _, _ = col.step(x, jnp.asarray(v), HydroelasticParams(damping=0.5))
    assert float(jnp.abs(fs).sum()) < float(jnp.abs(f0).sum())


def test_friction_opposes_sliding(overlapping):
    nodes, conn, mesh_ids, col = overlapping
    x = jnp.asarray(nodes)
    nodes_b = np.unique(np.asarray(conn)[np.asarray(mesh_ids) == 1])
    v = np.zeros_like(nodes)
    v[nodes_b, 2] = 1.0  # B sliding +z relative to A
    f, _, _ = col.step(x, jnp.asarray(v), HydroelasticParams(friction=0.5))
    f = np.asarray(f)
    nodes_a = np.unique(np.asarray(conn)[np.asarray(mesh_ids) == 0])
    # Friction drags A along +z and resists B's +z motion.
    assert f[nodes_b, 2].sum() < 0
    assert f[nodes_a, 2].sum() > 0


def test_block_broadphase_matches_dense(overlapping):
    """Two-level block broadphase finds the same candidate
    set and produces the same patch forces as the exact dense cross test."""
    from tlfea.collision.broadphase import (
        find_pairs_block, find_pairs_dense, setup_block_cross,
        setup_broadphase, setup_dense_cross,
    )

    nodes, conn, mesh_ids, col = overlapping
    x = jnp.asarray(nodes)
    bp = setup_broadphase(conn, mesh_ids, window=64)
    cross = setup_dense_cross(conn, mesh_ids)
    blk = setup_block_cross(conn, mesh_ids, nodes, block=16, block_pair_cap=64)
    pd, vd, _ = find_pairs_dense(bp, x, cross)
    pb, vb, ob = find_pairs_block(bp, blk, x)
    assert not bool(ob)
    sd = {tuple(r) for r in np.asarray(pd)[np.asarray(vd)].tolist()}
    sb = {tuple(r) for r in np.asarray(pb)[np.asarray(vb)].tolist()}
    assert sd == sb and len(sd) > 0

    col_blk = HydroelasticCollision(
        conn, mesh_ids, col._init_args["pressures"], broadphase="block",
        rest_nodes=nodes, block=16, block_pair_cap=64, window=64,
    )
    f_d, p_d, _ = col.step(x)
    f_b, p_b, _ = col_blk.step(x)
    assert int(np.asarray(p_d.n_contacts)) == int(np.asarray(p_b.n_contacts))
    np.testing.assert_allclose(np.asarray(f_b), np.asarray(f_d), atol=1e-9)


def test_block_broadphase_overflow_detected(overlapping):
    """Undersized block-pair capacity raises the overflow flag (grow path)."""
    nodes, conn, mesh_ids, col = overlapping
    col_small = HydroelasticCollision(
        conn, mesh_ids, col._init_args["pressures"], broadphase="block",
        rest_nodes=nodes, block=16, block_pair_cap=2, window=64,
    )
    _, _, overflow = col_small.step(jnp.asarray(nodes))
    assert bool(overflow)
    grown = col_small.grow()
    assert grown.blk.block_pair_cap == 4
