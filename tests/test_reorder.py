"""RCM node renumbering (`tlfea.utils.reorder`).

Physics must be invariant under renumbering: the ALM gradient of the
renumbered system equals the permutation of the original gradient.
"""

import numpy as np
import jax.numpy as jnp

from tlfea.constraints import FixedCoefs
from tlfea.elements import feat10
from tlfea.elements.assembly import lumped_mass
from tlfea.materials import SVK, lame_from_E_nu
from tlfea.solvers import System
from tlfea.solvers.common import grad_L
from tlfea.utils.reorder import apply_node_order, bandwidth, rcm_order
from tlfea.utils.tetmesh import box_t10_mesh


def test_rcm_reduces_bandwidth_and_preserves_physics():
    nodes, conn = box_t10_mesh(1.0, 0.3, 0.3, 8, 2, 2)
    perm = rcm_order(conn, len(nodes))
    nodes2, conn2 = apply_node_order(nodes, conn, perm)
    assert sorted(perm.tolist()) == list(range(len(nodes)))
    assert bandwidth(conn2) < bandwidth(conn)
    assert np.allclose(nodes2, nodes[perm])

    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = SVK(lam=jnp.asarray(lam), mu=jnp.asarray(mu),
              eta_damp=jnp.asarray(1e3), lam_damp=jnp.asarray(1e3))

    def build(nds, cn):
        fixed = np.nonzero(nds[:, 0] < 1e-12)[0]
        elems = feat10.build(nds, cn, rho=1000.0)
        return System(elems=elems, material=mat,
                      constraints=FixedCoefs.from_indices(fixed, nds)), fixed

    sys1, fixed1 = build(nodes, conn)
    sys2, fixed2 = build(nodes2, conn2)
    # Same constrained node SET under the permutation.
    assert sorted(perm[fixed2].tolist()) == sorted(fixed1.tolist())

    n = len(nodes)
    rng = np.random.default_rng(0)
    v1 = rng.normal(size=(n, 3)) * 0.1
    f1 = np.asarray(
        jnp.zeros((n, 3)).at[:, 2].add(lumped_mass(sys1.elems) * -9.81)
    )
    # lam duals must correspond to the same physical nodes: both systems'
    # constraints are coordinate-derived, so map via the permutation.
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    lam1 = rng.normal(size=(len(fixed1), 3))
    # fixed2 rows ordered by new index; original node of row k is perm[fixed2[k]]
    pos_in_fixed1 = {int(j): k for k, j in enumerate(fixed1)}
    lam2 = np.stack([lam1[pos_in_fixed1[int(perm[j])]] for j in fixed2])

    g1 = grad_L(jnp.asarray(v1), jnp.asarray(nodes), jnp.asarray(v1) * 0,
                jnp.asarray(lam1), jnp.asarray(f1), 1e-3, 1e6, sys1)
    g2 = grad_L(jnp.asarray(v1[perm]), jnp.asarray(nodes2),
                jnp.asarray(v1[perm]) * 0, jnp.asarray(lam2),
                jnp.asarray(f1[perm]), 1e-3, 1e6, sys2)
    assert np.allclose(np.asarray(g2), np.asarray(g1)[perm], atol=1e-8)


def _two_box_scene():
    from tlfea.utils.mesh_manager import MeshManager
    from tlfea.utils.pressure import distance_pressure_field

    mm = MeshManager()
    na, ca = box_t10_mesh(1.0, 0.4, 0.4, 4, 2, 2)
    a = mm.add_mesh(na, ca, "a")
    nb, cb = box_t10_mesh(0.5, 0.5, 0.2, 2, 2, 1)
    b = mm.add_mesh(nb, cb, "b")
    mm.translate_mesh(b, (0.2, 0.0, 0.6))
    for mid in (a, b):
        inst = mm.instances[mid]
        local = mm.elements[inst.elem_offset:inst.elem_offset + inst.n_elems] - inst.node_offset
        mm.set_scalar_field(mid, distance_pressure_field(mm.mesh_nodes(mid), local, 1e6))
    return mm


def test_scene_reorder_consistency():
    """`MeshManager.scene()` threads ONE node permutation through every
    node-indexed array (scene-level renumbering)."""
    mm = _two_box_scene()
    base = mm.scene(reorder=False)
    sc = mm.scene(reorder=True)
    n = mm.nodes.shape[0]

    # perm/inv are mutually inverse and cover all nodes.
    assert sorted(sc.perm.tolist()) == list(range(n))
    assert np.array_equal(sc.perm[sc.inv], np.arange(n))
    # Reorder actually improved the band on this assembly-ordered scene.
    assert bandwidth(sc.conn) < bandwidth(base.conn)
    # Node-indexed arrays are consistently permuted.
    assert np.allclose(sc.nodes, mm.nodes[sc.perm])
    assert np.allclose(sc.pressures, mm.scalar_field()[sc.perm])
    assert np.array_equal(sc.node_mesh_ids, mm.node_mesh_ids()[sc.perm])
    assert np.array_equal(sc.elem_mesh_ids, mm.elem_mesh_ids())
    # Connectivity relabeled, element rows in place: mapping scene labels
    # back through perm recovers the original connectivity.
    assert np.array_equal(sc.perm[sc.conn], mm.elements)
    # Surface triangles carry scene labels for the same physical triangles.
    for mid in range(len(mm.instances)):
        ref = {tuple(sorted(t)) for t in sc.perm[sc.surface_triangles(mid)].tolist()}
        got = {tuple(sorted(t)) for t in mm.surface_triangles(mid).tolist()}
        assert ref == got
    # to_old round-trips per-node data.
    assert np.allclose(sc.to_old(sc.nodes), mm.nodes)

