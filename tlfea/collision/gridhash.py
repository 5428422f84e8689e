"""Uniform-grid (spatial hash) broadphase — the self-collision-capable
alternative to sweep-and-prune.

The reference's broadphase is a single-axis sweep (`HydroelasticBroadphase.cu:
387-420`); this repo's static-shape version uses a fixed candidate window,
which degenerates when many boxes share the sweep axis (measured 8.9k
window on mixed scenes). For SELF-collision — where elements of one mesh are comparable
in size — a uniform grid is the right structure: each element lands in the
cell of its AABB center, and candidate pairs come from the 27-cell
neighborhood, all with static shapes:

  cell keys -> argsort -> per-(element, neighbor-cell) searchsorted -> a
  fixed per-cell capacity of candidate slots, masked.

Cell size is chosen at setup (~the largest rest AABB extent), so a
neighborhood query is exact while capacities hold; both the per-cell
capacity and the downstream pair capacity report overflow rather than
silently dropping contacts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tlfea import struct
from tlfea.collision.broadphase import BroadphaseSetup, _is_neighbor

__all__ = ["GridSetup", "setup_grid", "find_pairs_grid"]

# 27-cell neighborhood offsets, static.
_OFFSETS = np.array(
    [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=np.int32,
)


@struct.dataclass
class GridSetup:
    origin: jnp.ndarray  # (3,)
    inv_h: jnp.ndarray  # scalar 1/cell
    dims: tuple = struct.field(pytree_node=False)  # (Gx, Gy, Gz)
    cell_cap: int = struct.field(pytree_node=False)


def setup_grid(
    nodes: np.ndarray,
    conn: np.ndarray,
    cell_scale: float = 1.1,
    cell_cap: int | None = None,
    slack: float = 0.5,
    margin: float = 0.0,
) -> GridSetup:
    """Host-side grid sizing from the rest configuration.

    cell = cell_scale x (largest element AABB extent + 2 x margin): two
    margin-inflated AABBs that overlap then have centers at most one cell
    apart per axis, so the 27-cell neighborhood is exact. The grid covers
    the rest bounding box inflated by `slack` x its extent (positions
    outside clip to boundary cells, which stays correct — far-out elements
    cluster there and the cell capacity flag fires if they crowd).
    """
    nodes = np.asarray(nodes)
    conn = np.asarray(conn)
    pts = nodes[conn]  # (E, S, 3)
    ext = pts.max(axis=1) - pts.min(axis=1)  # (E, 3)
    h = cell_scale * (float(ext.max()) + 2.0 * margin)
    lo = nodes.min(axis=0)
    hi = nodes.max(axis=0)
    span = hi - lo
    origin = lo - slack * span - h
    dims = np.maximum(np.ceil((span * (1 + 2 * slack) + 2 * h) / h).astype(int), 1)
    if cell_cap is None:
        # Size the per-cell capacity from actual rest occupancy (x2 slack):
        # structured T10 meshes pack 6+ tets per cube, so a fixed small cap
        # overflows immediately.
        centers = 0.5 * (pts.min(axis=1) + pts.max(axis=1))
        cell = np.clip(((centers - origin) / h).astype(int), 0, dims - 1)
        key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        occ = np.bincount(key).max() if key.size else 1
        cell_cap = int(max(8, 2 * occ))
    return GridSetup(
        origin=jnp.asarray(origin),
        inv_h=jnp.asarray(1.0 / h),
        dims=(int(dims[0]), int(dims[1]), int(dims[2])),
        cell_cap=int(cell_cap),
    )


def find_pairs_grid(
    bp: BroadphaseSetup,
    grid: GridSetup,
    x: jnp.ndarray,
    enable_self_collision: bool = True,
):
    """Candidate pairs via the uniform grid.

    Returns (pairs (E*27*cap, 2) int32, valid, overflow). overflow fires
    when any cell holds more than cell_cap elements (some candidates were
    then missed — regrow via `HydroelasticCollision.grow()`).
    """
    pts = x[bp.all_nodes]  # (E, S, 3)
    lo = jnp.min(pts, axis=1) - bp.margin
    hi = jnp.max(pts, axis=1) + bp.margin
    centers = 0.5 * (lo + hi)

    Gx, Gy, Gz = grid.dims
    dims = jnp.asarray([Gx, Gy, Gz], dtype=jnp.int32)
    cell = jnp.clip(
        jnp.floor((centers - grid.origin) * grid.inv_h).astype(jnp.int32),
        0,
        dims - 1,
    )  # (E, 3)

    def linkey(c):
        return (c[..., 0] * Gy + c[..., 1]) * Gz + c[..., 2]

    key = linkey(cell)  # (E,)
    E = key.shape[0]
    order = jnp.argsort(key)
    keys_s = key[order]

    # Per-cell occupancy overflow check.
    left = jnp.searchsorted(keys_s, key, side="left")
    right = jnp.searchsorted(keys_s, key, side="right")
    overflow = jnp.max(right - left) > grid.cell_cap

    # Neighbor-cell candidate slots.
    off = jnp.asarray(_OFFSETS)  # (27, 3)
    ncell = cell[:, None, :] + off[None, :, :]  # (E, 27, 3)
    in_grid = jnp.all((ncell >= 0) & (ncell < dims), axis=-1)  # (E, 27)
    ncell = jnp.clip(ncell, 0, dims - 1)
    nkey = linkey(ncell)  # (E, 27)

    starts = jnp.searchsorted(keys_s, nkey.reshape(-1)).reshape(E, 27)
    C = grid.cell_cap
    slots = starts[..., None] + jnp.arange(C)[None, None, :]  # (E, 27, C)
    slot_ok = slots < E
    slots_c = jnp.minimum(slots, E - 1)
    cand_key_ok = keys_s[slots_c] == nkey[..., None]
    b = order[slots_c]  # (E, 27, C) candidate element ids
    a = jnp.arange(E, dtype=b.dtype)[:, None, None]

    valid = slot_ok & cand_key_ok & in_grid[..., None] & (b > a)

    # AABB overlap.
    box = jnp.all((lo[b] <= hi[:, None, None, :]) & (hi[b] >= lo[:, None, None, :]), axis=-1)
    valid = valid & box

    # Mesh / topological-neighbor filters (reference `isNeighborPair`,
    # HydroelasticBroadphaseFunc.cuh:105-165).
    a_b = jnp.broadcast_to(a, b.shape)
    same_mesh = bp.mesh_ids[a_b] == bp.mesh_ids[b]
    if enable_self_collision:
        neigh = jax.vmap(jax.vmap(jax.vmap(lambda p, q: _is_neighbor(bp, p, q))))(a_b, b)
        valid = valid & jnp.logical_not(same_mesh & neigh)
    else:
        valid = valid & jnp.logical_not(same_mesh)

    pairs = jnp.stack([a_b.reshape(-1), b.reshape(-1)], axis=1).astype(jnp.int32)
    return pairs, valid.reshape(-1), overflow
