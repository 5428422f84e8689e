"""Hydroelastic contact-patch narrowphase (Drake pressure-field convention).

For each candidate tet pair: fit affine pressure fields p(x) = a.x + b from
the 4 corner pressures, intersect the equal-pressure plane with tet A,
Sutherland-Hodgman clip against tet B's 4 halfspaces, compute patch
area/centroid, orient the normal by the Drake g_A > 0, g_B > 0 convention
with flip fallback, and evaluate the equilibrium pressure at the centroid.
(Reference: `lib_src/collision/HydroelasticNarrowphaseFunc.cuh:73-638`.)

Static-shape design: every polygon lives in a fixed (MAX_VERTS, 3) buffer with a
vertex count — plane-tet intersection yields <= 8 points after dedup, and
each halfspace clip is capped at 8 vertices exactly as the reference's
`ClipPolygon` is (`HydroelasticNarrowphase.cuh:22`). All branching is masked
arithmetic; the whole narrowphase is one `vmap` over the (static-capacity)
pair array, so patch counts never induce dynamic shapes (SURVEY hard part #2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tlfea import struct
from tlfea.ops.linalg import solve3x3, det3x3

__all__ = ["ContactPatches", "compute_patches", "MAX_VERTS", "NP_EPS"]

MAX_VERTS = 8
NP_EPS = 1e-10

# Tet edges, as in the reference plane intersection (`...Func.cuh:143`).
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
# Tet faces (i, j, k, opposite) for clipping (`...Func.cuh:308-311`).
_TET_FACES = [(0, 1, 2, 3), (0, 1, 3, 2), (0, 2, 3, 1), (1, 2, 3, 0)]


@struct.dataclass
class ContactPatches:
    """SoA of fixed-capacity contact patches (reference `ContactPatch` POD,
    `HydroelasticNarrowphase.cuh:32-76`)."""

    verts: jnp.ndarray  # (P, MAX_VERTS, 3)
    n_verts: jnp.ndarray  # (P,) int32
    normal: jnp.ndarray  # (P, 3)
    centroid: jnp.ndarray  # (P, 3)
    area: jnp.ndarray  # (P,)
    g_A: jnp.ndarray  # (P,)
    g_B: jnp.ndarray  # (P,)
    p_eq: jnp.ndarray  # (P,)
    tetA: jnp.ndarray  # (P,) int32
    tetB: jnp.ndarray  # (P,) int32
    valid: jnp.ndarray  # (P,) bool
    valid_orientation: jnp.ndarray  # (P,) bool

    @property
    def n_contacts(self):
        return jnp.sum(self.valid & self.valid_orientation)


def _affine_from_tet(v, p):
    """Affine field (a, b) with a.v_i + b = p_i. v: (4,3), p: (4,).

    Returns (a (3,), b, ok). Reference: `affineFromTet` (...Func.cuh:73-109).
    """
    TT = jnp.stack([v[1] - v[0], v[2] - v[0], v[3] - v[0]])  # rows = edges
    det = det3x3(TT)
    ok = jnp.abs(det) > 1e-30
    a = solve3x3(TT, jnp.array([p[1] - p[0], p[2] - p[0], p[3] - p[0]]), eps=1e-30)
    b = p[0] - jnp.dot(a, v[0])
    return a, b, ok


def _order_by_angle(pts, mask, n_ref):
    """Sort masked points CCW around their centroid in the plane with normal
    n_ref; invalid slots go last. pts: (K,3), mask: (K,) -> (K,3), count."""
    cnt = jnp.sum(mask)
    safe_cnt = jnp.maximum(cnt, 1)
    centroid = jnp.sum(jnp.where(mask[:, None], pts, 0.0), axis=0) / safe_cnt

    n_hat = n_ref / jnp.maximum(jnp.linalg.norm(n_ref), NP_EPS)

    # First valid in-plane direction; fall back to x then y axes
    # (reference: `...Func.cuh:188-203`).
    first_idx = jnp.argmax(mask)
    v0 = pts[first_idx] - centroid
    v0 = v0 - jnp.dot(v0, n_hat) * n_hat

    def fallback(vec):
        cand = vec - jnp.dot(vec, n_hat) * n_hat
        return cand

    x_cand = fallback(jnp.array([1.0, 0.0, 0.0], dtype=pts.dtype))
    y_cand = fallback(jnp.array([0.0, 1.0, 0.0], dtype=pts.dtype))
    v0 = jnp.where(jnp.linalg.norm(v0) < NP_EPS, x_cand, v0)
    v0 = jnp.where(jnp.linalg.norm(v0) < NP_EPS, y_cand, v0)
    u = v0 / jnp.maximum(jnp.linalg.norm(v0), NP_EPS)
    w = jnp.cross(n_hat, u)

    rel = pts - centroid
    ang = jnp.arctan2(rel @ w, rel @ u)
    ang = jnp.where(mask, ang, jnp.inf)
    order = jnp.argsort(ang)
    return pts[order], cnt


def _plane_tet_intersection(v, n, c):
    """Plane {n.x + c = 0} ∩ tet -> ordered polygon (MAX_VERTS, 3), count.

    Reference: `planeTetIntersection` (...Func.cuh:111-251).
    """
    dtype = v.dtype
    g = v @ n + c  # (4,)
    any_cross = jnp.logical_not(
        jnp.logical_or(jnp.max(g) < -NP_EPS, jnp.min(g) > NP_EPS)
    )

    # 4 on-plane vertices + 6 edge crossings = 10 candidate slots.
    on_plane = jnp.abs(g) <= NP_EPS  # (4,)
    pts_v = v  # (4, 3)

    ei = jnp.array([e[0] for e in _TET_EDGES])
    ej = jnp.array([e[1] for e in _TET_EDGES])
    gi, gj = g[ei], g[ej]
    crossing = gi * gj < -NP_EPS * NP_EPS
    t = gi / jnp.where(gi - gj == 0, 1.0, gi - gj)
    pts_e = (1.0 - t)[:, None] * v[ei] + t[:, None] * v[ej]  # (6, 3)

    pts = jnp.concatenate([pts_v, pts_e], axis=0)  # (10, 3)
    mask = jnp.concatenate([on_plane, crossing], axis=0)  # (10,)

    # O(K^2) dedup: drop a point if an earlier kept point is within tol.
    d2 = jnp.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    tol2 = (NP_EPS * 10) ** 2

    def dedup_body(i, keep):
        earlier = (jnp.arange(10) < i) & keep
        dup = jnp.any(earlier & (d2[i] < tol2))
        return keep.at[i].set(keep[i] & jnp.logical_not(dup))

    mask = jax.lax.fori_loop(0, 10, dedup_body, mask)

    ordered, cnt = _order_by_angle(pts, mask, n)
    cnt = jnp.where(any_cross, cnt, 0)
    cnt = jnp.where(cnt >= 3, jnp.minimum(cnt, MAX_VERTS), 0)
    out = jnp.where(
        (jnp.arange(10) < cnt)[:, None], ordered, jnp.zeros((), dtype)
    )[:MAX_VERTS]
    return out, cnt.astype(jnp.int32)


def _clip_halfspace(verts, m, n, p0):
    """Sutherland-Hodgman clip vs halfspace {n.(x-p0) <= 0}, capped at
    MAX_VERTS. verts: (MAX_VERTS, 3), m: count. Reference: ...Func.cuh:304-425.
    """
    K = MAX_VERTS
    idx = jnp.arange(K)
    active = idx < m
    nxt = jnp.where(idx + 1 >= m, 0, idx + 1)
    A = verts
    B = verts[nxt]
    sA = (A - p0) @ n
    sB = (B - p0) @ n
    inA = sA <= NP_EPS
    inB = sB <= NP_EPS

    t = sA / jnp.where(sA - sB == 0, 1.0, sA - sB)
    X = (1.0 - t)[:, None] * A + t[:, None] * B

    # Per-edge emissions: first slot, second slot.
    emit1 = active & (inA | inB)  # any case except both-outside emits >= 1
    first = jnp.where((inA & inB)[:, None], B, X)  # in-in -> B; else X
    emit2 = active & (~inA) & inB  # out-in -> also emit B
    second = B

    c1 = emit1.astype(jnp.int32)
    c2 = emit2.astype(jnp.int32)
    total_before = jnp.cumsum(c1 + c2) - (c1 + c2)  # exclusive prefix
    pos1 = total_before
    pos2 = total_before + c1

    out = jnp.zeros_like(verts)
    out = out.at[jnp.where(emit1, pos1, K)].set(first, mode="drop")
    out = out.at[jnp.where(emit2, pos2, K)].set(second, mode="drop")
    m_out = jnp.minimum(jnp.sum(c1 + c2), K)
    return out, m_out


def _clip_with_tet(verts, m, tet, n_ref):
    """Clip polygon against the 4 faces of a tet, then reorder by angle.

    Reference: `clipPolygonWithTet` (...Func.cuh:304-425).
    """
    for (i, j, k, o) in _TET_FACES:
        p0 = tet[i]
        n_raw = jnp.cross(tet[j] - tet[i], tet[k] - tet[i])
        flip = jnp.dot(n_raw, tet[o] - p0) > 0
        n_face = jnp.where(flip, -n_raw, n_raw)
        verts, m = _clip_halfspace(verts, m, n_face, p0)

    mask = jnp.arange(MAX_VERTS) < m
    ordered, cnt = _order_by_angle(verts, mask, n_ref)
    return ordered, jnp.minimum(cnt, MAX_VERTS).astype(jnp.int32)


def _polygon_area_centroid(verts, m):
    """Fan triangulation area + area-weighted centroid
    (reference: `computePolygonAreaAndCentroid`, ...Func.cuh:427-466)."""
    K = MAX_VERTS
    i = jnp.arange(1, K - 1)
    tri_ok = (i + 1) < m
    v0 = verts[0]
    v1 = verts[1 : K - 1]
    v2 = verts[2:K]
    cr = jnp.cross(v1 - v0, v2 - v0)
    tri_area = 0.5 * jnp.linalg.norm(cr, axis=-1) * tri_ok
    tri_cent = (v0 + v1 + v2) / 3.0
    area = jnp.sum(tri_area)
    centroid = jnp.where(
        area > NP_EPS,
        jnp.sum(tri_area[:, None] * tri_cent, axis=0) / jnp.maximum(area, NP_EPS),
        jnp.sum(jnp.where((jnp.arange(K) < m)[:, None], verts, 0.0), axis=0)
        / jnp.maximum(m, 1),
    )
    return area, centroid


def _patch_one(vA, pA, vB, pB):
    """Full narrowphase for one candidate pair. Returns patch fields."""
    dtype = vA.dtype
    aA, bA, okA = _affine_from_tet(vA, pA)
    aB, bB, okB = _affine_from_tet(vB, pB)

    n = aA - aB
    c = bA - bB
    n_norm = jnp.linalg.norm(n)
    ok = okA & okB & (n_norm >= NP_EPS)

    poly, cntA = _plane_tet_intersection(vA, n, c)
    poly, cnt = _clip_with_tet(poly, cntA, vB, n)
    area, centroid = _polygon_area_centroid(poly, cnt)

    valid = ok & (cntA >= 3) & (cnt >= 3) & (area >= NP_EPS * NP_EPS)

    nhat0 = n / jnp.maximum(n_norm, NP_EPS)
    g_A0 = -jnp.dot(aA, nhat0)
    g_B0 = jnp.dot(aB, nhat0)
    need_flip = (g_A0 <= 0) | (g_B0 <= 0)
    nhat1 = -nhat0
    g_A1, g_B1 = -g_A0, -g_B0
    flip_ok = (g_A1 > 0) & (g_B1 > 0)
    valid_orientation = (~need_flip) | flip_ok
    use_flipped = need_flip & flip_ok
    nhat = jnp.where(use_flipped, nhat1, nhat0)
    g_A = jnp.where(use_flipped, g_A1, g_A0)
    g_B = jnp.where(use_flipped, g_B1, g_B0)

    p_eq = jnp.dot(aA, centroid) + bA
    return dict(
        verts=poly.astype(dtype),
        n_verts=cnt,
        normal=nhat,
        centroid=centroid,
        area=area,
        g_A=g_A,
        g_B=g_B,
        p_eq=p_eq,
        valid=valid,
        valid_orientation=valid_orientation,
    )


def compute_patches(
    x: jnp.ndarray,
    pressures: jnp.ndarray,
    corners: jnp.ndarray,
    pairs: jnp.ndarray,
    pair_valid: jnp.ndarray,
    mesh_ids: jnp.ndarray,
    enable_self_collision: bool = False,
) -> ContactPatches:
    """Narrowphase over a static-capacity pair array.

    x: (n_nodes, 3); pressures: (n_nodes,); corners: (E, 4) tet corner node
    ids; pairs: (P, 2) element ids; pair_valid: (P,); mesh_ids: (E,).
    """
    tetA = pairs[:, 0]
    tetB = pairs[:, 1]
    # Normal convention: from lower mesh id to higher (reference kernel swap).
    swap = mesh_ids[tetA] > mesh_ids[tetB]
    tetA, tetB = jnp.where(swap, tetB, tetA), jnp.where(swap, tetA, tetB)
    if not enable_self_collision:
        pair_valid = pair_valid & (mesh_ids[tetA] != mesh_ids[tetB])

    vA = x[corners[tetA]]  # (P, 4, 3)
    vB = x[corners[tetB]]
    pA = pressures[corners[tetA]]  # (P, 4)
    pB = pressures[corners[tetB]]

    fields = jax.vmap(_patch_one)(vA, pA, vB, pB)
    valid = fields["valid"] & pair_valid
    return ContactPatches(
        verts=fields["verts"],
        n_verts=fields["n_verts"],
        normal=fields["normal"],
        centroid=fields["centroid"],
        area=fields["area"],
        g_A=fields["g_A"],
        g_B=fields["g_B"],
        p_eq=fields["p_eq"],
        tetA=tetA.astype(jnp.int32),
        tetB=tetB.astype(jnp.int32),
        valid=valid,
        valid_orientation=fields["valid_orientation"],
    )
