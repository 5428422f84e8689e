"""Native on-device DEM contact backends (sphere contacts, DEM-Engine style).

The reference co-simulates with projectchrono's DEM-Engine
(`lib_src/collision/DemeMeshCollisionSystem.cu:334-620`): meshes are
registered with the external CUDA DEM solver, `DoDynamics(dt)` advances it,
and returned contact forces are spread onto mesh nodes. DEM-Engine cannot
run here, and a host co-sim loop would add a host round trip per step —
so this module implements the same *capability* natively, fully on device:

- `NodeSphereDem` — mesh-vs-mesh contact via per-surface-node spheres
  (classic node-based DEM): every surface vertex carries a sphere whose
  radius is derived from the local surface edge length; spheres of
  different meshes interact by spring-dashpot normal force + regularized
  Coulomb friction (the same contact law DEM-Engine applies,
  `DemeMeshCollisionSystem.cu:105-137` material knobs). Forces act directly
  on the owning node, so mesh attribution and Newton's third law are exact
  (round-1 advisor finding: the generic bridge spread every contact onto
  every mesh).

- `GranularDem` — a free sphere cloud (granular material) advanced by
  symplectic-Euler substeps inside one jit (`lax.fori_loop` replaces
  `DoDynamics`), contacting the deformable surface triangles
  (closest-point-on-triangle, barycentric force spreading) and each other.
  The mesh is position-prescribed during substeps, matching the reference's
  fully-prescribed DEME families (`DemeMeshCollisionSystem.cu:497-502`).

Both implement the `CollisionSystem` step contract:
`step(x, v, params) -> (f_ext (n,3), info, overflow)`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tlfea import struct

__all__ = ["DemParams", "dem_params_from_material", "NodeSphereDem",
           "SphereCloud", "GranularDem", "node_sphere_radii"]


@struct.dataclass
class DemParams:
    """Contact-law parameters (reference env knobs DEME_CONTACT_E/NU/COR,
    `DemeMeshCollisionSystem.cu:358-366`, mapped to an explicit
    spring-dashpot). Raw kn/cn/mu are the low-level knobs; derive them from
    material properties with `dem_params_from_material` (the
    parameter-comparable path to the reference's DEME runs)."""

    kn: jnp.ndarray = 1e6  # normal stiffness [N/m]
    cn: jnp.ndarray = 1e2  # normal damping [N s/m]
    mu: jnp.ndarray = 0.4  # Coulomb friction coefficient
    v_reg: jnp.ndarray = 1e-3  # friction regularization velocity [m/s]


def dem_params_from_material(E, nu, cor, radius, mass, mu=0.4,
                             overlap_frac=1e-2, v_reg=1e-3) -> DemParams:
    """Physical contact parameterization: (E, nu, CoR) -> (kn, cn), the
    same material knobs the reference forwards to DEM-Engine
    (`DemeMeshCollisionSystem.cu:358-366`, env DEME_CONTACT_E/NU/COR; DEME
    applies Hertz-Mindlin internally). Host-side, called once at setup.

    Mapping (standard linear-spring equivalent of Hertzian contact between
    like spheres):
      E*  = E / (2 (1 - nu^2))          (effective contact modulus)
      R*  = radius / 2                  (effective radius, equal spheres)
      kn  = (4/3) E* sqrt(R* d0),  d0 = overlap_frac * R*
            (Hertz stiffness dF/dd linearized at characteristic overlap d0)
      m*  = mass / 2                    (effective mass, equal spheres)
      cn  = 2 beta sqrt(kn m*),  beta = -ln(e) / sqrt(ln(e)^2 + pi^2)
            (exact linear spring-dashpot restitution inversion: a normal
            impact then exits with |v_out/v_in| = e; e = 1 -> cn = 0,
            e -> 0 -> cn -> critical damping 2 sqrt(kn m*))

    radius/mass: characteristic contact-sphere radius [m] and mass [kg]
    (e.g. median of `node_sphere_radii` and the node lumped mass, or the
    `SphereCloud` particle values for `GranularDem`).
    """
    E, nu, cor = float(E), float(nu), float(cor)
    radius, mass = float(radius), float(mass)
    if not (0.0 <= cor <= 1.0):
        raise ValueError(f"restitution must be in [0, 1], got {cor}")
    e_star = E / (2.0 * (1.0 - nu * nu))
    r_star = 0.5 * radius
    d0 = overlap_frac * r_star
    kn = (4.0 / 3.0) * e_star * np.sqrt(r_star * d0)
    m_star = 0.5 * mass
    if cor <= 0.0:
        beta = 1.0  # ln(0) limit: critical damping
    else:
        ln_e = np.log(cor)
        beta = -ln_e / np.sqrt(ln_e * ln_e + np.pi * np.pi)
    cn = 2.0 * beta * np.sqrt(kn * m_star)
    return DemParams(kn=kn, cn=cn, mu=mu, v_reg=v_reg)


def _contact_force(n_hat, delta, v_rel, kn, cn, mu, v_reg):
    """Spring-dashpot + regularized Coulomb force ON body A (n_hat points
    from B to A). delta > 0 means penetration. Shapes broadcast; returns
    force with n_hat's shape."""
    vn = jnp.sum(v_rel * n_hat, axis=-1, keepdims=True)  # approach < 0
    fn_mag = kn * delta - cn * vn[..., 0]
    fn_mag = jnp.where(delta > 0, jnp.maximum(fn_mag, 0.0), 0.0)
    f_n = fn_mag[..., None] * n_hat
    v_t = v_rel - vn * n_hat
    vt_mag = jnp.linalg.norm(v_t, axis=-1, keepdims=True)
    f_t = -(mu * fn_mag)[..., None] * v_t / (vt_mag + v_reg)
    return f_n + f_t


def node_sphere_radii(nodes: np.ndarray, tris: np.ndarray, scale: float = 0.5) -> np.ndarray:
    """Per-surface-node contact radius: `scale` x the shortest incident
    surface edge (host-side, NumPy). nodes: (n,3) global; tris: (T,3) global
    node ids. Returns (n,) with zeros for non-surface nodes."""
    r = np.full(nodes.shape[0], np.inf)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        e = np.linalg.norm(nodes[tris[:, a]] - nodes[tris[:, b]], axis=1)
        np.minimum.at(r, tris[:, a], e)
        np.minimum.at(r, tris[:, b], e)
    r[~np.isfinite(r)] = 0.0
    return scale * r


class NodeSphereDem:
    """Mesh-vs-mesh DEM contact through per-surface-node spheres.

    surface_tris_per_mesh: list of (T_i, 3) GLOBAL node-id triangle arrays,
    one per mesh instance (e.g. from MeshManager.surface_triangles).
    Contact is evaluated between every pair of distinct meshes as a dense
    cross product of their surface nodes (masked, static shapes — the
    static-shape answer to DEM broadphase at these scales).

    Like all sphere-decomposition contact, forces engage at "skin" distance
    (the sphere radii, ~half the local surface edge length): choose kn stiff
    enough that surfaces never actually cross, or the per-sphere normals
    become ambiguous. This matches DEM-Engine's clumped-sphere behavior.
    """

    def __init__(self, nodes: np.ndarray, surface_tris_per_mesh, radius_scale: float = 0.5):
        nodes = np.asarray(nodes)
        surf_ids = []
        for tris in surface_tris_per_mesh:
            surf_ids.append(np.unique(np.asarray(tris).reshape(-1)))
        all_tris = np.concatenate([np.asarray(t) for t in surface_tris_per_mesh], axis=0)
        radii = node_sphere_radii(nodes, all_tris, scale=radius_scale)

        # Mesh-pair cross lists (host, once).
        pairs_a, pairs_b = [], []
        for i in range(len(surf_ids)):
            for j in range(i + 1, len(surf_ids)):
                pairs_a.append((surf_ids[i], surf_ids[j]))
        self._pairs = [
            (jnp.asarray(a.astype(np.int32)), jnp.asarray(b.astype(np.int32)))
            for a, b in pairs_a
        ]
        self._radii = jnp.asarray(radii)
        self._n = nodes.shape[0]
        self.n_spheres = int(sum(len(s) for s in surf_ids))

        radii_dev = self._radii
        pairs = self._pairs
        n = self._n

        @jax.jit
        def _step(x, v, params: DemParams):
            f = jnp.zeros_like(x)
            n_active = jnp.zeros((), jnp.int32)
            for ia, ib in pairs:
                xa, xb = x[ia], x[ib]  # (A,3), (B,3)
                va, vb = v[ia], v[ib]
                ra, rb = radii_dev[ia], radii_dev[ib]
                d = xa[:, None, :] - xb[None, :, :]  # (A,B,3) from B to A
                dist = jnp.linalg.norm(d, axis=-1)
                delta = (ra[:, None] + rb[None, :]) - dist
                n_hat = d / (dist[..., None] + 1e-30)
                v_rel = va[:, None, :] - vb[None, :, :]
                fab = _contact_force(
                    n_hat, delta, v_rel, params.kn, params.cn, params.mu, params.v_reg
                )  # force on A spheres
                f = f.at[ia].add(jnp.sum(fab, axis=1))
                f = f.at[ib].add(-jnp.sum(fab, axis=0))
                n_active = n_active + jnp.sum((delta > 0).astype(jnp.int32))
            return f, n_active

        self._step_fn = _step

    def step(self, x, v=None, params: DemParams | None = None):
        from types import SimpleNamespace

        if params is None or not isinstance(params, DemParams):
            params = DemParams()
        if v is None:
            v = jnp.zeros_like(x)
        f, n_active = self._step_fn(jnp.asarray(x), jnp.asarray(v), params)
        return f, SimpleNamespace(n_contacts=n_active), jnp.asarray(False)


@struct.dataclass
class SphereCloud:
    """Free granular spheres (a pytree; host-held between steps)."""

    x: jnp.ndarray  # (P, 3)
    v: jnp.ndarray  # (P, 3)
    r: jnp.ndarray  # (P,)
    m: jnp.ndarray  # (P,)

    @staticmethod
    def grid(center, extent, spacing, radius, density=2500.0, dtype=np.float64):
        """Regular block of spheres centered at `center`."""
        c = np.asarray(center, dtype=float)
        e = np.asarray(extent, dtype=float)
        counts = np.maximum(1, np.round(e / spacing).astype(int))
        axes = [
            (np.arange(k) - (k - 1) / 2.0) * spacing + cc
            for k, cc in zip(counts, c)
        ]
        g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
        P = g.shape[0]
        m = density * 4.0 / 3.0 * np.pi * radius**3
        return SphereCloud(
            x=jnp.asarray(g.astype(dtype)),
            v=jnp.zeros((P, 3), dtype),
            r=jnp.full((P,), radius, dtype),
            m=jnp.full((P,), m, dtype),
        )


def _closest_point_tri(p, a, b, c):
    """Closest point on triangle (a,b,c) to p; all (..., 3). Returns
    (point, bary (...,3)). Ericson's real-time collision detection
    formulation, fully branchless for vmap."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = jnp.sum(ab * ap, axis=-1)
    d2 = jnp.sum(ac * ap, axis=-1)
    bp = p - b
    d3 = jnp.sum(ab * bp, axis=-1)
    d4 = jnp.sum(ac * bp, axis=-1)
    cp = p - c
    d5 = jnp.sum(ab * cp, axis=-1)
    d6 = jnp.sum(ac * cp, axis=-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    v = vb / jnp.where(denom != 0, denom, 1.0)
    w = vc / jnp.where(denom != 0, denom, 1.0)

    # Edge/vertex regions, selected in priority order (vertex first).
    eps = 0.0
    # interior
    u_i, v_i, w_i = 1.0 - v - w, v, w

    # edge AB: t = d1/(d1-d3)
    t_ab = d1 / jnp.where(d1 - d3 != 0, d1 - d3, 1.0)
    t_ab = jnp.clip(t_ab, 0.0, 1.0)
    # edge AC
    t_ac = d2 / jnp.where(d2 - d6 != 0, d2 - d6, 1.0)
    t_ac = jnp.clip(t_ac, 0.0, 1.0)
    # edge BC
    t_bc = (d4 - d3) / jnp.where((d4 - d3) + (d5 - d6) != 0, (d4 - d3) + (d5 - d6), 1.0)
    t_bc = jnp.clip(t_bc, 0.0, 1.0)

    in_a = (d1 <= eps) & (d2 <= eps)
    in_b = (d3 >= -eps) & (d4 <= d3)
    in_c = (d6 >= -eps) & (d5 <= d6)
    on_ab = (~in_a) & (~in_b) & (~in_c) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (~in_a) & (~in_b) & (~in_c) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (~in_a) & (~in_b) & (~in_c) & (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    u = jnp.where(in_a, 1.0, jnp.where(in_b, 0.0, jnp.where(in_c, 0.0,
        jnp.where(on_ab, 1.0 - t_ab, jnp.where(on_ac, 1.0 - t_ac,
        jnp.where(on_bc, 0.0, u_i))))))
    vv = jnp.where(in_a, 0.0, jnp.where(in_b, 1.0, jnp.where(in_c, 0.0,
        jnp.where(on_ab, t_ab, jnp.where(on_ac, 0.0,
        jnp.where(on_bc, 1.0 - t_bc, v_i))))))
    ww = 1.0 - u - vv
    bary = jnp.stack([u, vv, ww], axis=-1)
    point = (
        u[..., None] * a + vv[..., None] * b + ww[..., None] * c
    )
    return point, bary


class GranularDem:
    """Free sphere cloud contacting the deformable FEA surface.

    The whole multi-substep advance (`DoDynamics` analogue) is ONE jitted
    `lax.fori_loop`; the mesh is position-prescribed within it. Returns the
    time-averaged reaction force on mesh nodes (impulse-consistent with the
    FEA step) and the advanced cloud.
    """

    def __init__(self, tris: np.ndarray, n_sub: int = 8, gravity=(0.0, 0.0, -9.81)):
        self.tris = jnp.asarray(np.asarray(tris, dtype=np.int32))  # (T,3) global ids
        self.n_sub = int(n_sub)
        self.gravity = tuple(float(g) for g in gravity)
        self.cloud: SphereCloud | None = None
        tris_dev = self.tris
        n_sub_ = self.n_sub
        grav = jnp.asarray(self.gravity)

        @jax.jit
        def _advance(cloud: SphereCloud, x_mesh, v_mesh, dt, params: DemParams):
            h = dt / n_sub_
            a_tri = x_mesh[tris_dev[:, 0]]
            b_tri = x_mesh[tris_dev[:, 1]]
            c_tri = x_mesh[tris_dev[:, 2]]
            va_t = v_mesh[tris_dev[:, 0]]
            vb_t = v_mesh[tris_dev[:, 1]]
            vc_t = v_mesh[tris_dev[:, 2]]
            g = grav.astype(cloud.x.dtype)

            def substep(_, carry):
                xs, vs, f_mesh_acc = carry
                # --- sphere-triangle contacts (P, T)
                cp, bary = _closest_point_tri(
                    xs[:, None, :], a_tri[None], b_tri[None], c_tri[None]
                )  # (P,T,3), (P,T,3)
                d = xs[:, None, :] - cp
                dist = jnp.linalg.norm(d, axis=-1)
                delta = cloud.r[:, None] - dist
                n_hat = d / (dist[..., None] + 1e-30)
                v_surf = (
                    bary[..., 0:1] * va_t[None]
                    + bary[..., 1:2] * vb_t[None]
                    + bary[..., 2:3] * vc_t[None]
                )
                v_rel = vs[:, None, :] - v_surf
                f_pt = _contact_force(
                    n_hat, delta, v_rel, params.kn, params.cn, params.mu, params.v_reg
                )  # (P,T,3) on spheres
                f_s = jnp.sum(f_pt, axis=1)  # (P,3)
                # reaction onto triangle nodes by barycentric weights
                w_r = -f_pt[..., None, :] * bary[..., :, None]  # (P,T,3nodes,3)
                f_mesh = jnp.zeros_like(x_mesh)
                f_mesh = f_mesh.at[tris_dev.reshape(-1)].add(
                    jnp.sum(w_r, axis=0).reshape(-1, 3)
                )

                # --- sphere-sphere contacts (P, P)
                dss = xs[:, None, :] - xs[None, :, :]
                dist_ss = jnp.linalg.norm(dss, axis=-1)
                delta_ss = (cloud.r[:, None] + cloud.r[None, :]) - dist_ss
                # mask self
                P = xs.shape[0]
                delta_ss = jnp.where(jnp.eye(P, dtype=bool), -1.0, delta_ss)
                n_ss = dss / (dist_ss[..., None] + 1e-30)
                v_ss = vs[:, None, :] - vs[None, :, :]
                f_ss = _contact_force(
                    n_ss, delta_ss, v_ss, params.kn, params.cn, params.mu, params.v_reg
                )
                f_s = f_s + jnp.sum(f_ss, axis=1)

                # --- integrate (symplectic Euler)
                vs = vs + h * (f_s / cloud.m[:, None] + g[None, :])
                xs = xs + h * vs
                return xs, vs, f_mesh_acc + f_mesh

            xs, vs, f_acc = jax.lax.fori_loop(
                0, n_sub_, substep, (cloud.x, cloud.v, jnp.zeros_like(x_mesh))
            )
            new_cloud = SphereCloud(x=xs, v=vs, r=cloud.r, m=cloud.m)
            return new_cloud, f_acc / n_sub_  # time-averaged force

        self._advance = _advance

    def bind_cloud(self, cloud: SphereCloud) -> None:
        self.cloud = cloud

    def step(self, x, v=None, params: DemParams | None = None, dt=1e-3):
        assert self.cloud is not None, "bind_cloud() first"
        if params is None or not isinstance(params, DemParams):
            params = DemParams()
        if v is None:
            v = jnp.zeros_like(x)
        self.cloud, f_mesh = self._advance(
            self.cloud, jnp.asarray(x), jnp.asarray(v), jnp.asarray(dt), params
        )
        return f_mesh, {"cloud": self.cloud}, jnp.asarray(False)
