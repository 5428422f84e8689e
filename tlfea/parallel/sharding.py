"""SPMD scaling over a `jax.sharding.Mesh`.

The reference is strictly single-GPU (SURVEY §2.10): its only parallelism is
thread-level. Here the element axis scales across devices: each device owns
a contiguous slab of elements (and their per-QP data); coefficient arrays
(x, v, f) stay replicated. The only cross-device communication FEA needs is
the reduction of per-element force/mass contributions at shared coefficients,
which XLA's SPMD partitioner emits automatically as an all-reduce from
the scatter-add in `coef_scatter_add` — no hand-written collectives.

For meshes large enough that replicated coefficient arrays dominate HBM,
switch to `partition_elements` + node-sharded states (future work; the
element-slab partitioner here already minimizes the replicated traffic by
keeping element order mesh-local).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tlfea.elements.assembly import ElementBatch

__all__ = ["make_elem_mesh", "shard_system", "replicate"]

ELEM_AXIS = "elem"


def make_elem_mesh(devices=None) -> Mesh:
    """1-D device mesh over the element axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (ELEM_AXIS,))


def _pad_elems(elems: ElementBatch, multiple: int) -> ElementBatch:
    """Pad the element axis to a multiple of the mesh size.

    Padding elements reference coefficient 0 with zero dV / zero mass, so
    they contribute exactly nothing to any assembled quantity.
    """
    E = elems.conn.shape[0]
    rem = (-E) % multiple
    if rem == 0:
        return elems
    def pad(a, value=0):
        widths = [(0, rem)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, widths, constant_values=value)

    return ElementBatch(
        conn=pad(elems.conn),
        grad_N=pad(elems.grad_N),
        dV=pad(elems.dV),
        mass_elem=pad(elems.mass_elem),
        xe_ref=pad(elems.xe_ref),
        n_coef=elems.n_coef,
        x_ref=elems.x_ref,  # node-space: untouched by element padding
        trans_mask=elems.trans_mask,
    )


def shard_system(system, mesh: Mesh):
    """Place a System's element arrays sharded over the mesh's elem axis.

    Element-indexed arrays get PartitionSpec(ELEM_AXIS, ...); everything else
    (material scalars, constraint arrays) is replicated. Returns a new System
    whose leaves carry shardings, ready to be closed over by a jitted step.
    """
    elems = _pad_elems(system.elems, mesh.devices.size)
    esh = NamedSharding(mesh, P(ELEM_AXIS))
    rep = NamedSharding(mesh, P())

    sharded_elems = ElementBatch(
        conn=jax.device_put(elems.conn, esh),
        grad_N=jax.device_put(elems.grad_N, esh),
        dV=jax.device_put(elems.dV, esh),
        mass_elem=jax.device_put(elems.mass_elem, esh),
        xe_ref=jax.device_put(elems.xe_ref, esh),
        n_coef=elems.n_coef,
        x_ref=(
            None if elems.x_ref is None
            else jax.device_put(elems.x_ref, rep)  # node arrays replicate
        ),
        trans_mask=elems.trans_mask,
    )

    def put_rep(leaf):
        if isinstance(leaf, (jnp.ndarray, np.ndarray)) or hasattr(leaf, "shape"):
            return jax.device_put(jnp.asarray(leaf), rep)
        return leaf

    material = jax.tree_util.tree_map(put_rep, system.material)
    constraints = (
        jax.tree_util.tree_map(put_rep, system.constraints)
        if system.constraints is not None
        else None
    )
    # .replace preserves the static fields (fused_grad, accum_dtype).
    return system.replace(elems=sharded_elems, material=material, constraints=constraints)


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (state, forces) across all devices of the mesh."""
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: jax.device_put(jnp.asarray(a), rep), tree)
