"""Gather/scatter between element-local and global coefficient arrays.

The reference scatters per-element force contributions with `atomicAdd`
(`lib_src/elements/FEAT10DataFunc.cuh:397-458`), accepting floating-point
nondeterminism. Here they are XLA scatter-adds (`.at[].add`). On the CPU
backend these are deterministic; on the GPU XLA accumulates float
scatter-adds with atomics too, so sums may differ in the last bits from run
to run (docs/ARCHITECTURE.md §6).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["gather_coefs", "coef_scatter_add"]


def gather_coefs(x: jnp.ndarray, conn: jnp.ndarray) -> jnp.ndarray:
    """Gather per-element coefficient vectors.

    x: (n_coef, 3) global coefficient (node/ANCF-coefficient) positions.
    conn: (E, S) int32 element connectivity into the coefficient axis.
    -> (E, S, 3)
    """
    return x[conn]


def coef_scatter_add(values: jnp.ndarray, conn: jnp.ndarray, n_coef: int) -> jnp.ndarray:
    """Scatter-add per-element contributions back to the global array.

    values: (E, S, 3); conn: (E, S) -> (n_coef, 3).
    """
    out = jnp.zeros((n_coef, values.shape[-1]), dtype=values.dtype)
    return out.at[conn.reshape(-1)].add(values.reshape(-1, values.shape[-1]))
