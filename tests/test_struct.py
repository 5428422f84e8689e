"""tlfea.struct: frozen pytree dataclasses with static fields."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from tlfea import struct


@struct.dataclass
class _Thing:
    a: jnp.ndarray
    b: jnp.ndarray = 0.0
    n: int = struct.field(pytree_node=False, default=3)


def test_replace_returns_a_new_frozen_instance():
    t = _Thing(a=jnp.ones(2))
    t2 = t.replace(b=jnp.asarray(5.0), n=4)
    assert (t.b, t.n) == (0.0, 3)
    assert float(t2.b) == 5.0 and t2.n == 4
    with pytest.raises(AttributeError):
        t.n = 7


def test_static_field_is_not_a_leaf():
    t = _Thing(a=jnp.ones(2), b=jnp.zeros(3), n=9)
    leaves, treedef = jax.tree_util.tree_flatten(t)
    assert len(leaves) == 2 and all(leaf.shape in ((2,), (3,)) for leaf in leaves)
    assert jax.tree_util.tree_unflatten(treedef, leaves).n == 9
    # Static values are part of the structure (and of every jit cache key).
    assert treedef != jax.tree_util.tree_structure(t.replace(n=10))


def test_data_change_does_not_retrace():
    f = jax.jit(lambda t: t.a * t.b + t.n)
    one = jnp.ones(2)
    f(_Thing(a=one, b=one[0]))
    out = f(_Thing(a=2 * one, b=3 * one[0]))
    assert f._cache_size() == 1
    assert out.tolist() == [9.0, 9.0]


def test_import_tlfea_needs_no_flax():
    code = ("import sys; sys.modules['flax'] = None\n"
            "import tlfea, tlfea.simulation, tlfea.collision.hydroelastic\n"
            "import tlfea.collision.dem, tlfea.solvers.coarse\n"
            "assert 'flax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"JAX_PLATFORMS": "cpu", "PATH": ""})
    assert out.returncode == 0, out.stderr
