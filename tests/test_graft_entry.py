"""Driver-contract tests for __graft_entry__.

The driver invokes `dryrun_multichip(n)` in a FRESH process with no CPU env
vars set (an early version assumed the devices already existed and
failed). The subprocess test reproduces that exact flow.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_dryrun_multichip_driver_style():
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run(
        [sys.executable, "-c", "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    assert "ok" in out.stdout


@pytest.mark.slow
def test_entry_traces():
    """entry() returns a function that traces (abstract eval) on the example
    args — catches signature/shape breakage without a full compile."""
    import jax

    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.eval_shape(fn, *args)
    state = args[1]  # (system, state, f_ext)
    assert out.x.shape == state.x.shape
    assert state.x.shape[0] >= 10_000  # driver asked for a non-toy problem
