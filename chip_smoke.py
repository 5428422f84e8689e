"""Smoke run of tlfea's main path on a GPU: every phase at its real size.

    python chip_smoke.py               # one card: all single-card phases
    python chip_smoke.py --devices 4   # four cards: the sharded step only

Phases (one card): device, the 10k-element T10 beam rollout (run twice to
check that the two final states are bit-identical), the XLA Hessian-vector
product per CG iteration at 10k and 100k elements, the 100k-element rollout
with its compiled memory analysis, the ANCF3443 shell, the sphere-drop
contact rollout, and accuracy (the `gpu`-marked tests, run in this process,
and the 10k beam in float32 against float64 on the card).

With --devices 4 only the element-sharded GSPMD step (tlfea.parallel.sharding)
runs, over four cards, and is compared with the same step on one card.

Everything runs in this one process: a JAX process reserves most of a card's
memory when it first uses it, so a second one would fail. On a host whose
JAX finds no GPU the script exits non-zero. A failed phase makes it exit
non-zero; only a run in which every phase passed prints the final line,
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

ONE_CARD_PHASES = ("device", "rollout_10k", "hv_per_cg", "rollout_100k",
                   "shell", "sphere_drop", "accuracy")
FOUR_CARD_PHASES = ("device", "sharded_step")

# Steps timed in the 10k rollout (bench.py's ROLLOUT for that scale).
ROLLOUT_10K = 60
# Hessian-vector products timed per scale in the Hv loop.
HV_ITERS = 50
# f32 vs f64 bar on the 10k beam, as a fraction of the displacement scale:
# the bar bench-configuration f32 runs are held to against each other.
F32_VS_F64_TOL = 5e-3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="1: the single-card phases; 4: only the sharded "
                         "step over four cards")
    return ap.parse_args(argv)


def phases_for(n_devices: int) -> tuple:
    return FOUR_CARD_PHASES if n_devices == 4 else ONE_CARD_PHASES


def check_devices(devices, n_devices: int) -> None:
    """Refuse to run anywhere but on `n_devices` GPUs."""
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX's default backend is {platform!r}")
    if len(devices) < n_devices:
        raise SystemExit(f"chip_smoke.py --devices {n_devices}: JAX sees {len(devices)} GPU(s)")


def result_line(devices, n_devices: int) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": n_devices}})


def say(phase: str, msg) -> None:
    print(f"[{phase}] {msg}", flush=True)


def peak_bytes(device) -> int:
    """The device's peak_bytes_in_use (-1 where the backend keeps no stats)."""
    return int((device.memory_stats() or {}).get("peak_bytes_in_use", -1))


def _steps_summary(nit, cgit, max_inner):
    import numpy as np

    nit, cgit = np.asarray(nit), np.asarray(cgit)
    return {"newton_per_step": float(np.median(nit)),
            "cg_per_step": float(np.median(cgit)),
            "newton_capped_frac": float((nit >= max_inner).mean())}


# -- phases -----------------------------------------------------------------

def phase_device(ctx):
    import jax

    devs = jax.devices()
    say("device", f"jax.devices() = {devs}")
    for d in devs:
        say("device", f"  {d.id}: platform={d.platform} device_kind={d.device_kind!r}")
    say("device", f"count = {len(devs)}")
    say("device", f"jax {jax.__version__}; jax_default_matmul_precision = "
                  f"{jax.config.jax_default_matmul_precision!r}; "
                  f"jax_enable_x64 = {jax.config.jax_enable_x64}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say("device", "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    print(smi, flush=True)
    from tlfea.utils.roofline import chip_peaks

    say("device", f"published peaks: {chip_peaks(devs[0].device_kind)}")
    say("device", f"compile cache: {ctx['cache']}")


def phase_rollout_10k(ctx):
    import jax
    import numpy as np

    import bench
    from tlfea.solvers import newton

    system, state, f_ext, params, coarse = bench.beam_problem("10k")
    roll = newton.make_rollout(system, params, ROLLOUT_10K, coarse=coarse,
                               precond_refresh=bench.PRECOND_REFRESH)
    t0 = time.perf_counter()
    a, _ = roll(state, f_ext)
    jax.block_until_ready(a)
    say("rollout_10k", f"{system.elems.n_elem} elements, {system.elems.n_coef} nodes; "
                       f"compile + first rollout {time.perf_counter() - t0:.1f} s")
    # Determinism: the same rollout from the same state, twice.
    b, _ = roll(state, f_ext)
    jax.block_until_ready(b)
    same = all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))
    diff = float(np.max(np.abs(np.asarray(a.u) - np.asarray(b.u))))
    say("rollout_10k", f"two rollouts from the same state bit-identical: {same} "
                       f"(max |du| = {diff:.3e}, |u| max {float(np.abs(np.asarray(a.u)).max()):.3e})")
    t0 = time.perf_counter()
    s, (nit, cgit) = roll(a, f_ext)
    jax.block_until_ready(s)
    wall = time.perf_counter() - t0
    assert np.isfinite(np.asarray(s.x)).all(), "10k rollout diverged"
    say("rollout_10k", {"ms_per_step": wall / ROLLOUT_10K * 1e3,
                        **_steps_summary(nit, cgit, params.max_inner),
                        "peak_bytes_in_use": peak_bytes(jax.devices()[0])})


def _hv_ms(problem, n_iter=HV_ITERS):
    """Device time of one XLA Hessian-vector product (the tangent of
    jax.linearize(grad_L), as Newton-PCG applies it), from a loop of n_iter
    products inside one jit."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tlfea.solvers.common import grad_L

    system, state, f_ext, params, _ = problem

    @jax.jit
    def loop(sys_, st, f, p0, c):
        def g_of(v):
            return grad_L(v, st.x, st.v, st.lam, f, params.dt, params.rho,
                          sys_, u_prev=st.u)

        _, hvp = jax.linearize(g_of, st.v)
        return jax.lax.fori_loop(0, n_iter, lambda i, p: p + c * hvp(p), p0)

    p0 = jnp.asarray(np.random.default_rng(0).standard_normal(state.v.shape),
                     state.v.dtype)
    c = jnp.asarray(1e-12, state.v.dtype)
    jax.block_until_ready(loop(system, state, f_ext, p0, c))
    t0 = time.perf_counter()
    out = jax.block_until_ready(loop(system, state, f_ext, p0, c))
    assert np.isfinite(np.asarray(out)).all()
    return (time.perf_counter() - t0) / n_iter * 1e3


def phase_hv_per_cg(ctx):
    import bench

    for name in ("10k", "100k"):
        problem = bench.beam_problem(name)
        say("hv_per_cg", f"{name}: {problem[0].elems.n_elem} elements, XLA Hv "
                         f"{_hv_ms(problem):.4f} ms per product ({HV_ITERS} in one jit)")
    ctx["problem_100k"] = problem  # reused by rollout_100k


def phase_rollout_100k(ctx):
    import jax
    import numpy as np

    import bench
    from tlfea.solvers import newton

    system, state, f_ext, params, coarse = ctx.pop("problem_100k", None) or bench.beam_problem("100k")
    n_steps = 10
    roll = newton.make_rollout(system, params, n_steps, coarse=coarse,
                               precond_refresh=bench.PRECOND_REFRESH)
    t0 = time.perf_counter()
    compiled = roll.lower(state, f_ext).compile()
    say("rollout_100k", f"{system.elems.n_elem} elements, {system.elems.n_coef} nodes; "
                        f"compile {time.perf_counter() - t0:.1f} s")
    say("rollout_100k", f"memory_analysis: {compiled.memory_analysis()}")
    s, _ = roll(state, f_ext)
    jax.block_until_ready(s)
    t0 = time.perf_counter()
    s, (nit, cgit) = roll(s, f_ext)
    jax.block_until_ready(s)
    wall = time.perf_counter() - t0
    assert np.isfinite(np.asarray(s.x)).all(), "100k rollout diverged"
    say("rollout_100k", {"steps": 2 * n_steps, "ms_per_step": wall / n_steps * 1e3,
                         **_steps_summary(nit, cgit, params.max_inner),
                         "peak_bytes_in_use": peak_bytes(jax.devices()[0])})


def phase_shell(ctx):
    import jax
    import numpy as np

    import bench
    from tlfea.solvers import newton

    system, state, f_ext, params, coarse = bench.shell_problem()
    n_steps = 10
    roll = newton.make_rollout(system, params, n_steps, coarse=coarse,
                               precond_refresh=bench.PRECOND_REFRESH)
    s, _ = roll(state, f_ext)
    jax.block_until_ready(s)
    t0 = time.perf_counter()
    s, (nit, cgit) = roll(s, f_ext)
    jax.block_until_ready(s)
    wall = time.perf_counter() - t0
    assert np.isfinite(np.asarray(s.x)).all(), "shell rollout diverged"
    say("shell", {"elems": system.elems.n_elem, "qp": int(system.elems.grad_N.shape[1]),
                  "steps": 2 * n_steps, "ms_per_step": wall / n_steps * 1e3,
                  **_steps_summary(nit, cgit, params.max_inner),
                  "peak_bytes_in_use": peak_bytes(jax.devices()[0])})


def phase_sphere_drop(ctx):
    import bench

    # Warm-up through Simulation, then the fused coupled rollout; asserts
    # finite state, no capacity overflow and contacts > 0.
    info = bench.run_collision("collision")
    say("sphere_drop", info)


def phase_accuracy(ctx):
    import pytest

    # The gpu-marked tests, in this process (one process per card).
    os.environ["JAX_PLATFORMS"] = "cuda"
    tests = os.path.join(REPO, "tests")
    files = sorted(os.path.join(tests, f) for f in os.listdir(tests)
                   if f.startswith("test_") and f.endswith(".py")
                   and "pytest.mark.gpu" in open(os.path.join(tests, f)).read())
    rc = pytest.main([*files, "-q", "-s", "-m", "gpu", "-p", "no:xdist",
                      "-p", "no:cacheprovider", "--rootdir", REPO,
                      "-c", os.path.join(REPO, "pytest.ini")])
    say("accuracy", f"pytest -m gpu exit code {int(rc)}")
    assert int(rc) == 0, "gpu-marked tests failed"
    err = f32_vs_f64_10k()
    say("accuracy", f"10k beam f32 vs f64: max |u32 - u64| / max |u64| = {err:.3e} "
                    f"(bar {F32_VS_F64_TOL})")
    assert err <= F32_VS_F64_TOL, err


def f32_vs_f64_10k(n_steps=20):
    """The 10k beam, bench configuration, n_steps from rest in float32 and
    in float64 on the card; returns max |u32 - u64| / max |u64|."""
    import jax
    import numpy as np

    import bench
    from tlfea.solvers import newton

    finals = {}
    for dtype in (np.float32, np.float64):
        with jax.enable_x64(dtype == np.float64):
            system, state, f_ext, params, coarse = bench.beam_problem("10k", dtype=dtype)
            roll = newton.make_rollout(system, params, n_steps, coarse=coarse,
                                       precond_refresh=bench.PRECOND_REFRESH)
            s, (nit, cgit) = roll(state, f_ext)
            finals[dtype] = np.asarray(s.u, np.float64)
            say("accuracy", f"{np.dtype(dtype).name}: "
                            f"{_steps_summary(nit, cgit, params.max_inner)}")
    u32, u64 = finals[np.float32], finals[np.float64]
    assert np.isfinite(u32).all() and np.isfinite(u64).all()
    return float(np.abs(u32 - u64).max() / np.abs(u64).max())


def phase_sharded_step(ctx):
    """The element-sharded GSPMD step over all cards vs the same on one."""
    import jax
    import numpy as np

    import bench
    from tlfea.parallel.sharding import make_elem_mesh, replicate, shard_system
    from tlfea.solvers import newton

    devs = jax.devices()[: ctx["n_devices"]]
    mesh = make_elem_mesh(devs)
    n_steps = 10
    system, state, f_ext, params, coarse = bench.beam_problem("10k")
    out = {}
    for label, sys_, st, f in (
        ("one card", system, state, f_ext),
        (f"{len(devs)} cards", shard_system(system, mesh),
         replicate(state, mesh), replicate(f_ext, mesh)),
    ):
        roll = newton.make_rollout(sys_, params, n_steps, coarse=coarse,
                                   precond_refresh=bench.PRECOND_REFRESH)
        s, _ = roll(st, f)
        jax.block_until_ready(s)
        t0 = time.perf_counter()
        s, (nit, cgit) = roll(s, f)
        jax.block_until_ready(s)
        wall = time.perf_counter() - t0
        assert np.isfinite(np.asarray(s.x)).all(), f"{label}: diverged"
        out[label] = np.asarray(s.u)
        say("sharded_step", {"run": label, "ms_per_step": wall / n_steps * 1e3,
                             **_steps_summary(nit, cgit, params.max_inner)})
    a, b = out.values()
    err = float(np.abs(a - b).max() / np.abs(a).max())
    say("sharded_step", f"{2 * n_steps}-step f32 rollout, {len(devs)} cards vs one: "
                        f"max |du| / max |u| = {err:.3e} (bar {F32_VS_F64_TOL})")
    for d in devs:
        say("sharded_step", f"device {d.id}: peak_bytes_in_use {peak_bytes(d)}")
    assert err <= F32_VS_F64_TOL, err
    # Exact-arithmetic parity: one float64 step, sharded vs one card.
    with jax.enable_x64(True):
        system, state, f_ext, params, coarse = bench.beam_problem("10k", dtype=np.float64)
        ref, _ = newton.step(system, state, params, f_ext, coarse)
        sh, _ = newton.step(shard_system(system, mesh), replicate(state, mesh),
                            params, replicate(f_ext, mesh), coarse)
        err64 = float(np.abs(np.asarray(sh.u) - np.asarray(ref.u)).max()
                      / np.abs(np.asarray(ref.u)).max())
    # Bar: f64 roundoff (the two runs sum the scatter-adds in different
    # orders) amplified by the CG solves of one step.
    say("sharded_step", f"one f64 step, {len(devs)} cards vs one: "
                        f"max |du| / max |u| = {err64:.3e} (bar 1e-8)")
    assert err64 <= 1e-8, err64


PHASES = {name: globals()[f"phase_{name}"] for name in ONE_CARD_PHASES + FOUR_CARD_PHASES}


def main(argv=None) -> int:
    args = parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "tlfea")):
        raise SystemExit(f"chip_smoke.py must run from a tlfea checkout ({REPO} has no tlfea/)")
    sys.path.insert(0, REPO)

    import jax

    import tlfea  # noqa: F401  (precision settings)
    from tlfea.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    check_devices(devices, args.devices)
    ctx = {"n_devices": args.devices, "cache": enable_compile_cache()}
    failed = []
    t_all = time.perf_counter()
    for name in phases_for(args.devices):
        t0 = time.perf_counter()
        try:
            PHASES[name](ctx)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            say(name, "FAILED")
        say(name, f"{time.perf_counter() - t0:.1f} s")
    say("total", f"{time.perf_counter() - t_all:.1f} s; failed phases: {failed or 'none'}")
    if failed:
        return 1
    print(result_line(devices, args.devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
