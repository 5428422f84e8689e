"""The parts of chip_smoke.py (and bench.py) that run without a GPU: device
checks, phase selection and the result line."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import bench
import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def test_refuses_a_non_gpu_platform():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.check_devices(jax.devices(), 1)
    with pytest.raises(SystemExit, match="--devices 4"):
        chip_smoke.check_devices([_FakeGpu()], 4)


def test_last_line_has_the_exact_shape():
    line = chip_smoke.result_line([_FakeGpu()] * 4, 4)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 4}}')
    assert json.loads(chip_smoke.result_line([_FakeGpu()], 1))["device"]["count"] == 1


def test_devices_4_selects_only_the_sharded_phase():
    four = chip_smoke.phases_for(chip_smoke.parse_args(["--devices", "4"]).devices)
    one = chip_smoke.phases_for(chip_smoke.parse_args([]).devices)
    assert four == ("device", "sharded_step")
    assert "sharded_step" not in one and "rollout_10k" in one
    assert set(chip_smoke.PHASES) == set(one) | set(four)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_script_fails_without_a_gpu_or_a_checkout(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_refuses_the_cpu():
    with pytest.raises(SystemExit, match="only the CPU"):
        bench.main()


def test_bench_series_line_names_no_target():
    entry = {**bench.device_info(), "elems": 10584, "steps_per_sec": 12.5}
    line = json.loads(bench._series_json({"1k": {"error": "x"}, "10k": entry}))
    assert line["metric"] == "implicit_newton_steps_per_sec_T10_10584elem_rollout"
    assert line["value"] == 12.5 and "vs_baseline" not in line
    assert {"platform", "device_kind", "device_count"} <= set(line["series"]["10k"])
