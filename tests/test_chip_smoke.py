"""chip_smoke.py and bench.py contracts that the CPU can check: the device
guard and the form of the result line."""

import json
import os
import shutil
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_without_gpu():
    r = _run(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_fails_alone(tmp_path):
    """Copied out of the repository it fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_result_line_form():
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line(dev, 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_cards_option_checked():
    """Only one card or four: anything else is refused before JAX starts."""
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                        "--cards", "2"], capture_output=True, text=True,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300)
    assert r.returncode == 2 and "--cards" in r.stderr


def test_bench_fails_without_gpu():
    """bench.py names the device and refuses to report a CPU number."""
    r = _run(ROOT, os.path.join(ROOT, "bench.py"))
    assert r.returncode != 0
    assert "platform=cpu" in r.stdout and '"metric"' not in r.stdout
