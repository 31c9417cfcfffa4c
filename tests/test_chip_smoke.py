"""chip_smoke.py's contract on a host without a GPU: it refuses to run and
prints no result; its last line is exactly the contract's JSON."""

import json
import os
import subprocess
import sys

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_cpu_host():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_chip_smoke_ok_line_is_the_contract():
    line = chip_smoke.ok_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
