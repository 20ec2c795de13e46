"""Smoke tests for the measurement tools (tools/).

The per-stage budget (`stage_profile.py`, cumulative-prefix ablation)
and the sustained serving soak (`serve_soak.py`) each have a --cpu
tiny-geometry mode designed for exactly this hermetic check: the tools
must keep emitting a parseable one-line JSON contract, or the next
measurements silently break.

Run as subprocesses (the tools configure their own CPU backend before
first device use; the parent conftest's settings don't propagate).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_tool(args, timeout=280):
    proc = subprocess.run(
        [sys.executable, *args],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln]
    assert lines, f"no stdout; stderr: {proc.stderr[-500:]}"
    return json.loads(lines[-1])


def test_stage_profile_cpu_smoke():
    res = _run_tool(["tools/stage_profile.py", "--cpu", "--iters", "3"])
    # Structural contract only: timings on a loaded shared host are noisy,
    # so asserting stage ordering here is a flake; what must not rot is
    # the JSON schema the measurements parse.
    for key in ("master_ms", "chan_ms", "full_ms", "fills_ms",
                "pl_ring_ms", "pl_fft_amortised_ms",
                "d_channelize_ms", "d_demod_ms", "realtime_x"):
        assert key in res, key
        assert isinstance(res[key], (int, float)), key
    assert res["channels"] == 16 and res["L_dec"] > 0
    # derived rows must stay consistent with the prefixes they difference
    assert abs(res["d_channelize_ms"]
               - (res["chan_ms"] - res["master_ms"])) < 1e-6
    assert abs(res["d_demod_ms"]
               - (res["full_ms"] - res["chan_ms"])) < 1e-6


def test_serve_soak_cpu_smoke():
    res = _run_tool(["tools/serve_soak.py", "--cpu", "--blocks", "25"])
    assert res["blocks"] == 25
    assert res["sustained_rt"] > 0
    assert 0 < res["p50_ms"] <= res["p99_ms"] <= res["max_ms"]
    assert res["channels"] >= 1 and res["block_ms"] > 0
