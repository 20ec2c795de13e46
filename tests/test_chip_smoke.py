"""chip_smoke.py: its refusal to run without a card, and each phase at a
tiny size on the CPU (the same code the card runs at deployment size).

The phases are called directly, not through main(), because main()
refuses to run anywhere but on a GPU.  The `gpu`-marked tests at the end
run the phases at their real widths on a card.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 1.536e6            # tiny geometry: N = 2^16 at 20 ms, 2^18 long


def _run_script(script, cwd, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_refuses_without_a_gpu():
    proc = _run_script(os.path.join(REPO, "chip_smoke.py"), REPO,
                       {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path),
                       {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A seeded recording and the mixed-mode bankd run over it, shared by
    the phase cases that read them."""
    from ka9q_sdr_tpu.apps.bankd import derive_geometry

    tmp = str(tmp_path_factory.mktemp("smoke"))
    plan = cs.channel_plan(FS, 12, 4, 4)
    rec = os.path.join(tmp, "wide.iq")
    cs.make_recording(rec, plan, 4 * derive_geometry(FS, 148.0)[0],
                      chunk=1 << 16)
    mixed = cs.mixed_phase(tmp, plan, rec, 12)
    return {"tmp": tmp, "plan": plan, "rec": rec, "mixed": mixed}


@pytest.mark.parametrize("phase", ["fill", "fft_rule", "mixed_bankd",
                                   "flagship_bankd", "device_step",
                                   "bank_vs_receiver", "multicard"])
def test_phase(phase, tiny):
    if phase == "fill":
        r = cs.fill_phase(33, 250, iters=2)
        assert r["exact"] and r["ms"] > 0
    elif phase == "fft_rule":
        r = cs.fft_phase(14, iters=2)
        assert r["rule"] == "monolithic" and r["rel_err"] < 2e-5
        assert r["monolithic_ms"] > 0 and r["fourstep_ms"] > 0
    elif phase == "mixed_bankd":
        s = tiny["mixed"]["summary"]
        assert s["blocks"] == 12 and s["steady_s_per_block"] > 0
        assert s["step_memory"]["temp_size_in_bytes"] > 0
        assert set(tiny["mixed"]["pcm"]) == {"FM", "USB", "CAM"}
        json.dumps(s)
    elif phase == "flagship_bankd":
        r = cs.flagship_phase(tiny["tmp"], tiny["plan"], tiny["rec"], 3)
        assert r["channels"] == 40 and r["summary"]["blocks"] == 3
    elif phase == "device_step":
        r = cs.device_step_phase(tiny["plan"], tiny["rec"], iters=2)
        assert r["mixed_ms"] > 0 and r["flagship_ms"] > 0
    elif phase == "bank_vs_receiver":
        worst = cs.parity_phase(tiny["plan"], tiny["rec"],
                                tiny["mixed"]["pcm"], 12)
        assert set(worst) == {"FM", "USB", "CAM"}
        for mode, ratio in worst.items():
            assert ratio < cs.PARITY_BOUND[mode], (mode, ratio)
    else:
        from ka9q_sdr_tpu.apps.bankd import derive_geometry

        L, M = derive_geometry(FS, 20.0)
        r = cs.multicard_phase(tiny["tmp"], 4, 16, FS, L, M, blocks=2)
        assert r["FM"]["max_err"] <= 1e-5
        assert r["shard_fft"]["max_err"] <= 3e-5
        assert r["bankd_mesh"]["max_lsb"] <= 8


def test_channel_file_round_trips_frequencies(tmp_path):
    """Channel-file lines use the kHz form, which bankd reads back as the
    exact master-bin frequency (bare small numbers would read as MHz)."""
    from ka9q_sdr_tpu.apps.bankd import read_channel_file

    plan = cs.channel_plan(FS, 12, 4, 4)
    path = str(tmp_path / "ch.txt")
    cs.write_channel_file(path, plan)
    groups = read_channel_file(path)
    assert [m for m, _ in groups] == ["FM", "USB", "CAM"]
    got = np.concatenate([f for _, f in groups])
    np.testing.assert_allclose(got, plan["freqs"], rtol=0, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8192, 7104), (4096, 960)])
def test_fill_full_width_on_card(gpu, shape):
    assert cs.fill_phase(*shape)["exact"]


@pytest.mark.gpu
def test_bank_vs_receiver_on_card(gpu, tmp_path):
    from ka9q_sdr_tpu.apps.bankd import derive_geometry

    plan = cs.channel_plan(cs.SAMPRATE, 3072, 512, 512)
    rec = str(tmp_path / "wide.iq")
    cs.make_recording(rec, plan, 12 * derive_geometry(cs.SAMPRATE, 20.0)[0])
    mixed = cs.mixed_phase(str(tmp_path), plan, rec, 12)
    worst = cs.parity_phase(plan, rec, mixed["pcm"], 12)
    for mode, ratio in worst.items():
        assert ratio < cs.PARITY_BOUND[mode], (mode, ratio)
