"""utils/runtime: where the persistent compile cache lives, and the
measurement paths' refusal to run without a GPU.

configure_jax touches process-global JAX config, so the cache cases run
in a subprocess."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_child(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    code = ("import jax; from ka9q_sdr_tpu.utils.runtime import "
            "configure_jax; configure_jax(); "
            "print(jax.config.jax_compilation_cache_dir)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.strip().splitlines()[-1]


def test_cache_dir_follows_the_environment(tmp_path):
    assert _cache_dir_in_child(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)


def test_default_cache_dir_is_fixed_inside_the_checkout():
    from ka9q_sdr_tpu.utils.runtime import DEFAULT_CACHE_DIR

    assert DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert _cache_dir_in_child({}) == DEFAULT_CACHE_DIR
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_require_gpu_refuses_the_cpu():
    import jax

    from ka9q_sdr_tpu.utils.runtime import require_gpu

    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()
