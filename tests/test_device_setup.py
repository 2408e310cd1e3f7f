"""Device sizing, the compilation cache location and the GPU smoke script.

The memory helper (utils/memory.py) is tested against stubbed devices; the
cache tests and the smoke-script tests run fresh interpreters, because the
cache directory is fixed when the package is first imported.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from juliachem_jl_tpu.utils import memory

REPO = pathlib.Path(__file__).resolve().parents[1]


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _with_device(monkeypatch, dev):
    monkeypatch.setattr(memory.jax, "devices", lambda: [dev])


def test_memory_reads_device_limit(monkeypatch):
    _with_device(monkeypatch, _FakeDevice(
        "gpu", {"bytes_limit": 64_000_000_000, "bytes_in_use": 5}))
    assert memory.device_memory_bytes() == 64_000_000_000
    assert memory.share_bytes("fold_tile") == 8_000_000_000
    assert memory.budget_elements("fold_tile") == 1_000_000_000


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_memory_without_limit_raises(monkeypatch, stats):
    _with_device(monkeypatch, _FakeDevice("gpu", stats))
    with pytest.raises(RuntimeError, match="no memory limit"):
        memory.device_memory_bytes()


def test_memory_cpu_is_host_ram(monkeypatch):
    _with_device(monkeypatch, _FakeDevice("cpu", None))
    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert memory.device_memory_bytes() == ram


@pytest.mark.gpu
def test_memory_on_gpu(gpu_device):
    assert memory.device_memory_bytes() > 0


def _run(code, env_extra=None, unset=(), cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k not in unset}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_compile_cache_honours_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there."""
    code = (
        "import jax, jax.numpy as jnp, juliachem_jl_tpu\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((8, 8)))"
        ".block_until_ready()\n")
    proc = _run(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[0] == str(tmp_path)
    assert any(tmp_path.iterdir()), "no executable written to the cache"


def test_compile_cache_default_in_checkout():
    code = ("import jax, juliachem_jl_tpu\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    proc = _run(code, unset=("JAX_COMPILATION_CACHE_DIR",))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == str(REPO / ".jax_cache")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_cpu(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result off the GPU, both
    in the checkout and copied alone into an empty directory."""
    script = REPO / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          cwd=script.parent, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
