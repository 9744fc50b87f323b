"""Command-line plumbing: the persistent compile cache and chip_smoke.py's
refusal to run anywhere but on a GPU with this checkout."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from yag_slam_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    calls = _record_updates(monkeypatch)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself


def test_chip_smoke_refuses_cpu():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.device_check(1)


@pytest.mark.parametrize("alone", [True, False])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    """Alone in a directory it cannot import the package; in the checkout
    on the CPU it fails the device check.  Either way: non-zero exit and
    no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
