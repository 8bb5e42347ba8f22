"""Host-side pieces of running on a GPU: the compile-cache location, the
memory-derived structured budget, the benchmark's peak table, and
chip_smoke.py's refusal to run without a GPU."""
import _cpu  # noqa: F401  (pin CPU backend before jax init)

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_subprocess(env):
    code = ("import jax; from hymls.utils import compile_cache; "
            "d = compile_cache.enable(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.split()


def test_compile_cache_honours_env(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    helper_dir, jax_dir = _cache_dir_in_subprocess(env)
    assert helper_dir == str(tmp_path)
    assert jax_dir == str(tmp_path)


def test_compile_cache_default_inside_checkout():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    helper_dir, jax_dir = _cache_dir_in_subprocess(env)
    assert helper_dir == jax_dir == os.path.join(REPO, ".jax_cache")


def test_plan_cache_default_inside_checkout(monkeypatch):
    from hymls.core.preconditioner import _plan_cache_dir
    monkeypatch.delenv("HYMLS_PLAN_CACHE", raising=False)
    assert _plan_cache_dir() == os.path.join(REPO, ".plan_cache")


@pytest.mark.parametrize("gib, fits_32cube",
                         [(12, False), (60, False), (128, True)])
def test_structured_budget_from_bytes_limit(gib, fits_32cube):
    """256 bytes per estimated element fill at most half the device: a
    12 GiB device and a 60 GiB one (an 80 GB card at JAX's default 75%
    reservation) keep 32^3 skew L=2 (est. 2.1e8 elements) on the
    generic path, a 128 GiB one builds it; 128^2 L=2 (3.4e6) fits
    all."""
    from hymls.core.preconditioner import structured_budget
    budget = structured_budget(gib * 2**30)
    assert budget * 256 <= 0.5 * gib * 2**30 + 1
    assert (2.1e8 <= budget) == fits_32cube
    assert 3.4e6 <= budget


def test_peak_table_unknown_device_raises():
    sys.path.insert(0, REPO)
    import bench
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_gbps"] == 3350.0
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks("NVIDIA Unknown GPU")


def test_peaks_absent_on_cpu():
    sys.path.insert(0, REPO)
    import bench
    assert bench._peaks() is None
    assert bench._device()["platform"] == "cpu"


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_without_package(tmp_path):
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_precision_probe_on_gpu():
    """chip_smoke.py phase D on the card, in a process of its own (this
    one is pinned to the CPU): f32 products are full f32, not TF32."""
    import shutil
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs a GPU (run: python -m pytest -m gpu on the card)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    code = ("import jax, hymls, chip_smoke; "
            "assert jax.default_backend() == 'gpu'; chip_smoke.phase_d()")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"D_precision"' in out.stdout
