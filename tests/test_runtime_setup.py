"""Run-time setup: compile-cache placement, the voxel-mean modes, and
``chip_smoke.py`` refusing to run off the GPU and checking what it claims
to check."""

import os
import shutil
import subprocess
import sys

import pytest

from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu.utils import compilation_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import jax; from ros_gpu_depthmap_fusion_tpu.utils."
          "compilation_cache import enable_persistent_compilation_cache as "
          "e; p = e(); print(p); print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compilation_cache_placement(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins untouched; otherwise the fixed,
    git-ignored <repo>/.jax_cache (never a temp dir)."""
    env = {k: v for k, v in os.environ.items()
           if k != compilation_cache.CACHE_ENV}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / "cache")
        env[compilation_cache.CACHE_ENV] = want
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    assert out == [want, want]
    assert compilation_cache.DEFAULT_CACHE_DIR == os.path.join(
        REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("mode", ["rle", "fast"])
def test_unknown_voxel_mean_mode_rejected(mode):
    with pytest.raises(ValueError, match="voxel_mean_mode"):
        FusionConfig(voxel_mean_mode=mode)
    with pytest.raises(ValueError, match="voxel_mean_mode"):
        FusionConfig().replace(voxel_mean_mode=mode)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_cpu(alone, tmp_path):
    """Without a GPU (and in a directory holding nothing else of the repo)
    the smoke exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("perturb", [False, True])
def test_chip_smoke_oracle_comparison(perturb):
    """The engine-against-composed-oracles check passes at small shapes on
    the CPU, and fails when one occupied cell is perturbed."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    scene = cs.make_scene(c=2, h=48, w=64, lidar_pts=256)
    if not perturb:
        diffs, worst, flips = cs.raw_link_check(scene, None, frames=2)
        assert diffs == 0 and flips == 0
        assert worst < 0.1
        return
    with pytest.raises(cs.SmokeFailure):
        cs.raw_link_check(scene, None, frames=2, perturb_cell=0)
