"""Backend selection, the compile-cache rule, one GPU per process in the
multi-process path, and chip_smoke.py's refusal to run without a GPU."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,impl", [
    ("gpu", "triton"), ("cpu", "xla"), ("rocm", "xla"),
])
def test_fast_pair_impl_per_platform(platform, impl):
    from demuxlet_jax.backend import fast_pair_impl

    assert fast_pair_impl(platform) == impl


@pytest.mark.parametrize("V,grid", [(1, [0.0]), (2, [0.0, 0.5]),
                                    (8, [0.0, 0.5]), (64, [0.0, 0.5]),
                                    (2, [0.0, 0.1, 0.2, 0.3, 0.5])])
def test_engine_pair_impl_same_for_every_shape(V, grid):
    """The engine takes the platform's implementation at every (V, A)
    shape; there is no per-shape split."""
    import numpy as np

    from demuxlet_jax.backend import fast_pair_impl
    from demuxlet_jax.models.engine import DemuxEngine

    eng = DemuxEngine(np.full((4, V, 3), 1 / 3), grid, mode="fast")
    assert eng.pair_impl == fast_pair_impl() == "xla"


def test_fast_pair_impl_default_backend():
    """The engine's choice follows JAX's default backend (CPU here)."""
    import numpy as np

    from demuxlet_jax.backend import fast_pair_impl
    from demuxlet_jax.models.engine import DemuxEngine

    assert fast_pair_impl() == "xla"
    eng = DemuxEngine(np.full((4, 2, 3), 1 / 3), [0.0, 0.5], mode="fast")
    assert eng.pair_impl == "xla"


def test_check_platform_gpu_without_gpu_raises():
    import jax

    from demuxlet_jax import backend
    from demuxlet_jax.utils.logging_utils import DemuxError

    try:
        backend.select_platform("gpu")
        with pytest.raises(DemuxError, match="--device gpu"):
            backend.check_platform("gpu")
    finally:
        jax.config.update("jax_platforms", "cpu")
    assert backend.check_platform("cpu").startswith("cpu")
    assert backend.check_platform("auto").startswith("cpu")


def test_cli_device_gpu_without_gpu_raises(tmp_path):
    """--device gpu fails fast with a DemuxError (before any input is
    read) when JAX finds no GPU; it never falls back to the CPU."""
    import jax

    from demuxlet_jax import cli
    from demuxlet_jax.utils.logging_utils import DemuxError

    try:
        with pytest.raises(DemuxError, match="--device gpu"):
            cli.main(["--sam", str(tmp_path / "none.bam"),
                      "--vcf", str(tmp_path / "none.vcf"),
                      "--out", str(tmp_path / "o"), "--device", "gpu"])
    finally:
        jax.config.update("jax_platforms", "cpu")


def test_cli_device_choices():
    from demuxlet_jax.cli import build_parser

    p = build_parser()
    base = ["--sam", "a", "--vcf", "b", "--out", "c"]
    for dev in ("auto", "gpu", "cpu"):
        assert p.parse_args(base + ["--device", dev]).device == dev
    with pytest.raises(SystemExit):
        p.parse_args(base + ["--device", "metal"])
    with pytest.raises(SystemExit):
        p.parse_args(base + ["--exact-kernel", "xla"])


@pytest.mark.parametrize("default", [None, "/elsewhere/cache"])
def test_cache_dir_env_var_wins(monkeypatch, default):
    from demuxlet_jax.utils import jaxcfg

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/from/env")
    assert jaxcfg.compilation_cache_dir(default) == "/from/env"


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    from demuxlet_jax.utils import jaxcfg

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jaxcfg.compilation_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    assert path == jaxcfg.compilation_cache_dir()  # no pid/time in it
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()
    assert jaxcfg.compilation_cache_dir("/x") == "/x"


def test_enable_compilation_cache_sets_env_dir(monkeypatch):
    import jax

    from demuxlet_jax.utils import jaxcfg

    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/tmp/demux_env_cache")
    try:
        jaxcfg.enable_compilation_cache("/not/this/one")
        assert jax.config.jax_compilation_cache_dir == "/tmp/demux_env_cache"
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


@pytest.mark.parametrize(
    "visible,pid,want",
    [("0,1,2,3", 0, [0]), ("0,1,2,3", 2, [2]), ("0,1", 3, [1]),
     ("", 1, None)],
)
def test_multihost_initialize_one_gpu_per_process(monkeypatch, visible,
                                                  pid, want):
    """Each process of a --num-shards run opens only its own GPU."""
    import jax

    from demuxlet_jax.parallel import multihost as mh

    seen = {}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    mh.initialize("localhost:1234", 4, pid)
    assert seen["local_device_ids"] == want
    assert seen["process_id"] == pid and seen["num_processes"] == 4


def test_multihost_initialize_explicit_ids_and_single_process(monkeypatch):
    import jax

    from demuxlet_jax.parallel import multihost as mh

    calls = []
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    mh.initialize("localhost:1234", 2, 1, local_device_ids=[3])
    assert calls[-1]["local_device_ids"] == [3]
    assert mh.initialize(None, 1, 0) == (0, 1)
    assert len(calls) == 1
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert mh.local_gpu_count() >= 0


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke script exits non-zero and prints no
    result line."""
    out = _smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied alone into an empty directory, the script fails."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _smoke(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
