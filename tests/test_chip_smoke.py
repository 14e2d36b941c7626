"""Entry-point plumbing that runs on the CPU: compile-cache placement,
chip_smoke.py's refusal to run without a GPU, and the production-host
site configuration it drives."""

import json
import os
import subprocess
import sys

import jax
import pytest

from radiocapture_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env, want, set_here", [
    ({"JAX_COMPILATION_CACHE_DIR": "/srv/xla-cache"}, "/srv/xla-cache",
     False),
    ({}, os.path.join(REPO, ".jax_cache"), True),
])
def test_compile_cache_dir(env, want, set_here):
    assert compile_cache.cache_dir(env) == (want, set_here)


@pytest.mark.parametrize("env_dir", [None, "/srv/xla-cache"])
def test_compile_cache_enable(monkeypatch, env_dir):
    """With the variable set, JAX reads it and the code sets nothing;
    unset, the config points at the fixed in-checkout directory."""
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable()
        if env_dir is None:
            assert got == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        else:
            assert got == env_dir
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_fails_without_gpu():
    """The device phase refuses a CPU-only JAX: non-zero exit and no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "not gpu" in r.stderr
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_site_config_is_production_host_shape():
    """configs/config_site_10rtl.py: ten 2.4 MS/s sources, 64 slots,
    grouped xlat, mixed trunked systems (reference den940 host)."""
    from radiocapture_tpu.rxconfig import load_config
    cfg = load_config(os.path.join(REPO, "configs", "config_site_10rtl.py"))
    assert len(cfg.sources) == 10
    assert {s.samp_rate for s in cfg.sources.values()} == {2.4e6}
    assert {s.type for s in cfg.sources.values()} == {"file"}
    assert cfg.num_slots_per_source == 64 and cfg.block_seconds == 0.1
    assert cfg.frontend_mode == "xlat" and cfg.group_sources
    assert {s.type for s in cfg.systems.values()} == {"p25", "edacs",
                                                     "moto"}
    assert cfg.systems[0].control_channels == [857.5e6]


def test_smoke_bank_and_site_phases_pass_on_cpu_at_small_width():
    """chip_smoke.py's bank and site checks, rehearsed on the CPU at a
    reduced width (the card runs them at 64 slots, 40 blocks): float64
    bank parity and split continuity, then lock, every grant decoded,
    new_call and a recording through SiteRuntime."""
    import chip_smoke
    chip_smoke.phase_bank(jax, num_slots=8, block=24_000)
    chip_smoke.phase_site(n_blocks=4, num_slots_per_source=4)
