"""Test configuration: run on the CPU with a virtual 8-device mesh so
sharding is testable without accelerators (SURVEY.md §4).  Must run before
jax initializes a backend.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; run them on a
GPU machine with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``."""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent compilation cache makes repeated test runs fast.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
from oddio_tpu.utils.cache import use_compile_cache  # noqa: E402

use_compile_cache()

# Two-tier test run: the long goldens / ScenePack soaks / kernel-parity
# sweeps are marked `slow` here (one central list, no per-file decorators);
# `pytest -m "not slow"` finishes in a few minutes for inner-loop debugging,
# the full run stays the merge gate.  Names without parametrize suffixes.
_SLOW_TESTS = {
    "test_dr_pool_fast_path_matches_scan_path",
    "test_golden_buffered_huge_blocks_wrapped_reads",
    "test_scenepack_matches_single_device",
    "test_scenepack_clamped_voice_disables_subpass",
    "test_golden_spatial_flyby_large_blocks",
    "test_golden_spatial_flyby",
    "test_scan_unroll_parity",
    "test_scenepack_scan_unroll_parity",
    "test_scenepack_dr_stream_ingest",
    "test_idle_slot_cursors_hold",
    "test_scenepack_walk_tier_uniform",
    "test_scenepack_grow_and_eager_plays_mid_pack",
    "test_stream_dr_spatial_matches_host_pool",
    "test_no_retrace_after_warmup",
    "test_scenepack_sampler_seek_voices",
    "test_buffered_spatial_retrace_containment",
    "test_checkpoint_resume",
    "test_control_plane_under_tsan",
    "test_stream_dr_checkpoint_restore",
    "test_large_blocks_match_chunked",
    "test_fader_mirror_count_sync_in_submix",
    "test_frames_control_readout_in_dr_pool",
    "test_block_vs_scan_vs_remainder",
    "test_golden_buffered_rate_mismatch",
    "test_stream_as_buffered_spatial_source",
    "test_fader_outgoing_heavy_target_keeps_exact_path",
    "test_golden_buffered_beyond_max_delay",
    "test_golden_family_subpass_mixed_scene",
    "test_spatial_buffered_gain_dr",
    "test_distance_attenuation",
    "test_doppler_shift",
    "test_seek_pool_dr_frames_cycle_matches_host",
    "test_submix_play_buffered",
    "test_mixer_pack",
    "test_fader_as_buffered_spatial_voice",
    "test_streaming_agc_scene_pack",
    "test_scenepack_dr_fades_under_mesh",
    "test_gain_stream_dr_matches_host_pool",
    "test_adapt_stream_dr_spatial_matches_host_pool",
    "test_stereo_dr_adapt_matches_host",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long goldens/soaks; excluded by -m 'not slow'"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere"
    )


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name.split("[")[0] in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time, so
    every xdist worker collects the same tests)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest tests/ -m gpu")
