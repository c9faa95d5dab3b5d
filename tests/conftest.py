"""Test configuration: force an 8-device virtual CPU mesh.

Must run before jax is imported anywhere (hence env mutation at module
import time). This mirrors the reference's strategy of testing distributed
code via multi-process on one host (test_dist_base.py) — here we do better:
XLA's CPU backend gives us 8 virtual devices in one process, so every
sharding/collective path is exercised in CI without TPU hardware.
"""
import os
import sys

# PD_TEST_TPU=1 opts OUT of the CPU forcing so the TPU-gated tests
# (tests/test_pallas_attention.py -k tpu) can reach the real chip
# (tools/tpu_first_light.py sets it).
_USE_TPU = os.environ.get("PD_TEST_TPU") == "1"

# the suite asserts the kernel-dropout self-check's own behavior; a
# PD_KERNEL_DROPOUT pin inherited from a bench/first-light shell would
# invert those assertions
os.environ.pop("PD_KERNEL_DROPOUT", None)

if not _USE_TPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
# exact matmuls for numpy-reference comparisons (CPU default is low-prec).
# NB: pytest plugins import jax before this conftest, so set the config
# directly rather than via env.
import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
if not _USE_TPU:
    # JAX config snapshots env at import, and pytest plugins import jax
    # before this conftest — force the CPU platform via config, not env.
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# jax version shims (jax.shard_map / lax.axis_size / jax_num_cpu_devices
# on older runtimes) must be live BEFORE test modules run their own
# `from jax import shard_map` imports at collection time.
from paddle_tpu import jax_compat  # noqa: E402,F401


def pytest_configure(config):
    # tier-1 is `-m 'not slow'` under a hard wall-clock budget
    # (ROADMAP.md). Integration tests that cost >~15 s on the 2-core
    # sandbox carry this marker so tier-1 finishes inside the budget;
    # each keeps a faster sibling receipt in tier-1. Run the slow tier
    # with `-m slow`.
    config.addinivalue_line(
        "markers", "slow: heavy integration test, excluded from tier-1")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (paddle_tpu_torch kernels); "
        "skips without one")


def shard_frac(arr):
    """Fraction of a sharded array materialized on this process's first
    shard — 1/n under an n-way sharding, 1.0 when replicated. Shared by
    the ZeRO/sharding receipts (test_zero_stages, test_yolo)."""
    import numpy as _np
    return (_np.prod(arr.addressable_shards[0].data.shape)
            / _np.prod(arr.shape))
