"""Test configuration: force CPU with a virtual 8-device mesh so sharding
tests run anywhere, and enable x64 so kernels can be validated in double
precision against the float64 NumPy oracle."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

# Persistent XLA executable cache: the suite's long poles are the
# sharded-step compiles; a warm cache deserializes them instead.  Same
# placement rule as the package (utils/compile_cache.py):
# JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache.  Entries
# are keyed by XLA flags, so the 8-virtual-device setting above stays
# part of the key.
from ohm_tsd_slam.utils.compile_cache import (  # noqa: E402
    enable_persistent_cache,
)

enable_persistent_cache(min_compile_secs=1.0)

sys.path.insert(0, os.path.dirname(__file__))
