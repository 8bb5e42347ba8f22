"""Import before hymls in ad-hoc scripts to force the CPU backend."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

from hymls.utils import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=0.5)
