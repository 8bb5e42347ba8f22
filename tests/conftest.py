import os

# Tests run on the CPU backend with a virtual 8-device mesh so sharding
# logic is exercised without accelerator hardware (the reference's
# analogue: a FakeComm + mpirun -np 8 test matrix).  config.update after
# import wins over whatever JAX_PLATFORMS says.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite re-traces many identical
# programs (same grids/configs across tests and runs); caching compiled
# executables cuts suite wall-clock several-fold (reference suite
# budget: 600 s, integration_tests/CMakeLists.txt:21).
from hymls.utils import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=0.5)
