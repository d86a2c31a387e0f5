"""Test configuration: force JAX onto a virtual 8-device CPU mesh with x64.

Device kernels are validated on CPU (deterministic f64) against the NumPy
oracle; Pallas kernels run in interpret mode. Multi-device sharding tests
use the 8 virtual devices. Tests marked `gpu` need a CUDA GPU and skip
without one (run them on the GPU with `pytest -m gpu tests/`).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
prev = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in prev:
    os.environ["XLA_FLAGS"] = (
        prev + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_ENABLE_X64"] = "true"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# persistent compile cache at a fixed path outside the checkout, so the
# tree stays small (JAX_COMPILATION_CACHE_DIR, when set, wins)
from demuxlet_jax.utils.jaxcfg import enable_compilation_cache  # noqa: E402

enable_compilation_cache(os.path.expanduser("~/.cache/demuxlet_jax_tests"))
