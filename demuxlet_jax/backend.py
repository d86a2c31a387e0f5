"""The one place that chooses the execution platform and, per platform,
the fast-mode pair-search implementation.

  platform  fast pair search                 exact mode
  gpu       Pallas-Triton kernel             f64 XLA contraction
  cpu       XLA (plain contraction)          f64 XLA contraction

A Pallas kernel runs in the interpreter only when a test asks for it
explicitly; no production path derives interpret mode from the backend.
"""

from __future__ import annotations

# fast-mode pair implementation per platform; "triton" = the Pallas kernel
# in ops/pallas_pair.py, "xla" = models/likelihood.pair_contract
FAST_PAIR_IMPL = {"gpu": "triton", "cpu": "xla"}


def select_platform(device: str) -> None:
    """Apply a --device choice before the backend initialises: "gpu" pins
    JAX to CUDA, "cpu" to the host, "auto" leaves JAX's default."""
    import jax

    if device == "gpu":
        jax.config.update("jax_platforms", "cuda")
    elif device == "cpu":
        jax.config.update("jax_platforms", "cpu")


def check_platform(device: str) -> str:
    """Initialise the backend and check it against --device. Returns a
    description of the device ("platform device_kind xN") for the log;
    raises DemuxError when --device gpu finds no GPU."""
    import jax

    from demuxlet_jax.utils.logging_utils import DemuxError

    try:
        devs = jax.devices()
    except (RuntimeError, AssertionError) as e:
        # JAX raises RuntimeError when CUDA fails to initialise, and
        # AssertionError when it finds no visible NVIDIA device at all
        if device == "gpu":
            raise DemuxError(f"--device gpu: no GPU backend ({e})") from e
        raise
    if device == "gpu" and devs[0].platform != "gpu":
        raise DemuxError(
            f"--device gpu: JAX found {devs[0].platform}, not a GPU")
    return f"{devs[0].platform} {devs[0].device_kind} x{len(devs)}"


def fast_pair_impl(platform: str | None = None) -> str:
    """Fast-mode pair-search implementation for a platform (default: the
    platform of JAX's default backend)."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    return FAST_PAIR_IMPL.get(platform, "xla")
