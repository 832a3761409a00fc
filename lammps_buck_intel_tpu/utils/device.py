"""The accelerator a measurement runs on.

A measurement that finds no GPU fails; it never falls back to the CPU.
Every number it prints sits beside the card's name and power limit, as
``nvidia-smi`` reports them (a card set below its maximum power runs
slower under load).
"""
from __future__ import annotations

import subprocess

NVIDIA_SMI = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


class NoGPUError(RuntimeError):
    """JAX found no GPU."""


def require_gpu():
    """The JAX devices, if they are GPUs; raises ``NoGPUError`` otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoGPUError(
            f"no GPU: JAX's first device is {devs[0].platform} "
            f"({devs[0].device_kind}); this measurement runs on the card "
            "only")
    return devs


def card_name_power() -> str:
    """``nvidia-smi``'s name and power limit, one line per card."""
    try:
        r = subprocess.run(NVIDIA_SMI, capture_output=True, text=True,
                           timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    out = r.stdout.strip()
    return out if r.returncode == 0 and out else (
        f"nvidia-smi failed (rc={r.returncode})")


def peak_memory_bytes(dev):
    """Peak bytes the program's arrays took on ``dev`` (None if the
    backend keeps no statistics)."""
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")
