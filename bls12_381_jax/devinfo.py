"""The device a measurement runs on: a GPU check and the card's identity.

Every timing this repository prints names the card and its power limit
(a card set below its maximum runs slower under load), so the numbers of
two runs can be told apart.
"""

from __future__ import annotations

import subprocess


class NoGpuError(RuntimeError):
    """JAX's default device is not a GPU."""


def require_gpu():
    """Return JAX's first device; raise :class:`NoGpuError` unless it is
    a GPU (a measurement never falls back to the CPU)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NoGpuError(
            f"needs a GPU; JAX's default device is {dev.platform!r} "
            f"({dev.device_kind})")
    return dev


def card_info() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them (one
    line per card), read in a child process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
