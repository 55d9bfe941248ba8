"""Identity of the device a measurement runs on.

Every speed figure is reported beside the JAX platform, device kind and
count, and for a GPU the card's name and power limit as nvidia-smi gives
them (a card set below its maximum power runs slower under load).
"""
from __future__ import annotations

import subprocess


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    read by a child process that stays off JAX; 'not available' when
    nvidia-smi is absent or fails."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return r.stdout.strip() or "not available"


def device_identity() -> dict:
    """platform / kind / count of JAX's default backend + the card line."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_name_and_power_limit()}
