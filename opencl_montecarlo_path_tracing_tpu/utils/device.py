"""What a measurement runs on, and where compiled programs are cached.

Every timing this repository prints names its device: JAX's view
(platform, device kind, device count) and, on an NVIDIA card, the name
and power limit ``nvidia-smi`` reports, because a card set below its
maximum power runs slower under load.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import jax

# the checkout root: the directory holding the package
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def configure_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache``: the path is part of what a later run looks
    up, so it must not move between runs."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def nvidia_smi() -> str | None:
    """``name, power.limit`` of each card as nvidia-smi reports them
    (one line per card), or None where there is no nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_info() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    card's name and power limit (``card``, None off NVIDIA hardware)."""
    devs = jax.devices()
    smi = nvidia_smi()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs),
            "card": smi.splitlines()[0] if smi else None}
