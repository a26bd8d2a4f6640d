"""Device set-up shared by the measurement entry points (bench.py,
chip_smoke.py): the persistent compile cache, the accelerator gate and
the card's identity line."""

from __future__ import annotations

import os
import subprocess

import jax

__all__ = [
    "CACHE_ENV",
    "checkout_root",
    "setup_compile_cache",
    "require_gpu",
    "gpu_identity",
    "device_record",
]

#: Environment variable that, when set, owns the compile-cache location.
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def checkout_root() -> str:
    """The directory that holds the ``ndsm_tpu`` package."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def setup_compile_cache(root: str | None = None) -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here.  Otherwise the cache goes to
    ``<checkout>/.jax_cache`` (ignored by git).  The path is part of the
    cache key, so it is never built from a temporary name, a process id
    or the time.  Call before the first compilation.  Returns the
    directory in use.
    """
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = os.path.join(root or checkout_root(), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> jax.Device:
    """Device 0 if it is a GPU; otherwise raise ``SystemExit`` with the
    reason.  Measurement paths never fall back to the CPU."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's device 0 is {d.platform!r} ({d.device_kind}); "
            "this entry point measures the accelerator and has no CPU mode"
        )
    return d


def gpu_identity() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (``name, power.limit``), or why they could not be read."""
    try:
        out = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=30,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {type(e).__name__}: {e}"
    if out.returncode != 0:
        return f"nvidia-smi failed (rc {out.returncode}): {out.stderr.strip()}"
    return out.stdout.strip()


def device_record() -> dict:
    """``platform``, ``kind`` and ``count`` of the visible devices, as
    JAX reports them."""
    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
    }
