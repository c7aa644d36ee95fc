"""Process set-up shared by the entry scripts: the persistent compile
cache and the accelerator check of measurement paths."""

from __future__ import annotations

import os
import sys

#: Repository root (the package's parent directory).
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, otherwise the fixed
    ``<repo>/.jax_cache`` (the cache key includes the path, so a
    directory that moves never hits)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache at
    `compile_cache_dir()` and return it.  Exported through the
    environment too, so child processes share it."""
    path = compile_cache_dir()
    os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
    if "jax" in sys.modules:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(label: str):
    """Exit non-zero unless JAX's default device is a GPU: measurement
    paths never fall back to the CPU.  Returns the devices."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.stderr.write(
            f"{label}: needs a GPU, JAX found {devices[0].platform!r}\n"
        )
        sys.exit(2)
    return devices


__all__ = [
    "REPO_ROOT", "compile_cache_dir", "enable_compile_cache", "require_gpu",
]
