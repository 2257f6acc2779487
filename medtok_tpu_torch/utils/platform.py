"""Process set-up of the port's entry points (counterpart of
``medtok_tpu/utils/platform.py``). The JAX version also selects JAX's
platform from the environment; the port's CLIs take ``--device`` instead,
so what is left is the allocator setting every CLI applies first thing.
"""

from __future__ import annotations


def tune_malloc() -> bool:
    """Keep freed large allocations on the glibc heap instead of returning
    them to the OS (mallopt M_MMAP_THRESHOLD / M_TRIM_THRESHOLD at 1 GiB).

    Large numpy temporaries that glibc serves through mmap / munmap fault
    their pages in afresh on every step; with both thresholds raised a freed
    buffer stays warm on the heap for the next one. Returns whether both
    settings took; a no-op returning False off glibc."""
    import ctypes

    try:
        libc = ctypes.CDLL(None, use_errno=True)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
    ok = mallopt(M_MMAP_THRESHOLD, 1 << 30)
    ok &= mallopt(M_TRIM_THRESHOLD, 1 << 30)
    return bool(ok)


def apply_platform_env() -> None:
    """What the port's CLIs run first thing: ``tune_malloc``."""
    tune_malloc()
