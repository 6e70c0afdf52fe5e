"""Native (C++) runtime components, loaded via ctypes.

Built lazily with g++ on first use into the package's ``_build/``
directory; every consumer has a NumPy fallback so the package works
without a toolchain.
"""

from .host_rng import HostRandomGenerator, native_available

__all__ = ["HostRandomGenerator", "native_available"]
