"""ctypes loader for the native host-math runtime (ntt_host.cpp).

Compiles the C++ source with g++ on first use (the image ships a native
toolchain but no pybind11; the C ABI + ctypes is the binding layer).  The
shared object is cached next to the source and rebuilt when the source
changes.  Every caller must tolerate `load() is None` and fall back to the
pure-Python implementations in utils/hostmath.py — the native layer is an
accelerator, not a dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
_SRC = _DIR / "ntt_host.cpp"
_LIB: ctypes.CDLL | None = None
_TRIED = False

u64 = ctypes.c_uint64
u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")


def _build() -> Path | None:
    src_hash = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _DIR / f"libntt_host-{src_hash}.so"
    if so.exists():
        return so
    # clear stale builds
    for old in _DIR.glob("libntt_host-*.so"):
        try:
            old.unlink()
        except OSError:
            pass
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
             "-o", str(so), str(_SRC)],
            check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None
    return so if so.exists() else None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.nh_mulmod.restype = u64
    lib.nh_mulmod.argtypes = [u64, u64, u64]
    lib.nh_modpow.restype = u64
    lib.nh_modpow.argtypes = [u64, u64, u64]
    lib.nh_modinv.restype = u64
    lib.nh_modinv.argtypes = [u64, u64]
    lib.nh_bitrev.restype = u64
    lib.nh_bitrev.argtypes = [u64, ctypes.c_int]
    lib.nh_shoup.restype = u64
    lib.nh_shoup.argtypes = [u64, u64]
    lib.nh_barrett_mu.restype = u64
    lib.nh_barrett_mu.argtypes = [u64, ctypes.c_int]
    lib.nh_fill_bitrev_powers.restype = None
    lib.nh_fill_bitrev_powers.argtypes = [u64, u64, u64, u64p]
    lib.nh_geometric_row.restype = None
    lib.nh_geometric_row.argtypes = [u64, u64, u64, u64p]
    lib.nh_schoolbook_negacyclic.restype = None
    lib.nh_schoolbook_negacyclic.argtypes = [u64p, u64p, u64, u64, u64p]
    lib.nh_salsa20_keystream.restype = None
    lib.nh_salsa20_keystream.argtypes = [u32p, u32p, u64, u64, u32p]
    return lib


def load() -> ctypes.CDLL | None:
    """The bound CDLL, or None when the native build is unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("NTT_NO_NATIVE"):
        return None
    so = _build()
    if so is None:
        return None
    try:
        _LIB = _bind(ctypes.CDLL(str(so)))
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return load() is not None


# ---------------------------------------------------------------------------
# NumPy-typed convenience wrappers (None-safe callers should check
# available() first or use the utils/hostmath.py dispatchers).
# ---------------------------------------------------------------------------

def fill_bitrev_powers(base: int, q: int, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.uint64)
    load().nh_fill_bitrev_powers(base, q, n, out)
    return out


def geometric_row(g: int, q: int, count: int) -> np.ndarray:
    out = np.empty(count, dtype=np.uint64)
    load().nh_geometric_row(g, q, count, out)
    return out


def schoolbook_negacyclic(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    out = np.empty_like(a)
    load().nh_schoolbook_negacyclic(a, b, q, a.size, out)
    return out


def salsa20_keystream(key: bytes, nonce: bytes, nbytes: int,
                      counter0: int = 0) -> bytes:
    nblocks = (nbytes + 63) // 64
    key8 = np.frombuffer(key.ljust(32, b"\0")[:32], dtype=np.uint32).copy()
    nonce2 = np.frombuffer(nonce.ljust(8, b"\0")[:8], dtype=np.uint32).copy()
    out = np.empty(16 * nblocks, dtype=np.uint32)
    load().nh_salsa20_keystream(key8, nonce2, counter0, nblocks, out)
    return out.tobytes()[:nbytes]
