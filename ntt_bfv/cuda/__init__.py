"""The Hopper NTT kernel (ntt.cu): build, registration and JAX wrappers.

The CUDA source is compiled with `nvcc` for sm_90a on first use, into
`build/` beside it (gitignored), under a name keyed by a hash of the
source, and registered as two XLA FFI targets.  There is no fallback: on
a GPU a missing `nvcc` or a failed build raises.  Arrays on any other
platform take the XLA stage loop in ops/ntt.py, which the kernel matches
bit for bit (`selected`).

`schedule` and `model_forward` / `model_inverse` restate the kernel's
stage split and index algebra in NumPy, so the CPU tests can hold the
schedule to ops/ntt.py without a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

_DIR = Path(__file__).parent
_SOURCES = (_DIR / "ntt.cu",)
_BUILD = _DIR / "build"
_TARGETS = {"forward": ("ntt_cuda_forward", "NttForward"),
            "inverse": ("ntt_cuda_inverse", "NttInverse")}

# mirror the constants of ntt.cu's schedule()
MAX_SMEM_LOG = 14
MIN_SMEM_LOG = 10
MAX_K = 4
MAX_LOG = MAX_SMEM_LOG + MAX_K
TARGET_BLOCKS = 256

# Transform sizes at which the kernel replaces the XLA stage loop on a GPU:
# where it measured faster end to end on an H100 (PERF.md).  At
# n = 2^11 no BFV set runs and the transforms alone came out even, so the
# stage loop stays there.
KERNEL_SIZES = frozenset(1 << k for k in range(12, 17))

_REGISTERED = False


def selected(n: int, platform: str) -> bool:
    """Whether a transform of size n on `platform` runs this kernel."""
    return platform == "gpu" and n in KERNEL_SIZES


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("the CUDA NTT kernel needs nvcc (CUDA toolkit) to "
                       "build; none found on PATH or in /usr/local/cuda")


def library_path() -> Path:
    """Where the build of the current sources lives."""
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(jax.__version__.encode())
    return _BUILD / f"libntt_cuda-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless this source's build exists."""
    so = library_path()
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", str(tmp),
           *[str(s) for s in _SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    for old in _BUILD.glob("libntt_cuda-*.so"):
        if old != so:
            old.unlink(missing_ok=True)
    return so


def register() -> None:
    """Build (if needed), load and register the FFI targets, once."""
    global _REGISTERED
    if _REGISTERED:
        return
    lib = ctypes.cdll.LoadLibrary(str(build()))
    err = lib.NttInit()
    if err:
        raise RuntimeError(f"NttInit failed with CUDA error {err}")
    for name, symbol in _TARGETS.values():
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA")
    _REGISTERED = True


def _check(x, psi, q, qinv):
    r, n = psi.shape
    if x.dtype != jnp.uint64 or x.ndim < 2 or x.shape[-2:] != (r, n):
        raise ValueError(f"ntt kernel: x must be (..., {r}, {n}) uint64, got "
                         f"{x.shape} {x.dtype}")
    if n & (n - 1) or not 2 <= n <= 1 << MAX_LOG:
        raise ValueError(f"ntt kernel: n={n} is not a power of two in "
                         f"[2, 2^{MAX_LOG}]")
    if q.size != r or qinv.size != r:
        raise ValueError("ntt kernel: one modulus constant per table row")


def _call(which: str, x, psi, q, qinv):
    _check(x, psi, q, qinv)
    register()
    name, _ = _TARGETS[which]
    return jax.ffi.ffi_call(name, jax.ShapeDtypeStruct(x.shape, x.dtype))(
        x, psi, q, qinv)


def forward(x, psi_mont, q, qinv_neg):
    """Forward negacyclic NTT of every (..., r, n) row on the card."""
    return _call("forward", x, psi_mont, q, qinv_neg)


def inverse(x, psiinv_mont, q, qinv_neg):
    """Inverse negacyclic NTT of every (..., r, n) row on the card."""
    return _call("inverse", x, psiinv_mont, q, qinv_neg)


# ---------------------------------------------------------------------------
# NumPy model of the kernel's schedule (tests only need the CPU).
# ---------------------------------------------------------------------------

def schedule(n: int, rows: int) -> tuple[int, int]:
    """(K, logm) for `rows` transforms of size n: K leading stages in the
    global-memory pass, then sub-transforms of 2^logm coefficients in
    shared memory.  K grows past the shared-memory minimum until the
    rows' sub-transforms give TARGET_BLOCKS blocks (or sub-transforms
    reach 2^MIN_SMEM_LOG, or K reaches MAX_K)."""
    logn = n.bit_length() - 1
    k = max(0, logn - MAX_SMEM_LOG)
    while k < MAX_K and logn - k > MIN_SMEM_LOG and \
            (rows << k) < TARGET_BLOCKS:
        k += 1
    return k, logn - k


_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)


def _mulhi(a, b):
    a0, a1, b0, b1 = a & _M32, a >> _S32, b & _M32, b >> _S32
    p01, p10 = a0 * b1, a1 * b0
    mid = ((a0 * b0) >> _S32) + (p01 & _M32) + (p10 & _M32)
    return a1 * b1 + (p01 >> _S32) + (p10 >> _S32) + (mid >> _S32)


def _mont(a, b, q, qi):
    lo = a * b
    t = _mulhi(a, b) + _mulhi(lo * qi, q) + (lo != 0).astype(np.uint64)
    return np.where(t >= q, t - q, t)


def _add(a, b, q):
    s = a + b
    return np.where(s >= q, s - q, s)


def _sub(a, b, q):
    return a + np.where(a < b, q, np.uint64(0)) - b


def _halve(x, q):
    return (x >> np.uint64(1)) + ((q + np.uint64(1)) >> np.uint64(1)) \
        * (x & np.uint64(1))


def _bfly(u, v, w, q, qi, inverse):
    if inverse:
        return (_halve(_add(u, v, q), q),
                _halve(_mont(_sub(u, v, q), w, q, qi), q))
    t = _mont(v, w, q, qi)
    return _add(u, t, q), _sub(u, t, q)


def _model(x, tab, q, qi, inverse: bool):
    with np.errstate(over="ignore"):
        x = np.array(x, dtype=np.uint64)
        tab = np.asarray(tab, dtype=np.uint64)
        r, n = tab.shape
        shape = x.shape
        rows = x.reshape(-1, r, n)
        qc = np.asarray(q, np.uint64).reshape(1, r, 1)
        qic = np.asarray(qi, np.uint64).reshape(1, r, 1)
        K, logm = schedule(n, rows.shape[0] * r)
        H, m = 1 << K, 1 << logm

        def global_pass(y):
            y = y.reshape(y.shape[0], r, H, m)      # element j + t * m
            a = [y[:, :, t] for t in range(H)]
            for s in (range(K - 1, -1, -1) if inverse else range(K)):
                half = 1 << (K - s - 1)
                for t in range(H):
                    if t & half:
                        continue
                    w = tab[:, (1 << s) + (t >> (K - s))].reshape(1, r, 1)
                    a[t], a[t + half] = _bfly(a[t], a[t + half], w, qc,
                                              qic, inverse)
            return np.stack(a, axis=2).reshape(-1, r, n)

        def local_stages(y):
            y = y.reshape(y.shape[0], r, H, m)
            h = np.arange(H).reshape(H, 1)
            order = range(logm - 1, -1, -1) if inverse else range(logm)
            q4, qi4 = qc[..., None, None], qic[..., None, None]
            for s in order:
                L, step = 1 << s, m >> (s + 1)
                idx = (H + h) * L + np.arange(L).reshape(1, L)   # (H, L)
                w = tab[:, idx][None, ..., None]                  # (1,r,H,L,1)
                z = y.reshape(y.shape[:3] + (L, 2, step))
                u, v = _bfly(z[..., 0, :], z[..., 1, :], w, q4, qi4, inverse)
                y = np.stack([u, v], axis=-2).reshape(y.shape)
            return y.reshape(-1, r, n)

        if inverse:
            out = local_stages(rows)
            if K:
                out = global_pass(out)
        else:
            out = global_pass(rows) if K else rows
            out = local_stages(out)
        return out.reshape(shape)


def model_forward(x, psi_mont, q, qinv_neg):
    """NumPy replay of the kernel's forward schedule."""
    return _model(x, psi_mont, q, qinv_neg, inverse=False)


def model_inverse(x, psiinv_mont, q, qinv_neg):
    """NumPy replay of the kernel's inverse schedule."""
    return _model(x, psiinv_mont, q, qinv_neg, inverse=True)
