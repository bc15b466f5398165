"""Negacyclic NTT / inverse NTT over u64 lanes (XLA path).

Implements the reference's merged negacyclic transform with identical index
algebra (ntt_60bit.cuh:63-265): CT forward (natural in, bit-reversed out,
twiddle = psi_powers[length + psi_step] from a bit-reverse-ordered table),
GS inverse with lazy halving that folds n^-1 into the stages.  Twiddle
tables are pre-scaled to Montgomery form so every butterfly is a single
REDC (see ops/modmath.py).

Where the reference schedules stages as separate kernel launches vs. a
fused shared-memory kernel (the paper's D5 hybrid, ntt_60bit.cuh:267-386),
this XLA path expresses each stage as a reshape + vector ops inside one
jit: XLA owns the fusion.  `ntt_forward` / `ntt_inverse` are the one NTT
entry of the library: tables built on a GPU route it to the hand-written
CUDA kernel (ntt_bfv/cuda, bit-identical), everywhere else to the
stage loop here, which stays the plain reference.  The multi-chip
coefficient-sharded version lives in parallel/sharded.py.

Shapes: transforms operate on the last axis; the RNS-modulus axis is
second-to-last.  x: (..., r, n); tables: (r, n); ModulusSet constants (r, 1).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import cuda
from ..utils import hostmath as hm
from . import modmath
from .modmath import ModulusSet

U64 = jnp.uint64


# ---------------------------------------------------------------------------
# Twiddle-table construction (host, exact ints).
# ---------------------------------------------------------------------------

def bitrev_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    v = np.arange(n, dtype=np.int64)
    r = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        r = (r << 1) | ((v >> b) & 1)
    return r


def _power_table(base: int, q: int, n: int) -> np.ndarray:
    """Natural-order powers base^0..base^(n-1) mod q, exact ints."""
    out = np.empty(n, dtype=np.uint64)
    v = 1
    for i in range(n):
        out[i] = v
        v = (v * base) % q
    return out


@functools.lru_cache(maxsize=64)
def _psi_tables_cached(psi: int, psiinv: int, q: int, n: int):
    perm = bitrev_perm(n)
    tbl = _power_table(psi, q, n)[perm]
    tbl_inv = _power_table(psiinv, q, n)[perm]
    # Montgomery-scaled copies (x * 2^64 mod q), exact ints.
    scale = lambda t: np.array([(int(x) << 64) % q for x in t], dtype=np.uint64)
    return tbl, tbl_inv, scale(tbl), scale(tbl_inv)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["psi_mont", "psiinv_mont"],
    meta_fields=["n", "kernel"],
)
@dataclasses.dataclass(frozen=True)
class NTTTables:
    """Bit-reverse-ordered psi/psiinv power tables, Montgomery-scaled,
    stacked over the RNS axis: (r, n) u64.  The device analog of the
    reference's psi_table_device / psiinv_table_device (demo.cu:186-196).

    `kernel` says whether transforms with these tables run the CUDA
    kernel; `build` decides it from the platform the tables were placed
    on and from n (cuda.selected)."""

    psi_mont: jax.Array
    psiinv_mont: jax.Array
    n: int
    kernel: bool = False

    @staticmethod
    def build(qs, psis, n: int, kernel: bool | None = None) -> "NTTTables":
        fwd, inv = [], []
        for q, psi in zip(qs, psis):
            psiinv = hm.modinv(int(psi), int(q))
            _, _, f_m, i_m = _psi_tables_cached(int(psi), psiinv, int(q), n)
            fwd.append(f_m)
            inv.append(i_m)
        psi_mont = jnp.asarray(np.stack(fwd))
        if kernel is None:
            platform = next(iter(psi_mont.devices())).platform
            kernel = cuda.selected(n, platform)
        return NTTTables(psi_mont=psi_mont,
                         psiinv_mont=jnp.asarray(np.stack(inv)),
                         n=n, kernel=kernel)


def tables_for(params, count: int | None = None,
               kernel: bool | None = None) -> NTTTables:
    qs = params.q if count is None else params.q[:count]
    psis = params.psi if count is None else params.psi[:count]
    return NTTTables.build(qs, psis, params.n, kernel=kernel)


# ---------------------------------------------------------------------------
# Transforms.
# ---------------------------------------------------------------------------

def _const_for(c: jax.Array, tail_ndim: int) -> jax.Array:
    """Reshape an (r, 1) constant to (r, 1, ..., 1) with `tail_ndim` ones so
    it broadcasts against (..., r, *tail)."""
    return c.reshape((c.shape[0],) + (1,) * tail_ndim)


def ntt_forward(x: jax.Array, tables: NTTTables, ms: ModulusSet) -> jax.Array:
    """Forward negacyclic NTT on the last axis. Natural order in,
    bit-reversed order out; values stay in [0, q)."""
    if tables.kernel:
        return cuda.forward(x, tables.psi_mont, ms.q, ms.qinv_neg)
    return forward_stages(x, tables, ms)


def ntt_inverse(x: jax.Array, tables: NTTTables, ms: ModulusSet) -> jax.Array:
    """Inverse negacyclic NTT on the last axis. Bit-reversed order in,
    natural order out."""
    if tables.kernel:
        return cuda.inverse(x, tables.psiinv_mont, ms.q, ms.qinv_neg)
    return inverse_stages(x, tables, ms)


def forward_stages(x: jax.Array, tables: NTTTables,
                   ms: ModulusSet) -> jax.Array:
    """The forward transform as an XLA stage loop (the plain reference)."""
    n = tables.n
    logn = n.bit_length() - 1
    shape = x.shape
    lead = shape[:-1]
    q2 = _const_for(ms.q, 2)
    qi2 = _const_for(ms.qinv_neg, 2)
    for s in range(logn):
        length = 1 << s
        step = n >> (s + 1)
        xr = x.reshape(lead + (length, 2, step))
        u = xr[..., 0, :]
        v = xr[..., 1, :]
        psi = jax.lax.slice_in_dim(tables.psi_mont, length, 2 * length, axis=-1)
        psi = psi[..., :, None]  # (r, length, 1)
        t = modmath.mont_mul(v, psi, q2, qi2)
        nu = modmath.add_mod(u, t, q2)
        nv = modmath.sub_mod(u, t, q2)
        x = jnp.stack([nu, nv], axis=-2).reshape(shape)
    return x


def inverse_stages(x: jax.Array, tables: NTTTables,
                   ms: ModulusSet) -> jax.Array:
    """The inverse transform as an XLA stage loop.  The per-stage lazy
    halving folds in n^-1 (GSBasedINTT*, ntt_60bit.cuh:125-190)."""
    n = tables.n
    logn = n.bit_length() - 1
    shape = x.shape
    lead = shape[:-1]
    q2 = _const_for(ms.q, 2)
    qi2 = _const_for(ms.qinv_neg, 2)
    for s in reversed(range(logn)):
        length = 1 << s
        step = n >> (s + 1)
        xr = x.reshape(lead + (length, 2, step))
        u = xr[..., 0, :]
        v = xr[..., 1, :]
        psiinv = jax.lax.slice_in_dim(tables.psiinv_mont, length, 2 * length, axis=-1)
        psiinv = psiinv[..., :, None]
        s_ = modmath.add_mod(u, v, q2)
        d_ = modmath.mont_mul(modmath.sub_mod(u, v, q2), psiinv, q2, qi2)
        nu = modmath.halve_mod(s_, q2)
        nv = modmath.halve_mod(d_, q2)
        x = jnp.stack([nu, nv], axis=-2).reshape(shape)
    return x


def dyadic_mul(a: jax.Array, b: jax.Array, ms: ModulusSet) -> jax.Array:
    """Pointwise a*b mod q in the NTT domain (barrett_batch,
    poly_arithmetic.cuh:36-66)."""
    q = _const_for(ms.q, 1)
    return modmath.mulmod(a, b, q, _const_for(ms.qinv_neg, 1), _const_for(ms.r2, 1))


def negacyclic_polymul(a, b, tables: NTTTables, ms: ModulusSet):
    """full_poly_mul composition (poly_arithmetic.cuh:277-294):
    INTT(NTT(a) . NTT(b))."""
    fa = ntt_forward(a, tables, ms)
    fb = ntt_forward(b, tables, ms)
    return ntt_inverse(dyadic_mul(fa, fb, ms), tables, ms)


# Jitted entry points.  The stage loops above trace to one XLA computation;
# calling them eagerly would compile each tiny op separately (hundreds of
# compilations).  Always use these from user code and tests.
ntt_forward_jit = jax.jit(ntt_forward)
ntt_inverse_jit = jax.jit(ntt_inverse)
dyadic_mul_jit = jax.jit(dyadic_mul)
negacyclic_polymul_jit = jax.jit(negacyclic_polymul)
