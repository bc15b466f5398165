"""Vectorized 60-bit modular arithmetic on u64 arrays.

Redesign of the reference's device arithmetic (`BFV_Scheme/uint128.h`
mul64/sub128 PTX + `ntt_60bit.cuh:44-61` singleBarrett).  Two deliberate
departures, both bit-identical on outputs:

1. **Plain u64 array ops instead of PTX 32-bit limbs.**  The high half of
   the 128-bit product is built from four u64 multiplies of 32-bit halves
   (`mulhi_u64`), which XLA can lower on every backend; how each backend's
   compiler lowers them is for a profile to show.  The CUDA NTT kernel
   (ntt_bfv/cuda) uses `__umul64hi` for the same value.

2. **Montgomery (R = 2^64) instead of Barrett.**  The reference's Barrett
   uses per-modulus *variable* 128-bit shifts (qbit-2 / qbit+2); Montgomery
   REDC needs only limb-aligned fixed shifts.  With one operand pre-scaled by R (twiddle tables and
   per-modulus scalar constants), ``mont_mul(a, bR) == a*b mod q`` exactly,
   so every stored value matches the reference's Barrett result bit-for-bit
   (both are the true product mod q).

All functions broadcast: residue tensors put the coefficient axis last and
the RNS-modulus axis second-to-last; per-modulus constants are passed with
shape (r, 1) (or any broadcast-compatible shape).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import params as params_mod
from ..utils import hostmath as hm

U64 = jnp.uint64
_32 = jnp.uint64(32)
_MASK32 = jnp.uint64(0xFFFFFFFF)


def mulhi_u64(a, b):
    """High 64 bits of the 128-bit product a*b (reference: mul64,
    uint128.h:353-373 — there via PTX mad.cc carry chains, here via
    32-bit-half cross products in u64 lanes)."""
    a0 = a & _MASK32
    a1 = a >> _32
    b0 = b & _MASK32
    b1 = b >> _32
    p01 = a0 * b1
    p10 = a1 * b0
    mid = ((a0 * b0) >> _32) + (p01 & _MASK32) + (p10 & _MASK32)
    return a1 * b1 + (p01 >> _32) + (p10 >> _32) + (mid >> _32)


def mont_mul(a, b_mont, q, qinv_neg):
    """Montgomery product: a * b_mont * 2^-64 mod q, result in [0, q).

    Valid for any u64 `a` and `b_mont < q` (or vice versa): the 128-bit
    product stays below q * 2^64.  `qinv_neg` = -q^-1 mod 2^64.

    REDC carry trick: low64(m*q) == -low64(a*b) mod 2^64 by construction,
    so the carry out of the low halves is simply (low64(a*b) != 0).
    """
    t_lo = a * b_mont
    t_hi = mulhi_u64(a, b_mont)
    m = t_lo * qinv_neg
    t = t_hi + mulhi_u64(m, q) + (t_lo != 0).astype(U64)
    return t - q * (t >= q).astype(U64)


def mulmod(a, b, q, qinv_neg, r2):
    """Exact a*b mod q for two runtime operands (a, b < 2^64, b < q):
    lift a into Montgomery form via r2 = 2^128 mod q, then one REDC.
    Plays the role of the dyadic `barrett` kernels
    (poly_arithmetic.cuh:9-98)."""
    return mont_mul(mont_mul(a, r2, q, qinv_neg), b, q, qinv_neg)


def add_mod(a, b, q):
    """(a + b) mod q for a, b in [0, q) (reference butterfly add,
    ntt_60bit.cuh:102-104: `target_result -= q * (target_result >= q)`)."""
    s = a + b
    return s - q * (s >= q).astype(U64)


def add_mod_lazy_gt(a, b, q):
    """poly_add's `if (ra > q) ra -= q` quirk (poly_arithmetic.cuh:143-153):
    a sum equal to exactly q is NOT reduced.  Preserved bit-for-bit because
    the reference's golden ciphertext pipeline exercises it."""
    s = a + b
    return s - q * (s > q).astype(U64)


def sub_mod(a, b, q):
    """(a - b) mod q for a, b in [0, q) (reference butterfly sub,
    ntt_60bit.cuh:108-110: conditional +q before subtract)."""
    return a + q * (a < b).astype(U64) - b


def halve_mod(x, q):
    """x * 2^-1 mod q for x in [0, q): `(x>>1) + ((q+1)>>1)*(x&1)`
    (GS lazy halving, ntt_60bit.cuh:132,166)."""
    q2 = (q + jnp.uint64(1)) >> jnp.uint64(1)
    return (x >> jnp.uint64(1)) + q2 * (x & jnp.uint64(1))


def negate_mod(x, q):
    """q - x with 0 fixup (poly_negate, poly_arithmetic.cuh:332-338)."""
    r = q - x
    return r * (r != q).astype(U64)


def add_negate_mod(a, b, q):
    """-(a + b) mod q fused (poly_add_negate_xq, bfv_keygen.cuh:81-93)."""
    s = a + b
    s = s - q * (s >= q).astype(U64)
    r = q - s
    return r * (r != q).astype(U64)


def mod_u64(x, q, nu):
    """x mod q for arbitrary u64 x, via one mulhi with nu = floor(2^64 / q).

    est = floor(x*nu / 2^64) satisfies x/q - 2 < est <= x/q, so one
    conditional subtract suffices.  Replaces the reference's long-division
    `%` operator (uint128.h:278-312) and the in-kernel `% base_q_i`
    (poly_arithmetic.cuh:185)."""
    est = mulhi_u64(x, nu)
    r = x - est * q
    return r - q * (r >= q).astype(U64)


# ---------------------------------------------------------------------------
# Device-resident per-modulus constant bundle.
#
# Plays the role of the reference's `__constant__` banks q_cons / mu_cons /
# q_bit_cons (ntt_60bit.cuh:8-13): a small set of per-modulus scalars
# broadcast to every lane.  Shapes are (r, 1) so they broadcast against
# (..., r, n) residue tensors.
# ---------------------------------------------------------------------------


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["q", "qinv_neg", "r2", "nu", "r1"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class ModulusSet:
    q: jax.Array        # (r, 1) u64 moduli
    qinv_neg: jax.Array  # (r, 1) -q^-1 mod 2^64
    r2: jax.Array       # (r, 1) 2^128 mod q
    nu: jax.Array       # (r, 1) floor(2^64 / q)
    r1: jax.Array       # (r, 1) 2^64 mod q (Montgomery one)

    @property
    def r(self) -> int:
        return self.q.shape[0]

    @staticmethod
    def from_moduli(qs) -> "ModulusSet":
        qs = [int(q) for q in qs]
        col = lambda vals: np.array(vals, dtype=np.uint64).reshape(-1, 1)
        return ModulusSet(
            q=jnp.asarray(col(qs)),
            qinv_neg=jnp.asarray(col([hm.mont_qinv_neg(q) for q in qs])),
            r2=jnp.asarray(col([hm.mont_r2(q) for q in qs])),
            nu=jnp.asarray(col([(1 << 64) // q for q in qs])),
            r1=jnp.asarray(col([hm.mont_r1(q) for q in qs])),
        )

    def mont_mul(self, a, b_mont):
        return mont_mul(a, b_mont, self.q, self.qinv_neg)

    def mulmod(self, a, b):
        return mulmod(a, b, self.q, self.qinv_neg, self.r2)

    def mod(self, x):
        return mod_u64(x, self.q, self.nu)


def modulus_set(params: params_mod.BFVParams, count: int | None = None) -> ModulusSet:
    """ModulusSet over the first `count` moduli of a BFV parameter set."""
    qs = params.q if count is None else params.q[:count]
    return ModulusSet.from_moduli(qs)
