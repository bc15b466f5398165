"""Host-side exact modular arithmetic in arbitrary-precision Python ints.

Re-design of the reference's host C++ helpers
(`BFV_Scheme/helper.h:8-70`, `BFV_Scheme/uint128.h:314-341`): where the
reference emulates 128-bit integers with two u64 limbs and schoolbook
shift-add multiplication (`host64x2`), we simply use Python's
arbitrary-precision ints at parameter-generation/trace time.  Nothing in
this module runs on device.
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1


def modpow(a: int, b: int, mod: int) -> int:
    """a**b mod `mod` (reference: modpow128, helper.h:8-28)."""
    return pow(a, b, mod)


def modinv(a: int, q: int) -> int:
    """Inverse of `a` mod prime `q` via Fermat (reference: modinv128, helper.h:52-56)."""
    return pow(a, q - 2, q)


def bit_reverse(a: int, bit_length: int) -> int:
    """Reverse the low `bit_length` bits of `a` (reference: bitReverse, helper.h:58-70)."""
    res = 0
    for _ in range(bit_length):
        res = (res << 1) | (a & 1)
        a >>= 1
    return res


def mu_barrett(q: int, qbit: int) -> int:
    """Barrett constant mu = floor(2^(2*qbit) / q) (reference: demo.cu:156-165)."""
    return (1 << (2 * qbit)) // q


def q_bit_length(q: int) -> int:
    """Bit length as the reference computes it: log2((double)q) + 1.

    For the NTT-friendly primes used here this equals Python's
    ``q.bit_length()`` (reference: demo.cu:67-71).
    """
    return q.bit_length()


# ---------------------------------------------------------------------------
# Montgomery constants (a design choice of this library).
#
# The reference reduces every 128-bit product with Barrett using
# per-modulus *variable* shifts (qbit-2 / qbit+2, ntt_60bit.cuh:44-61).
# The device arithmetic here uses Montgomery multiplication with R = 2^64
# instead, which needs only fixed limb-aligned shifts: with one
# operand pre-scaled by R, `REDC(a * bR)` returns exactly `a*b mod q` —
# bit-identical *outputs* to the reference's Barrett (both compute the true
# product mod q), with only limb-aligned fixed shifts on device.
# ---------------------------------------------------------------------------

R64 = 1 << 64


def mont_qinv_neg(q: int) -> int:
    """-q^{-1} mod 2^64 for Montgomery REDC (q odd)."""
    return (-pow(q, -1, R64)) & MASK64


def mont_r1(q: int) -> int:
    """R mod q = 2^64 mod q."""
    return R64 % q


def mont_r2(q: int) -> int:
    """R^2 mod q = 2^128 mod q (used to lift runtime operands)."""
    return (R64 * R64) % q


def to_mont(x: int, q: int) -> int:
    """x * R mod q."""
    return (x << 64) % q


def psi_tables(psi: int, psiinv: int, q: int, n: int) -> tuple[list[int], list[int]]:
    """Bit-reversed-ordered power tables of psi and psi^-1.

    Matches the reference's ``fillTablePsi128`` (parameter.h:5-12):
    ``table[i] = psi ** bit_reverse(i, log2 n) mod q``.  This ordering is
    what lets the merged negacyclic NTT address its twiddle as
    ``psi_powers[length + psi_step]``.
    """
    if q < (1 << 61):
        from .. import native
        if native.available():
            return ([int(x) for x in native.fill_bitrev_powers(psi, q, n)],
                    [int(x) for x in native.fill_bitrev_powers(psiinv, q, n)])
    logn = n.bit_length() - 1
    tbl = [pow(psi, bit_reverse(i, logn), q) for i in range(n)]
    tbl_inv = [pow(psiinv, bit_reverse(i, logn), q) for i in range(n)]
    return tbl, tbl_inv
