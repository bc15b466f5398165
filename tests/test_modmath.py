"""Unit tests: u64 modular primitives vs exact Python-int arithmetic.

Model: the reference validates its device arithmetic against host
uint128 schoolbook math (60bit_ntt_test.cu + helper.h); here every lane op
is asserted against Python's arbitrary-precision ints.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ntt_bfv.ops import modmath
from ntt_bfv.params import get_bfv_params
from ntt_bfv.utils import hostmath as hm

QS = [
    68719403009,           # 37-bit (4k_3q)
    137438822401,
    36028797017456641,     # 55-bit
    18014398506729473,
    2305843009213683713,   # gamma, 61-bit
]


def _rand_u64(rng, k, lim=1 << 64):
    return rng.integers(0, lim, k, dtype=np.uint64) if lim == 1 << 64 else \
        rng.integers(0, lim, k, dtype=np.uint64)


def test_mulhi_u64(rng):
    a = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    got = np.asarray(modmath.mulhi_u64(jnp.asarray(a), jnp.asarray(b)))
    exp = np.array([(int(x) * int(y)) >> 64 for x, y in zip(a, b)], dtype=np.uint64)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("q", QS)
def test_mont_mul_exact(rng, q):
    qinv = hm.mont_qinv_neg(q)
    r2 = hm.mont_r2(q)
    a = rng.integers(0, 1 << 64, 2048, dtype=np.uint64)  # any u64
    b = rng.integers(0, q, 2048, dtype=np.uint64)        # < q
    bm = np.array([(int(x) << 64) % q for x in b], dtype=np.uint64)
    got = np.asarray(modmath.mont_mul(jnp.asarray(a), jnp.asarray(bm),
                                      jnp.uint64(q), jnp.uint64(qinv)))
    exp = np.array([(int(x) * int(y)) % q for x, y in zip(a, b)], dtype=np.uint64)
    np.testing.assert_array_equal(got, exp)
    # two-REDC runtime x runtime path
    got2 = np.asarray(modmath.mulmod(jnp.asarray(a), jnp.asarray(b),
                                     jnp.uint64(q), jnp.uint64(qinv), jnp.uint64(r2)))
    np.testing.assert_array_equal(got2, exp)


@pytest.mark.parametrize("q", QS)
def test_add_sub_halve(rng, q):
    a = rng.integers(0, q, 2048, dtype=np.uint64)
    b = rng.integers(0, q, 2048, dtype=np.uint64)
    qj = jnp.uint64(q)
    np.testing.assert_array_equal(
        np.asarray(modmath.add_mod(jnp.asarray(a), jnp.asarray(b), qj)),
        np.array([(int(x) + int(y)) % q for x, y in zip(a, b)], dtype=np.uint64))
    np.testing.assert_array_equal(
        np.asarray(modmath.sub_mod(jnp.asarray(a), jnp.asarray(b), qj)),
        np.array([(int(x) - int(y)) % q for x, y in zip(a, b)], dtype=np.uint64))
    inv2 = pow(2, q - 2, q)
    np.testing.assert_array_equal(
        np.asarray(modmath.halve_mod(jnp.asarray(a), qj)),
        np.array([(int(x) * inv2) % q for x in a], dtype=np.uint64))


def test_add_mod_gt_quirk():
    # sum exactly q stays q (reference poly_add `>` comparison)
    q = 101
    out = modmath.add_mod_lazy_gt(jnp.uint64(51), jnp.uint64(50), jnp.uint64(q))
    assert int(out) == q
    out2 = modmath.add_mod_lazy_gt(jnp.uint64(52), jnp.uint64(50), jnp.uint64(q))
    assert int(out2) == 1


@pytest.mark.parametrize("q", QS)
def test_mod_u64(rng, q):
    nu = (1 << 64) // q
    x = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    got = np.asarray(modmath.mod_u64(jnp.asarray(x), jnp.uint64(q), jnp.uint64(nu)))
    exp = np.array([int(v) % q for v in x], dtype=np.uint64)
    np.testing.assert_array_equal(got, exp)


def test_negate_and_add_negate(rng):
    q = 68719403009
    a = rng.integers(0, q, 1024, dtype=np.uint64)
    b = rng.integers(0, q, 1024, dtype=np.uint64)
    a[0] = 0
    got = np.asarray(modmath.negate_mod(jnp.asarray(a), jnp.uint64(q)))
    exp = np.array([(q - int(x)) % q for x in a], dtype=np.uint64)
    np.testing.assert_array_equal(got, exp)
    got2 = np.asarray(modmath.add_negate_mod(jnp.asarray(a), jnp.asarray(b), jnp.uint64(q)))
    exp2 = np.array([(-(int(x) + int(y))) % q for x, y in zip(a, b)], dtype=np.uint64)
    np.testing.assert_array_equal(got2, exp2)


def test_modulus_set_shapes():
    p = get_bfv_params("4k_3q")
    ms = modmath.modulus_set(p)
    assert ms.q.shape == (3, 1)
    assert ms.r == 3
    x = jnp.asarray(np.arange(3 * 8, dtype=np.uint64).reshape(3, 8))
    y = ms.mod(x * jnp.uint64(1 << 40))
    assert y.shape == (3, 8)
    exp = np.array([[(i * (1 << 40)) % p.q[row] for i in range(row * 8, row * 8 + 8)]
                    for row in range(3)], dtype=np.uint64)
    np.testing.assert_array_equal(np.asarray(y), exp)


def test_poly_sub_correct(rng):
    """poly_sub is the CORRECT subtraction, not the reference's buggy
    kernel (poly_arithmetic.cuh:167-178 never subtracts b)."""
    import jax.numpy as jnp
    from ntt_bfv.ops import modmath as mm, poly
    from ntt_bfv.params import get_bfv_params
    p = get_bfv_params("4k_3q")
    ms = mm.modulus_set(p)
    a = np.stack([rng.integers(0, q, 64, dtype=np.uint64) for q in p.q])
    b = np.stack([rng.integers(0, q, 64, dtype=np.uint64) for q in p.q])
    got = np.asarray(poly.poly_sub(jnp.asarray(a), jnp.asarray(b), ms))
    expect = np.stack([(a[i].astype(object) - b[i].astype(object)) % p.q[i]
                       for i in range(p.r)]).astype(np.uint64)
    np.testing.assert_array_equal(got, expect)


def test_poly_add_scalar(rng):
    import jax.numpy as jnp
    from ntt_bfv.ops import modmath as mm, poly
    from ntt_bfv.params import get_bfv_params
    p = get_bfv_params("4k_3q")
    ms = mm.modulus_set(p)
    a = np.stack([rng.integers(0, q, 64, dtype=np.uint64) for q in p.q])
    c = 12345
    got = np.asarray(poly.poly_add_scalar(jnp.asarray(a), c, ms))
    expect = np.stack([(a[i].astype(object) + c) % p.q[i]
                       for i in range(p.r)]).astype(np.uint64)
    np.testing.assert_array_equal(got, expect)
