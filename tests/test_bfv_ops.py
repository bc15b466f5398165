"""The BFV operations against exact oracles on the CPU.

* 8k_4q keygen / encrypt / decrypt against the exact-integer golden
  pipeline fed the device's own draws (test_bfv.py does the same at 4k);
* the batched entry points against the per-message ones;
* the evaluator on a small generated set against exact plaintext
  arithmetic mod t;
* the three plaintext-modulus regimes end to end.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ntt_bfv.models import bfv, encoder
from ntt_bfv.ops import sampling
from ntt_bfv.params import get_bfv_params
from ntt_bfv.utils import golden, primegen


@pytest.fixture(scope="module")
def ctx8k():
    return bfv.BFVContext.build(get_bfv_params("8k_4q"))


def _tabs(p):
    tabs = [p.psi_tables(i) for i in range(p.r)]
    return [t[0] for t in tabs], [t[1] for t in tabs]


def test_keygen_golden_8k(ctx8k):
    p = ctx8k.params
    s, a, e = sampling.keygen_draws(p.n, p.r, ctx8k.ms_full, nonce=3)
    sk, pk = ctx8k.keygen(nonce=3)
    sk_g, pk0_g, pk1_g = golden.keygen(
        p, np.asarray(s).tolist(), np.asarray(a).tolist(),
        np.asarray(e).tolist(), *_tabs(p))
    np.testing.assert_array_equal(np.asarray(sk), np.array(sk_g, np.uint64))
    np.testing.assert_array_equal(np.asarray(pk[0]),
                                  np.array(pk0_g, np.uint64))
    np.testing.assert_array_equal(np.asarray(pk[1]),
                                  np.array(pk1_g, np.uint64))


def test_encrypt_golden_8k(ctx8k, rng):
    p = ctx8k.params
    _, pk = ctx8k.keygen()
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx8k.encrypt(pk, jnp.asarray(m), nonce=9)
    u, e0, e1 = sampling.encrypt_draws(
        p.n, p.r, ctx8k.ms_full, nonce=sampling.encrypt_nonce(9))
    ct_g = golden.encrypt(
        p, np.asarray(pk[0]).tolist(), np.asarray(pk[1]).tolist(),
        m.tolist(), np.asarray(u).tolist(), np.asarray(e0).tolist(),
        np.asarray(e1).tolist(), *_tabs(p))
    np.testing.assert_array_equal(np.asarray(ct[0]),
                                  np.array(ct_g[0], np.uint64))
    np.testing.assert_array_equal(np.asarray(ct[1]),
                                  np.array(ct_g[1], np.uint64))


def test_decrypt_golden_8k(ctx8k, rng):
    p = ctx8k.params
    sk, pk = ctx8k.keygen()
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx8k.encrypt(pk, jnp.asarray(m), nonce=4)
    m_g = golden.decrypt(p, np.asarray(ct[0]).tolist(),
                         np.asarray(ct[1]).tolist(),
                         np.asarray(sk).tolist(), *_tabs(p))
    out = np.asarray(ctx8k.decrypt(sk, ct))
    np.testing.assert_array_equal(out, np.array(m_g, np.uint64))
    np.testing.assert_array_equal(out, m)


# ---------------------------------------------------------------------------
# Batched entry points and the evaluator on a small generated set.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    p = primegen.make_bfv_params(1024, 50, 4)
    ctx = bfv.BFVContext.build(p)
    sk, pk = ctx.keygen(nonce=1)
    return p, ctx, sk, pk


def _neg_t(a, b, t, n):
    return np.array(golden.schoolbook_negacyclic(
        [int(v) for v in a], [int(v) for v in b], t, n), dtype=np.uint64)


def test_encrypt_batch_matches_single(small, rng):
    p, ctx, sk, pk = small
    mb = rng.integers(0, p.t, (3, p.n), dtype=np.uint64)
    nonces = np.array([5, 6, 7], np.uint64)
    cts = np.asarray(ctx.encrypt_batch(pk, jnp.asarray(mb), nonces))
    assert cts.shape == (3, 2, p.r - 1, p.n)
    for j in range(3):
        one = np.asarray(ctx.encrypt(pk, jnp.asarray(mb[j]),
                                     nonce=int(nonces[j])))
        np.testing.assert_array_equal(cts[j], one)


def test_decrypt_batch_matches_single(small, rng):
    p, ctx, sk, pk = small
    mb = rng.integers(0, p.t, (3, p.n), dtype=np.uint64)
    cts = ctx.encrypt_batch(pk, jnp.asarray(mb),
                            np.array([8, 9, 10], np.uint64))
    out = np.asarray(ctx.decrypt_batch(sk, cts))
    np.testing.assert_array_equal(out, mb)
    for j in range(3):
        np.testing.assert_array_equal(
            out[j], np.asarray(ctx.decrypt(sk, cts[j])))


@pytest.fixture(scope="module")
def small_rlk(small):
    p, ctx, sk, pk = small
    return ctx.relin_keygen(sk, nonce=2)


def test_mul_exact(small, small_rlk, rng):
    p, ctx, sk, pk = small
    m1, m2 = rng.integers(0, p.t, (2, p.n), dtype=np.uint64)
    ct = ctx.mul(ctx.encrypt(pk, m1, nonce=11), ctx.encrypt(pk, m2, nonce=12),
                 rlk=small_rlk)
    np.testing.assert_array_equal(np.asarray(ctx.decrypt(sk, ct)),
                                  _neg_t(m1, m2, p.t, p.n))


def test_square_exact(small, small_rlk, rng):
    p, ctx, sk, pk = small
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx.encrypt(pk, m, nonce=13)
    sq = ctx.square(ct, rlk=small_rlk)
    np.testing.assert_array_equal(np.asarray(ctx.decrypt(sk, sq)),
                                  _neg_t(m, m, p.t, p.n))
    np.testing.assert_array_equal(np.asarray(sq),
                                  np.asarray(ctx.mul(ct, ct, rlk=small_rlk)))


def test_galois_exact(small, rng):
    p, ctx, sk, pk = small
    g = 5
    gk = ctx.galois_keygen(sk, [g], nonce=3)[g]
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    out = np.asarray(ctx.decrypt(sk, ctx.apply_galois(
        ctx.encrypt(pk, m, nonce=14), g, gk)))
    # tau_g(m)[j*g mod 2n] = m[j], negated where j*g wraps past n
    exp = np.zeros(p.n, np.uint64)
    for j in range(p.n):
        k = (j * g) % (2 * p.n)
        exp[k % p.n] = m[j] if k < p.n else (p.t - m[j]) % p.t
    np.testing.assert_array_equal(out, exp)


def test_mod_switch_exact(small, rng):
    p, ctx, sk, pk = small
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx.encrypt(pk, m, nonce=15)
    sw = ctx.mod_switch_to_next(ct)
    assert sw.shape == (2, p.r - 2, p.n)
    np.testing.assert_array_equal(
        np.asarray(ctx.next_context().decrypt(sk, sw)), m)


def test_noise_budget_shrinks_under_mul(small, small_rlk, rng):
    p, ctx, sk, pk = small
    m1, m2 = rng.integers(0, p.t, (2, p.n), dtype=np.uint64)
    ct = ctx.encrypt(pk, m1, nonce=16)
    fresh = ctx.noise_budget(sk, ct)
    prod = ctx.mul(ct, ctx.encrypt(pk, m2, nonce=17), rlk=small_rlk)
    after = ctx.noise_budget(sk, prod)
    q_bits = sum(q.bit_length() for q in p.q[:-1])
    t_bits = p.t.bit_length()
    assert 0 < after < fresh < q_bits - t_bits + 1


def test_add_plain_exact(small, rng):
    p, ctx, sk, pk = small
    m1, m2 = rng.integers(0, p.t, (2, p.n), dtype=np.uint64)
    ct = ctx.add_plain(ctx.encrypt(pk, m1, nonce=18), m2)
    np.testing.assert_array_equal(np.asarray(ctx.decrypt(sk, ct)),
                                  (m1 + m2) % p.t)


def test_mul_plain_exact(small, rng):
    p, ctx, sk, pk = small
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    small_poly = np.zeros(p.n, np.uint64)
    small_poly[[0, 3, p.n - 1]] = [2, 1, 3]
    ct = ctx.mul_plain(ctx.encrypt(pk, m, nonce=19), small_poly)
    np.testing.assert_array_equal(np.asarray(ctx.decrypt(sk, ct)),
                                  _neg_t(m, small_poly, p.t, p.n))


# ---------------------------------------------------------------------------
# Plaintext-modulus regimes: power of two (the reference), odd prime below
# 2^31 (batching), odd at or above 2^31.
# ---------------------------------------------------------------------------

def _regime_params(kind):
    n = 1024
    if kind == "pow2":
        # a power of two t <= 2n keeps q === 1 mod t (Delta embedding)
        return primegen.make_bfv_params(n, 50, 4, t=2 * n)
    if kind == "prime_small":
        return primegen.make_bfv_params(n, 50, 4,
                                        t=primegen.find_plain_modulus(n, 20))
    return primegen.make_bfv_params(n, 60, 4,
                                    t=primegen.find_plain_modulus(n, 33))


@pytest.mark.parametrize("kind", ["pow2", "prime_small", "prime_large"])
def test_plaintext_modulus_regimes(kind, rng):
    p = _regime_params(kind)
    assert (p.t & (p.t - 1) == 0) == (kind == "pow2")
    assert (p.t >= 1 << 31) == (kind == "prime_large")
    ctx = bfv.BFVContext.build(p)
    sk, pk = ctx.keygen(nonce=4)
    m1, m2 = rng.integers(0, p.t, (2, p.n), dtype=np.uint64)
    c1 = ctx.encrypt(pk, m1, nonce=20)
    c2 = ctx.encrypt(pk, m2, nonce=21)
    np.testing.assert_array_equal(np.asarray(ctx.decrypt(sk, c1)), m1)
    np.testing.assert_array_equal(
        np.asarray(ctx.decrypt(sk, ctx.add(c1, c2))),
        ((m1.astype(object) + m2.astype(object)) % p.t).astype(np.uint64))
    if kind != "pow2":
        enc = encoder.BatchEncoder(p)
        v = rng.integers(0, p.t, p.n, dtype=np.uint64)
        ct = ctx.encrypt(pk, enc.encode(v), nonce=22)
        np.testing.assert_array_equal(
            np.asarray(enc.decode(ctx.decrypt(sk, ct))), v)
