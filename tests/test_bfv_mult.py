"""Homomorphic multiplication (EvalMult) + relinearization end-to-end.

The oracle is the schoolbook negacyclic product mod t — multiplication is
beyond the reference (it stops at encrypt/decrypt), so correctness is
anchored to the scheme contract decrypt(mul(E(m1), E(m2))) == m1*m2 in
R_t, exercised through the same keygen/encrypt/decrypt pipelines that ARE
bit-exact against the reference's golden vectors (tests/test_bfv.py).
"""

import numpy as np
import pytest

from ntt_bfv.models import bfv
from ntt_bfv.params import get_bfv_params
from ntt_bfv.utils import golden


@pytest.fixture(scope="module")
def ctx4k():
    return bfv.BFVContext.build(get_bfv_params("4k_3q"))


@pytest.fixture(scope="module")
def keys4k(ctx4k):
    sk, pk = ctx4k.keygen()
    rlk = ctx4k.relin_keygen(sk)
    return sk, pk, rlk


def _msgs(rng, t, n, j=2):
    return rng.integers(0, t, size=(j, n), dtype=np.uint64)


def _negacyclic_t(m1, m2, t, n):
    return golden.schoolbook_negacyclic(m1.tolist(), m2.tolist(), t, n)


def test_mul_3comp_decrypt(ctx4k, keys4k, rng):
    p = ctx4k.params
    sk, pk, _ = keys4k
    m1, m2 = _msgs(rng, p.t, p.n)
    ct3 = ctx4k.mul(ctx4k.encrypt(pk, m1, nonce=1),
                    ctx4k.encrypt(pk, m2, nonce=2))
    assert ct3.shape == (3, p.r - 1, p.n)
    out = np.asarray(ctx4k.decrypt(sk, ct3))
    assert out.tolist() == _negacyclic_t(m1, m2, p.t, p.n)


def test_mul_relinearized(ctx4k, keys4k, rng):
    p = ctx4k.params
    sk, pk, rlk = keys4k
    m1, m2 = _msgs(rng, p.t, p.n)
    ct = ctx4k.mul(ctx4k.encrypt(pk, m1, nonce=3),
                   ctx4k.encrypt(pk, m2, nonce=4), rlk=rlk)
    assert ct.shape == (2, p.r - 1, p.n)
    out = np.asarray(ctx4k.decrypt(sk, ct))
    assert out.tolist() == _negacyclic_t(m1, m2, p.t, p.n)


@pytest.mark.slow
def test_mul_batched(ctx4k, keys4k, rng):
    """(J, 2, r-1, n) batches broadcast through mul() and match the
    per-message results bit-for-bit."""
    p = ctx4k.params
    sk, pk, rlk = keys4k
    ms = _msgs(rng, p.t, p.n, 4)
    cts = np.stack([np.asarray(ctx4k.encrypt(pk, ms[j], nonce=10 + j))
                    for j in range(4)])
    batched = np.asarray(ctx4k.mul(cts[:2], cts[2:]))
    assert batched.shape == (2, 3, p.r - 1, p.n)
    for j in range(2):
        one = np.asarray(ctx4k.mul(cts[j], cts[2 + j]))
        np.testing.assert_array_equal(batched[j], one)


@pytest.mark.slow
def test_mul_then_add(ctx4k, keys4k, rng):
    """Compose EvalMult with EvalAdd: m1*m2 + m3."""
    p = ctx4k.params
    sk, pk, rlk = keys4k
    m1, m2, m3 = _msgs(rng, p.t, p.n, 3)
    prod = ctx4k.mul(ctx4k.encrypt(pk, m1, nonce=21),
                     ctx4k.encrypt(pk, m2, nonce=22), rlk=rlk)
    total = ctx4k.add(prod, ctx4k.encrypt(pk, m3, nonce=23))
    out = np.asarray(ctx4k.decrypt(sk, total))
    exp = [(a + int(b)) % p.t
           for a, b in zip(_negacyclic_t(m1, m2, p.t, p.n), m3)]
    assert out.tolist() == exp


@pytest.mark.slow
def test_mul_depth2_8k(rng):
    """Two chained multiplications ((m1*m2)*m3) inside the 8k_4q noise
    budget, relinearizing after each."""
    p = get_bfv_params("8k_4q")
    ctx = bfv.BFVContext.build(p)
    sk, pk = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    m1, m2, m3 = _msgs(rng, p.t, p.n, 3)
    c12 = ctx.mul(ctx.encrypt(pk, m1, nonce=1),
                  ctx.encrypt(pk, m2, nonce=2), rlk=rlk)
    c123 = ctx.mul(c12, ctx.encrypt(pk, m3, nonce=3), rlk=rlk)
    out = np.asarray(ctx.decrypt(sk, c123))
    m12 = np.array(_negacyclic_t(m1, m2, p.t, p.n), dtype=np.uint64)
    exp = _negacyclic_t(m12, m3, p.t, p.n)
    assert out.tolist() == exp


def test_relin_stream_independent_of_keygen(ctx4k):
    """Relin draws run under their own Salsa20 key byte: same nonce as
    keygen, different streams."""
    from ntt_bfv.ops import salsa20, sampling
    p = ctx4k.params
    kg = salsa20.keystream_block_words(4, nonce=0)
    rl = salsa20.keystream_block_words(4, key_byte=sampling.RELIN_KEY_BYTE,
                                       nonce=0)
    assert not np.array_equal(np.asarray(kg), np.asarray(rl))


def test_validation_errors(ctx4k, keys4k):
    p = ctx4k.params
    sk, pk, rlk = keys4k
    ct = ctx4k.encrypt(pk, np.zeros(p.n, dtype=np.uint64), nonce=40)
    with pytest.raises(ValueError):
        ctx4k.relinearize(np.asarray(ct), rlk)       # (2, ...) not (3, ...)
    ct3 = ctx4k.mul(ct, ct)
    with pytest.raises(ValueError):
        ctx4k.relinearize(ct3, np.zeros((2, 2, 2, p.n), dtype=np.uint64))
    with pytest.raises(ValueError):
        ctx4k.mul(ct, np.asarray(ct3))               # mismatched shapes
    with pytest.raises(ValueError):
        ctx4k.relin_keygen(sk, nonce=1 << 63)        # reserved bit


def test_square(ctx4k, keys4k, rng):
    """square() decrypts to m^2 in R_t and is bit-identical to
    mul(ct, ct)."""
    p = ctx4k.params
    sk, pk, rlk = keys4k
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx4k.encrypt(pk, m, nonce=50)
    sq3 = ctx4k.square(ct)
    np.testing.assert_array_equal(np.asarray(sq3),
                                  np.asarray(ctx4k.mul(ct, ct)))
    out = np.asarray(ctx4k.decrypt(sk, ctx4k.relinearize(sq3, rlk)))
    assert out.tolist() == _negacyclic_t(m, m, p.t, p.n)


def test_apply_galois(ctx4k, keys4k, rng):
    """decrypt(apply_galois(E(m), g)) == tau_g(m) mod t for a rotation
    generator and the conjugation element."""
    from ntt_bfv.ops import poly
    p = ctx4k.params
    sk, pk, _ = keys4k
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx4k.encrypt(pk, m, nonce=60)
    elts = [3, 2 * p.n - 1]
    gks = ctx4k.galois_keygen(sk, elts, nonce=61)
    for g in elts:
        out = np.asarray(ctx4k.decrypt(sk, ctx4k.apply_galois(ct, g,
                                                              gks[g])))
        perm, neg = poly.galois_maps(p.n, g)
        exp = [(p.t - int(m[perm[j]])) % p.t if neg[j] else int(m[perm[j]])
               for j in range(p.n)]
        assert out.tolist() == exp


def test_galois_element_validation(ctx4k, keys4k):
    from ntt_bfv.ops import poly
    p = ctx4k.params
    sk, _, _ = keys4k
    with pytest.raises(ValueError, match="odd"):
        poly.galois_maps(p.n, 4)
    with pytest.raises(ValueError, match="odd"):
        ctx4k.galois_keygen(sk, [2 * p.n + 1])


def test_noise_budget(ctx4k, keys4k, rng):
    """SEAL-style invariant noise budget: positive and ample on fresh
    ciphertexts, reduced but positive after a multiply, zero on garbage."""
    p = ctx4k.params
    sk, pk, rlk = keys4k
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx4k.encrypt(pk, m, nonce=70)
    fresh = ctx4k.noise_budget(sk, ct)
    assert fresh > 40                      # ~55 bits on 4k_3q
    prod = ctx4k.mul(ct, ct, rlk=rlk)
    after = ctx4k.noise_budget(sk, prod)
    assert 0 < after < fresh
    garbage = np.asarray(ct).copy()
    garbage[0] ^= 1 << 20                  # break c0's RNS consistency
    # the corrupted w is ~uniform in (-q/2, q/2): budget collapses to ~0
    assert ctx4k.noise_budget(sk, garbage) <= 2


def test_mod_switch(ctx4k, keys4k, rng):
    """mod_switch_to_next drops one residue row, stays decryptable under
    next_context() with the same full-chain sk."""
    p = ctx4k.params
    sk, pk, _ = keys4k
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx4k.encrypt(pk, m, nonce=80)
    ct1 = ctx4k.mod_switch_to_next(ct)
    nxt = ctx4k.next_context()
    assert ct1.shape == (2, p.r - 2, p.n)
    assert nxt.params.q == p.q[:-1]
    out = np.asarray(nxt.decrypt(sk, ct1))       # full-chain sk accepted
    assert out.tolist() == m.tolist()
    assert nxt.noise_budget(sk, ct1) > 0
    with pytest.raises(ValueError, match="chain exhausted"):
        nxt.next_context()                       # r=2 has nothing to drop


@pytest.mark.slow
def test_mod_switch_chain_8k(rng):
    """Two switches down the 8k_4q chain; eval ops work at lower levels
    (mul with level-local relin keys)."""
    p = get_bfv_params("8k_4q")
    ctx = bfv.BFVContext.build(p)
    sk, pk = ctx.keygen()
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx.encrypt(pk, m, nonce=1)
    ct1 = ctx.mod_switch_to_next(ct)
    nxt = ctx.next_context()
    ct2 = nxt.mod_switch_to_next(ct1)
    n2 = nxt.next_context()
    assert np.asarray(n2.decrypt(sk, ct2)).tolist() == m.tolist()
    # 3-component ciphertexts switch too, and mul runs at the new level
    rlk1 = nxt.relin_keygen(sk[: nxt.params.r], nonce=5)
    prod = nxt.mul(ct1, ct1, rlk=rlk1)
    exp = _negacyclic_t(m, m, p.t, p.n)
    assert np.asarray(nxt.decrypt(sk, prod)).tolist() == exp
    prod3 = ctx.mul(ct, ct)
    ps = ctx.mod_switch_to_next(prod3)
    assert ps.shape == (3, p.r - 2, p.n)
    assert np.asarray(nxt.decrypt(sk, ps)).tolist() == exp


def test_galois_keys_element_indexed_streams(ctx4k, keys4k):
    """Same nonce + different element sets never reuse randomness across
    targets: a shared element reproduces its key exactly; distinct
    elements draw from disjoint counter regions."""
    p = ctx4k.params
    sk, _, _ = keys4k
    g1, g2 = 3, 5
    k_a = ctx4k.galois_keygen(sk, [g1])
    k_b = ctx4k.galois_keygen(sk, [g1, g2])
    np.testing.assert_array_equal(np.asarray(k_a[g1]),
                                  np.asarray(k_b[g1]))
    # the uniform halves (rlk row 1 = the raw draws) must differ
    assert not np.array_equal(np.asarray(k_b[g1])[1],
                              np.asarray(k_b[g2])[1])
