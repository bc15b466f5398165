"""BFV scheme tests.

1. Bit-exact decryption of the reference CUDA repo's embedded golden
   ciphertext (decryption_test.cu; the primary BASELINE.json target).
2. End-to-end roundtrip decrypt(encrypt(m)) == m (demo.cu mode).
3. Pipeline-structure bit-exactness: device keygen/encrypt vs the integer
   golden pipeline fed the device's own sampler outputs.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

from ntt_bfv.models import bfv
from ntt_bfv.ops import sampling
from ntt_bfv.params import get_bfv_params
from ntt_bfv.utils import golden

FIX = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def ctx4k():
    return bfv.BFVContext.build(get_bfv_params("4k_3q"))


def test_decrypt_reference_golden_vectors(ctx4k):
    """CONFIG: bit-exact vs decryption_test.cu embedded vectors."""
    c0 = np.load(FIX / "dec4k_c0.npy")
    c1 = np.load(FIX / "dec4k_c1.npy")
    sk = np.load(FIX / "dec4k_sk_ntt.npy")
    ct = jnp.asarray(np.stack([c0, c1]))
    m = np.asarray(ctx4k.decrypt(jnp.asarray(sk), ct))
    exp = np.arange(ctx4k.params.n, dtype=np.uint64) % 10
    np.testing.assert_array_equal(m, exp)


def test_roundtrip_4k(ctx4k, rng):
    m = rng.integers(0, ctx4k.params.t, ctx4k.params.n, dtype=np.uint64)
    got = np.asarray(ctx4k.roundtrip_check(jnp.asarray(m)))
    np.testing.assert_array_equal(got, m)


def test_keygen_matches_golden_pipeline(ctx4k):
    """Device keygen == integer golden keygen on the device's own draws."""
    p = ctx4k.params
    s, a, e = sampling.keygen_draws(p.n, p.r, ctx4k.ms_full)
    sk_dev, pk_dev = ctx4k.keygen()
    tabs = [p.psi_tables(i) for i in range(p.r)]
    sk_g, pk0_g, pk1_g = golden.keygen(
        p, np.asarray(s).tolist(), np.asarray(a).tolist(), np.asarray(e).tolist(),
        [t[0] for t in tabs], [t[1] for t in tabs])
    np.testing.assert_array_equal(np.asarray(sk_dev), np.array(sk_g, dtype=np.uint64))
    np.testing.assert_array_equal(np.asarray(pk_dev[0]), np.array(pk0_g, dtype=np.uint64))
    np.testing.assert_array_equal(np.asarray(pk_dev[1]), np.array(pk1_g, dtype=np.uint64))


def test_encrypt_matches_golden_pipeline(ctx4k, rng):
    """Device encrypt == integer golden encrypt on the device's own draws."""
    p = ctx4k.params
    _, pk_dev = ctx4k.keygen()
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct_dev = ctx4k.encrypt(pk_dev, jnp.asarray(m))
    u, e0, e1 = sampling.encrypt_draws(p.n, p.r, ctx4k.ms_full)
    tabs = [p.psi_tables(i) for i in range(p.r)]
    ct_g = golden.encrypt(
        p, np.asarray(pk_dev[0]).tolist(), np.asarray(pk_dev[1]).tolist(),
        m.tolist(), np.asarray(u).tolist(), np.asarray(e0).tolist(),
        np.asarray(e1).tolist(), [t[0] for t in tabs], [t[1] for t in tabs])
    np.testing.assert_array_equal(np.asarray(ct_dev[0]), np.array(ct_g[0], dtype=np.uint64))
    np.testing.assert_array_equal(np.asarray(ct_dev[1]), np.array(ct_g[1], dtype=np.uint64))


def test_decrypt_matches_golden_pipeline(ctx4k, rng):
    p = ctx4k.params
    sk_dev, pk_dev = ctx4k.keygen()
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx4k.encrypt(pk_dev, jnp.asarray(m))
    tabs = [p.psi_tables(i) for i in range(p.r)]
    m_g = golden.decrypt(
        p, np.asarray(ct[0]).tolist(), np.asarray(ct[1]).tolist(),
        np.asarray(sk_dev).tolist(), [t[0] for t in tabs], [t[1] for t in tabs])
    m_dev = np.asarray(ctx4k.decrypt(sk_dev, ct))
    np.testing.assert_array_equal(m_dev, np.array(m_g, dtype=np.uint64))
    np.testing.assert_array_equal(m_dev, m)


@pytest.mark.parametrize("name", ["8k_4q"])
def test_roundtrip_other_sets(name, rng):
    p = get_bfv_params(name)
    ctx = bfv.BFVContext.build(p)
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    got = np.asarray(ctx.roundtrip_check(jnp.asarray(m)))
    np.testing.assert_array_equal(got, m)


def test_encrypt_nonce_freshness(ctx4k, rng):
    """Distinct nonces give distinct randomness (fresh u/e draws) and every
    ciphertext still decrypts; nonce=0 is the reference's deterministic
    default."""
    p = ctx4k.params
    sk, pk = ctx4k.keygen()
    m = jnp.asarray(rng.integers(0, p.t, p.n, dtype=np.uint64))
    ct0 = ctx4k.encrypt(pk, m)
    ct0b = ctx4k.encrypt(pk, m, nonce=0)
    ct1 = ctx4k.encrypt(pk, m, nonce=1)
    np.testing.assert_array_equal(np.asarray(ct0b), np.asarray(ct0))
    assert not np.array_equal(np.asarray(ct1), np.asarray(ct0))
    np.testing.assert_array_equal(np.asarray(ctx4k.decrypt(sk, ct1)),
                                  np.asarray(m))
    # keygen with a fresh nonce also roundtrips
    sk2, pk2 = ctx4k.keygen(nonce=7)
    assert not np.array_equal(np.asarray(sk2), np.asarray(sk))
    ct2 = ctx4k.encrypt(pk2, m, nonce=2)
    np.testing.assert_array_equal(np.asarray(ctx4k.decrypt(sk2, ct2)),
                                  np.asarray(m))


def test_api_validation_messages():
    """Public-API shape/dtype validation fails fast with clear errors
    instead of deep-kernel reshape failures (VERDICT round 1, weak #8)."""
    import jax.numpy as jnp
    from ntt_bfv.models.bfv import BFVContext, check_residues
    from ntt_bfv.params import get_bfv_params

    p = get_bfv_params("4k_3q")
    ctx = BFVContext.build(p)
    sk, pk = ctx.keygen()
    m = jnp.zeros((p.n,), jnp.uint64)

    with pytest.raises(ValueError, match="pk: expected shape"):
        ctx.encrypt(pk[0], m)
    with pytest.raises(ValueError, match="m_poly: expected shape"):
        ctx.encrypt(pk, m[: p.n // 2])
    with pytest.raises(TypeError, match="integer array"):
        ctx.encrypt(pk, m.astype(jnp.float32))
    ct = ctx.encrypt(pk, m)
    with pytest.raises(ValueError, match="ct: expected shape"):
        ctx.decrypt(sk, ct[:, :1])
    with pytest.raises(TypeError, match="expected an array"):
        ctx.decrypt(sk, "nonsense")
    # (r-1, n) sk accepted
    out = np.asarray(ctx.decrypt(sk[: p.r - 1], ct))
    np.testing.assert_array_equal(out, np.zeros(p.n, np.uint64))
    # int32 plaintext casts cleanly
    out2 = ctx.encrypt(pk, jnp.zeros((p.n,), jnp.int32))
    np.testing.assert_array_equal(np.asarray(out2), np.asarray(ct))
    assert check_residues("x", np.zeros((2, 2), np.uint32), (2, 2)).dtype == jnp.uint64


def test_homomorphic_add_sub(ctx4k, rng):
    """EvalAdd/EvalSub (beyond the reference): decrypt(add(E(m1), E(m2)))
    == (m1 + m2) mod t, including plaintext wraparound; batched shapes
    and canonical [0, q) outputs."""
    p = ctx4k.params
    sk, pk = ctx4k.keygen()
    m1 = rng.integers(0, p.t, p.n, dtype=np.uint64)
    m2 = rng.integers(0, p.t, p.n, dtype=np.uint64)
    m1[:8] = p.t - 1  # force (m1 + m2) >= t lanes
    m2[:8] = p.t - 1
    ct1 = ctx4k.encrypt(pk, jnp.asarray(m1), nonce=1)
    ct2 = ctx4k.encrypt(pk, jnp.asarray(m2), nonce=2)
    ct_sum = ctx4k.add(ct1, ct2)
    ct_dif = ctx4k.sub(ct1, ct2)
    qcol = np.asarray(ctx4k.ms_drop.q)  # (r-1, 1)
    assert (np.asarray(ct_sum) < qcol).all()
    assert (np.asarray(ct_dif) < qcol).all()
    np.testing.assert_array_equal(
        np.asarray(ctx4k.decrypt(sk, ct_sum)), (m1 + m2) % p.t)
    np.testing.assert_array_equal(
        np.asarray(ctx4k.decrypt(sk, ct_dif)), (m1 - m2) % p.t)
    # batched shape
    cts = jnp.stack([ct1, ct2])
    np.testing.assert_array_equal(
        np.asarray(ctx4k.add(cts, cts))[0], np.asarray(ctx4k.add(ct1, ct1)))
    # shape validation
    with pytest.raises(ValueError, match="shapes differ"):
        ctx4k.add(ct1, cts)
    with pytest.raises(ValueError, match="expected"):
        ctx4k.sub(ct1[0], ct2[0])


def test_plaintext_add_mul(ctx4k, rng):
    """add_plain / mul_plain: Delta-scaled plaintext addition and
    NTT-domain negacyclic plaintext multiplication (monomial shift and
    small-constant cases, where the noise growth is provably inside a
    fresh ciphertext's budget)."""
    p = ctx4k.params
    sk, pk = ctx4k.keygen()
    m1 = rng.integers(0, p.t, p.n, dtype=np.uint64)
    m2 = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx4k.encrypt(pk, jnp.asarray(m1), nonce=3)
    np.testing.assert_array_equal(
        np.asarray(ctx4k.decrypt(sk, ctx4k.add_plain(ct, jnp.asarray(m2)))),
        (m1 + m2) % p.t)
    # monomial multiplier x^k: negacyclic shift with sign wrap
    k = 17
    mono = np.zeros(p.n, dtype=np.uint64)
    mono[k] = 1
    got = np.asarray(ctx4k.decrypt(sk, ctx4k.mul_plain(ct, jnp.asarray(mono))))
    exp = np.empty(p.n, dtype=np.uint64)
    exp[k:] = m1[: p.n - k]
    exp[:k] = (p.t - m1[p.n - k:]) % p.t   # wrapped terms pick up -1
    np.testing.assert_array_equal(got, exp)
    # small-constant multiplier
    const = np.zeros(p.n, dtype=np.uint64)
    const[0] = 7
    got_c = np.asarray(ctx4k.decrypt(sk, ctx4k.mul_plain(ct, jnp.asarray(const))))
    np.testing.assert_array_equal(got_c, (m1 * 7) % p.t)
    with pytest.raises(ValueError, match="expected shape"):
        ctx4k.mul_plain(ct, jnp.asarray(mono[:8]))
    # sub_plain: exact inverse of add_plain, and (m1 - m2) mod t
    np.testing.assert_array_equal(
        np.asarray(ctx4k.sub_plain(ctx4k.add_plain(ct, jnp.asarray(m2)),
                                   jnp.asarray(m2))),
        np.asarray(ct))
    np.testing.assert_array_equal(
        np.asarray(ctx4k.decrypt(sk, ctx4k.sub_plain(ct, jnp.asarray(m2)))),
        (m1 - m2) % p.t)
    # negate: decrypts to (-m) mod t; double negation is the identity
    np.testing.assert_array_equal(
        np.asarray(ctx4k.decrypt(sk, ctx4k.negate(ct))),
        (p.t - m1) % p.t)
    np.testing.assert_array_equal(
        np.asarray(ctx4k.negate(ctx4k.negate(ct))), np.asarray(ct))
