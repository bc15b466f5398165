"""CRT batching encoder + rotations with a prime plaintext modulus.

Beyond the reference (no encoder there): SEAL BatchEncoder semantics —
slot packing via the mod-t negacyclic NTT, slotwise homomorphic ops, and
row/column rotations through the Galois machinery.  The golden anchor
for the pow2-t pipelines is unaffected (tests/test_bfv.py); here the
oracle is slotwise integer arithmetic mod t.
"""

import numpy as np
import pytest

from ntt_bfv.models import bfv, encoder
from ntt_bfv.utils import primegen

N = 2048


@pytest.fixture(scope="module")
def setup():
    t = primegen.find_plain_modulus(N, 17)          # 65537
    params = primegen.make_bfv_params(N, 45, 3, t=t)
    enc = encoder.BatchEncoder(params)
    ctx = bfv.BFVContext.build(params)              # auto-selects xla
    sk, pk = ctx.keygen()
    return params, enc, ctx, sk, pk


def test_prime_t_congruences(setup):
    params, enc, ctx, sk, pk = setup
    t = params.t
    assert primegen.is_prime(t) and t % (2 * N) == 1
    assert all(q % t == 1 for q in params.q)        # Delta-embedding req.


def test_encode_decode_roundtrip(setup, rng):
    params, enc, ctx, sk, pk = setup
    v = rng.integers(0, params.t, N, dtype=np.uint64)
    np.testing.assert_array_equal(np.asarray(enc.decode(enc.encode(v))), v)
    with pytest.raises(ValueError, match="expected shape"):
        enc.encode(v[: N // 2])


def test_encoder_requires_batching_prime():
    params = primegen.make_bfv_params(N, 45, 3)     # t = 1024 (pow2)
    with pytest.raises(ValueError, match="prime plaintext modulus"):
        encoder.BatchEncoder(params)


def test_slotwise_homomorphic_ops(setup, rng):
    params, enc, ctx, sk, pk = setup
    t = params.t
    v1 = rng.integers(0, t, N, dtype=np.uint64)
    v2 = rng.integers(0, t, N, dtype=np.uint64)
    ct1 = ctx.encrypt(pk, enc.encode(v1), nonce=1)
    ct2 = ctx.encrypt(pk, enc.encode(v2), nonce=2)
    got_add = np.asarray(enc.decode(ctx.decrypt(sk, ctx.add(ct1, ct2))))
    np.testing.assert_array_equal(got_add, (v1 + v2) % t)
    rlk = ctx.relin_keygen(sk)
    got_mul = np.asarray(enc.decode(
        ctx.decrypt(sk, ctx.mul(ct1, ct2, rlk=rlk))))
    exp = np.array([(int(a) * int(b)) % t for a, b in zip(v1, v2)],
                   dtype=np.uint64)
    np.testing.assert_array_equal(got_mul, exp)


def test_rotations(setup, rng):
    """rotate_rows(k): both rows roll LEFT by k (SEAL's convention);
    rotate_columns swaps the rows."""
    params, enc, ctx, sk, pk = setup
    v = rng.integers(0, params.t, N, dtype=np.uint64)
    ct = ctx.encrypt(pk, enc.encode(v), nonce=3)
    half = N // 2
    elts = [encoder.rotation_element(N, 1), encoder.rotation_element(N, -2),
            encoder.column_element(N)]
    gks = ctx.galois_keygen(sk, elts, nonce=4)

    for steps in (1, -2):
        got = np.asarray(enc.decode(
            ctx.decrypt(sk, ctx.rotate_rows(ct, steps, gks))))
        np.testing.assert_array_equal(got[:half], np.roll(v[:half], -steps))
        np.testing.assert_array_equal(got[half:], np.roll(v[half:], -steps))

    got = np.asarray(enc.decode(
        ctx.decrypt(sk, ctx.rotate_columns(ct, gks))))
    np.testing.assert_array_equal(got[:half], v[half:])
    np.testing.assert_array_equal(got[half:], v[:half])

    with pytest.raises(KeyError, match="rotation element"):
        ctx.rotate_rows(ct, 7, gks)


def test_apply_galois_batched(setup, rng):
    """(J, 2, r-1, n) batches through apply_galois match per-message."""
    params, enc, ctx, sk, pk = setup
    t = params.t
    g = encoder.rotation_element(N, 1)
    gks = ctx.galois_keygen(sk, [g], nonce=9)
    cts = np.stack([
        np.asarray(ctx.encrypt(pk, enc.encode(
            rng.integers(0, t, N, dtype=np.uint64)), nonce=10 + j))
        for j in range(2)])
    batched = np.asarray(ctx.apply_galois(cts, g, gks[g]))
    assert batched.shape == cts.shape
    for j in range(2):
        np.testing.assert_array_equal(
            batched[j], np.asarray(ctx.apply_galois(cts[j], g, gks[g])))


@pytest.mark.slow
def test_encrypted_dot_product_example():
    import sys, pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from examples.encrypted_dot_product import encrypted_dot_product
    result, expected, budget = encrypted_dot_product(verbose=False)
    assert result == expected
    assert budget > 0
