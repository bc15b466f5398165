"""op_programs / mult_program: the outer-jit-embeddable op functions
must be bit-identical to the public methods.

Tracing the public methods under an OUTER jit freezes the NTT table
bundles into the compiled module as constants (tens of MB at n=32768,
paid in compile time and host memory on every compilation).  The
*_program variants thread the bundles as runtime buffers (bench.py uses
them for every chained-loop step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ntt_bfv.models import bfv
from ntt_bfv.params import get_bfv_params


@pytest.fixture(scope="module", params=["4k_3q", "8k_4q"])
def pctx(request):
    return bfv.BFVContext.build(get_bfv_params(request.param))


def test_op_programs_bitexact(pctx):
    ctx = pctx
    p = ctx.params
    m = jnp.asarray(np.arange(p.n, dtype=np.uint64) % p.t)
    sk, pk = ctx.keygen(nonce=5)
    ct = ctx.encrypt(pk, m, nonce=6)
    kg_fn, enc_fn, dec_fn, encb_fn, decb_fn, bz = ctx.op_programs()

    sk2, pk2 = jax.jit(kg_fn)(jnp.uint64(5), bz)
    np.testing.assert_array_equal(np.asarray(sk2), np.asarray(sk))
    np.testing.assert_array_equal(np.asarray(pk2), np.asarray(pk))

    ct2 = jax.jit(enc_fn)(jnp.uint64(6), pk, m, bz)
    np.testing.assert_array_equal(np.asarray(ct2), np.asarray(ct))

    out = jax.jit(dec_fn)(sk, ct, bz)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(m))

    nonces = jnp.asarray([7, 8], dtype=jnp.uint64)
    mb = jnp.stack([m, (m + 1) % jnp.uint64(p.t)])
    cts_ref = ctx.encrypt_batch(pk, mb, nonces)
    cts = jax.jit(encb_fn)(nonces, pk, mb, bz)
    np.testing.assert_array_equal(np.asarray(cts), np.asarray(cts_ref))
    outs = jax.jit(decb_fn)(sk, cts, bz)
    np.testing.assert_array_equal(np.asarray(outs), np.asarray(mb))


def test_mult_program_bitexact(pctx):
    ctx = pctx
    p = ctx.params
    m = jnp.asarray(np.arange(p.n, dtype=np.uint64) % p.t)
    sk, pk = ctx.keygen(nonce=5)
    rlk = ctx.relin_keygen(sk)
    ct1 = ctx.encrypt(pk, m, nonce=6)
    ct2 = ctx.encrypt(pk, m, nonce=7)
    mul_fn, sq_fn, bz = ctx.mult_program()
    ref = ctx.mul(ct1, ct2, rlk=rlk)
    got = jax.jit(mul_fn)(ct1, ct2, rlk, bz)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    refs = ctx.square(ct1, rlk=rlk)
    gots = jax.jit(sq_fn)(ct1, rlk, bz)
    np.testing.assert_array_equal(np.asarray(gots), np.asarray(refs))
    # un-relinearized form
    ref3 = ctx.mul(ct1, ct2)
    got3 = jax.jit(mul_fn)(ct1, ct2, None, bz)
    np.testing.assert_array_equal(np.asarray(got3), np.asarray(ref3))
