"""Multi-chip sharding tests on a virtual 8-device CPU mesh.

The distributed-correctness contract (SURVEY.md §4): sharded paths must be
bit-exact equal to the single-chip outputs — the single-device result is
itself the fixture.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from ntt_bfv.models import bfv
from ntt_bfv.ops import modmath, ntt
from ntt_bfv.parallel import mesh as mesh_mod, rns as rns_mod, sharded
from ntt_bfv.params import get_bfv_params, get_params
from ntt_bfv.utils import primegen


requires_8dev = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


@requires_8dev
@pytest.mark.parametrize("rns,coef", [(1, 8), (2, 4), (1, 2), (2, 1)])
def test_sharded_ntt_bitexact(rng, rns, coef):
    """Coefficient-sharded forward/inverse == single-chip, any mesh shape."""
    p = primegen.make_bfv_params(1024, 30, max(rns * 2, 2))
    n, r = p.n, p.r
    tables = ntt.tables_for(p)
    ms = modmath.modulus_set(p)
    x = np.stack([rng.integers(0, p.q[i], n, dtype=np.uint64) for i in range(r)])
    ref_f = np.asarray(ntt.ntt_forward_jit(jnp.asarray(x), tables, ms))

    m = mesh_mod.make_mesh(rns=rns, coef=coef)
    fwd = sharded.sharded_ntt_forward(m, n)
    inv = sharded.sharded_ntt_inverse(m, n)
    xs = jax.device_put(jnp.asarray(x), mesh_mod.residue_sharding(m, shard_coef=True))
    tab_f = jax.device_put(tables.psi_mont, mesh_mod.table_sharding(m))
    tab_i = jax.device_put(tables.psiinv_mont, mesh_mod.table_sharding(m))
    q = jax.device_put(ms.q, mesh_mod.const_sharding(m))
    qi = jax.device_put(ms.qinv_neg, mesh_mod.const_sharding(m))

    got_f = np.asarray(fwd(xs, tab_f, q, qi))
    np.testing.assert_array_equal(got_f, ref_f)

    got_rt = np.asarray(inv(fwd(xs, tab_f, q, qi), tab_i, q, qi))
    np.testing.assert_array_equal(got_rt, x)


@requires_8dev
@pytest.mark.parametrize("rns,coef", [(1, 4), (4, 2)])
def test_sharded_ntt_30bit_family(rng, rns, coef):
    """The 30-bit family through the coefficient-sharded transform."""
    n = 2048
    q, psi, _, _, _ = get_params(n, "30bit")
    tables = ntt.NTTTables.build([q] * rns, [psi] * rns, n)
    ms = modmath.ModulusSet.from_moduli([q] * rns)
    x = rng.integers(0, q, (rns, n), dtype=np.uint64)
    ref = np.asarray(ntt.ntt_forward_jit(jnp.asarray(x), tables, ms))
    m = mesh_mod.make_mesh(rns=rns, coef=coef)
    xs = jax.device_put(jnp.asarray(x),
                        mesh_mod.residue_sharding(m, shard_coef=True))
    tab_f = jax.device_put(tables.psi_mont, mesh_mod.table_sharding(m))
    tab_i = jax.device_put(tables.psiinv_mont, mesh_mod.table_sharding(m))
    qq = jax.device_put(ms.q, mesh_mod.const_sharding(m))
    qi = jax.device_put(ms.qinv_neg, mesh_mod.const_sharding(m))
    got = sharded.sharded_ntt_forward(m, n)(xs, tab_f, qq, qi)
    np.testing.assert_array_equal(np.asarray(got), ref)
    back = sharded.sharded_ntt_inverse(m, n)(got, tab_i, qq, qi)
    np.testing.assert_array_equal(np.asarray(back), x)


@requires_8dev
def test_sharded_ntt_bitexact_60bit_large(rng):
    """60-bit family at n=2^15 on an 8-way coefficient shard."""
    q, psi, _, _, _ = get_params(32768)
    tables = ntt.NTTTables.build([q], [psi], 32768)
    ms = modmath.ModulusSet.from_moduli([q])
    x = rng.integers(0, q, 32768, dtype=np.uint64)[None, :]
    ref = np.asarray(ntt.ntt_forward_jit(jnp.asarray(x), tables, ms))

    m = mesh_mod.make_mesh(rns=1, coef=8)
    fwd = sharded.sharded_ntt_forward(m, 32768)
    xs = jax.device_put(jnp.asarray(x), mesh_mod.residue_sharding(m, shard_coef=True))
    got = np.asarray(fwd(xs,
                         jax.device_put(tables.psi_mont, mesh_mod.table_sharding(m)),
                         jax.device_put(ms.q, mesh_mod.const_sharding(m)),
                         jax.device_put(ms.qinv_neg, mesh_mod.const_sharding(m))))
    np.testing.assert_array_equal(got, ref)


@requires_8dev
@pytest.mark.slow
def test_rns_sharded_bfv_pipeline(rng):
    """GSPMD rns-axis sharding of keygen/encrypt/decrypt (r=4 over rns=2)
    matches the unsharded pipeline bit-exactly."""
    p = get_bfv_params("8k_4q")
    ctx = bfv.BFVContext.build(p)
    sk_ref, pk_ref = ctx.keygen()
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct_ref = ctx.encrypt(pk_ref, jnp.asarray(m))

    mesh = mesh_mod.make_mesh(rns=2, coef=4)
    sctx = rns_mod.ShardedBFVContext.build(p, mesh)
    sk_s, pk_s = sctx.keygen()
    np.testing.assert_array_equal(np.asarray(sk_s), np.asarray(sk_ref))
    np.testing.assert_array_equal(np.asarray(pk_s), np.asarray(pk_ref))
    ct_s = sctx.encrypt(pk_s, jnp.asarray(m))
    np.testing.assert_array_equal(np.asarray(ct_s), np.asarray(ct_ref))
    got = np.asarray(sctx.decrypt(sk_s, ct_s))   # the sharded decrypt path
    np.testing.assert_array_equal(got, m)
    got_ref = np.asarray(ctx.decrypt(sk_s, ct_s))
    np.testing.assert_array_equal(got_ref, m)


@pytest.mark.slow
def test_primegen_params_roundtrip(rng):
    p = primegen.make_bfv_params(512, 28, 4)
    assert all(q % (2 * p.n) == 1 for q in p.q)
    ctx = bfv.BFVContext.build(p)
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    got = np.asarray(ctx.roundtrip_check(jnp.asarray(m)))
    np.testing.assert_array_equal(got, m)


def test_pod_mesh_single_process():
    """multihost.pod_mesh lays ('rns', 'coef') over all runtime devices
    (single-process here: 8 virtual CPU devices), all on 'rns' unless
    'coef' is asked for."""
    import jax
    from ntt_bfv.parallel import multihost
    mesh = multihost.pod_mesh()
    assert mesh.axis_names == ("rns", "coef")
    assert mesh.devices.shape == (len(jax.devices()), 1)
    mesh2 = multihost.pod_mesh(rns=4, coef=2)
    assert mesh2.devices.shape == (4, 2)
    assert multihost.is_coordinator()


@pytest.mark.slow
def test_config5_n17_sharded_ntt_and_bfv(rng):
    """BASELINE.json config 5: N=2^17 NTT + BFV across a sharded mesh.

    No published reference parameters exist at n=2^17; moduli come from
    the prime generator.  Sharded outputs must equal the single-device
    XLA path bit-exactly, and the RNS-sharded BFV pipeline must
    round-trip."""
    n = 1 << 17
    params = primegen.make_bfv_params(n, 55, 4)

    # coefficient-sharded NTT vs single-device, one modulus
    q, psi = params.q[0], params.psi[0]
    tables = ntt.NTTTables.build([q], [psi], n)
    ms = modmath.ModulusSet.from_moduli([q])
    x = rng.integers(0, q, n, dtype=np.uint64)[None, :]
    ref = np.asarray(ntt.ntt_forward_jit(jnp.asarray(x), tables, ms))
    m = mesh_mod.make_mesh(rns=1, coef=8)
    fwd = sharded.sharded_ntt_forward(m, n)
    xs = jax.device_put(jnp.asarray(x),
                        mesh_mod.residue_sharding(m, shard_coef=True))
    got = np.asarray(fwd(
        xs, jax.device_put(tables.psi_mont, mesh_mod.table_sharding(m)),
        jax.device_put(ms.q, mesh_mod.const_sharding(m)),
        jax.device_put(ms.qinv_neg, mesh_mod.const_sharding(m))))
    np.testing.assert_array_equal(got, ref)

    # RNS-sharded BFV keygen -> encrypt -> decrypt round-trip
    mesh2 = mesh_mod.make_mesh(rns=2, coef=4)
    sctx = rns_mod.ShardedBFVContext.build(params, mesh2)
    sk, pk = sctx.keygen()
    msg = jnp.asarray(np.arange(n, dtype=np.uint64) % params.t)
    ct = sctx.encrypt(pk, msg)
    out = np.asarray(sctx.decrypt(sk, ct))
    np.testing.assert_array_equal(out, np.asarray(msg))


@pytest.mark.slow
def test_rns_sharded_mul(rng):
    """GSPMD EvalMult (r=4 over rns=2) matches the unsharded mul
    bit-exactly, relinearized and not."""
    p = get_bfv_params("8k_4q")
    ctx = bfv.BFVContext.build(p)
    sk, pk = ctx.keygen()
    m1 = rng.integers(0, p.t, p.n, dtype=np.uint64)
    m2 = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct1 = ctx.encrypt(pk, jnp.asarray(m1), nonce=1)
    ct2 = ctx.encrypt(pk, jnp.asarray(m2), nonce=2)
    rlk = ctx.relin_keygen(sk)

    mesh = mesh_mod.make_mesh(rns=2, coef=4)
    sctx = rns_mod.ShardedBFVContext.build(p, mesh)
    np.testing.assert_array_equal(np.asarray(sctx.mul(ct1, ct2)),
                                  np.asarray(ctx.mul(ct1, ct2)))
    rlk_s = sctx.relin_keygen(sk)
    np.testing.assert_array_equal(np.asarray(rlk_s), np.asarray(rlk))
    np.testing.assert_array_equal(
        np.asarray(sctx.mul(ct1, ct2, rlk=rlk_s)),
        np.asarray(ctx.mul(ct1, ct2, rlk=rlk)))


def test_rns_sharded_add_sub_galois(rng):
    """GSPMD add/sub/apply_galois delegates match the unsharded ops
    bit-exactly (VERDICT r3 weak #6)."""
    p = get_bfv_params("8k_4q")
    ctx = bfv.BFVContext.build(p)
    sk, pk = ctx.keygen()
    m1 = rng.integers(0, p.t, p.n, dtype=np.uint64)
    m2 = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct1 = ctx.encrypt(pk, jnp.asarray(m1), nonce=1)
    ct2 = ctx.encrypt(pk, jnp.asarray(m2), nonce=2)

    mesh = mesh_mod.make_mesh(rns=2, coef=4)
    sctx = rns_mod.ShardedBFVContext.build(p, mesh)
    np.testing.assert_array_equal(np.asarray(sctx.add(ct1, ct2)),
                                  np.asarray(ctx.add(ct1, ct2)))
    np.testing.assert_array_equal(np.asarray(sctx.sub(ct1, ct2)),
                                  np.asarray(ctx.sub(ct1, ct2)))
    g = 3
    gks = ctx.galois_keygen(sk, [g], nonce=5)
    gks_s = sctx.galois_keygen(sk, [g], nonce=5)
    np.testing.assert_array_equal(np.asarray(gks_s[g]), np.asarray(gks[g]))
    np.testing.assert_array_equal(
        np.asarray(sctx.apply_galois(ct1, g, gks_s[g])),
        np.asarray(ctx.apply_galois(ct1, g, gks[g])))


def test_rns_sharded_square_plain_modswitch(rng):
    """The remaining GSPMD delegates: square, add_plain/mul_plain,
    mod_switch_to_next + next_context — bit-identical to single-chip."""
    p = get_bfv_params("8k_4q")
    ctx = bfv.BFVContext.build(p)
    sk, pk = ctx.keygen()
    m1 = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct1 = ctx.encrypt(pk, jnp.asarray(m1), nonce=1)
    rlk = ctx.relin_keygen(sk)

    mesh = mesh_mod.make_mesh(rns=2, coef=4)
    sctx = rns_mod.ShardedBFVContext.build(p, mesh)
    np.testing.assert_array_equal(
        np.asarray(sctx.square(ct1, rlk=rlk)),
        np.asarray(ctx.square(ct1, rlk=rlk)))
    np.testing.assert_array_equal(
        np.asarray(sctx.add_plain(ct1, jnp.asarray(m1))),
        np.asarray(ctx.add_plain(ct1, jnp.asarray(m1))))
    np.testing.assert_array_equal(
        np.asarray(sctx.mul_plain(ct1, jnp.asarray(m1))),
        np.asarray(ctx.mul_plain(ct1, jnp.asarray(m1))))
    ct_l = sctx.mod_switch_to_next(ct1)
    np.testing.assert_array_equal(np.asarray(ct_l),
                                  np.asarray(ctx.mod_switch_to_next(ct1)))
    out = sctx.next_context().decrypt(sk[: p.r - 1], ct_l)
    np.testing.assert_array_equal(np.asarray(out), m1)
    # batched delegates
    nonces = jnp.asarray([7, 8], dtype=jnp.uint64)
    mb = jnp.stack([jnp.asarray(m1), jnp.asarray(m1)])
    cts = sctx.encrypt_batch(pk, mb, nonces)
    np.testing.assert_array_equal(
        np.asarray(cts), np.asarray(ctx.encrypt_batch(pk, mb, nonces)))
    np.testing.assert_array_equal(
        np.asarray(sctx.decrypt_batch(sk, cts)), np.asarray(mb))
