"""RNS-axis data parallelism for the BFV pipelines via pjit/GSPMD.

The reference batches RNS moduli over CUDA grid-y (ntt_60bit.cuh:388-697);
multi-chip, the modulus axis becomes a mesh axis.  Because the BFV
pipelines in models/bfv.py are plain jnp over (..., r, n) tensors, simply
placing the operands with a NamedSharding P(..., 'rns', None) and calling
the existing jitted functions lets GSPMD partition them: per-modulus work
(NTT, dyadic, samplers) stays local, and XLA inserts exactly two
collectives — the last-residue broadcast in divide_and_round_q_last and
the BEHZ reduction over moduli in fast_convert_and_round — on the 'rns'
axis, matching the communication structure identified in SURVEY.md §2.2.

GSPMD can partition the XLA stage-loop NTT freely, but it can only
replicate a custom call such as the CUDA NTT kernel (gathering the whole
operand onto every device).  So on a mesh of more than one device the
context pins the XLA NTT (BFVContext.with_ntt); a one-device mesh keeps
whatever the platform selects.

This module provides placement helpers and a sharded context wrapper.
"""

from __future__ import annotations

import dataclasses

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import bfv
from ..params import BFVParams
from . import mesh as mesh_mod


def _put(tree, sharding):
    """device_put a constant bundle; leaves of rank < 2 (per-scheme scalars
    inside the dataclasses) are replicated — a 2-axis PartitionSpec cannot
    apply to them."""
    repl = NamedSharding(sharding.mesh, P())
    return jax.tree.map(
        lambda x: jax.device_put(
            x, sharding if getattr(x, "ndim", 0) >= 2 else repl),
        tree)


@dataclasses.dataclass(frozen=True)
class ShardedBFVContext:
    """A BFVContext whose constant bundles live sharded over the 'rns' axis
    (coefficient axis replicated; use parallel/sharded.py for 'coef').

    Keys/ciphertexts produced by this context are sharded P('rns', None) /
    P(None, 'rns', None); all three pipelines run under GSPMD.
    """

    inner: bfv.BFVContext
    mesh: Mesh

    @staticmethod
    def build(params: BFVParams, mesh: Mesh) -> "ShardedBFVContext":
        return ShardedBFVContext._wrap(bfv.BFVContext.build(params), mesh)

    @staticmethod
    def _wrap(ctx: bfv.BFVContext, mesh: Mesh) -> "ShardedBFVContext":
        """Reshard an existing single-device context's bundles over
        'rns' (with the XLA NTT on a multi-device mesh)."""
        if mesh.devices.size > 1:
            ctx = ctx.with_ntt(False)
        params = ctx.params
        rns = mesh_mod.RNS_AXIS
        rns_size = mesh.shape[rns]
        const = NamedSharding(mesh, P(rns, None))
        repl = NamedSharding(mesh, P())

        # r and r-1 cannot both be divisible by the rns axis, so shard the
        # r-row bundles (where the keygen/encrypt NTT work lives) when
        # divisible and replicate the (r-1)-row tail constants — the
        # divide-and-round / decrypt tail is elementwise-cheap, and GSPMD
        # reshards the activations at the slice.
        full_sh = const if params.r % rns_size == 0 else repl
        drop_sh = const if (params.r - 1) % rns_size == 0 else repl
        ctx = dataclasses.replace(
            ctx,
            ms_full=_put(ctx.ms_full, full_sh),
            ms_drop=_put(ctx.ms_drop, drop_sh),
            ms_last=_put(ctx.ms_last, repl),
            tables_full=_put(ctx.tables_full, full_sh),
            tables_drop=_put(ctx.tables_drop, drop_sh),
            dr_consts=dataclasses.replace(
                _put(ctx.dr_consts, drop_sh), half=jax.device_put(ctx.dr_consts.half, repl)),
            msg_consts=_put(ctx.msg_consts, drop_sh),
            dec_consts=dataclasses.replace(
                _put(ctx.dec_consts, drop_sh),
                gamma=jax.device_put(ctx.dec_consts.gamma, repl),
                gamma_qinv_neg=jax.device_put(ctx.dec_consts.gamma_qinv_neg, repl),
                gamma_div_2=jax.device_put(ctx.dec_consts.gamma_div_2, repl),
                neg_g_mont=jax.device_put(ctx.dec_consts.neg_g_mont, repl),
            ),
        )
        return ShardedBFVContext(inner=ctx, mesh=mesh)

    # Sharding constructors for user-held tensors.
    def key_sharding(self):
        p = self.inner.params
        rns_size = self.mesh.shape[mesh_mod.RNS_AXIS]
        spec = P(mesh_mod.RNS_AXIS, None) if p.r % rns_size == 0 else P()
        return NamedSharding(self.mesh, spec)

    def ct_sharding(self):
        p = self.inner.params
        rns_size = self.mesh.shape[mesh_mod.RNS_AXIS]
        spec = (P(None, mesh_mod.RNS_AXIS, None)
                if (p.r - 1) % rns_size == 0 else P())
        return NamedSharding(self.mesh, spec)

    def rlk_sharding(self):
        p = self.inner.params
        rns_size = self.mesh.shape[mesh_mod.RNS_AXIS]
        spec = (P(None, None, mesh_mod.RNS_AXIS, None)
                if p.r % rns_size == 0 else P())
        return NamedSharding(self.mesh, spec)

    def keygen(self, nonce=0):
        """(sk, pk) with every per-modulus row computed on its own shard."""
        return self.inner.keygen(nonce=nonce)

    def relin_keygen(self, sk, nonce=0):
        """Relinearization keys under GSPMD, sharded P(.., 'rns', None)."""
        return jax.device_put(
            self.inner.relin_keygen(
                jax.device_put(sk, self.key_sharding()), nonce=nonce),
            self.rlk_sharding())

    def mul(self, ct_a, ct_b, rlk=None):
        """EvalMult under GSPMD: operands placed P(None, 'rns', None);
        the BEHZ base-conversion inner products lower to collectives the
        partitioner inserts."""
        put = lambda c: jax.device_put(c, self.ct_sharding())
        if rlk is not None:
            rlk = jax.device_put(rlk, self.rlk_sharding())
        return self.inner.mul(put(ct_a), put(ct_b), rlk=rlk)

    def encrypt(self, pk, m_poly, nonce=0):
        return self.inner.encrypt(pk, m_poly, nonce=nonce)

    def decrypt(self, sk, ct):
        return self.inner.decrypt(
            jax.device_put(sk, self.key_sharding())[: self.inner.params.r - 1],
            jax.device_put(ct, self.ct_sharding()))

    def add(self, ct_a, ct_b):
        """EvalAdd under GSPMD: elementwise over P(None, 'rns', None)
        shards, zero collectives."""
        put = lambda c: jax.device_put(c, self.ct_sharding())
        return self.inner.add(put(ct_a), put(ct_b))

    def sub(self, ct_a, ct_b):
        put = lambda c: jax.device_put(c, self.ct_sharding())
        return self.inner.sub(put(ct_a), put(ct_b))

    def galois_keygen(self, sk, elts, nonce=0):
        """Galois switching keys under GSPMD, each sharded like rlk."""
        keys = self.inner.galois_keygen(
            jax.device_put(sk, self.key_sharding()), elts, nonce=nonce)
        return {g: jax.device_put(k, self.rlk_sharding())
                for g, k in keys.items()}

    def apply_galois(self, ct, g, gk):
        """Homomorphic automorphism under GSPMD: the coefficient gather
        is row-local (the permutation acts on the replicated axis), the
        key switch reshards like mul's."""
        return self.inner.apply_galois(
            jax.device_put(ct, self.ct_sharding()), g,
            jax.device_put(gk, self.rlk_sharding()))

    def square(self, ct, rlk=None):
        """EvalSquare under GSPMD (half of mul's forwards, same BEHZ
        collectives)."""
        if rlk is not None:
            rlk = jax.device_put(rlk, self.rlk_sharding())
        return self.inner.square(jax.device_put(ct, self.ct_sharding()),
                                 rlk=rlk)

    def add_plain(self, ct, m_poly):
        """ct + Delta*m: elementwise on the c0 shards, zero collectives."""
        return self.inner.add_plain(
            jax.device_put(ct, self.ct_sharding()), m_poly)

    def mul_plain(self, ct, m_poly):
        """Negacyclic plaintext multiply: per-modulus transforms stay
        shard-local (the plaintext forward replicates)."""
        return self.inner.mul_plain(
            jax.device_put(ct, self.ct_sharding()), m_poly)

    def encrypt_batch(self, pk, m_batch, nonces):
        return self.inner.encrypt_batch(pk, m_batch, nonces)

    def decrypt_batch(self, sk, cts):
        return self.inner.decrypt_batch(
            jax.device_put(sk, self.key_sharding())
            [: self.inner.params.r - 1],
            jax.device_put(cts, NamedSharding(
                self.mesh, P(None, *self.ct_sharding().spec))))

    def next_context(self) -> "ShardedBFVContext":
        """The context one modulus-switch down, on the same mesh (the
        level's own r/r-1 divisibility decides which bundles shard;
        reuses the inner context's cached next level)."""
        return ShardedBFVContext._wrap(self.inner.next_context(),
                                       self.mesh)

    def mod_switch_to_next(self, ct):
        """Modulus switch under GSPMD.  The row count changes r-1 ->
        r-2, so the result is placed with the NEXT level's ciphertext
        sharding (replicated when r-2 doesn't divide the axis)."""
        out = self.inner.mod_switch_to_next(
            jax.device_put(ct, self.ct_sharding()))
        return jax.device_put(out, self.next_context().ct_sharding())
