"""Coefficient-sharded distributed NTT over a ('rns', 'coef') mesh.

This is the multi-chip re-design of the reference's hybrid stage schedule
(forwardNTT, ntt_60bit.cuh:267-386).  There, early long-stride butterfly
stages run as separate kernel launches (grid-wide sync at the launch
boundary) and late short-stride stages fuse into one shared-memory kernel
per contiguous region.  Distributed over C coefficient shards of width
S = n/C, the same boundary appears at stride S:

* forward stages s < log2(C): the butterfly partner lives on shard
  (b XOR C>>(s+1)) — one `ppermute` per stage, then a local
  butterfly with a single per-shard twiddle scalar;
* forward stages s >= log2(C): groups align inside the shard — the local
  stage loop is exactly the single-chip kernel with the twiddle base
  offset by the shard index (the same `blockIdx.x * (n/l/2)` offset the
  reference's fused kernel applies, ntt_60bit.cuh:90).

The inverse transform mirrors this (local stages first, the last log2(C)
stages exchange), as the reference's inverse schedule mirrors its forward.

Everything is expressed with `shard_map` so the collectives are explicit
and the per-shard code is the plain single-chip math from ops/modmath.py.
Outputs are bit-exact equal to the single-chip transform for any C.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import modmath
from .mesh import COEF_AXIS, RNS_AXIS

U64 = jnp.uint64


def _psi_col(table_loc, start_col):
    """(r_loc, 1) dynamic twiddle column at `start_col`."""
    return jax.lax.dynamic_slice_in_dim(table_loc, start_col, 1, axis=1)


def _local_forward_stages(x, table_loc, q, qinv, n: int, block: jax.Array,
                          first_stage: int):
    """Stages first_stage..log2(n)-1 of the CT forward transform on one
    shard of width S, twiddle base offset by the shard index (the fused
    single-kernel region of the reference, ntt_60bit.cuh:63-123)."""
    logn = n.bit_length() - 1
    lead = x.shape[:-1]
    S = x.shape[-1]
    shape = x.shape
    for s in range(first_stage, logn):
        length = 1 << s
        step = n >> (s + 1)
        m_loc = S // (2 * step)
        xr = x.reshape(lead + (m_loc, 2, step))
        u = xr[..., 0, :]
        v = xr[..., 1, :]
        # psi indices: length + block*m_loc + [0, m_loc)
        psi = jax.lax.dynamic_slice_in_dim(
            table_loc, length + block * m_loc, m_loc, axis=1)[..., :, None]
        t = modmath.mont_mul(v, psi, q[..., None], qinv[..., None])
        nu_ = modmath.add_mod(u, t, q[..., None])
        nv_ = modmath.sub_mod(u, t, q[..., None])
        x = jnp.stack([nu_, nv_], axis=-2).reshape(shape)
    return x


def _local_inverse_stages(x, table_loc, q, qinv, n: int, block: jax.Array,
                          last_stage: int):
    """Stages log2(n)-1 .. last_stage (descending) of the GS inverse on one
    shard (the reference's GSBasedINTTInnerSingle region)."""
    logn = n.bit_length() - 1
    lead = x.shape[:-1]
    S = x.shape[-1]
    shape = x.shape
    for s in reversed(range(last_stage, logn)):
        length = 1 << s
        step = n >> (s + 1)
        m_loc = S // (2 * step)
        xr = x.reshape(lead + (m_loc, 2, step))
        u = xr[..., 0, :]
        v = xr[..., 1, :]
        psiinv = jax.lax.dynamic_slice_in_dim(
            table_loc, length + block * m_loc, m_loc, axis=1)[..., :, None]
        s_ = modmath.add_mod(u, v, q[..., None])
        d_ = modmath.mont_mul(modmath.sub_mod(u, v, q[..., None]), psiinv,
                              q[..., None], qinv[..., None])
        nu_ = modmath.halve_mod(s_, q[..., None])
        nv_ = modmath.halve_mod(d_, q[..., None])
        x = jnp.stack([nu_, nv_], axis=-2).reshape(shape)
    return x


def _xor_perm(C: int, k: int):
    return [(i, i ^ k) for i in range(C)]


def _cross_forward_stage(x, table_loc, q, qinv, n: int, C: int, s: int,
                         block: jax.Array):
    """One cross-shard CT stage: exchange with shard (block XOR k), then a
    whole-shard butterfly with one twiddle scalar (the multi-kernel stage
    of the reference, CTBasedNTTInner, with the launch boundary replaced
    by a ppermute)."""
    length = 1 << s
    k = C >> (s + 1)
    partner = jax.lax.ppermute(x, COEF_AXIS, _xor_perm(C, k))
    g = block // (2 * k)  # same group index on both sides of the pair
    psi = _psi_col(table_loc, length + g)
    u_side = (block & k) == 0
    vv = jnp.where(u_side, partner, x)
    uu = jnp.where(u_side, x, partner)
    t = modmath.mont_mul(vv, psi, q, qinv)
    return jnp.where(u_side, modmath.add_mod(uu, t, q), modmath.sub_mod(uu, t, q))


def _cross_inverse_stage(x, table_loc, q, qinv, n: int, C: int, s: int,
                         block: jax.Array):
    """One cross-shard GS stage, folding the stage's 2^-1 as the reference
    does."""
    length = 1 << s
    k = C >> (s + 1)
    partner = jax.lax.ppermute(x, COEF_AXIS, _xor_perm(C, k))
    g = block // (2 * k)
    psiinv = _psi_col(table_loc, length + g)
    u_side = (block & k) == 0
    s_uv = jnp.where(u_side,
                     modmath.add_mod(x, partner, q),
                     modmath.sub_mod(partner, x, q))
    t = modmath.mont_mul(s_uv, psiinv, q, qinv)
    return modmath.halve_mod(jnp.where(u_side, s_uv, t), q)


def _fwd_shard(x, psi_mont, q, qinv, *, n: int, C: int):
    block = jax.lax.axis_index(COEF_AXIS)
    logc = C.bit_length() - 1
    for s in range(logc):
        x = _cross_forward_stage(x, psi_mont, q, qinv, n, C, s, block)
    return _local_forward_stages(x, psi_mont, q, qinv, n, block, logc)


def _inv_shard(x, psiinv_mont, q, qinv, *, n: int, C: int):
    block = jax.lax.axis_index(COEF_AXIS)
    logc = C.bit_length() - 1
    x = _local_inverse_stages(x, psiinv_mont, q, qinv, n, block, logc)
    for s in reversed(range(logc)):
        x = _cross_inverse_stage(x, psiinv_mont, q, qinv, n, C, s, block)
    return x


def _make(mesh: Mesh, n: int, kernel):
    C = mesh.shape[COEF_AXIS]
    spec_x = P(RNS_AXIS, COEF_AXIS)
    spec_tab = P(RNS_AXIS, None)
    spec_c = P(RNS_AXIS, None)
    fn = shard_map(
        functools.partial(kernel, n=n, C=C),
        mesh=mesh,
        in_specs=(spec_x, spec_tab, spec_c, spec_c),
        out_specs=spec_x,
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_ntt_forward(mesh: Mesh, n: int):
    """Jitted (r, n)->(r, n) forward NTT, x sharded P('rns', 'coef'),
    tables P('rns', None), constants P('rns', None).

    Call as fn(x, tables.psi_mont, ms.q, ms.qinv_neg)."""
    return _make(mesh, n, _fwd_shard)


def sharded_ntt_inverse(mesh: Mesh, n: int):
    return _make(mesh, n, _inv_shard)
