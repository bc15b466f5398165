"""Salsa20/20 keystream generator over u32 arrays.

Counterpart of the reference's CSPRNG (VecCrypt kernel,
distributions.cuh:48-155): one keystream block per SIMT thread there, one
block per array element here — the 20-round core is pure 32-bit
add/xor/rotl, left to XLA to fuse.  Byte-exact against the reference
(validated against the
ECRYPT published vectors and the integer golden model): fixed key
(32 bytes of 0x01 for `generate_random_default`, distributions.cuh:261),
zero nonce, sigma = "expand 32-byte k", 64-bit little-endian block counter
in state words 8/9.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

U32 = jnp.uint32
U64 = jnp.uint64

SIGMA_WORDS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # "expand 32-byte k"
DEFAULT_KEY_BYTE = 0x01  # generate_random_default (distributions.cuh:261)
STREAM_KEY_BYTE = 0x4D   # generate_random (distributions.cuh:232, memset 77)


def _key_words(key_byte: int) -> tuple[int, ...]:
    w = key_byte | (key_byte << 8) | (key_byte << 16) | (key_byte << 24)
    return (w,) * 8


def _rotl(x, c: int):
    return (x << U32(c)) | (x >> U32(32 - c))


def _double_round(x):
    # column round then row round (distributions.cuh:83-115)
    for a, b, c, d in ((0, 4, 8, 12), (5, 9, 13, 1), (10, 14, 2, 6), (15, 3, 7, 11),
                       (0, 1, 2, 3), (5, 6, 7, 4), (10, 11, 8, 9), (15, 12, 13, 14)):
        x[b] = x[b] ^ _rotl(x[a] + x[d], 7)
        x[c] = x[c] ^ _rotl(x[b] + x[a], 9)
        x[d] = x[d] ^ _rotl(x[c] + x[b], 13)
        x[a] = x[a] ^ _rotl(x[d] + x[c], 18)


def keystream_block_words(nblocks: int, key_byte: int = DEFAULT_KEY_BYTE,
                          nonce=0, rounds: int = 20, counter0=0) -> jax.Array:
    """Keystream in block-position layout: (16, nblocks) u32 — see
    _keystream_xla for the layout contract."""
    nonce = jnp.asarray(nonce, U64)        # python ints >= 2^63 would
    counter0 = jnp.asarray(counter0, U64)  # overflow jit's i64 parsing
    return _keystream_xla(nblocks, key_byte=key_byte, nonce=nonce,
                          rounds=rounds, counter0=counter0)


@functools.partial(jax.jit, static_argnames=("nblocks", "key_byte", "rounds"))
def _keystream_xla(nblocks: int, key_byte: int = DEFAULT_KEY_BYTE,
                   nonce=0, rounds: int = 20,
                   counter0=0) -> jax.Array:
    """Keystream in block-position layout: (16, nblocks) u32, row p =
    word p of every 64-byte block.  This is the generator's natural
    (compute) layout; stream word w lives at [w % 16, w // 16].  Consumers
    slice rows and transpose once, instead of materializing the canonical
    interleave-16 stream and de-interleaving it again.

    `nonce` may be a Python int or a traced u64 scalar (state words 6/7);
    the reference always uses 0, but a per-message nonce is how a caller
    gets fresh encryption randomness under the fixed key.  `counter0`
    (int or traced u64) offsets the block counter: counter mode means a
    shard can generate exactly its slice of the stream — block b here
    equals block counter0 + b of the full stream."""
    ctr = jnp.arange(nblocks, dtype=U64) + jnp.asarray(counter0, U64)
    kw = _key_words(key_byte)
    nonce = jnp.asarray(nonce, U64)
    j = [
        jnp.full((nblocks,), SIGMA_WORDS[0], U32),
        jnp.full((nblocks,), kw[0], U32), jnp.full((nblocks,), kw[1], U32),
        jnp.full((nblocks,), kw[2], U32), jnp.full((nblocks,), kw[3], U32),
        jnp.full((nblocks,), SIGMA_WORDS[1], U32),
        jnp.broadcast_to((nonce & U64(0xFFFFFFFF)).astype(U32), (nblocks,)),
        jnp.broadcast_to((nonce >> U64(32)).astype(U32), (nblocks,)),
        (ctr & U64(0xFFFFFFFF)).astype(U32),
        (ctr >> U64(32)).astype(U32),
        jnp.full((nblocks,), SIGMA_WORDS[2], U32),
        jnp.full((nblocks,), kw[4], U32), jnp.full((nblocks,), kw[5], U32),
        jnp.full((nblocks,), kw[6], U32), jnp.full((nblocks,), kw[7], U32),
        jnp.full((nblocks,), SIGMA_WORDS[3], U32),
    ]
    x = list(j)
    for _ in range(rounds // 2):
        _double_round(x)
    return jnp.stack([x[i] + j[i] for i in range(16)], axis=0)


def keystream_block_words_batch(nblocks: int, nonces: jax.Array,
                                key_byte: int = DEFAULT_KEY_BYTE,
                                rounds: int = 20, counter0=0) -> jax.Array:
    """(J,) nonces -> (J, 16, nblocks) keystream planes in one batched
    computation.  Counter-mode streams are per-nonce, so J messages need
    J streams; row j is bit-identical to
    keystream_block_words(nblocks, nonce=nonces[j])."""
    nonces = jnp.asarray(nonces, U64)
    counter0 = jnp.asarray(counter0, U64)
    return jax.vmap(
        lambda nn: _keystream_xla(nblocks, key_byte=key_byte, nonce=nn,
                                  rounds=rounds, counter0=counter0)
    )(nonces)


def keystream_words(nblocks: int, key_byte: int = DEFAULT_KEY_BYTE,
                    nonce=0, rounds: int = 20) -> jax.Array:
    """Keystream as a flat u32 array of length nblocks*16, little-endian
    word order (byte k of the stream = byte k%4 of word k//4)."""
    bw = keystream_block_words(nblocks, key_byte=key_byte, nonce=nonce,
                               rounds=rounds)
    return bw.T.reshape(nblocks * 16)


def block_words_u32(bw: jax.Array, start: int, count: int) -> jax.Array:
    """`count` canonical-order stream words from byte offset `start`
    (start must be 64-byte block aligned)."""
    assert start % 64 == 0
    blk0 = start // 64
    nb = -(-count // 16)
    w = jax.lax.slice_in_dim(bw, blk0, blk0 + nb, axis=1)
    return w.T.reshape(nb * 16)[:count]


def block_words_u8(bw: jax.Array, start: int, count: int) -> jax.Array:
    """`count` keystream bytes from block-aligned byte offset `start`."""
    w = block_words_u32(bw, start, -(-count // 4))
    b = jnp.stack([(w >> U32(8 * k)) & U32(0xFF) for k in range(4)], axis=1)
    return b.reshape(-1)[:count]


def block_words_u32_batch(bw: jax.Array, start: int, count: int) -> jax.Array:
    """Batched block_words_u32: (J, 16, nb_total) -> (J, count) canonical
    stream words from block-aligned byte offset `start`, per message."""
    assert start % 64 == 0
    J = bw.shape[0]
    blk0 = start // 64
    nb = -(-count // 16)
    w = jax.lax.slice_in_dim(bw, blk0, blk0 + nb, axis=2)   # (J, 16, nb)
    return w.transpose(0, 2, 1).reshape(J, nb * 16)[:, :count]


def block_words_u8_batch(bw: jax.Array, start: int, count: int) -> jax.Array:
    """Batched block_words_u8: (J, 16, nb_total) -> (J, count) bytes."""
    w = block_words_u32_batch(bw, start, -(-count // 4))
    b = jnp.stack([(w >> U32(8 * k)) & U32(0xFF) for k in range(4)], axis=2)
    return b.reshape(w.shape[0], -1)[:, :count]


def block_words_u64(bw: jax.Array, start: int, count: int) -> jax.Array:
    """`count` little-endian u64 lanes from block-aligned byte offset
    `start` (count a multiple of 8, whole blocks).  Pairs adjacent block
    positions on the cheap major axis — one transpose instead of an
    interleave-16 plus a stride-2 de-interleave."""
    assert start % 64 == 0 and count % 8 == 0
    blk0 = start // 64
    nb = count // 8
    sub = jax.lax.slice_in_dim(bw, blk0, blk0 + nb, axis=1)   # (16, nb)
    w = sub.T.reshape(nb, 8, 2)                               # u32 first
    return (w[..., 0].astype(U64)
            | (w[..., 1].astype(U64) << U64(32))).reshape(count)


def keystream_for_bytes(nbytes: int, **kw) -> jax.Array:
    """Keystream covering ceil(nbytes/64) blocks, as flat u32 words."""
    return keystream_words((nbytes + 63) // 64, **kw)


# ---------------------------------------------------------------------------
# Lane extraction: the reference reads the same byte stream as u8 / u32le /
# u64le at different offsets (bfv_keygen.cuh:120-122, bfv_encryption.cuh:247).
# Offsets used by the pipelines are always 4-byte-aligned.
# ---------------------------------------------------------------------------

def bytes_u8(ks: jax.Array, start: int, count: int) -> jax.Array:
    """count bytes from byte offset `start` (start % 4 == 0, count % 4 == 0)."""
    assert start % 4 == 0 and count % 4 == 0
    w = jax.lax.slice_in_dim(ks, start // 4, start // 4 + count // 4)
    b = jnp.stack([(w >> U32(8 * k)) & U32(0xFF) for k in range(4)], axis=1)
    return b.reshape(count)


def bytes_u32(ks: jax.Array, start: int, count: int) -> jax.Array:
    assert start % 4 == 0
    return jax.lax.slice_in_dim(ks, start // 4, start // 4 + count)


def bytes_u64(ks: jax.Array, start: int, count: int) -> jax.Array:
    assert start % 8 == 0
    w = jax.lax.slice_in_dim(ks, start // 4, start // 4 + 2 * count).reshape(count, 2)
    return w[:, 0].astype(U64) | (w[:, 1].astype(U64) << U64(32))
