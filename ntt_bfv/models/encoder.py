"""CRT batching encoder (SEAL BatchEncoder semantics).

The reference has no plaintext encoder (its demo encrypts raw coefficient
vectors); this is the standard slot-packing layer that makes Galois
rotations meaningful: for a PRIME plaintext modulus t === 1 mod 2n
(primegen.find_plain_modulus), R_t = Z_t[x]/(x^n+1) splits into n CRT
slots — evaluations at the primitive 2n-th roots of unity mod t.  Values
form a 2 x (n/2) matrix; elementwise ciphertext ops act slotwise, and

  * BFVContext.rotate_rows(ct, steps, gks) rotates both rows cyclically,
  * BFVContext.rotate_columns(ct, gks) swaps the rows

(the Galois elements 3^steps and 2n-1, SEAL's batching group).

Slot ordering follows SEAL's matrix_reps_index_map: slot j of row 0
evaluates at psi^(3^j), row 1 at psi^(-3^j); the NTT output index for
exponent e is bitrev((e-1)/2) (the merged negacyclic CT transform
evaluates position i at psi^(2*bitrev(i)+1)).

encode/decode are one n-point mod-t NTT each, jitted on device — t is an
odd prime, so the same Montgomery modmath as the ciphertext moduli
applies.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import modmath, ntt
from ..utils import hostmath as hm, primegen

U64 = jnp.uint64


def rotation_element(n: int, steps: int) -> int:
    """The Galois element for rotate_rows(steps): 3^steps mod 2n
    (negative steps rotate the other way; step 0 is the identity)."""
    return pow(3, steps % (n // 2), 2 * n)


COLUMN_ELEMENT_DOC = "rotate_columns uses the element 2n - 1"


def column_element(n: int) -> int:
    return 2 * n - 1


class BatchEncoder:
    """encode: (n,) slot values in [0, t) -> (n,) plaintext poly mod t;
    decode: the inverse.  Build once per parameter set."""

    def __init__(self, params):
        t, n = params.t, params.n
        if t % 2 == 0 or t % (2 * n) != 1 or not primegen.is_prime(t):
            raise ValueError(
                f"batching needs a prime plaintext modulus t === 1 mod 2n "
                f"(got t={t}); generate one with "
                f"primegen.find_plain_modulus(n, bits)")
        self.params = params
        psi = primegen.find_primitive_2n_root(t, n)
        self.ms = modmath.ModulusSet.from_moduli([t])
        self.tables = ntt.NTTTables.build([t], [psi], n)
        logn = n.bit_length() - 1
        m = 2 * n
        idx = np.empty(n, dtype=np.int64)
        pos = 1
        for j in range(n // 2):
            idx[j] = hm.bit_reverse((pos - 1) >> 1, logn)
            idx[j + n // 2] = hm.bit_reverse((m - pos - 1) >> 1, logn)
            pos = pos * 3 % m
        self._idx = jnp.asarray(idx)

    def encode(self, values) -> jax.Array:
        values = jnp.asarray(values)
        p = self.params
        if values.shape != (p.n,):
            raise ValueError(f"values: expected shape ({p.n},), got "
                             f"{values.shape}")
        return _encode_jit(values.astype(U64), self._idx, self.tables,
                           self.ms)

    def decode(self, plain) -> jax.Array:
        plain = jnp.asarray(plain)
        p = self.params
        if plain.shape != (p.n,):
            raise ValueError(f"plain: expected shape ({p.n},), got "
                             f"{plain.shape}")
        return _decode_jit(plain.astype(U64), self._idx, self.tables,
                           self.ms)


@jax.jit
def _encode_jit(values, idx, tables, ms):
    hat = jnp.zeros_like(values).at[idx].set(values)
    return ntt.ntt_inverse(hat[None, :], tables, ms)[0]


@jax.jit
def _decode_jit(plain, idx, tables, ms):
    hat = ntt.ntt_forward(plain[None, :], tables, ms)[0]
    return hat[idx]
