"""NTT/INTT correctness: golden-model differential tests.

Mirrors the reference's test strategy (60bit_ntt_test.cu): round-trip and
full polymul vs the O(n^2) schoolbook negacyclic golden — plus exact
per-stage equality against the integer golden NTT, which the reference
lacks.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ntt_bfv.ops import modmath, ntt
from ntt_bfv.params import get_bfv_params, get_params
from ntt_bfv.utils import golden, hostmath as hm


def _single_modulus_setup(n, family="60bit"):
    q, psi, psiinv, _, _ = get_params(n, family)
    tables = ntt.NTTTables.build([q], [psi], n)
    ms = modmath.ModulusSet.from_moduli([q])
    return q, psi, psiinv, tables, ms


# every published size of both families: the 55-bit family of the BFV
# sets (n = 2^11..2^15) and the 30-bit family (n = 2^11..2^16)
GRID = [(n, "60bit") for n in (2048, 4096, 8192, 16384, 32768)] + \
    [(n, "30bit") for n in (2048, 4096, 8192, 16384, 32768, 65536)]


@pytest.mark.parametrize("n,family", GRID)
def test_forward_matches_golden(rng, n, family):
    q, psi, psiinv, tables, ms = _single_modulus_setup(n, family)
    a = rng.integers(0, q, n, dtype=np.uint64)
    pt, pit = hm.psi_tables(psi, psiinv, q, n)
    exp = golden.ntt_forward(a, pt, q, n)
    got = np.asarray(ntt.ntt_forward_jit(jnp.asarray(a[None, :]), tables, ms))[0]
    np.testing.assert_array_equal(got, np.array(exp, dtype=np.uint64))


@pytest.mark.parametrize("n,family", GRID)
def test_inverse_matches_golden(rng, n, family):
    q, psi, psiinv, tables, ms = _single_modulus_setup(n, family)
    a = rng.integers(0, q, n, dtype=np.uint64)
    pt, pit = hm.psi_tables(psi, psiinv, q, n)
    exp = golden.ntt_inverse(a, pit, q, n)
    got = np.asarray(ntt.ntt_inverse_jit(jnp.asarray(a[None, :]), tables, ms))[0]
    np.testing.assert_array_equal(got, np.array(exp, dtype=np.uint64))


@pytest.mark.parametrize("n", [2048, 4096, 8192, 16384, 32768])
def test_roundtrip(rng, n):
    q, psi, psiinv, tables, ms = _single_modulus_setup(n)
    a = rng.integers(0, q, n, dtype=np.uint64)
    x = jnp.asarray(a[None, :])
    back = np.asarray(ntt.ntt_inverse_jit(ntt.ntt_forward_jit(x, tables, ms), tables, ms))[0]
    np.testing.assert_array_equal(back, a)


@pytest.mark.parametrize("n", [2048])
def test_polymul_vs_schoolbook(rng, n):
    """CONFIG 1/2 of BASELINE.json: NTT -> dyadic -> INTT == schoolbook
    negacyclic product (the reference's 60bit_ntt_test `check` mode)."""
    q, psi, psiinv, tables, ms = _single_modulus_setup(n)
    a = rng.integers(0, q, n, dtype=np.uint64)
    b = rng.integers(0, q, n, dtype=np.uint64)
    got = np.asarray(ntt.negacyclic_polymul_jit(
        jnp.asarray(a[None, :]), jnp.asarray(b[None, :]), tables, ms))[0]
    exp = golden.schoolbook_negacyclic(a, b, q, n)
    np.testing.assert_array_equal(got, np.array(exp, dtype=np.uint64))


def test_rns_batched_matches_per_modulus(rng):
    """The (r, n) batched transform must equal r independent transforms
    (forwardNTT_batch vs forwardNTT equivalence)."""
    p = get_bfv_params("4k_3q")
    n, r = p.n, p.r
    tables = ntt.tables_for(p)
    ms = modmath.modulus_set(p)
    x = np.stack([rng.integers(0, p.q[i], n, dtype=np.uint64) for i in range(r)])
    got = np.asarray(ntt.ntt_forward_jit(jnp.asarray(x), tables, ms))
    for i in range(r):
        ti = ntt.NTTTables.build([p.q[i]], [p.psi[i]], n)
        mi = modmath.ModulusSet.from_moduli([p.q[i]])
        gi = np.asarray(ntt.ntt_forward_jit(jnp.asarray(x[i][None, :]), ti, mi))[0]
        np.testing.assert_array_equal(got[i], gi)


def test_ciphertext_rank3_batch(rng):
    """(2, r, n) tensors (both ciphertext halves in one launch, the
    reference's num=2r division=r batching) transform correctly."""
    p = get_bfv_params("4k_3q")
    n, r = p.n, p.r
    tables = ntt.tables_for(p)
    ms = modmath.modulus_set(p)
    x = np.stack([
        np.stack([rng.integers(0, p.q[i], n, dtype=np.uint64) for i in range(r)])
        for _ in range(2)])
    got = np.asarray(ntt.ntt_forward_jit(jnp.asarray(x), tables, ms))
    for h in range(2):
        gi = np.asarray(ntt.ntt_forward_jit(jnp.asarray(x[h]), tables, ms))
        np.testing.assert_array_equal(got[h], gi)


def test_30bit_family_roundtrip(rng):
    """Legacy 30-bit modulus family (old/ntt_30bit.cuh), incl. n=65536."""
    for n in (2048, 65536):
        q, psi, psiinv, _, _ = get_params(n, "30bit")
        tables = ntt.NTTTables.build([q], [psi], n)
        ms = modmath.ModulusSet.from_moduli([q])
        a = rng.integers(0, q, n, dtype=np.uint64)
        x = jnp.asarray(a[None, :])
        back = np.asarray(ntt.ntt_inverse_jit(ntt.ntt_forward_jit(x, tables, ms), tables, ms))[0]
        np.testing.assert_array_equal(back, a)
