"""BEHZ EvalMult machinery (ops/behz.py) vs exact-int golden mirrors and
the mathematical contracts of each base-conversion primitive.

The reference has no multiplication pipeline; the oracle here is exact
arbitrary-precision arithmetic (utils/golden.py behz_* mirrors), the same
contract SEAL 3.5's BFV evaluator implements.
"""

import numpy as np
import pytest

from ntt_bfv.ops import behz
from ntt_bfv.params import get_bfv_params
from ntt_bfv.utils import golden, primegen

@pytest.fixture(scope="module", params=["4k_3q", "gen_2048_r5"])
def setup(request):
    if request.param == "4k_3q":
        p = get_bfv_params("4k_3q")
    else:
        p = primegen.make_bfv_params(2048, 50, 5)
    aux = behz.AuxBase.build(p)
    mc = behz.MultConsts.build(p, aux)
    return p, aux, mc


def _residues(vals, moduli):
    """list of ints -> (len(moduli), n) u64 residue array."""
    return np.array([[v % m for v in vals] for m in moduli], dtype=np.uint64)


def _crt_centered(res, moduli):
    """(k, n) residues -> list of centered ints via CRT."""
    prod = 1
    for m in moduli:
        prod *= int(m)
    out = []
    for i in range(res.shape[1]):
        x = 0
        for j, m in enumerate(moduli):
            pj = prod // m
            x = (x + int(res[j, i]) * pj * pow(pj % m, -1, m)) % prod
        out.append(x - prod if x > prod // 2 else x)
    return out


def test_aux_base_build(setup):
    p, aux, _ = setup
    assert len(aux.b) == p.r - 1
    for m in aux.bsk:
        assert primegen.is_prime(m)
        assert m % (2 * p.n) == 1
        assert m not in p.q and m != p.gamma
    assert len(set(aux.bsk)) == p.r
    aux.validate(p)  # the documented correctness bounds hold


def test_rns_to_bsk(setup, rng):
    p, aux, mc = setup
    k = p.r - 1
    qs = p.q[:k]
    q_prod = 1
    for q in qs:
        q_prod *= q
    n = 256  # value-level checks are per-coefficient python ints
    xs = [int.from_bytes(rng.bytes(16), "little") % q_prod for _ in range(n)]
    x = _residues(xs, qs)

    dev = np.asarray(behz.rns_to_bsk(x, mc))
    gold = np.array(golden.behz_rns_to_bsk(
        [list(row) for row in x], qs, aux.bsk, aux.m_tilde), dtype=np.uint64)
    np.testing.assert_array_equal(dev, gold)

    vals = _crt_centered(dev, aux.bsk)
    for v, xi in zip(vals, xs):
        assert (v - xi) % q_prod == 0      # congruent to the input mod q
        assert abs(v) < q_prod             # sm_mrq's centered bound


def test_fast_floor(setup, rng):
    p, aux, mc = setup
    k = p.r - 1
    qs = p.q[:k]
    q_prod = 1
    for q in qs:
        q_prod *= q
    bound = 4 * p.n * q_prod * q_prod // (1 << 10)  # tensor-product scale
    n = 256
    xs = [int.from_bytes(rng.bytes(32), "little") % (2 * bound) - bound
          for _ in range(n)]
    xq = _residues(xs, qs)
    xbsk = _residues(xs, aux.bsk)

    dev = np.asarray(behz.fast_floor(xq, xbsk, mc))
    gold = np.array(golden.behz_fast_floor(
        [list(r) for r in xq], [list(r) for r in xbsk], qs, aux.bsk, p.t),
        dtype=np.uint64)
    np.testing.assert_array_equal(dev, gold)

    vals = _crt_centered(dev, aux.bsk)
    for v, xi in zip(vals, xs):
        err = (p.t * xi - q_prod * v) // q_prod  # floor(t*x/q) - v
        assert 0 <= err < k, err               # alpha in [0, k)


def test_bsk_to_q_exact(setup, rng):
    p, aux, mc = setup
    k = p.r - 1
    qs = p.q[:k]
    b_prod = 1
    for b in aux.b:
        b_prod *= b
    n = 256
    xs = [int.from_bytes(rng.bytes(32), "little") % (b_prod - 1)
          - (b_prod - 1) // 2 for _ in range(n)]
    x = _residues(xs, aux.bsk)

    dev = np.asarray(behz.bsk_to_q(x, mc))
    gold = np.array(golden.behz_bsk_to_q(
        [list(r) for r in x], qs, aux.b, aux.m_sk), dtype=np.uint64)
    np.testing.assert_array_equal(dev, gold)

    expect = _residues(xs, qs)                 # exact, incl. negatives
    np.testing.assert_array_equal(dev, expect)


def test_scale_and_round(setup, rng):
    """Composition: round(t*x/q) with error <= k, back in base q."""
    p, aux, mc = setup
    k = p.r - 1
    qs = p.q[:k]
    q_prod = 1
    for q in qs:
        q_prod *= q
    bound = 4 * p.n * q_prod * q_prod // (1 << 10)
    n = 128
    xs = [int.from_bytes(rng.bytes(32), "little") % (2 * bound) - bound
          for _ in range(n)]
    xq = _residues(xs, qs)
    xbsk = _residues(xs, aux.bsk)

    dev = np.asarray(behz.scale_and_round(xq, xbsk, mc))
    for i, xi in enumerate(xs):
        exact = p.t * xi // q_prod
        got = int(dev[0, i])
        ok = any((exact - d) % qs[0] == got for d in range(k))
        assert ok, (exact % qs[0], got)


def test_batch_dims(setup, rng):
    """Leading batch dims broadcast through the whole pipeline."""
    p, aux, mc = setup
    k = p.r - 1
    x = rng.integers(0, min(p.q[:k]), size=(3, k, 64), dtype=np.uint64)
    one = np.asarray(behz.rns_to_bsk(x[1], mc))
    batched = np.asarray(behz.rns_to_bsk(x, mc))
    assert batched.shape == (3, k + 1, 64)
    np.testing.assert_array_equal(batched[1], one)


@pytest.mark.parametrize("lead", [(2,), (2, 3)])
def test_conversions_batched_vs_golden(setup, rng, lead):
    """Leading batch dims through all three conversions, each slice
    against the exact-integer mirrors."""
    p, aux, mc = setup
    k = p.r - 1
    qs = p.q[:k]
    n = 32
    q_prod = 1
    for q in qs:
        q_prod *= q
    x = np.empty(lead + (k, n), dtype=np.uint64)
    xb = np.empty(lead + (k + 1, n), dtype=np.uint64)
    for idx in np.ndindex(*lead):
        vals = [int.from_bytes(rng.bytes(16), "little") % q_prod
                for _ in range(n)]
        x[idx] = _residues(vals, qs)
        xb[idx] = _residues(vals, aux.bsk)
    r2b = np.asarray(behz.rns_to_bsk(x, mc))
    ff = np.asarray(behz.fast_floor(x, xb, mc))
    b2q = np.asarray(behz.bsk_to_q(ff, mc))
    for idx in np.ndindex(*lead):
        rows = [list(r) for r in x[idx]]
        np.testing.assert_array_equal(r2b[idx], np.array(
            golden.behz_rns_to_bsk(rows, qs, aux.bsk, aux.m_tilde),
            dtype=np.uint64))
        np.testing.assert_array_equal(ff[idx], np.array(
            golden.behz_fast_floor(rows, [list(r) for r in xb[idx]], qs,
                                   aux.bsk, p.t), dtype=np.uint64))
        np.testing.assert_array_equal(b2q[idx], np.array(
            golden.behz_bsk_to_q([list(r) for r in ff[idx]], qs, aux.b,
                                 aux.m_sk), dtype=np.uint64))
