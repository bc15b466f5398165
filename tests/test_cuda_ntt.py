"""The Hopper NTT kernel (ntt_bfv/cuda).

CUDA has no interpret mode, so on the CPU the kernel's stage schedule is
held to ops/ntt.py through its NumPy replay (cuda.model_*), and the
wrapper's checks and the platform choice are tested directly.  The
`gpu`-marked cases run the compiled kernel on a card and skip elsewhere.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from ntt_bfv import cuda
from ntt_bfv.models import bfv
from ntt_bfv.ops import modmath, ntt
from ntt_bfv.params import get_bfv_params, get_params

SIZES = [2048, 4096, 8192, 16384, 32768, 65536]


def _setup(n, rows, rng):
    family = "30bit" if n == 65536 else "60bit"
    q, psi, _, _, _ = get_params(n, family)
    r = 2
    tables = ntt.NTTTables.build([q] * r, [psi] * r, n, kernel=False)
    ms = modmath.ModulusSet.from_moduli([q] * r)
    x = rng.integers(0, q, (rows, r, n), dtype=np.uint64)
    return tables, ms, x


def _consts(tables, ms):
    return (np.asarray(ms.q), np.asarray(ms.qinv_neg))


@pytest.mark.parametrize("n", SIZES)
def test_model_schedule_matches_xla(n, rng):
    """Global/shared split + sub-block twiddle indexing == the stage loop,
    forward and inverse, for every published size."""
    tables, ms, x = _setup(n, 2, rng)
    q, qi = _consts(tables, ms)
    ref_f = np.asarray(ntt.ntt_forward_jit(jnp.asarray(x), tables, ms))
    got_f = cuda.model_forward(x, np.asarray(tables.psi_mont), q, qi)
    np.testing.assert_array_equal(got_f, ref_f)
    ref_i = np.asarray(ntt.ntt_inverse_jit(jnp.asarray(ref_f), tables, ms))
    got_i = cuda.model_inverse(ref_f, np.asarray(tables.psiinv_mont), q, qi)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_i, x)


def test_schedule_split():
    """Rows up to 2^14 fit in shared memory, so 2^15 / 2^16 take at least
    one / two global stages; few rows take more (up to 4, sub-transforms
    of at least 2^10) so that the card has blocks to fill."""
    assert [cuda.schedule(n, 256) for n in SIZES] == [
        (0, 11), (0, 12), (0, 13), (0, 14), (1, 14), (2, 14)]
    assert [cuda.schedule(n, 16) for n in SIZES] == [
        (1, 10), (2, 10), (3, 10), (4, 10), (4, 11), (4, 12)]
    assert cuda.schedule(16384, 80) == (2, 12)
    assert cuda.schedule(32768, 512) == (1, 14)


@pytest.mark.parametrize("rows", [1, 3, 40])
def test_model_schedule_few_rows(rows, rng):
    """The deeper global pass taken for few rows matches the stage loop."""
    q, psi, _, _, _ = get_params(16384, "60bit")
    tables = ntt.NTTTables.build([q], [psi], 16384, kernel=False)
    ms = modmath.ModulusSet.from_moduli([q])
    x = rng.integers(0, q, (rows, 1, 16384), dtype=np.uint64)
    qq, qi = _consts(tables, ms)
    ref = np.asarray(ntt.ntt_forward_jit(jnp.asarray(x), tables, ms))
    got = cuda.model_forward(x, np.asarray(tables.psi_mont), qq, qi)
    np.testing.assert_array_equal(got, ref)
    back = cuda.model_inverse(ref, np.asarray(tables.psiinv_mont), qq, qi)
    np.testing.assert_array_equal(back, x)


def test_model_flattens_leading_dims(rng):
    """(J, 2, r, n) rows use modulus row % r, exactly like (r, n) slices."""
    p = get_bfv_params("4k_3q")
    tables = ntt.tables_for(p, kernel=False)
    ms = modmath.modulus_set(p)
    x = np.stack([np.stack([rng.integers(0, q, (2, p.n), dtype=np.uint64)
                            for q in p.q], axis=1) for _ in range(3)])
    q, qi = _consts(tables, ms)
    got = cuda.model_forward(x, np.asarray(tables.psi_mont), q, qi)
    assert got.shape == x.shape == (3, 2, p.r, p.n)
    for j in range(3):
        for h in range(2):
            np.testing.assert_array_equal(
                got[j, h], cuda.model_forward(x[j, h],
                                              np.asarray(tables.psi_mont),
                                              q, qi))


def test_wrapper_rejects_bad_shapes():
    p = get_bfv_params("4k_3q")
    tables = ntt.tables_for(p, kernel=False)
    ms = modmath.modulus_set(p)
    with pytest.raises(ValueError, match="uint64"):
        cuda.forward(jnp.zeros((p.r + 1, p.n), jnp.uint64),
                     tables.psi_mont, ms.q, ms.qinv_neg)
    with pytest.raises(ValueError, match="uint64"):
        cuda.forward(jnp.zeros((p.r, p.n), jnp.uint32),
                     tables.psi_mont, ms.q, ms.qinv_neg)
    with pytest.raises(ValueError, match="power of two"):
        cuda.forward(jnp.zeros((1, 3), jnp.uint64),
                     jnp.zeros((1, 3), jnp.uint64), ms.q[:1],
                     ms.qinv_neg[:1])
    with pytest.raises(ValueError, match="one modulus constant"):
        cuda.inverse(jnp.zeros((p.r, p.n), jnp.uint64),
                     tables.psiinv_mont, ms.q[:1], ms.qinv_neg)


def test_platform_choice():
    """The kernel runs only on a GPU, at every published size from 2^12
    (where it measured faster); CPU tables (and so every context built
    here) take the XLA stage loop."""
    for n in SIZES:
        assert cuda.selected(n, "gpu") == (n >= 4096)
        assert not cuda.selected(n, "cpu")
    ctx = bfv.BFVContext.build(get_bfv_params("4k_3q"))
    assert not ctx.ntt_kernel and not ctx.tables_drop.kernel
    assert ctx.with_ntt(True).tables_full.kernel
    assert ctx.with_ntt(False) is ctx


def test_build_is_keyed_by_source(tmp_path, monkeypatch):
    """The library name changes with the source text, and lives in a
    gitignored directory inside the checkout."""
    path = cuda.library_path()
    assert path.parent == cuda._BUILD
    assert path.name.startswith("libntt_cuda-") and path.suffix == ".so"
    src = tmp_path / "ntt.cu"
    src.write_text(cuda._SOURCES[0].read_text() + "\n// changed\n")
    monkeypatch.setattr(cuda, "_SOURCES", (src,))
    assert cuda.library_path() != path


@pytest.mark.gpu
@pytest.mark.parametrize("n", SIZES)
def test_kernel_matches_xla_on_card(gpu, n, rng):
    tables, ms, x = _setup(n, 3, rng)
    kt = dataclasses.replace(tables, kernel=True)
    xj = jnp.asarray(x)
    ref_f = ntt.forward_stages(xj, tables, ms)
    got_f = ntt.ntt_forward_jit(xj, kt, ms)
    np.testing.assert_array_equal(np.asarray(got_f), np.asarray(ref_f))
    got_i = ntt.ntt_inverse_jit(got_f, kt, ms)
    np.testing.assert_array_equal(np.asarray(got_i), x)


@pytest.mark.gpu
def test_bfv_kernel_matches_xla_on_card(gpu, rng):
    p = get_bfv_params("8k_4q")
    ctx = bfv.BFVContext.build(p)
    assert ctx.ntt_kernel
    ref = ctx.with_ntt(False)
    sk, pk = ctx.keygen(nonce=1)
    sk_r, pk_r = ref.keygen(nonce=1)
    np.testing.assert_array_equal(np.asarray(sk), np.asarray(sk_r))
    np.testing.assert_array_equal(np.asarray(pk), np.asarray(pk_r))
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx.encrypt(pk, m, nonce=2)
    np.testing.assert_array_equal(np.asarray(ct),
                                  np.asarray(ref.encrypt(pk, m, nonce=2)))
    rlk = ctx.relin_keygen(sk)
    prod = ctx.mul(ct, ct, rlk=rlk)
    np.testing.assert_array_equal(np.asarray(prod),
                                  np.asarray(ref.mul(ct, ct, rlk=rlk)))
