"""GSPMD rns-axis sharding (parallel/rns.py) on virtual CPU meshes:
keygen, encrypt, decrypt and mul+relin on rns = 1, 2 and 4 devices, each
bit-equal to the single-device pipeline."""

import numpy as np
import jax
import pytest

from ntt_bfv.models import bfv
from ntt_bfv.parallel import mesh as mesh_mod, rns as rns_mod
from ntt_bfv.utils import primegen

RNS = [1, 2, 4]


@pytest.fixture(scope="module")
def ref():
    """Single-device results for a set whose r = 4 divides every mesh."""
    p = primegen.make_bfv_params(1024, 50, 4)
    ctx = bfv.BFVContext.build(p)
    sk, pk = ctx.keygen(nonce=1)
    rng = np.random.default_rng(7)
    m1, m2 = rng.integers(0, p.t, (2, p.n), dtype=np.uint64)
    ct1 = ctx.encrypt(pk, m1, nonce=2)
    ct2 = ctx.encrypt(pk, m2, nonce=3)
    rlk = ctx.relin_keygen(sk, nonce=4)
    return dict(p=p, sk=sk, pk=pk, m1=m1, ct1=ct1, ct2=ct2, rlk=rlk,
                prod=ctx.mul(ct1, ct2, rlk=rlk))


@pytest.fixture(scope="module", params=RNS)
def sctx(request, ref):
    if len(jax.devices()) < request.param:
        pytest.skip(f"needs {request.param} devices")
    mesh = mesh_mod.make_mesh(rns=request.param)
    return rns_mod.ShardedBFVContext.build(ref["p"], mesh)


def _same(got, exp):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(exp))


def test_keygen(sctx, ref):
    sk, pk = sctx.keygen(nonce=1)
    _same(sk, ref["sk"])
    _same(pk, ref["pk"])
    assert len(sk.sharding.device_set) == sctx.mesh.devices.size


def test_encrypt(sctx, ref):
    _, pk = sctx.keygen(nonce=1)
    _same(sctx.encrypt(pk, ref["m1"], nonce=2), ref["ct1"])


def test_decrypt(sctx, ref):
    _same(sctx.decrypt(ref["sk"], ref["ct1"]), ref["m1"])


def test_mul_relin(sctx, ref):
    rlk = sctx.relin_keygen(ref["sk"], nonce=4)
    _same(rlk, ref["rlk"])
    _same(sctx.mul(ref["ct1"], ref["ct2"], rlk=rlk), ref["prod"])
