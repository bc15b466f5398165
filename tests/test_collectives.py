"""Communication structure of the coefficient-sharded NTT, read from the
compiled HLO.

The design (parallel/sharded.py) claims exactly log2(C) collective
permutes per transform over C coefficient shards and nothing else.
Bit-exactness tests cannot catch the partitioner silently inserting
all-gathers (correct but slow at scale), so these tests compile the
transforms on a virtual mesh and count the collectives in the HLO.
"""

import re

import jax
import numpy as np
import pytest

from ntt_bfv.ops import modmath, ntt
from ntt_bfv.parallel import mesh as mesh_mod, sharded
from ntt_bfv.utils import primegen

COLLECTIVES = ("all-reduce", "all-gather", "all-to-all",
               "collective-permute", "reduce-scatter")


def _collective_counts(lowered):
    txt = lowered.compile().as_text()
    counts = {k: 0 for k in COLLECTIVES}
    # match op instructions ("= <shape> all-reduce(" or async "-start(");
    # "-done(" closers are skipped so async pairs count once
    pat = re.compile(r"=\s+\S+\s+(" + "|".join(COLLECTIVES) +
                     r")(?:-start)?\(")
    for m in pat.finditer(txt):
        counts[m.group(1)] += 1
    return counts


@pytest.mark.parametrize("coef", [2, 4, 8])
def test_sharded_ntt_permute_count(coef):
    if len(jax.devices()) < coef:
        pytest.skip(f"needs {coef} devices")
    p = primegen.make_bfv_params(1024, 30, 2)
    mesh = mesh_mod.make_mesh(rns=1, coef=coef)
    tables = ntt.tables_for(p)
    ms = modmath.modulus_set(p)
    x = jax.device_put(np.zeros((p.r, p.n), np.uint64),
                       mesh_mod.residue_sharding(mesh, shard_coef=True))
    args = (x,
            jax.device_put(tables.psi_mont, mesh_mod.table_sharding(mesh)),
            jax.device_put(ms.q, mesh_mod.const_sharding(mesh)),
            jax.device_put(ms.qinv_neg, mesh_mod.const_sharding(mesh)))
    expect = {k: 0 for k in COLLECTIVES}
    expect["collective-permute"] = coef.bit_length() - 1
    for make in (sharded.sharded_ntt_forward, sharded.sharded_ntt_inverse):
        counts = _collective_counts(make(mesh, p.n).lower(*args))
        assert counts == expect, (make.__name__, counts)


def test_rns_keygen_gathers_no_residue_tensor():
    """GSPMD keygen over rns=4 keeps every (r, n) residue tensor sharded:
    the only gathers move per-coefficient draws shared by all moduli,
    never a u64 tensor with a modulus axis."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    import jax.numpy as jnp
    from ntt_bfv.models import bfv
    from ntt_bfv.parallel import rns

    p = primegen.make_bfv_params(1024, 50, 4)
    ctx = rns.ShardedBFVContext.build(p, mesh_mod.make_mesh(rns=4)).inner
    txt = bfv._keygen_jit.lower(
        jnp.asarray(0, jnp.uint64), ctx.ms_full, ctx.tables_full, p.n, p.r,
        ctx.uniform_spec).compile().as_text()
    moved = re.findall(r"=\s+(\S+)\s+(?:all-gather|all-to-all)(?:-start)?\(",
                       txt)
    assert moved, "expected the draw gathers"
    assert not [s for s in moved if s.startswith("u64[") and "," in s], moved
