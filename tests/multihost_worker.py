"""Worker for the 2-process multi-host smoke test (run by
tests/test_multihost.py, one subprocess per controller).

Each process owns 2 virtual CPU devices; the pair forms a 4-device pod
mesh.  Exercises the multi-process runtime path (parallel/multihost.py):
jax.distributed.initialize, pod_mesh, a cross-process psum, and the
GSPMD ShardedBFVContext (parallel/rns.py) over an 'rns' axis that spans
both processes, whose keys, ciphertexts and plaintexts must be
bit-identical to the single-device pipeline.
"""

import os
import sys

# Script-mode sys.path holds tests/, not the repo root: make the package
# importable even when ntt_bfv isn't pip-installed on this machine.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

coordinator, num, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from ntt_bfv.parallel import multihost  # noqa: E402

multihost.initialize(coordinator_address=coordinator, num_processes=num,
                     process_id=pid)
assert jax.process_count() == num, jax.process_count()
assert len(jax.devices()) == 2 * num
assert multihost.is_coordinator() == (pid == 0)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from jax import shard_map  # noqa: E402

# ---- pod_mesh + one cross-process psum ------------------------------------
mesh = multihost.pod_mesh()          # every device on 'rns' by default
assert mesh.shape == {"rns": 4, "coef": 1}, mesh.shape
# jax.devices() is process-major: each process owns two adjacent rows
for row in range(4):
    assert mesh.devices[row][0].process_index == row // 2


@jax.jit
def psum_over_rns(x):
    fn = shard_map(lambda v: jax.lax.psum(v, "rns"), mesh=mesh,
                   in_specs=P("rns"), out_specs=P())
    return fn(x)


x = jnp.arange(8.0)                  # shard i holds [2i, 2i+1]
out = psum_over_rns(x)
np.testing.assert_allclose(np.asarray(out.addressable_shards[0].data),
                           np.array([12.0, 16.0]))

# ---- GSPMD BFV keygen -> encrypt -> decrypt across the two processes -------
from ntt_bfv.models import bfv  # noqa: E402
from ntt_bfv.parallel import mesh as mesh_mod, rns  # noqa: E402
from ntt_bfv.utils import primegen  # noqa: E402

params = primegen.make_bfv_params(2048, 40, 2)
rns_mesh = mesh_mod.make_mesh(rns=2, devices=[mesh.devices[0][0],
                                              mesh.devices[2][0]])
ctx = rns.ShardedBFVContext.build(params, rns_mesh)
sk_s, pk_s = ctx.keygen()

ref = bfv.BFVContext.build(params)
sk_r, pk_r = ref.keygen()            # deterministic, same in both processes


def check(got, exp):
    exp_np = np.asarray(exp)
    for shard in got.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      exp_np[shard.index])


check(sk_s, sk_r)
check(pk_s, pk_r)
m_np = np.arange(params.n, dtype=np.uint64) % params.t
ct_s = ctx.encrypt(pk_s, m_np)
check(ct_s, ref.encrypt(pk_r, m_np))
check(ctx.decrypt(sk_s, ct_s), m_np)

print(f"proc {pid}: multihost smoke OK", flush=True)
