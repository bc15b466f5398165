"""Scaling-efficiency benchmark: NTT + BFV ops/s at 1 chip vs N devices.

BASELINE.json config 5: sharded N=2^17 NTT and BFV enc/dec across a slice,
efficiency = (ops/s at N devices) / (N * ops/s at 1 device).  The RNS axis
scales embarrassingly (only BEHZ's psum and the last-residue broadcast
communicate); the coef axis pays ppermute exchanges for log2(C) butterfly
stage groups.

One process drives every card of the host; across hosts, run one
process per host with `ntt_bfv.parallel.multihost.initialize()`
first.  On a single card it reports the 1-device baseline.  With --cpu
(virtual devices from xla_force_host_platform_device_count) it rehearses
the harness and the collective structure; its times are not device
numbers.

Usage: python benchmarks/scaling.py [--n 131072] [--r 8] [--op ntt|bfv]
Prints one JSON line per mesh shape.
"""

import argparse
import json
import sys
import time

import numpy as np


def _bench(fn, args, reps=5):
    out = fn(*args)
    _ = np.asarray(out if not isinstance(out, tuple) else out[0]).ravel()[:1]
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _ = np.asarray(out if not isinstance(out, tuple) else out[0]).ravel()[:1]
    return (time.perf_counter() - t0) / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 17)
    ap.add_argument("--r", type=int, default=8)
    ap.add_argument("--op", default="ntt", choices=["ntt", "bfv"])
    ap.add_argument("--qbits", type=int, default=55)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU backend's virtual devices")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from ntt_bfv.ops import modmath, ntt
    from ntt_bfv.parallel import mesh as mesh_mod, rns as rns_mod, sharded
    from ntt_bfv.utils import primegen

    n, r = args.n, args.r
    params = primegen.make_bfv_params(n, args.qbits, r)
    devs = jax.devices()
    D = len(devs)
    print(f"platform={jax.default_backend()} devices={D} n={n} r={r}",
          file=sys.stderr)

    # mesh ladder: (rns, coef) shapes from 1 device up to all of them
    shapes = []
    d = 1
    while d <= D:
        if args.op == "ntt":
            rns_ax = 1          # single modulus: coefficient sharding only
        else:
            rns_ax = min(d, r)
            while d % rns_ax or r % rns_ax:
                rns_ax -= 1
        shapes.append((rns_ax, d // rns_ax))
        d *= 2
    base_rate = None
    rng = np.random.default_rng(0)

    for rns_ax, coef_ax in shapes:
        ndev = rns_ax * coef_ax
        mesh = mesh_mod.make_mesh(rns=rns_ax, coef=coef_ax,
                                  devices=devs[:ndev])
        if args.op == "ntt":
            q, psi = params.q[0], params.psi[0]
            tables = ntt.NTTTables.build([q], [psi], n)
            ms = modmath.ModulusSet.from_moduli([q])
            x = jnp.asarray(rng.integers(0, q, (1, n), dtype=np.uint64))
            xs = jax.device_put(x, mesh_mod.residue_sharding(
                mesh, shard_coef=True))
            tab = jax.device_put(tables.psi_mont, mesh_mod.table_sharding(mesh))
            qd = jax.device_put(ms.q, mesh_mod.const_sharding(mesh))
            qi = jax.device_put(ms.qinv_neg, mesh_mod.const_sharding(mesh))
            fwd = sharded.sharded_ntt_forward(mesh, n)
            dt = _bench(fwd, (xs, tab, qd, qi))
        else:
            sctx = rns_mod.ShardedBFVContext.build(params, mesh)
            _, pk = sctx.keygen()
            m = jnp.asarray(np.arange(n, dtype=np.uint64) % params.t)
            dt = _bench(sctx.encrypt, (pk, m))
        rate = 1.0 / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * ndev)
        print(json.dumps({
            "op": args.op, "n": n, "r": r,
            "mesh": {"rns": rns_ax, "coef": coef_ax},
            "sec_per_op": round(dt, 6),
            "ops_per_sec": round(rate, 2),
            "scaling_efficiency_vs_1dev": round(eff, 3),
        }))


if __name__ == "__main__":
    main()
