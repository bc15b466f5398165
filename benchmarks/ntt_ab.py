"""A/B of the NTT implementations on one GPU: the CUDA kernel against
the XLA stage loop.

Transforms: device time per transform (the slope between two chained
fori_loop lengths, as bench.py measures) for forward and inverse at every
published (n, r) with J = 1 and 16, and over the 30-bit family at J = 16.

End to end: for every published parameter set, keygen, encrypt, decrypt
and mul+relin through BFVContext, once with the kernel (the default on a
GPU) and once with BFVContext.with_ntt(False), in the order kernel, xla,
xla, kernel so drift shows up.  Each number is the median host-clock
latency of `--runs` calls after warm-up, block_until_ready inside the
clock.  Results of the two implementations are checked bit-equal first.

    python benchmarks/ntt_ab.py [--sets 4k_3q,32k_16q] [--runs 20]

Prints one JSON line per case, then the card's nvidia-smi line.  Needs a
GPU; exits nonzero without one.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import ntt_step  # noqa: E402
from chip_smoke import cache_dir, smi_lines  # noqa: E402


def _median_us(fn, runs):
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e6


def transforms(card):
    """Device us per transform, kernel vs stage loop."""
    import dataclasses
    import jax.numpy as jnp
    from ntt_bfv.ops import modmath, ntt
    from ntt_bfv.params import get_bfv_params, get_params
    from ntt_bfv.utils import profiling

    cases = []
    for name in ("4k_3q", "8k_4q", "16k_5q", "32k_9q", "32k_16q"):
        p = get_bfv_params(name)
        cases += [(name, list(p.q), list(p.psi), p.n, J) for J in (1, 16)]
    for k in range(11, 17):
        q, psi, _, _, _ = get_params(1 << k, "30bit")
        cases.append((f"30bit n=2^{k}", [q], [psi], 1 << k, 16))
    rng = np.random.default_rng(1)
    for label, qs, psis, n, J in cases:
        tx = ntt.NTTTables.build(qs, psis, n, kernel=False)
        tk = dataclasses.replace(tx, kernel=True)
        ms = modmath.ModulusSet.from_moduli(qs)
        x = jnp.asarray(rng.integers(0, min(qs), (J, len(qs), n),
                                     dtype=np.uint64))
        for f in (ntt.ntt_forward_jit, ntt.ntt_inverse_jit):
            if not np.array_equal(np.asarray(f(x, tk, ms)),
                                  np.asarray(f(x, tx, ms))):
                raise AssertionError(f"{label} J={J}: kernel != xla")
        row = {"case": label, "r": len(qs), "J": J, "card": card}
        for inverse in (False, True):
            for impl, t in (("kernel", tk), ("xla", tx)):
                per = profiling.time_chained_dynamic(
                    ntt_step(inverse), x, t, ms, inner_lo=8, inner_hi=64,
                    reps=3, epochs=2)
                key = f"{'inverse' if inverse else 'forward'}_{impl}_us"
                row[key] = round(per / (J * len(qs)) * 1e6, 3)
        print(json.dumps(row), flush=True)


def _ops(ctx, rng):
    import jax.numpy as jnp
    p = ctx.params
    m1, m2 = (jnp.asarray(v) for v in
              rng.integers(0, p.t, (2, p.n), dtype=np.uint64))
    sk, pk = ctx.keygen(nonce=1)
    rlk = ctx.relin_keygen(sk)
    c1 = ctx.encrypt(pk, m1, nonce=2)
    c2 = ctx.encrypt(pk, m2, nonce=3)
    return {
        "keygen": lambda: ctx.keygen(nonce=1),
        "encrypt": lambda: ctx.encrypt(pk, m1, nonce=2),
        "decrypt": lambda: ctx.decrypt(sk, c1),
        "mul_relin": lambda: ctx.mul(c1, c2, rlk=rlk),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sets", default="4k_3q,8k_4q,16k_5q,32k_9q,32k_16q")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--skip-transforms", action="store_true")
    args = ap.parse_args(argv)

    d, set_here = cache_dir()
    import jax
    if set_here:
        jax.config.update("jax_compilation_cache_dir", d)
    if jax.devices()[0].platform != "gpu":
        print("ntt_ab: no GPU found", file=sys.stderr)
        return 2
    from ntt_bfv.models import bfv
    from ntt_bfv.params import get_bfv_params

    card = "; ".join(smi_lines())
    if not args.skip_transforms:
        transforms(card)
    for name in args.sets.split(","):
        kern = bfv.BFVContext.build(get_bfv_params(name))
        if not kern.ntt_kernel:
            raise RuntimeError(f"{name}: the kernel is not selected")
        impls = {"kernel": _ops(kern, np.random.default_rng(0)),
                 "xla": _ops(kern.with_ntt(False), np.random.default_rng(0))}
        for op in impls["kernel"]:
            a = np.asarray(jax.tree.leaves(impls["kernel"][op]())[0])
            b = np.asarray(jax.tree.leaves(impls["xla"][op]())[0])
            if not np.array_equal(a, b):
                raise AssertionError(f"{name} {op}: kernel != xla")
        res = {impl: {op: [] for op in impls[impl]} for impl in impls}
        for impl in ("kernel", "xla", "xla", "kernel"):
            for op, fn in impls[impl].items():
                res[impl][op].append(_median_us(fn, args.runs))
        row = {"set": name, "runs": args.runs, "card": card}
        for op in impls["kernel"]:
            k, x = res["kernel"][op], res["xla"][op]
            row[op] = {"kernel_us": [round(v, 1) for v in k],
                       "xla_us": [round(v, 1) for v in x],
                       "xla_over_kernel": round(min(x) / min(k), 3)}
        print(json.dumps(row), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
