"""Command-line drivers — the analogs of the reference's four main() files.

    python -m ntt_bfv demo            # demo.cu: keygen->enc->dec + timing
    python -m ntt_bfv ntt-test        # 60bit_ntt_test.cu: polymul vs golden
    python -m ntt_bfv decryption-test # decryption_test.cu: golden vectors
    python -m ntt_bfv keygen-test     # keygen_test.cu: ternary histogram
    python -m ntt_bfv keys / encrypt / decrypt   # .npz serialization flows

The reference builds one Visual Studio binary per driver
(BFV_Scheme/README.md:3-8); here each is a subcommand over the same
library.  Timing methodology: per-phase latency via chained-iteration
slope (utils/profiling.py), which removes per-dispatch host overhead —
the analog of the reference's cudaEvent pairs (demo.cu:275-296).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _ctx(args):
    from .models import bfv
    from .params import get_bfv_params
    params = get_bfv_params(args.params)
    return params, bfv.BFVContext.build(params)


def _phase_times(ctx, params, inner=None):
    """Per-phase latency in seconds: keygen, encrypt, decrypt.

    Each phase chains `inner` data-dependent iterations inside one jit
    (per-iteration Salsa20 nonces / carried perturbations defeat XLA
    loop-invariant hoisting) and takes the slope between two inner counts.
    """
    import jax
    import jax.numpy as jnp
    from .utils import profiling

    m = jnp.asarray(np.arange(params.n, dtype=np.uint64) % params.t)
    sk, pk = ctx.keygen()
    ct = ctx.encrypt(pk, m)
    if inner is None:
        # chain length scaled so the slope dwarfs host dispatch jitter
        # regardless of per-op cost (small n => cheap ops => longer chains)
        hi = max(64, (1 << 24) // (params.n * params.r))
        lo = hi // 8
    else:
        lo, hi = inner
    t = jnp.uint64(params.t)
    q0 = jnp.uint64(params.q[0])

    def kg_make(k):
        @jax.jit
        def step(seed):
            def body(i, s):
                skk, pkk = ctx.keygen(nonce=s)
                # consume both outputs: XLA dead-code-eliminates the pk
                # path (2 of keygen's 3 NTT batches) otherwise
                return skk[0, 0] + pkk[0, 0, 0] + pkk[1, 0, 0]                  # carries into next nonce
            return jax.lax.fori_loop(0, k, body, seed)
        return step

    def enc_make(k):
        @jax.jit
        def step(c):
            def body(_, cc):
                return ctx.encrypt(pk, m, nonce=cc[0, 0, 0])
            return jax.lax.fori_loop(0, k, body, c)
        return step

    def dec_make(k):
        @jax.jit
        def step(c):
            def body(_, cc):
                out = ctx.decrypt(sk, cc)
                return cc.at[0, 0, 0].set((cc[0, 0, 0] + out[0]) % q0)
            return jax.lax.fori_loop(0, k, body, c)
        return step

    t_kg = profiling.time_chained(kg_make, jnp.uint64(1), lo, hi)
    t_enc = profiling.time_chained(enc_make, ct, lo, hi)
    t_dec = profiling.time_chained(dec_make, ct, lo, hi)
    return t_kg, t_enc, t_dec


def cmd_demo(args) -> int:
    """demo.cu equivalent: keygen -> encrypt -> decrypt, verify, time."""
    import jax
    import jax.numpy as jnp

    params, ctx = _ctx(args)
    print(f"[demo] platform={jax.default_backend()} "
          f"ntt={'cuda' if ctx.ntt_kernel else 'xla'} "
          f"n={params.n} r={params.r} t={params.t}")
    rng = np.random.default_rng(args.seed)
    m = jnp.asarray(rng.integers(0, params.t, params.n, dtype=np.uint64))

    t0 = time.perf_counter()
    sk, pk = ctx.keygen()
    ct = ctx.encrypt(pk, m)
    out = np.asarray(ctx.decrypt(sk, ct))
    t_first = time.perf_counter() - t0
    ok = np.array_equal(out, np.asarray(m))
    print(f"[demo] decrypt(encrypt(m)) == m: {'PASS' if ok else 'FAIL'} "
          f"(first run incl. compile: {t_first:.1f}s)")
    if not ok:
        return 1
    if args.time:
        t_kg, t_enc, t_dec = _phase_times(ctx, params)
        print(f"[demo] keygen  {t_kg*1e6:9.1f} us")
        print(f"[demo] encrypt {t_enc*1e6:9.1f} us")
        print(f"[demo] decrypt {t_dec*1e6:9.1f} us")
    if args.mul:
        from .utils import golden
        m2 = jnp.asarray(rng.integers(0, params.t, params.n,
                                      dtype=np.uint64))
        ct2 = ctx.encrypt(pk, m2, nonce=1)
        t0 = time.perf_counter()
        rlk = ctx.relin_keygen(sk)
        prod = ctx.mul(ct, ct2, rlk=rlk)
        outp = np.asarray(ctx.decrypt(sk, prod))
        t_first = time.perf_counter() - t0
        exp = golden.schoolbook_negacyclic(
            np.asarray(m).tolist(), np.asarray(m2).tolist(),
            params.t, params.n)
        okm = outp.tolist() == exp
        print(f"[demo] decrypt(mul(ct, ct2)) == m*m2: "
              f"{'PASS' if okm else 'FAIL'} "
              f"(first run incl. compile: {t_first:.1f}s)")
        if not okm:
            return 1
        if args.time:
            jax.block_until_ready(ctx.mul(ct, ct2, rlk=rlk))
            t0 = time.perf_counter()
            jax.block_until_ready(ctx.mul(ct, ct2, rlk=rlk))
            print(f"[demo] mul+relin {(time.perf_counter()-t0)*1e6:9.1f} us"
                  " (single dispatch incl. host latency; bench.py has the"
                  " chained-slope number)")
    return 0


def cmd_ntt_test(args) -> int:
    """60bit_ntt_test.cu equivalent: NTT->dyadic->INTT vs schoolbook
    (--family 30bit mirrors old/30bit_ntt_test.cu on the same path)."""
    import jax.numpy as jnp
    from .ops import modmath, ntt
    from .params import get_params
    from .utils import golden

    n = args.n
    q, psi, psiinv, _, _ = get_params(n, family=args.family)
    print(f"[ntt-test] n={n} q={q} ({q.bit_length()} bits, "
          f"{args.family} family)")
    rng = np.random.default_rng(args.seed)
    a = rng.integers(0, q, n, dtype=np.uint64)
    b = rng.integers(0, q, n, dtype=np.uint64)
    tables = ntt.NTTTables.build([q], [psi], n)
    ms = modmath.ModulusSet.from_moduli([q])
    got = np.asarray(ntt.negacyclic_polymul(
        jnp.asarray(a[None]), jnp.asarray(b[None]), tables, ms))[0]
    expect = golden.schoolbook_negacyclic(a, b, q, n)
    ok = [int(x) for x in got] == [int(x) for x in expect]
    print(f"[ntt-test] polymul vs schoolbook golden model: "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def cmd_decryption_test(args) -> int:
    """decryption_test.cu equivalent: golden-vector decryption."""
    from pathlib import Path
    import jax.numpy as jnp
    from .models import bfv
    from .params import get_bfv_params

    fix = Path(args.fixtures)
    params = get_bfv_params("4k_3q")
    ctx = bfv.BFVContext.build(params)
    c0 = np.load(fix / "dec4k_c0.npy")
    c1 = np.load(fix / "dec4k_c1.npy")
    sk = np.load(fix / "dec4k_sk_ntt.npy")
    ct = jnp.stack([jnp.asarray(c0), jnp.asarray(c1)])
    skj = jnp.concatenate([jnp.asarray(sk),
                           jnp.zeros((1, params.n), jnp.uint64)])
    t0 = time.perf_counter()
    out = np.asarray(ctx.decrypt(skj, ct))
    dt = time.perf_counter() - t0
    ok = np.array_equal(out, np.arange(params.n) % 10)
    print(f"[decryption-test] reference golden vectors (n=4096, r=3): "
          f"{'PASS' if ok else 'FAIL'} ({dt:.2f}s incl. compile)")
    return 0 if ok else 1


def cmd_keygen_test(args) -> int:
    """keygen_test.cu equivalent: ternary-sampler histogram (the reference
    draws 341M samples and eyeballs the -1/0/1 balance; we draw fewer and
    assert a 3-sigma band)."""
    from .ops import salsa20
    from .utils import golden

    nbytes = args.samples
    ks = np.asarray(salsa20.keystream_for_bytes(nbytes)).view(np.uint8)[:nbytes]
    # convert_ternary exactly as the sampler ships it (ops/sampling.py:49,
    # bfv_keygen.cuh:29-30): byte // 85 - 1 in {-1, 0, 1, 2} — byte 255
    # emits residue 2 (the reference's quirk), NOT a clamped 1.
    vals = ks.astype(np.int64) // 85 - 1
    hist = {v: int(np.sum(vals == v)) for v in (-1, 0, 1, 2)}
    total = sum(hist.values())
    print(f"[keygen-test] {total} ternary samples: {hist}")
    # bytes 0..84 -> -1, 85..169 -> 0, 170..254 -> 1, 255 -> 2
    p = {-1: 85 / 256, 0: 85 / 256, 1: 85 / 256, 2: 1 / 256}
    ok = True
    for v, cnt in hist.items():
        mu = total * p[v]
        sigma = (total * p[v] * (1 - p[v])) ** 0.5
        dev = abs(cnt - mu) / sigma
        print(f"[keygen-test]   {v:+d}: {cnt} (expected {mu:.0f}, "
              f"{dev:.2f} sigma)")
        ok = ok and dev < 4.0
    print(f"[keygen-test] {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def cmd_keys(args) -> int:
    """Generate a keypair and save it (.npz)."""
    from .utils import serialize
    params, ctx = _ctx(args)
    sk, pk = ctx.keygen()
    serialize.save_keypair(args.out, params, np.asarray(sk), np.asarray(pk))
    print(f"[keys] wrote keypair for {params.name} -> {args.out}")
    return 0


def cmd_encrypt(args) -> int:
    from .utils import serialize
    import jax.numpy as jnp
    params, ctx = _ctx(args)
    _, pk = serialize.load_keypair(args.keys, params)
    rng = np.random.default_rng(args.seed)
    m = (np.arange(params.n, dtype=np.uint64) % params.t if args.message == "ramp"
         else rng.integers(0, params.t, params.n, dtype=np.uint64))
    ct = ctx.encrypt(jnp.asarray(pk), jnp.asarray(m))
    serialize.save_ciphertext(args.out, params, np.asarray(ct))
    print(f"[encrypt] wrote ciphertext ({args.message}) -> {args.out}")
    return 0


def cmd_decrypt(args) -> int:
    from .utils import serialize
    import jax.numpy as jnp
    params, ctx = _ctx(args)
    sk, _ = serialize.load_keypair(args.keys, params)
    ct = serialize.load_ciphertext(args.ct, params)
    out = np.asarray(ctx.decrypt(jnp.asarray(sk), jnp.asarray(ct)))
    print(f"[decrypt] plaintext head: {out[:16].tolist()}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ntt_bfv",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--params", default="4k_3q",
                    help="parameter set name (default 4k_3q)")
    ap.add_argument("--seed", type=int, default=0)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("demo", help="keygen->encrypt->decrypt + timings")
    p.add_argument("--time", action="store_true", help="per-phase timings")
    p.add_argument("--mul", action="store_true",
                   help="also drive EvalMult + relinearization")
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("ntt-test", help="polymul vs schoolbook golden model")
    p.add_argument("--n", type=int, default=2048)
    p.add_argument("--family", default="60bit", choices=["60bit", "30bit"])
    p.set_defaults(fn=cmd_ntt_test)

    p = sub.add_parser("decryption-test", help="reference golden vectors")
    p.add_argument("--fixtures", default="tests/fixtures")
    p.set_defaults(fn=cmd_decryption_test)

    p = sub.add_parser("keygen-test", help="ternary sampler histogram")
    p.add_argument("--samples", type=int, default=1 << 22)
    p.set_defaults(fn=cmd_keygen_test)

    p = sub.add_parser("keys", help="generate + save a keypair")
    p.add_argument("--out", default="keys.npz")
    p.set_defaults(fn=cmd_keys)

    p = sub.add_parser("encrypt", help="encrypt a message with saved keys")
    p.add_argument("--keys", default="keys.npz")
    p.add_argument("--out", default="ct.npz")
    p.add_argument("--message", default="ramp", choices=["ramp", "random"])
    p.set_defaults(fn=cmd_encrypt)

    p = sub.add_parser("decrypt", help="decrypt a saved ciphertext")
    p.add_argument("--keys", default="keys.npz")
    p.add_argument("--ct", default="ct.npz")
    p.set_defaults(fn=cmd_decrypt)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
