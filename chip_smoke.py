"""Smoke run of the library's main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases 0-3
    python chip_smoke.py --multichip   # four cards: the sharded paths only

Phase 0 checks that JAX sees a GPU (and exits nonzero when it does not),
then prints the card's name and power limit, the JAX version, the device
kind, the compile-cache directory and whether the native host library
loaded.  Phase 1 decrypts the reference's embedded 4k_3q ciphertext.
Phase 2 drives BFVContext at 32k_16q (keygen, encrypt, decrypt, the J=16
batched entry points, relinearised mul and square) against exact host
oracles, checks 4k_3q against the exact-integer golden pipeline, and
prints per-op latency, compile time and the mul+relin memory analysis.
Phase 3 compares the CUDA NTT kernel with the XLA stage loop, bit for
bit, at every published (n, r) and over the 30-bit family.

Every phase passes or raises.  The last stdout line is one JSON object
{"ok": true, "device": {...}}; nothing is printed there on failure.
One process drives the card(s); nvidia-smi runs as a child that never
imports JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]
PUBLISHED = ("4k_3q", "8k_4q", "16k_5q", "32k_9q", "32k_16q")
RUNS = 20


def cache_dir(env=None) -> tuple[str, bool]:
    """(directory, set_here): JAX reads JAX_COMPILATION_CACHE_DIR itself
    when it is set; otherwise the cache is the fixed .jax_cache/ at the
    checkout root."""
    env = os.environ if env is None else env
    if env.get(CACHE_ENV):
        return env[CACHE_ENV], False
    return str(ROOT / ".jax_cache"), True


def parse_smi(line: str) -> tuple[str, str]:
    """'NVIDIA H100 80GB HBM3, 700.00 W' -> (name, power limit)."""
    name, _, limit = line.strip().rpartition(",")
    if not name:
        raise ValueError(f"unexpected nvidia-smi line: {line!r}")
    return name.strip(), limit.strip()


def smi_lines() -> list[str]:
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    for ln in lines:
        parse_smi(ln)
    return lines


def last_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def log(msg: str) -> None:
    print(msg, flush=True)


def median_us(fn, *args, runs: int = RUNS) -> float:
    """Median host-clock latency of fn(*args) in us, block_until_ready
    inside the clock, after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e6


def first_call_s(fn, *args) -> float:
    """Seconds of the first call: compilation (or a cache load) plus one
    run."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def negacyclic_mod_t(a, b, t: int):
    """Exact negacyclic product mod t (host, numpy int64 convolution:
    n * t^2 < 2^63 for every published set)."""
    import numpy as np
    n = a.size
    c = np.convolve(a.astype(np.int64), b.astype(np.int64))
    lo = c[:n].copy()
    lo[: n - 1] -= c[n:]
    return (lo % t).astype(np.uint64)


def import_package():
    """The package beside this script, and nothing else."""
    sys.path.insert(0, str(ROOT))
    import ntt_bfv
    where = Path(ntt_bfv.__file__).resolve().parent
    if where.parent != ROOT:
        raise RuntimeError(f"ntt_bfv found at {where}, not beside "
                           f"{ROOT / 'chip_smoke.py'}")
    return ntt_bfv


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase0(card: str):
    import jax
    from ntt_bfv import native
    d, set_here = cache_dir()
    log(f"[phase0] jax {jax.__version__}, device_kind "
        f"{jax.devices()[0].device_kind}, devices {len(jax.devices())}")
    log(f"[phase0] compile cache {d} "
        f"({'set here' if set_here else 'from ' + CACHE_ENV})")
    log(f"[phase0] native host library loaded: {native.available()}")
    log(f"[phase0] card: {card}")


def phase1():
    import numpy as np
    import jax.numpy as jnp
    from ntt_bfv.models import bfv
    from ntt_bfv.params import get_bfv_params
    fix = ROOT / "tests" / "fixtures"
    ctx = bfv.BFVContext.build(get_bfv_params("4k_3q"))
    ct = jnp.asarray(np.stack([np.load(fix / "dec4k_c0.npy"),
                               np.load(fix / "dec4k_c1.npy")]))
    sk = jnp.asarray(np.load(fix / "dec4k_sk_ntt.npy"))
    got = np.asarray(ctx.decrypt(sk, ct))
    exp = np.arange(ctx.params.n, dtype=np.uint64) % 10
    if not np.array_equal(got, exp):
        raise AssertionError(f"golden ciphertext: {int((got != exp).sum())} "
                             f"of {exp.size} coefficients differ")
    log(f"[phase1] golden 4k_3q ciphertext decrypted bit-exactly "
        f"({exp.size} coefficients == i % 10, ntt kernel "
        f"{ctx.ntt_kernel})")


def _check(name, got, exp):
    import numpy as np
    got, exp = np.asarray(got), np.asarray(exp)
    if got.shape != exp.shape or not np.array_equal(got, exp):
        raise AssertionError(f"{name}: mismatch")


def phase2(card: str):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from ntt_bfv.models import bfv
    from ntt_bfv.params import get_bfv_params

    p = get_bfv_params("32k_16q")
    rng = np.random.default_rng(2024)
    t0 = time.perf_counter()
    ctx = bfv.BFVContext.build(p)
    log(f"[phase2] 32k_16q n={p.n} r={p.r} t={p.t} context built in "
        f"{time.perf_counter() - t0:.2f} s, ntt kernel {ctx.ntt_kernel}")
    J = 16
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    m2 = rng.integers(0, p.t, p.n, dtype=np.uint64)
    mb = rng.integers(0, p.t, (J, p.n), dtype=np.uint64)
    nonces = np.arange(1, J + 1, dtype=np.uint64)
    mj, m2j, mbj = jnp.asarray(m), jnp.asarray(m2), jnp.asarray(mb)
    nj = jnp.asarray(nonces)

    first = {}
    first["keygen"] = first_call_s(ctx.keygen)
    sk, pk = ctx.keygen()
    first["encrypt"] = first_call_s(ctx.encrypt, pk, mj)
    ct = ctx.encrypt(pk, mj, nonce=100)
    first["decrypt"] = first_call_s(ctx.decrypt, sk, ct)
    _check("decrypt(encrypt(m))", ctx.decrypt(sk, ct), m)
    log("[phase2] keygen -> encrypt -> decrypt == m")

    first["encrypt_batch"] = first_call_s(ctx.encrypt_batch, pk, mbj, nj)
    cts = ctx.encrypt_batch(pk, mbj, nj)
    for j in range(J):
        _check(f"encrypt_batch[{j}]", cts[j],
               ctx.encrypt(pk, mbj[j], nonce=int(nonces[j])))
    first["decrypt_batch"] = first_call_s(ctx.decrypt_batch, sk, cts)
    outs = ctx.decrypt_batch(sk, cts)
    _check("decrypt_batch", outs, mb)
    for j in range(J):
        _check(f"decrypt_batch[{j}]", outs[j], ctx.decrypt(sk, cts[j]))
    log(f"[phase2] encrypt_batch / decrypt_batch J={J} == per-message "
        f"results")

    rlk = ctx.relin_keygen(sk)
    c1 = ctx.encrypt(pk, mj, nonce=201)
    c2 = ctx.encrypt(pk, m2j, nonce=202)
    mul = lambda a, b: ctx.mul(a, b, rlk=rlk)
    sq = lambda a: ctx.square(a, rlk=rlk)
    first["mul_relin"] = first_call_s(mul, c1, c2)
    first["square_relin"] = first_call_s(sq, c1)
    _check("mul+relin", ctx.decrypt(sk, mul(c1, c2)),
           negacyclic_mod_t(m, m2, p.t))
    _check("square+relin", ctx.decrypt(sk, sq(c1)),
           negacyclic_mod_t(m, m, p.t))
    log("[phase2] mul+relin and square+relin == exact negacyclic "
        "products mod t")

    mul_fn, _, bz = ctx.mult_program()
    compiled = jax.jit(mul_fn).lower(c1, c2, rlk, bz).compile()
    log(f"[phase2] mul+relin memory_analysis: {compiled.memory_analysis()}")

    lat = {
        "keygen": median_us(ctx.keygen),
        "encrypt": median_us(ctx.encrypt, pk, mj),
        "decrypt": median_us(ctx.decrypt, sk, ct),
        "encrypt_batch": median_us(ctx.encrypt_batch, pk, mbj, nj),
        "decrypt_batch": median_us(ctx.decrypt_batch, sk, cts),
        "mul_relin": median_us(mul, c1, c2),
        "square_relin": median_us(sq, c1),
    }
    for op, us in lat.items():
        per = f" ({us / J:.1f} us/msg)" if op.endswith("_batch") else ""
        log(f"[phase2] {op}: median {us:.1f} us over {RUNS} runs{per}; "
            f"first call {first[op]:.2f} s  [{card}]")

    golden_4k()


def golden_4k():
    """4k_3q keygen / encrypt / decrypt vs the exact-integer golden
    pipeline fed the device's own draws (tests/test_bfv.py)."""
    import numpy as np
    import jax.numpy as jnp
    from ntt_bfv.models import bfv
    from ntt_bfv.ops import sampling
    from ntt_bfv.params import get_bfv_params
    from ntt_bfv.utils import golden

    p = get_bfv_params("4k_3q")
    ctx = bfv.BFVContext.build(p)
    tabs = [p.psi_tables(i) for i in range(p.r)]
    pt, pit = [t[0] for t in tabs], [t[1] for t in tabs]
    s, a, e = sampling.keygen_draws(p.n, p.r, ctx.ms_full)
    sk, pk = ctx.keygen()
    sk_g, pk0_g, pk1_g = golden.keygen(
        p, np.asarray(s).tolist(), np.asarray(a).tolist(),
        np.asarray(e).tolist(), pt, pit)
    _check("4k keygen sk", sk, np.array(sk_g, np.uint64))
    _check("4k keygen pk", pk, np.array([pk0_g, pk1_g], np.uint64))
    m = np.random.default_rng(4).integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx.encrypt(pk, jnp.asarray(m))
    u, e0, e1 = sampling.encrypt_draws(p.n, p.r, ctx.ms_full)
    ct_g = golden.encrypt(p, np.asarray(pk[0]).tolist(),
                          np.asarray(pk[1]).tolist(), m.tolist(),
                          np.asarray(u).tolist(), np.asarray(e0).tolist(),
                          np.asarray(e1).tolist(), pt, pit)
    _check("4k encrypt", ct, np.array(ct_g, np.uint64))
    m_g = golden.decrypt(p, np.asarray(ct[0]).tolist(),
                         np.asarray(ct[1]).tolist(),
                         np.asarray(sk).tolist(), pt, pit)
    _check("4k decrypt (golden)", ctx.decrypt(sk, ct),
           np.array(m_g, np.uint64))
    _check("4k decrypt", ctx.decrypt(sk, ct), m)
    log("[phase2] 4k_3q keygen / encrypt / decrypt == exact-integer golden "
        "pipeline")


def phase3(card: str):
    """CUDA NTT kernel vs the XLA stage loop, bit for bit."""
    import dataclasses
    import numpy as np
    import jax
    import jax.numpy as jnp
    from ntt_bfv.ops import modmath, ntt, salsa20, sampling
    from ntt_bfv.params import get_bfv_params, get_params

    cases = []
    for name in PUBLISHED:
        p = get_bfv_params(name)
        cases.append((name, list(p.q), list(p.psi), p.n))
    for k in range(11, 17):
        n = 1 << k
        q, psi, _, _, _ = get_params(n, "30bit")
        cases.append((f"30bit n=2^{k}", [q], [psi], n))

    fwd_x = jax.jit(ntt.forward_stages)
    inv_x = jax.jit(ntt.inverse_stages)
    rng = np.random.default_rng(3)
    for label, qs, psis, n in cases:
        tx = ntt.NTTTables.build(qs, psis, n, kernel=False)
        tk = dataclasses.replace(tx, kernel=True)
        ms = modmath.ModulusSet.from_moduli(qs)
        for J in (1, 16):
            x = jnp.asarray(np.stack([
                np.stack([rng.integers(0, q, n, dtype=np.uint64)
                          for q in qs]) for _ in range(J)]))
            fk = ntt.ntt_forward_jit(x, tk, ms)
            _check(f"{label} J={J} forward", fk, fwd_x(x, tx, ms))
            _check(f"{label} J={J} inverse", ntt.ntt_inverse_jit(fk, tk, ms),
                   inv_x(fk, tx, ms))
            _check(f"{label} J={J} roundtrip",
                   ntt.ntt_inverse_jit(fk, tk, ms), x)
            t = [median_us(f, y, tt, ms) for f, y, tt in (
                (ntt.ntt_forward_jit, x, tk), (fwd_x, x, tx),
                (ntt.ntt_inverse_jit, fk, tk), (inv_x, fk, tx))]
            log(f"[phase3] {label} r={len(qs)} J={J}: bit-exact; forward "
                f"kernel {t[0]:.1f} us / xla {t[1]:.1f} us, inverse kernel "
                f"{t[2]:.1f} us / xla {t[3]:.1f} us  [{card}]")

    p = get_bfv_params("32k_16q")
    nblocks = (sampling.keygen_entropy_bytes(p.n, p.r) + 63) // 64
    txt = jax.jit(lambda nn: salsa20.keystream_block_words(
        nblocks, nonce=nn)).lower(jnp.uint64(0)).compile().as_text()
    log(f"[phase3] 32k_16q keygen keystream ({nblocks} blocks): "
        f"{txt.count(' fusion(')} fusion ops in the compiled HLO")


def multichip(card: str):
    """GSPMD rns=4 at 32k_16q vs one card, and the coef-sharded NTT round
    trip on rns=2 x coef=2."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from ntt_bfv.models import bfv
    from ntt_bfv.ops import modmath, ntt
    from ntt_bfv.parallel import mesh as mesh_mod, rns, sharded
    from ntt_bfv.params import get_bfv_params

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--multichip needs 4 GPUs, JAX sees "
                           f"{len(jax.devices())}")
    p = get_bfv_params("32k_16q")
    rng = np.random.default_rng(5)
    m1, m2 = rng.integers(0, p.t, (2, p.n), dtype=np.uint64)
    one = bfv.BFVContext.build(p)                       # device 0
    sctx = rns.ShardedBFVContext.build(p, mesh_mod.make_mesh(rns=4))

    def devices(x):
        return sorted(d.id for d in x.sharding.device_set)

    sk, pk = one.keygen(nonce=1)
    sk_s, pk_s = sctx.keygen(nonce=1)
    _check("rns=4 keygen sk", sk_s, sk)
    _check("rns=4 keygen pk", pk_s, pk)
    log(f"[multichip] keygen bit-equal; sk on devices {devices(sk_s)}, "
        f"pk on {devices(pk_s)}")
    ct1 = one.encrypt(pk, m1, nonce=2)
    ct_s = sctx.encrypt(pk_s, m1, nonce=2)
    _check("rns=4 encrypt", ct_s, ct1)
    log(f"[multichip] encrypt bit-equal; ct on devices {devices(ct_s)}")
    dec = sctx.decrypt(sk_s, ct_s)
    _check("rns=4 decrypt", dec, m1)
    log(f"[multichip] decrypt == m; on devices {devices(dec)}")
    ct2 = one.encrypt(pk, m2, nonce=3)
    rlk = one.relin_keygen(sk)
    rlk_s = sctx.relin_keygen(sk_s)
    _check("rns=4 relin_keygen", rlk_s, rlk)
    prod_s = sctx.mul(ct1, ct2, rlk=rlk_s)
    _check("rns=4 mul+relin", prod_s, one.mul(ct1, ct2, rlk=rlk))
    _check("rns=4 mul+relin decrypt", one.decrypt(sk, prod_s),
           negacyclic_mod_t(m1, m2, p.t))
    log(f"[multichip] mul+relin bit-equal to one card and == m1*m2 mod t; "
        f"rlk on devices {devices(rlk_s)}, product on {devices(prod_s)}")
    for op, fn, args in (
            ("keygen", sctx.keygen, ()),
            ("encrypt", sctx.encrypt, (pk_s, m1)),
            ("decrypt", sctx.decrypt, (sk_s, ct_s)),
            ("mul_relin", lambda a, b: sctx.mul(a, b, rlk=rlk_s),
             (ct1, ct2))):
        log(f"[multichip] rns=4 {op}: median {median_us(fn, *args):.1f} us "
            f"over {RUNS} runs  [{card}]")

    mesh = mesh_mod.make_mesh(rns=2, coef=2)
    p2 = get_bfv_params("8k_4q")
    tables = ntt.tables_for(p2, kernel=False)
    ms = modmath.modulus_set(p2)
    x = np.stack([rng.integers(0, q, p2.n, dtype=np.uint64) for q in p2.q])
    xs = jax.device_put(jnp.asarray(x),
                        mesh_mod.residue_sharding(mesh, shard_coef=True))
    tab_f = jax.device_put(tables.psi_mont, mesh_mod.table_sharding(mesh))
    tab_i = jax.device_put(tables.psiinv_mont, mesh_mod.table_sharding(mesh))
    q = jax.device_put(ms.q, mesh_mod.const_sharding(mesh))
    qi = jax.device_put(ms.qinv_neg, mesh_mod.const_sharding(mesh))
    f = sharded.sharded_ntt_forward(mesh, p2.n)(xs, tab_f, q, qi)
    _check("coef-sharded forward", f,
           ntt.ntt_forward_jit(jnp.asarray(x), tables, ms))
    back = sharded.sharded_ntt_inverse(mesh, p2.n)(f, tab_i, q, qi)
    _check("coef-sharded round trip", back, x)
    log(f"[multichip] coef-sharded NTT (rns=2, coef=2, 8k_4q) == ops/ntt.py"
        f", round trip exact; on devices {devices(f)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    d, set_here = cache_dir()
    import jax
    if set_here:
        jax.config.update("jax_compilation_cache_dir", d)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devs[0].platform!r}); this script runs only on a card",
              file=sys.stderr)
        return 2
    import_package()
    smi = smi_lines()
    for ln in smi:
        print(ln, flush=True)
    card = "; ".join(smi)
    phase0(card)
    if args.multichip:
        multichip(card)
        count = 4
    else:
        phase1()
        phase2(card)
        phase3(card)
        count = 1
    if len(devs) < count:
        raise RuntimeError(f"expected {count} device(s), JAX sees "
                           f"{len(devs)}")
    print(last_line(devs[0].platform, devs[0].device_kind, len(devs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
