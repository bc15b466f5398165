"""Benchmark: the reference's headline metrics on one NVIDIA GPU.

Prints ONE compact JSON line as the final stdout line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
   "intt_us": ..., "intt_vs_baseline": ..., "device": {...}}

value / vs_baseline carry the headline forward-NTT throughput (N=2^15,
55-bit family, Article.pdf Table 6: 39 us on V100 => 25,641 NTT/s).
Every other published anchor — inverse NTT (Table 6: 23 us), the full
Table 6 sweeps (55-bit + 30-bit families), and BFV keygen / encrypt /
decrypt per-op latency for all five Table 7 parameter sets
(BASELINE.md:37-45), each with its own vs_baseline (>1 = faster than the
V100 number) — is written to bench_detail.json (or BENCH_DETAIL).

Every transform goes through the library's NTT entry (ops/ntt.py: the
CUDA kernel on a GPU).  Per-op time is the slope between two chained
iteration counts inside one jit (lax.fori_loop with a dynamic trip
count), min over epochs, every output consumed.  Every row is stamped
with the platform, device kind, device count and the card's nvidia-smi
name and power limit; without a GPU the script exits nonzero.  Set
BENCH_SETS=32k_9q (comma list) to restrict the BFV sweep,
BENCH_NTT_ONLY=1 to skip it.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from chip_smoke import cache_dir, smi_lines

BASELINE_NTT_US = 39.0      # V100, Table 6, n=2^15, 55-bit
BASELINE_INTT_US = 23.0     # V100, Table 6
BASELINE_NTT30_US = 27.7    # V100, Table 6, n=2^15, 30-bit family
BASELINE_INTT30_US = 18.3
# V100 Table 6, 55-bit family, (ntt_us, intt_us) per size
BASELINE_TABLE6_US = {
    2048: (12.5, 12.5), 4096: (22.5, 15.5), 8192: (27.0, 18.0),
    16384: (29.0, 21.0), 32768: (39.0, 23.0),
}
# V100 Table 6, 30-bit family (the only family published at n=65536)
BASELINE_TABLE6_30_US = {
    2048: (7.0, 7.5), 4096: (11.5, 13.0), 8192: (22.5, 14.5),
    16384: (25.5, 16.3), 32768: (27.7, 18.3), 65536: (39.0, 20.7),
}
# V100 Table 7 (us): keygen, encrypt, decrypt per parameter set
BASELINE_BFV_US = {
    "4k_3q": (123.86, 85.82, 79.46),
    "8k_4q": (135.81, 99.93, 87.46),
    "16k_5q": (176.64, 119.26, 104.13),
    "32k_9q": (273.73, 276.10, 160.05),
    "32k_16q": (427.81, 514.73, 246.48),
}

DEVICE: dict = {}


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _stamp(row: dict) -> dict:
    row["device"] = DEVICE
    return row


def ntt_step(inverse: bool):
    """Chained transforms through the library entry; tables and moduli
    ride as runtime buffers."""
    import jax
    from ntt_bfv.ops import ntt

    @jax.jit
    def step(y, k, tables, ms):
        f = ntt.ntt_inverse if inverse else ntt.ntt_forward
        return jax.lax.fori_loop(0, k, lambda _, z: f(z, tables, ms), y)
    return step


def _time_transforms(qs, psis, n, batch, hi):
    """(forward, inverse) us per transform over a (batch, r, n) tensor."""
    import jax.numpy as jnp
    from ntt_bfv.ops import modmath, ntt
    from ntt_bfv.utils import profiling

    tables = ntt.NTTTables.build(qs, psis, n)
    ms = modmath.ModulusSet.from_moduli(qs)
    rng = np.random.default_rng(0)
    x = jnp.asarray(np.stack([
        np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in qs])
        for _ in range(batch)]))
    rows = batch * len(qs)
    out = []
    for inverse in (False, True):
        per = profiling.time_chained_dynamic(
            ntt_step(inverse), x, tables, ms, inner_lo=max(2, hi // 8),
            inner_hi=hi, reps=3, epochs=3)
        out.append(per / rows * 1e6)
    return out


def bench_transforms():
    """Forward + inverse NTT us/transform over the 16-modulus RNS batch of
    the 32k/16q set (the reference's largest constant-bank configuration)."""
    from ntt_bfv.params import get_bfv_params

    p = get_bfv_params("32k_16q")
    f_us, i_us = _time_transforms(list(p.q), list(p.psi), p.n, 1, 128)
    _log(f"[bench] ntt: {f_us:.2f} us/transform, intt: {i_us:.2f}")
    return {"ntt": f_us, "intt": i_us}


def _table6(family, baselines, skip):
    from ntt_bfv.params import get_params

    out = {}
    for n, (b_f, b_i) in baselines.items():
        if n == skip:
            continue
        q, psi, _, _, _ = get_params(n, family)
        f_us, i_us = _time_transforms([q], [psi], n, 16,
                                      max(128, (1 << 22) // n))
        row = {"ntt_us": round(f_us, 2),
               "ntt_vs_baseline": round(b_f / f_us, 3),
               "intt_us": round(i_us, 2),
               "intt_vs_baseline": round(b_i / i_us, 3)}
        out[str(n)] = _stamp(row)
        _log(f"[bench] table6 {family} n={n}: {row}")
    return out


def bench_table6():
    """Forward/inverse us per size across the 55-bit family (Table 6)."""
    return _table6("60bit", BASELINE_TABLE6_US, 32768)


def bench_transforms30():
    """30-bit family headline at n=2^15."""
    from ntt_bfv.params import get_params

    q, psi, _, _, _ = get_params(32768, "30bit")
    f_us, i_us = _time_transforms([q], [psi], 32768, 16, 256)
    _log(f"[bench] ntt30: {f_us:.2f} us/transform, intt30: {i_us:.2f}")
    return {"ntt30": f_us, "intt30": i_us}


def bench_table6_30bit():
    """The rest of the 30-bit Table 6 column, incl. n=65536."""
    return _table6("30bit", BASELINE_TABLE6_30_US, 32768)


def bench_bfv(set_names):
    """Table 7 per-op latency: keygen / encrypt / decrypt us for each
    parameter set, chained-slope methodology (nonce / data threading
    defeats loop-invariant hoisting; all outputs consumed)."""
    return {name: _bench_bfv_one(name) for name in set_names}


def _bench_bfv_one(name):
    import jax
    import jax.numpy as jnp
    from ntt_bfv.models import bfv
    from ntt_bfv.params import get_bfv_params
    from ntt_bfv.utils import profiling

    p = get_bfv_params(name)
    n, r = p.n, p.r
    m = jnp.asarray(np.arange(n, dtype=np.uint64) % p.t)
    q0 = jnp.uint64(p.q[0])
    t0 = time.perf_counter()
    ctx = bfv.BFVContext.build(p)
    sk, pk = ctx.keygen()
    ct = ctx.encrypt(pk, m)

    # thread the table bundles as runtime buffers (op_programs)
    kg_fn, enc_fn, dec_fn, _, _, bz = ctx.op_programs()

    @jax.jit
    def kg_step(seed, k, pkx, mx, bzz):
        def body(_, s):
            skk, pkk = kg_fn(s, bzz)
            # consume sk AND pk: XLA DCEs 2 of keygen's 3 NTT batches
            # otherwise
            return skk[0, 0] + pkk[0, 0, 0] + pkk[1, 0, 0]
        return jax.lax.fori_loop(0, k, body, seed)

    @jax.jit
    def enc_step(c, k, pkx, mx, bzz):
        def body(_, cc):
            return enc_fn(cc[0, 0, 0], pkx, mx, bzz)
        return jax.lax.fori_loop(0, k, body, c)

    @jax.jit
    def dec_step(c, k, skx, mx, bzz):
        def body(_, cc):
            out = dec_fn(skx, cc, bzz)
            return cc.at[0, 0, 0].set((cc[0, 0, 0] + out[0]) % q0)
        return jax.lax.fori_loop(0, k, body, c)

    hi = max(64, (1 << 24) // (n * r))
    kw = dict(inner_lo=hi // 8, inner_hi=hi, reps=3, epochs=3)
    t_kg = profiling.time_chained_dynamic(kg_step, jnp.uint64(1), pk, m, bz,
                                          **kw)
    t_enc = profiling.time_chained_dynamic(enc_step, ct, pk, m, bz, **kw)
    t_dec = profiling.time_chained_dynamic(dec_step, ct, sk, m, bz, **kw)
    b_kg, b_enc, b_dec = BASELINE_BFV_US[name]
    if min(t_kg, t_enc, t_dec) <= 0:
        raise RuntimeError(f"{name}: degenerate slope")
    row = {
        "ntt_kernel": ctx.ntt_kernel,
        "keygen_us": round(t_kg * 1e6, 2),
        "encrypt_us": round(t_enc * 1e6, 2),
        "decrypt_us": round(t_dec * 1e6, 2),
        "keygen_vs_baseline": round(b_kg / (t_kg * 1e6), 3),
        "encrypt_vs_baseline": round(b_enc / (t_enc * 1e6), 3),
        "decrypt_vs_baseline": round(b_dec / (t_dec * 1e6), 3),
    }
    _log(f"[bench] {name}: kg {t_kg*1e6:.1f} enc {t_enc*1e6:.1f} "
         f"dec {t_dec*1e6:.1f} us "
         f"({time.perf_counter()-t0:.0f}s incl. compiles)")
    return _stamp(row)


def bench_bfv_batched(set_names, J=16):
    """Throughput mode: J messages per transform batch via encrypt_batch /
    decrypt_batch.  The V100's Table 7 latencies are themselves
    18-36-transform batches (BASELINE.md:14-15), so ops/s here vs
    1e6/latency there is the apples-to-apples economics."""
    return {name: _bench_bfv_batched_one(name, J) for name in set_names}


def _bench_bfv_batched_one(name, J):
    import jax
    import jax.numpy as jnp
    from ntt_bfv.models import bfv
    from ntt_bfv.params import get_bfv_params
    from ntt_bfv.utils import profiling

    p = get_bfv_params(name)
    n, r = p.n, p.r
    t0 = time.perf_counter()
    m_batch = jnp.asarray(
        np.arange(J * n, dtype=np.uint64).reshape(J, n) % p.t)
    nonces0 = jnp.arange(1, J + 1, dtype=jnp.uint64)
    q0 = jnp.uint64(p.q[0])
    ctx = bfv.BFVContext.build(p)
    sk, pk = ctx.keygen()
    cts = ctx.encrypt_batch(pk, m_batch, nonces0)

    _, _, _, enc_batch_fn, dec_batch_fn, bz = ctx.op_programs()

    @jax.jit
    def enc_step(c, k, pkx, mb, bzz):
        def body(_, cc):
            return enc_batch_fn(nonces0 + cc[0, 0, 0, 0], pkx, mb, bzz)
        return jax.lax.fori_loop(0, k, body, c)

    @jax.jit
    def dec_step(c, k, skx, mb, bzz):
        def body(_, cc):
            out = dec_batch_fn(skx, cc, bzz)
            return cc.at[0, 0, 0, 0].set((cc[0, 0, 0, 0] + out[0, 0])
                                         % q0)
        return jax.lax.fori_loop(0, k, body, c)

    hi = max(16, (1 << 24) // (n * r * J))
    kw = dict(inner_lo=max(2, hi // 8), inner_hi=hi, reps=3, epochs=3)
    t_enc = profiling.time_chained_dynamic(enc_step, cts, pk, m_batch, bz,
                                           **kw)
    t_dec = profiling.time_chained_dynamic(dec_step, cts, sk, m_batch, bz,
                                           **kw)
    if min(t_enc, t_dec) <= 0:
        raise RuntimeError(f"batched {name}: degenerate slope")
    _, b_enc, b_dec = BASELINE_BFV_US[name]
    enc_ops = J / t_enc
    dec_ops = J / t_dec
    row = {
        "J": J,
        "encrypt_us_per_msg": round(t_enc / J * 1e6, 2),
        "decrypt_us_per_msg": round(t_dec / J * 1e6, 2),
        "encrypt_ops_per_s": round(enc_ops, 1),
        "decrypt_ops_per_s": round(dec_ops, 1),
        "encrypt_vs_baseline": round(enc_ops / (1e6 / b_enc), 3),
        "decrypt_vs_baseline": round(dec_ops / (1e6 / b_dec), 3),
    }
    _log(f"[bench] batched {name}: enc {enc_ops:.0f} dec {dec_ops:.0f} "
         f"ops/s ({time.perf_counter()-t0:.0f}s incl. compiles)")
    return _stamp(row)


def bench_bfv_mult(set_names):
    """EvalMult / EvalSquare latency (BEHZ pipeline + relinearization).
    No reference baseline exists (the CUDA repo stops at encrypt/decrypt),
    so raw us only; the chained loop feeds each product back in as the
    next multiplicand (all outputs consumed)."""
    return {name: _bench_bfv_mult_one(name) for name in set_names}


def _bench_bfv_mult_one(name):
    import jax
    import jax.numpy as jnp
    from ntt_bfv.models import bfv
    from ntt_bfv.params import get_bfv_params
    from ntt_bfv.utils import profiling

    p = get_bfv_params(name)
    n, r = p.n, p.r
    t0 = time.perf_counter()
    m = jnp.asarray(np.arange(n, dtype=np.uint64) % p.t)
    ctx = bfv.BFVContext.build(p)
    sk, pk = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    ct1 = ctx.encrypt(pk, m, nonce=1)
    ct2 = ctx.encrypt(pk, m, nonce=2)

    # the table bundles and the second operand ride as runtime buffers,
    # not module constants
    mul_fn, sq_fn, bundles = ctx.mult_program()

    @jax.jit
    def mul_step(c, k, ct2x, rl, bz):
        def body(_, cc):
            return mul_fn(cc, ct2x, rl, bz)
        return jax.lax.fori_loop(0, k, body, c)

    @jax.jit
    def sq_step(c, k, rl, bz):
        def body(_, cc):
            return sq_fn(cc, rl, bz)
        return jax.lax.fori_loop(0, k, body, c)

    J = int(os.environ.get("BENCH_MULT_J", "4"))
    ct1b = jnp.broadcast_to(ct1, (J,) + ct1.shape)
    ct2b = jnp.broadcast_to(ct2, (J,) + ct2.shape)

    @jax.jit
    def mul_batch_step(c, k, ct2bx, rl, bz):
        def body(_, cc):
            return mul_fn(cc, ct2bx, rl, bz)
        return jax.lax.fori_loop(0, k, body, c)

    # Galois rotation (rotate_rows by 1): the batching workload's hot op
    from ntt_bfv.models import encoder as encoder_mod
    from ntt_bfv.ops import poly as poly_mod
    g = encoder_mod.rotation_element(n, 1)
    gk = ctx.galois_keygen(sk, [g], nonce=9)[g]
    perm, neg = poly_mod.galois_maps(n, g)
    perm_j = jnp.asarray(perm)
    neg_j = jnp.asarray(neg)

    @jax.jit
    def rot_step(c, k, gkk, bz):
        def body(_, cc):
            return bfv._apply_galois_jit(
                cc, perm_j, neg_j, gkk, bz["msf"], bz["msd"], bz["msl"],
                bz["tf"], bz["dr"])
        return jax.lax.fori_loop(0, k, body, c)

    hi = max(16, (1 << 22) // (n * r))
    kw = dict(inner_lo=max(2, hi // 8), inner_hi=hi, reps=3, epochs=3)
    t_mul = profiling.time_chained_dynamic(mul_step, ct1, ct2, rlk,
                                           bundles, **kw)
    t_sq = profiling.time_chained_dynamic(sq_step, ct1, rlk, bundles,
                                          **kw)
    t_rot = profiling.time_chained_dynamic(rot_step, ct1, gk, bundles,
                                           **kw)
    hij = max(4, hi // J)
    t_mb = profiling.time_chained_dynamic(
        mul_batch_step, ct1b, ct2b, rlk, bundles,
        inner_lo=max(2, hij // 8), inner_hi=hij, reps=3, epochs=3)
    if min(t_mul, t_sq, t_rot, t_mb) <= 0:
        raise RuntimeError(f"mult {name}: degenerate slope")
    row = {
        "ntt_kernel": ctx.ntt_kernel,
        "mul_relin_us": round(t_mul * 1e6, 2),
        "square_relin_us": round(t_sq * 1e6, 2),
        "rotate_us": round(t_rot * 1e6, 2),
        "J": J,
        "mul_relin_us_per_msg_batched": round(t_mb / J * 1e6, 2),
        "mul_relin_ops_per_s_batched": round(J / t_mb, 1),
    }
    _log(f"[bench] mult {name}: mul {t_mul*1e6:.1f} sq {t_sq*1e6:.1f} "
         f"rot {t_rot*1e6:.1f} batched {t_mb/J*1e6:.1f} us/msg "
         f"({time.perf_counter()-t0:.0f}s incl. compiles)")
    return _stamp(row)


def main() -> int:
    d, set_here = cache_dir()
    import jax
    if set_here:
        jax.config.update("jax_compilation_cache_dir", d)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        _log(f"[bench] no GPU found (JAX platform {devs[0].platform!r})")
        return 2
    smi = smi_lines()
    DEVICE.update(platform=devs[0].platform, device_kind=devs[0].device_kind,
                  count=len(devs), nvidia_smi=smi)
    _log(f"[bench] {DEVICE}")

    detail = {}
    tf = bench_transforms()
    headline = {
        "metric": "NTT/s/chip @ N=2^15, 55-bit q (16-modulus batch)",
        "value": round(1e6 / tf["ntt"], 1),
        "unit": "transforms/sec",
        "vs_baseline": round(BASELINE_NTT_US / tf["ntt"], 3),
        "ntt_us": round(tf["ntt"], 2),
        "intt_us": round(tf["intt"], 2),
        "intt_vs_baseline": round(BASELINE_INTT_US / tf["intt"], 3),
        "device": DEVICE,
    }
    detail.update(headline)
    if os.environ.get("BENCH_NTT_ONLY", "") != "1":
        sets = [s for s in os.environ.get(
            "BENCH_SETS", ",".join(BASELINE_BFV_US)).split(",") if s]
        msets = [s for s in os.environ.get(
            "BENCH_MULT_SETS", "32k_9q,16k_5q").split(",") if s]
        bsets = [s for s in os.environ.get(
            "BENCH_BATCH_SETS", "32k_9q,16k_5q").split(",") if s]
        detail["bfv_table7"] = bench_bfv(sets)
        detail["bfv_mult"] = bench_bfv_mult(msets)
        detail["bfv_batched"] = bench_bfv_batched(bsets)
    t30 = bench_transforms30()
    detail.update({
        "ntt30_us": round(t30["ntt30"], 2),
        "ntt30_vs_baseline": round(BASELINE_NTT30_US / t30["ntt30"], 3),
        "intt30_us": round(t30["intt30"], 2),
        "intt30_vs_baseline": round(BASELINE_INTT30_US / t30["intt30"], 3),
    })
    detail["table6_55bit"] = bench_table6()
    detail["table6_30bit"] = bench_table6_30bit()
    out = Path(os.environ.get("BENCH_DETAIL", "bench_detail.json"))
    out.write_text(json.dumps(detail, indent=1))
    print(json.dumps(headline), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
