"""Distribution converters: keystream bytes -> ternary / uniform / Gaussian
RNS residues.

Counterparts of the reference's fused multi-modulus samplers
(ternary_dist_xq / uniform_dist_xq / gaussian_dist_xq, bfv_keygen.cuh:14-79;
convert_ternary_gaussian_x2, bfv_encryption.cuh:17-109).  One invocation
produces the whole (r, n) residue tensor; the RNS broadcast of the
ternary/Gaussian draw (same entropy reused across moduli) is a broadcast
along the leading axis.

Spec deviations from the reference (documented, deliberate):

* **Uniform**: the reference computes `(double)u64 / UINT64_MAX * (q-1)`
  truncated (bfv_keygen.cuh:33-45).  The default draw is the
  *integer-exact* `floor(u * (q-1) / 2^64)` — one mulhi, with no
  floating-point path whose rounding could differ between backends.  Distributionally at least as
  uniform; deterministic across all backends.  `utils/golden.py`
  provides both specs.  The fp64 semantics are ALSO implemented exactly
  (in integer arithmetic) as `uniform_ref` — opt in via
  BFVContext.build(..., uniform_spec="fp64"); with it the uniform draw
  is byte-identical to a CUDA run (the Gaussian bullet below quantifies
  the one remaining, bounded deviation source for keygen as a whole).

* **Gaussian**: the reference uses CUDA's `normcdfinvf` (an fp32 vendor
  intrinsic with unpublished bit behavior), so bit-identity with a CUDA
  run is unprovable for this draw.  Instead the converter implements a
  PINNED integer spec: the whole u32 -> {-19..16} map (u32 -> f32,
  /2^32, inverse normal CDF, * 3.2, clamp +-19.2, truncate) is a
  monotone step function, so it is defined EXACTLY by the 38 frozen u32
  thresholds in ``GAUSS_ICDF_BOUNDS`` (derived from the true
  double-precision Phi, with the reference's u32->f32 RNE quantization
  — including the f32(u) == 2^32 tie at u >= 2^32-128 — emulated
  exactly; regenerate with ``gen_gauss_icdf_bounds``).  The device
  converter is 38 integer compares: bit-deterministic on every backend,
  no transcendentals in the hot path.  A CUDA run can differ only for
  u32s adjacent to a threshold where normcdfinvf's few-ulp error flips
  the truncation: measured against an independent f32 ndtri pipeline
  the disagreement is 720 u32 values of the whole 2^32 space (1.7e-7
  per draw; every one +-1, every one within 4096 of a threshold —
  tests/test_sampling.py::test_gaussian_pinned_vs_f32_pipeline), i.e.
  a 32k keygen (n = 32768 Gaussian draws, broadcast across moduli)
  matches a same-error-order CUDA run on every draw with probability
  ~99.5%, and the BFV pipeline is agnostic to the +-1 boundary cases
  regardless (any valid error sample decrypts).
  sigma = 3.2, clamp +-19.2 and the eps nudges at p == 0 / p == 1
  (salsa_common.h:31, distributions.cuh:157-189) preserved exactly.

* **Ternary**: exact.  `b = int(byte / (255.0f/3)) - 1` has exact integer
  thresholds (85/170/255, since 255/3 = 85.0f and k*85/85.0f rounds
  exactly); byte == 255 yields b == 2 — a reference quirk we preserve
  bit-for-bit (bfv_keygen.cuh:29-30).

**Nonce domain separation** (structural, not documentation-only): both
pipelines read the ternary draw from the SAME keystream region (bytes
[0, n) under the fixed key, exactly as the reference's
generate_random_default does) — with equal raw nonces the encryption
ephemeral `u` would be bit-identical to the secret key `s`, a
key-recovery-grade hazard.  Therefore the pipelines map their nonces to
disjoint spaces before they reach Salsa20: keygen clears bit 63
(`keygen_nonce`), encryption sets bit 63 on every NONZERO nonce
(`encrypt_nonce`).  Nonce 0 passes through unchanged in both — the
reference's fixed-randomness pipeline (its bit-exactness contract) runs
keygen and encryption on the same nonce-0 stream by construction, and
stays byte-compatible.  Any nonzero keygen/encrypt nonce pair is
guaranteed disjoint (tests/test_sampling.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import modmath, salsa20

U32 = jnp.uint32
U64 = jnp.uint64
F32 = jnp.float32

_NONCE_HIGH_BIT = 1 << 63


def check_user_nonce(nonce) -> None:
    """Reject concrete user nonces with bit 63 set.  That bit is reserved
    for the keygen/encrypt domain separation: two raw nonces differing
    only in bit 63 would map to the SAME effective stream (silent
    randomness reuse), and keygen(2**63) would silently reproduce the
    fixed nonce-0 secret key.  Called at the public API layer (model /
    parallel contexts) — NOT inside keygen_nonce/encrypt_nonce, which the
    pipelines re-apply idempotently to already-mapped values.  Traced
    values (inside a user jit) cannot be checked and rely on the
    documented < 2**63 contract."""
    import numpy as np
    if isinstance(nonce, jax.core.Tracer):
        return
    v = np.asarray(nonce, dtype=np.uint64)
    if np.any(v >> np.uint64(63)):
        raise ValueError(
            "nonce bit 63 is reserved for keygen/encrypt domain "
            "separation; user nonces must be < 2**63")


def keygen_nonce(nonce):
    """Keygen's effective Salsa20 nonce: bit 63 cleared, so the keygen
    stream space is provably disjoint from every nonzero encryption
    stream (module docstring).  Nonce 0 maps to 0 (reference compat)."""
    return jnp.asarray(nonce, U64) & U64(_NONCE_HIGH_BIT - 1)


def encrypt_nonce(nonce):
    """Encryption's effective Salsa20 nonce: bit 63 set on every nonzero
    nonce; 0 passes through (the reference's fixed-randomness pipeline,
    which shares the keygen stream BY DESIGN — never reuse a key from
    nonce-0 keygen with nonce-0 encryption for real data)."""
    nonce = jnp.asarray(nonce, U64)
    return jnp.where(nonce == 0, nonce, nonce | U64(_NONCE_HIGH_BIT))


def _residues(d_int: jax.Array, ms: modmath.ModulusSet) -> jax.Array:
    """(..., n) small signed ints -> (..., r, n) residues: negatives map
    to q + d per modulus, non-negatives broadcast unchanged (the modulus
    axis is inserted before the coefficient axis).  The shared tail of
    every small-value sampler (ternary / gaussian, batched or not)."""
    d64 = jnp.asarray(d_int, jnp.int64)[..., None, :]
    q = ms.q.astype(jnp.int64)                             # (r, 1)
    out = jnp.where(d64 < 0, q + d64,
                    jnp.broadcast_to(d64, d64.shape[:-2]
                                     + (ms.r,) + d64.shape[-1:]))
    return out.astype(U64)


def ternary(bytes_u8: jax.Array, ms: modmath.ModulusSet) -> jax.Array:
    """(n,) bytes -> (r, n) ternary residues; same bytes for every modulus
    (ternary_dist_xq reads in[i % n])."""
    return _residues(ternary_int(bytes_u8), ms)


def uniform(u64s: jax.Array, ms: modmath.ModulusSet) -> jax.Array:
    """(r, n) u64 words -> (r, n) uniform residues in [0, q-1):
    floor(u * (q-1) / 2^64) (integer-exact spec; see module docstring).

    The optimization_barrier keeps XLA from fusing the keystream u64 lane
    extraction (block_words_u64's transpose + pack) into the mulhi; it
    is bit-neutral, and whether the fence helps or hurts on the GPU is
    for a profile to show."""
    return modmath.mulhi_u64(jax.lax.optimization_barrier(u64s),
                             ms.q - U64(1))


# ---------------------------------------------------------------------------
# Reference-exact fp64 uniform spec (opt-in).
#
# The reference computes `d = (double)u; d /= UINT64_MAX; d *= (double)(q-1);
# out = (unsigned long long)d` (uniform_dist_xq, bfv_keygen.cuh:33-45).
# uniform_ref emulates the IEEE-double data path in exact integer
# arithmetic, so the result does not depend on any backend's f64 units:
#
#   * (double)u           = RNE53(u)        (round-to-nearest-even, 53 bits)
#   * (double)UINT64_MAX  = 2^64 exactly, so the division is an EXACT
#     power-of-two scaling (no rounding)
#   * the multiply        = RNE53(RNE53(u) * RNE53(q-1)) * 2^-64
#   * the u64 cast        = truncation toward zero => >> 64
#
# Every step below reproduces those roundings bit-for-bit (including the
# quirk that the output can exceed q-1 when q-1 needs more than 53 bits
# and rounds up).  Validated element-wise against IEEE numpy float64
# (tests/test_sampling.py).
# ---------------------------------------------------------------------------

_ONE = jnp.uint64(1)


def _bitlen_u64(x):
    """Bit length of each u64 lane (0 for 0), by binary-search shifts."""
    n = jnp.zeros_like(x)
    for k in (32, 16, 8, 4, 2, 1):
        big = x >= (_ONE << U64(k))
        n = n + jnp.where(big, U64(k), U64(0))
        x = jnp.where(big, x >> U64(k), x)
    return n + (x > 0).astype(U64)


def _rne53_u64(x):
    """RNE53(x) for u64 lanes -> (value, overflowed_to_2_64)."""
    L = _bitlen_u64(x)
    shift = jnp.maximum(L, U64(53)) - U64(53)          # 0..11
    keep = x >> shift
    rem = x & ((_ONE << shift) - _ONE)
    half = jnp.where(shift > 0,
                     _ONE << jnp.minimum(shift - _ONE, U64(63)), U64(0))
    up = ((rem > half) | ((rem == half) & ((keep & _ONE) == _ONE))) \
        & (shift > 0)
    val = keep + up.astype(U64)                        # <= 2^53
    ov = (L == 64) & (val == (_ONE << U64(53)))
    return jnp.where(ov, U64(0), val << shift), ov


def _rne53_128_shift64(hi, lo):
    """floor(RNE53(hi * 2^64 + lo) / 2^64) for 128-bit lane pairs."""
    L = jnp.where(hi > 0, U64(64) + _bitlen_u64(hi), _bitlen_u64(lo))
    shift = jnp.maximum(L, U64(53)) - U64(53)          # 0..73
    ge64 = shift >= U64(64)
    # all shift amounts clamped to [0, 63] — where() evaluates both
    # branches, and XLA shifts by >= 64 are undefined
    sh_lo = jnp.minimum(shift, U64(63))
    sh_hi = jnp.minimum(shift - U64(64), U64(63))      # wraps (clamped) <64
    keep = jnp.where(
        ge64, hi >> sh_hi,
        jnp.where(shift == 0, lo,
                  (hi << jnp.minimum(U64(64) - sh_lo, U64(63)))
                  | (lo >> sh_lo)))
    # rem = prod & (2^shift - 1), half = 2^(shift-1), as 128-bit pairs
    rem_lo = jnp.where(ge64, lo, lo & ((_ONE << sh_lo) - _ONE))
    rem_hi = jnp.where(ge64, hi & ((_ONE << sh_hi) - _ONE), U64(0))
    # half's set bit (index shift-1) lives in lo for shift <= 64, hi for
    # shift >= 65; all shift amounts clamped in-range (where() evaluates
    # both branches)
    half_in_hi = shift >= U64(65)
    half_lo = jnp.where(half_in_hi | (shift == 0), U64(0),
                        _ONE << jnp.minimum(shift - _ONE, U64(63)))
    half_hi = jnp.where(half_in_hi,
                        _ONE << jnp.minimum(shift - U64(65), U64(63)),
                        U64(0))
    gt = (rem_hi > half_hi) | ((rem_hi == half_hi) & (rem_lo > half_lo))
    eq = (rem_hi == half_hi) & (rem_lo == half_lo)
    up = ((gt | (eq & ((keep & _ONE) == _ONE))) & (shift > 0)).astype(U64)
    val = keep + up                                    # <= 2^53
    # out = val * 2^shift >> 64
    return jnp.where(ge64, val << sh_hi,
                     jnp.where(shift == 0, U64(0),
                               val >> jnp.minimum(U64(64) - shift, U64(63))))


def uniform_ref(u64s: jax.Array, ms: modmath.ModulusSet) -> jax.Array:
    """(r, n) u64 words -> (r, n) residues under the reference's EXACT
    double-precision uniform spec (see block comment above).  Opt-in:
    BFVContext.build(..., uniform_spec="fp64")."""
    qd, _ = _rne53_u64(ms.q - _ONE)                    # (r, 1); q-1 < 2^62
    av, av_ov = _rne53_u64(u64s)
    hi = modmath.mulhi_u64(av, qd)
    lo = av * qd
    hi = jnp.where(av_ov, qd, hi)                      # RNE53(u) == 2^64
    lo = jnp.where(av_ov, U64(0), lo)
    return _rne53_128_shift64(hi, lo)


# The pinned Gaussian spec: 38 frozen u32 thresholds.  For u in
# [1, 2^32-129], d(u) = -19 + #{b in GAUSS_ICDF_BOUNDS : u >= b}; the
# p == 0 / p == 1 eps-nudge branches (u == 0 and u >= 2^32-128, where
# f32(u) RNE-rounds to 2^32) both yield |d| == 16.  Generated by
# gen_gauss_icdf_bounds() from the true double-precision Phi with the
# reference's u32->f32 quantization emulated exactly; frozen here so the
# spec is a diffable constant, not a library behavior.
GAUSS_ICDF_BOUNDS = (
    7, 40, 233, 1232,
    5940, 26078, 104261, 379750,
    1260811, 3818335, 10556606, 26670310,
    61645758, 130551381, 253768664, 453762321,
    748401120, 1142399168, 1620621248, 2674346113,
    3152568192, 3546566273, 3841204865, 4041198721,
    4164415872, 4233321601, 4268297088, 4284410752,
    4291148929, 4293706369, 4294587521, 4294862977,
    4294941313, 4294961281, 4294966144, 4294967168,
    4294967168, 4294967168,
)


def gen_gauss_icdf_bounds() -> tuple[int, ...]:
    """Regenerate GAUSS_ICDF_BOUNDS (documentation of the pinned spec).

    Boundary for output >= k is the smallest u32 whose quantized
    p(u) = f32(u) * 2^-32 satisfies p > Phi((k-1)/3.2) for k <= 0
    (truncation toward zero: trunc(x) >= k iff x > k-1) and
    p >= Phi(k/3.2) for k >= 1; k runs -18..19.  Phi is the exact
    standard normal CDF (double-precision erfc)."""
    import math

    import numpy as np

    def phi(x):
        return 0.5 * math.erfc(-x / math.sqrt(2.0))

    def p_of_u(u):
        return float(np.float32(u)) * 2.0 ** -32

    def smallest_u(pred):
        lo, hi = 0, 2 ** 32 - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if pred(p_of_u(mid)):
                hi = mid
            else:
                lo = mid + 1
        return lo

    out = []
    for k in range(-18, 20):
        if k <= 0:
            t = phi((k - 1) / 3.2)
            out.append(smallest_u(lambda p, t=t: p > t))
        else:
            t = phi(k / 3.2)
            out.append(smallest_u(lambda p, t=t: p >= t))
    return tuple(out)


def gaussian_int(u32s: jax.Array) -> jax.Array:
    """(..., n) u32 words -> (..., n) int32 discrete-Gaussian values in
    [-19, 16] under the pinned threshold spec (module docstring).
    Replaces the reference's convert_gaussian fp32 chain
    (distributions.cuh:157-189) with 38 integer compares —
    bit-deterministic on every backend."""
    b = jnp.asarray(GAUSS_ICDF_BOUNDS, U32)
    d = jnp.sum(u32s[..., None] >= b, axis=-1).astype(jnp.int32) \
        - jnp.int32(19)
    # eps-nudge branches: p == 0 (u == 0) -> -16; p == 1 (f32(u) RNE-ties
    # to 2^32, i.e. u >= 2^32 - 128) -> +16
    d = jnp.where(u32s == U32(0), jnp.int32(-16), d)
    d = jnp.where(u32s >= U32(2 ** 32 - 128), jnp.int32(16), d)
    return d


def _gaussian_f32_pipeline(u32s: jax.Array) -> jax.Array:
    """The fp32 chain the pinned spec replaces (u32 -> f32, /2^32, f32
    ndtri, * 3.2, clamp, truncate) — kept ONLY as the independent
    implementation the deviation-counting test compares against."""
    d = u32s.astype(F32) * F32(2.0 ** -32)
    eps = F32(1.192092896e-07)
    d = jnp.where(d == 0, d + eps, d)
    d = jnp.where(d == 1, d - eps, d)
    z = jax.scipy.special.ndtri(d.astype(F32)).astype(F32)
    z = z * F32(3.2)
    z = jnp.clip(z, F32(-19.2), F32(19.2))
    return z.astype(jnp.int32)  # C-style truncation toward zero


def gaussian(u32s: jax.Array, ms: modmath.ModulusSet) -> jax.Array:
    """(n,) u32 words -> (r, n) discrete-Gaussian residues; same draw for
    every modulus (gaussian_dist_xq reads in[i % n]); negatives mapped to
    q + d (convert_gaussian, distributions.cuh:184-188)."""
    return _residues(gaussian_int(u32s), ms)


# ---------------------------------------------------------------------------
# Byte-consumption layouts of the two pipelines (offsets must match the
# reference exactly for reproducibility of keygen/encryption randomness).
# ---------------------------------------------------------------------------

def keygen_entropy_bytes(n: int, r: int) -> int:
    """generate_random_default size in keygen_rns (bfv_keygen.cuh:99):
    (1 + 8) * r * n + 4 * n bytes."""
    return 9 * r * n + 4 * n


def keygen_draws(n: int, r: int, ms: modmath.ModulusSet,
                 key_byte: int = salsa20.DEFAULT_KEY_BYTE, nonce=0,
                 uniform_spec: str = "int"):
    """Sample (s, a, e) for keygen with the reference's byte layout
    (bfv_keygen.cuh:120-122): ternary bytes at 0, uniform u64 lanes at
    byte offset n, gaussian u32 lanes at byte offset n + 8*r*n.

    uniform_spec: "int" (default; the integer-exact mulhi spec) or
    "fp64" (the reference's exact double-precision semantics, emulated
    bit-for-bit — uniform_ref)."""
    nbytes = keygen_entropy_bytes(n, r)
    bw = salsa20.keystream_block_words((nbytes + 63) // 64,
                                       key_byte=key_byte,
                                       nonce=keygen_nonce(nonce))
    s = ternary(salsa20.block_words_u8(bw, 0, n), ms)
    ufn = uniform_ref if uniform_spec == "fp64" else uniform
    a = ufn(salsa20.block_words_u64(bw, n, r * n).reshape(r, n), ms)
    e = gaussian(salsa20.block_words_u32(bw, n + 8 * r * n, n), ms)
    return s, a, e


def encrypt_entropy_bytes(n: int) -> int:
    """generate_random_default size in encryption_rns
    (bfv_encryption.cuh:228): n + 2 * 4 * n bytes."""
    return 9 * n


def encrypt_draws(n: int, r: int, ms: modmath.ModulusSet,
                  key_byte: int = salsa20.DEFAULT_KEY_BYTE, nonce=0):
    """Sample (u, e0, e1) for encryption (convert_ternary_gaussian_x2,
    bfv_encryption.cuh:17-109): ternary bytes at 0, e0 u32 lanes at byte
    offset n, e1 u32 lanes at byte offset 5n."""
    nbytes = encrypt_entropy_bytes(n)
    bw = salsa20.keystream_block_words((nbytes + 63) // 64,
                                       key_byte=key_byte,
                                       nonce=encrypt_nonce(nonce))
    u = ternary(salsa20.block_words_u8(bw, 0, n), ms)
    e0 = gaussian(salsa20.block_words_u32(bw, n, n), ms)
    e1 = gaussian(salsa20.block_words_u32(bw, 5 * n, n), ms)
    return u, e0, e1


def ternary_int(bytes_u8: jax.Array) -> jax.Array:
    """(..., n) bytes -> (..., n) int32 ternary values in {-1, 0, 1, 2}
    (byte-255 quirk included), before the per-modulus residue mapping."""
    return (bytes_u8.astype(jnp.int32) // 85) - jnp.int32(1)


def encrypt_draws_batch(n: int, r: int, ms: modmath.ModulusSet,
                        nonces: jax.Array,
                        key_byte: int = salsa20.DEFAULT_KEY_BYTE):
    """Batched encrypt_draws: (J,) nonces -> (u (J, r, n), e (J, 2, r, n)).

    One batched keystream for all J per-nonce streams
    (salsa20.keystream_block_words_batch) and batched converters, instead
    of J dispatch chains.  Row j is bit-identical to
    encrypt_draws(..., nonce=nonces[j]) (tests/test_sampling.py)."""
    (J,) = nonces.shape
    nbytes = encrypt_entropy_bytes(n)
    bw = salsa20.keystream_block_words_batch(
        (nbytes + 63) // 64, encrypt_nonce(nonces),
        key_byte=key_byte)                                 # (J, 16, nb)
    u = _residues(ternary_int(salsa20.block_words_u8_batch(bw, 0, n)), ms)

    def gauss(start):
        dd = gaussian_int(salsa20.block_words_u32_batch(bw, start, n))
        return _residues(dd, ms)

    e = jnp.stack([gauss(n), gauss(5 * n)], axis=1)        # (J, 2, r, n)
    return u, e


# ---------------------------------------------------------------------------
# Relinearization-key draws (beyond the reference, which has no EvalMult).
#
# The streams run under a DIFFERENT Salsa20 key byte (0x02 instead of the
# reference's fixed 0x01, distributions.cuh:261), so every relin-keygen
# stream is cryptographically independent of every keygen/encrypt stream
# at ANY nonce pair — no byte-offset bookkeeping can collide them.  The
# nonce inherits the keygen-half domain mapping (bit 63 clear).
# ---------------------------------------------------------------------------

RELIN_KEY_BYTE = 0x02


def relin_entropy_bytes(n: int, r: int, k: int) -> int:
    """Per-key layout: 8*r*n uniform bytes then 4*n gaussian bytes."""
    return k * (8 * r * n + 4 * n)


def relin_draws(n: int, r: int, k: int, ms: modmath.ModulusSet, nonce=0):
    """Draws for the k relinearization keys: (a (k, r, n) uniform
    NTT-domain residues, e (k, r, n) gaussian residues).  Key j's uniform
    u64 lanes start at byte j*(8rn+4n), its gaussian u32 lanes at
    j*(8rn+4n) + 8rn — one keystream call for all keys."""
    nbytes = relin_entropy_bytes(n, r, k)
    bw = salsa20.keystream_block_words((nbytes + 63) // 64,
                                       key_byte=RELIN_KEY_BYTE,
                                       nonce=keygen_nonce(nonce))
    stride = 8 * r * n + 4 * n
    a = jnp.stack([
        uniform(salsa20.block_words_u64(bw, j * stride, r * n)
                .reshape(r, n), ms)
        for j in range(k)])
    e = jnp.stack([
        gaussian(salsa20.block_words_u32(bw, j * stride + 8 * r * n, n), ms)
        for j in range(k)])
    return a, e


GALOIS_KEY_BYTE = 0x03


def galois_draws(n: int, r: int, k: int, elts, ms: modmath.ModulusSet,
                 nonce=0):
    """Draws for the Galois switching keys of `elts` (a tuple of Galois
    elements): (a (E, k, r, n), e (E, k, r, n)).

    The stream region is indexed by the ELEMENT VALUE, not its rank in
    the call: element g's k per-digit blocks start at Salsa20 block
    counter g * ceil(k*(8rn+4n)/64) (g < 2n, so regions stay far below
    the 2^64 counter space).  Two galois_keygen calls at the same nonce
    therefore produce IDENTICAL keys for a shared element and
    independent streams for different elements — same-nonce calls with
    different element sets can never reuse randomness across targets
    (that reuse would hand an attacker P*(tau_g1(s) - tau_g2(s))).
    Runs under key byte 0x03, independent of the keygen/encrypt (0x01)
    and relin (0x02) stream families at any nonce."""
    stride = 8 * r * n + 4 * n
    region = (k * stride + 63) // 64          # blocks per element
    nonce_eff = keygen_nonce(nonce)
    a_rows, e_rows = [], []
    for g in elts:
        bw = salsa20.keystream_block_words(
            region, key_byte=GALOIS_KEY_BYTE, nonce=nonce_eff,
            counter0=int(g) * region)
        a_rows.append(jnp.stack([
            uniform(salsa20.block_words_u64(bw, j * stride, r * n)
                    .reshape(r, n), ms)
            for j in range(k)]))
        e_rows.append(jnp.stack([
            gaussian(salsa20.block_words_u32(
                bw, j * stride + 8 * r * n, n), ms)
            for j in range(k)]))
    return jnp.stack(a_rows), jnp.stack(e_rows)
