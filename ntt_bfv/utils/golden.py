"""Integer-exact golden models of every device computation.

These are the test oracles: pure-Python/NumPy re-statements of the exact
arithmetic the reference's CUDA kernels perform, used to validate the
JAX / CUDA device implementations bit-for-bit.  The reference has no such
layer (its golden model is the O(n^2) `refPolyMul128`, helper.h:95-126,
plus embedded ciphertext vectors in decryption_test.cu); we build the full
oracle so that every op and the end-to-end BFV pipeline can be asserted
exactly, including on the reference's embedded golden vectors.

Everything here is exact Python-int arithmetic — no floating point except
where the reference itself is floating-point (the Gaussian sampler, which
has its own documented spec in `ops/sampling.py`).
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1
MASK32 = (1 << 32) - 1


# ---------------------------------------------------------------------------
# Negacyclic schoolbook multiply — the reference's golden model
# (refPolyMul128, helper.h:95-126).
# ---------------------------------------------------------------------------

def schoolbook_negacyclic(a, b, q: int, n: int) -> list[int]:
    """O(n^2) negacyclic polynomial product mod q, c[i] -= c[i+n] wraparound."""
    if q < (1 << 61):
        from .. import native
        if native.available():
            av = np.asarray([int(x) for x in a], dtype=np.uint64)
            bv = np.asarray([int(x) for x in b], dtype=np.uint64)
            return [int(x) for x in native.schoolbook_negacyclic(av, bv, q)]
    c = [0] * (2 * n)
    for i in range(n):
        ai = int(a[i])
        for j in range(n):
            c[i + j] = (c[i + j] + ai * int(b[j])) % q
    return [(c[i] - c[i + n]) % q for i in range(n)]


# ---------------------------------------------------------------------------
# NTT / INTT with the reference's exact index algebra
# (CTBasedNTTInner*, GSBasedINTTInner*, ntt_60bit.cuh:63-265).
# ---------------------------------------------------------------------------

def ntt_forward(a, psi_table, q: int, n: int) -> list[int]:
    """Merged negacyclic forward NTT: natural order in, bit-reversed out.

    Stage loop `length = 1,2,...,n/2`; twiddle = psi_table[length + psi_step]
    where psi_table holds bit-reverse-ordered powers of psi.
    """
    a = [int(x) for x in a]
    length = 1
    while length < n:
        step = n // length // 2
        for gid in range(n // 2):
            psi_step = gid // step
            target = psi_step * step * 2 + gid % step
            psi = int(psi_table[length + psi_step])
            u = a[target]
            v = (a[target + step] * psi) % q
            a[target] = (u + v) % q
            a[target + step] = (u - v) % q
        length *= 2
    return a


def ntt_inverse(a, psiinv_table, q: int, n: int) -> list[int]:
    """GS inverse NTT with lazy halving: bit-reversed in, natural order out.

    Halving `(x>>1) + ((q+1)>>1)*(x&1)` == x * 2^-1 mod q for x in [0, q);
    the log2(n) halvings fold the final n^-1 scaling into the stages.
    """
    a = [int(x) for x in a]
    inv2 = pow(2, q - 2, q)
    length = n // 2
    while length >= 1:
        step = n // length // 2
        for gid in range(n // 2):
            psi_step = gid // step
            target = psi_step * step * 2 + gid % step
            psiinv = int(psiinv_table[length + psi_step])
            u = a[target]
            v = a[target + step]
            a[target] = ((u + v) * inv2) % q
            a[target + step] = ((u - v) * psiinv * inv2) % q
        length //= 2
    return a


# ---------------------------------------------------------------------------
# Salsa20 keystream (VecCrypt, distributions.cuh:48-155).
# ---------------------------------------------------------------------------

SIGMA = b"expand 32-byte k"


def _rotl32(x: int, c: int) -> int:
    return ((x << c) | (x >> (32 - c))) & MASK32


def _quarter(x, a, b, c, d):
    x[b] ^= _rotl32((x[a] + x[d]) & MASK32, 7)
    x[c] ^= _rotl32((x[b] + x[a]) & MASK32, 9)
    x[d] ^= _rotl32((x[c] + x[b]) & MASK32, 13)
    x[a] ^= _rotl32((x[d] + x[c]) & MASK32, 18)


def salsa20_block(key: bytes, nonce: int, blockno: int, rounds: int = 20) -> bytes:
    """One 64-byte Salsa20 keystream block, reference state layout.

    State words (distributions.cuh:63-81): sigma0, k0..k3, sigma1,
    nonce_lo, nonce_hi, ctr_lo, ctr_hi, sigma2, k4..k7, sigma3.
    """
    def le32(b, off):
        return int.from_bytes(b[off:off + 4], "little")

    j = [
        le32(SIGMA, 0), le32(key, 0), le32(key, 4), le32(key, 8),
        le32(key, 12), le32(SIGMA, 4),
        nonce & MASK32, (nonce >> 32) & MASK32,
        blockno & MASK32, (blockno >> 32) & MASK32,
        le32(SIGMA, 8), le32(key, 16), le32(key, 20), le32(key, 24),
        le32(key, 28), le32(SIGMA, 12),
    ]
    x = list(j)
    for _ in range(rounds // 2):
        # column round
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 5, 9, 13, 1)
        _quarter(x, 10, 14, 2, 6)
        _quarter(x, 15, 3, 7, 11)
        # row round
        _quarter(x, 0, 1, 2, 3)
        _quarter(x, 5, 6, 7, 4)
        _quarter(x, 10, 11, 8, 9)
        _quarter(x, 15, 12, 13, 14)
    out = b"".join(((x[i] + j[i]) & MASK32).to_bytes(4, "little") for i in range(16))
    return out


def salsa20_keystream(nbytes: int, key: bytes = b"\x01" * 32, nonce: int = 0) -> np.ndarray:
    """Keystream bytes as produced by generate_random_default
    (distributions.cuh:249-276): key = 32 bytes of 0x01, nonce = 0,
    counter starts at 0.  `nbytes` is rounded up to whole 64-byte blocks by
    the caller's layout, as in the reference (NBLKS = n / 64).
    """
    nblocks = (nbytes + 63) // 64
    out = b"".join(salsa20_block(key, nonce, b) for b in range(nblocks))
    return np.frombuffer(out[: nblocks * 64], dtype=np.uint8).copy()


# ---------------------------------------------------------------------------
# Samplers (exact integer semantics; see ops/sampling.py for spec notes).
# ---------------------------------------------------------------------------

def ternary_from_bytes(byte_vals, q: int) -> list[int]:
    """b = int(byte / (255/3)) - 1 mapped into [0, q) (ternary_dist_xq,
    bfv_keygen.cuh:14-31).  The float thresholds are exactly the integer
    thresholds 85/170/255; byte == 255 yields b == 2 (a reference quirk we
    preserve)."""
    out = []
    for by in byte_vals:
        by = int(by)
        b = by // 85 - 1  # int(byte/85.0f) - 1, exact (see ops/sampling.py)
        out.append((q + b) % q if b < 0 else b)
    return out


def uniform_from_u64(u64_vals, q: int) -> list[int]:
    """Our spec: floor(u * (q-1) / 2^64) — exact-integer replacement for the
    reference's double-precision `(double)u / UINT64_MAX * (q-1)`
    (uniform_dist_xq, bfv_keygen.cuh:33-45).  See ops/sampling.py for why."""
    return [((int(u) * (q - 1)) >> 64) for u in u64_vals]


def uniform_ref_double(u64_vals, q: int) -> list[int]:
    """The reference's exact double-precision semantics (host-side only, for
    documentation/comparison; IEEE f64 like the GPU's)."""
    out = []
    for u in u64_vals:
        d = np.float64(np.uint64(int(u)))
        d = d / np.float64(np.uint64(MASK64))
        d = d * np.float64(np.uint64(q - 1))
        out.append(int(d))  # C cast truncates toward zero
    return out


# ---------------------------------------------------------------------------
# Polynomial / RNS ops with the reference's exact u64 semantics, including
# its representative-value quirks (which we reproduce bit-for-bit).
# ---------------------------------------------------------------------------

def dyadic_mul(a, b, q: int) -> list[int]:
    """barrett / barrett_batch (poly_arithmetic.cuh:9-98): exact a*b mod q."""
    return [(int(x) * int(y)) % q for x, y in zip(a, b)]


def poly_add_gt(a, b, q: int) -> list[int]:
    """poly_add / poly_add_xq with the `if (ra > q)` quirk
    (poly_arithmetic.cuh:143-153, bfv_encryption.cuh:180-191): a sum equal
    to exactly q is stored as q, not 0."""
    out = []
    for x, y in zip(a, b):
        ra = (int(x) + int(y)) & MASK64
        if ra > q:
            ra -= q
        out.append(ra)
    return out


def poly_add_negate(a, b, q: int) -> list[int]:
    """poly_add_negate_xq (bfv_keygen.cuh:81-93): -(a+b) mod q with the
    `ra * (ra != q)` zero-fixup."""
    out = []
    for x, y in zip(a, b):
        ra = (int(x) + int(y))
        if ra >= q:
            ra -= q
        ra = q - ra
        out.append(0 if ra == q else ra)
    return out


def poly_negate(a, q: int) -> list[int]:
    """poly_negate (poly_arithmetic.cuh:332-338)."""
    return [0 if int(x) == 0 else q - int(x) for x in a]


def divide_and_round_q_last(c_halves, params) -> list[list[list[int]]]:
    """SEAL-style last-modulus drop on both ciphertext halves.

    c_halves: [c0, c1], each a list of r residue polys (ints, in [0, q_i)).
    Implements divide_and_round_q_last_inplace_add_x2 +
    divide_and_round_q_last_inplace_loop_xq (bfv_encryption.cuh:111-178).
    Returns the updated halves (last residue left in its post-add state,
    as the reference leaves it as ignored padding).
    """
    q = params.q
    r = params.r
    n = params.n
    half = params.half_last_modulus
    qlast = q[-1]
    out = [[list(map(int, poly)) for poly in half_] for half_ in c_halves]
    for h in range(2):
        last = out[h][r - 1]
        for i in range(n):
            ra = last[i] + half
            if ra >= qlast:
                ra -= qlast
            last[i] = ra
        for k in range(r - 1):
            qi = q[k]
            half_mod = params.half_mod_q[k]
            inv = params.inv_q_last_mod_q[k]
            poly = out[h][k]
            for i in range(n):
                tmp = last[i] % qi
                if tmp < half_mod:
                    tmp += qi
                tmp -= half_mod
                v = poly[i]
                if v < tmp:
                    v += qi
                v -= tmp
                poly[i] = (v * inv) % qi
    return out


def weird_m_stuff(m_poly, c0, params) -> list[list[int]]:
    """Delta*m + fix addition into c0 (bfv_encryption.cuh:193-213)."""
    t = params.t
    out = [list(map(int, poly)) for poly in c0]
    for j in range(params.n):
        m = int(m_poly[j])
        fix = (m + ((t + 1) >> 1)) // t
        for i in range(params.r - 1):
            out[i][j] = (out[i][j] + m * params.qi_div_t[i] + fix) % params.q[i]
    return out


def fast_convert_and_round(c1, params) -> list[int]:
    """BEHZ base conversion to {t, gamma} + final rounding.

    c1: list of r-1 residue polys (already multiplied by prod_t_gamma and
    inv_punctured_q).  Implements fast_convert_array_kernel_t / _gamma
    (poly_arithmetic.cuh:217-251) and dec_round_kernel (:253-263).
    """
    t, gamma = params.t, params.gamma
    mask = t - 1
    pow2_t = t & (t - 1) == 0
    bcm_t, bcm_g = params.base_change_matrix
    neg_t, neg_g = params.neg_inv_q_mod_t_gamma
    n = params.n
    rr = params.r - 1
    out = []
    for j in range(n):
        xt = 0
        xg = 0
        for i in range(rr):
            if pow2_t:
                xt += (int(c1[i][j]) * bcm_t[i]) & MASK64 & mask
            else:
                xt = (xt + int(c1[i][j]) * bcm_t[i]) % t
            xg = (xg + (int(c1[i][j]) * bcm_g[i]) % gamma) % gamma
        if pow2_t:
            xt &= mask
            xt = (xt * neg_t) & MASK64 & mask
        else:
            xt = (xt * neg_t) % t
        xg = (xg * neg_g) % gamma
        if pow2_t:
            if xg > params.gamma_div_2:
                out.append((xt + (gamma - xg)) & mask)
            else:
                out.append((xt - xg) & mask)
        elif xg > params.gamma_div_2:
            out.append((xt + (gamma - xg)) * pow(gamma % t, -1, t) % t)
        else:
            out.append((xt - xg) * pow(gamma % t, -1, t) % t)
    return out


# ---------------------------------------------------------------------------
# Full golden BFV pipeline (sampler outputs injected, so the FP-dependent
# Gaussian stage can be supplied from either golden or device samplers).
# ---------------------------------------------------------------------------

def keygen(params, s_rns, a_rns, e_rns, psi_tables, psiinv_tables):
    """keygen_rns (bfv_keygen.cuh:95-151) on pre-sampled s, a, e.

    s_rns/a_rns/e_rns: lists of r residue polys.  `a` is uniform, sampled
    directly in the NTT domain.  Returns (sk_ntt, pk0_ntt, pk1_ntt).
    """
    q, n, r = params.q, params.n, params.r
    sk = [ntt_forward(s_rns[i], psi_tables[i], q[i], n) for i in range(r)]
    pk0 = []
    for i in range(r):
        prod = dyadic_mul(a_rns[i], sk[i], q[i])
        prod = ntt_inverse(prod, psiinv_tables[i], q[i], n)
        neg = poly_add_negate(prod, e_rns[i], q[i])
        pk0.append(ntt_forward(neg, psi_tables[i], q[i], n))
    return sk, pk0, [list(map(int, p)) for p in a_rns]


def encrypt(params, pk0, pk1, m_poly, u_rns, e0_rns, e1_rns,
            psi_tables, psiinv_tables):
    """encryption_rns (bfv_encryption.cuh:223-290) on pre-sampled u, e0, e1.

    Returns [c0, c1] with r-1 live residues each (the dropped residue is
    omitted; the reference keeps it as in-place padding).
    """
    q, n, r = params.q, params.n, params.r
    c = [[list(map(int, u_rns[i])) for i in range(r)],
         [list(map(int, u_rns[i])) for i in range(r)]]
    pk = [pk0, pk1]
    e = [e0_rns, e1_rns]
    for h in range(2):
        for i in range(r):
            x = ntt_forward(c[h][i], psi_tables[i], q[i], n)
            x = dyadic_mul(x, pk[h][i], q[i])
            x = ntt_inverse(x, psiinv_tables[i], q[i], n)
            c[h][i] = poly_add_gt(x, e[h][i], q[i])
    c = divide_and_round_q_last(c, params)
    c[0] = weird_m_stuff(m_poly, c[0], params)
    return [c[0][: r - 1], c[1][: r - 1]]


def decrypt(params, c0, c1, sk_ntt, psi_tables, psiinv_tables):
    """decryption_rns (bfv_decryption.cuh:76-138): returns plaintext poly.

    c0/c1: r-1 live residue polys each; sk_ntt: NTT-domain secret key
    (only its first r-1 residues are used).
    """
    q, n = params.q, params.n
    rr = params.r - 1
    c1w = []
    for i in range(rr):
        x = ntt_forward(c1[i], psi_tables[i], q[i], n)
        x = dyadic_mul(x, sk_ntt[i], q[i])
        x = ntt_inverse(x, psiinv_tables[i], q[i], n)
        x = poly_add_gt(x, c0[i], q[i])  # poly_add_xq_d, `>` quirk
        x = [(v * params.prod_t_gamma_mod_q[i]) % q[i] for v in x]
        x = [(v * params.inv_punctured_q[i]) % q[i] for v in x]
        c1w.append(x)
    return fast_convert_and_round(c1w, params)


# ---------------------------------------------------------------------------
# BEHZ EvalMult machinery (ops/behz.py) — exact-int mirrors.
#
# The reference stops at keygen/encrypt/decrypt; its only base conversion
# is decryption's q -> {t, gamma} step (poly_arithmetic.cuh:217-251).  The
# multiplication pipeline generalizes that primitive (Bajard-Eynard-Hasan-
# Zucca 2016); these mirrors restate the device formulas in exact Python
# ints so the JAX implementations can be asserted bit-for-bit.
# ---------------------------------------------------------------------------


def _prod(xs) -> int:
    p = 1
    for x in xs:
        p *= int(x)
    return p


def behz_rns_to_bsk(x, qs, bsk, m_tilde: int):
    """Mirror of behz.rns_to_bsk: x (k polys of residues mod qs) ->
    k+1 polys of residues mod bsk, congruent to x mod prod(qs) with
    centered magnitude < prod(qs) (the m_tilde sm_mrq correction)."""
    k = len(qs)
    n = len(x[0])
    q_prod = _prod(qs)
    punct = [q_prod // qj for qj in qs]
    inv_punct = [pow(p % qj, -1, qj) for p, qj in zip(punct, qs)]
    neg_inv_q_mt = (-pow(q_prod, -1, m_tilde)) % m_tilde
    zp = [[(int(x[j][i]) * m_tilde % qs[j]) * inv_punct[j] % qs[j]
           for i in range(n)] for j in range(k)]
    out = []
    for m in bsk:
        pm = [p % m for p in punct]
        inv_mt = pow(m_tilde % m, -1, m)
        row = []
        for i in range(n):
            y = sum(zp[j][i] * pm[j] for j in range(k)) % m
            ymt = sum(zp[j][i] * (punct[j] % m_tilde)
                      for j in range(k)) % m_tilde
            rc = ymt * neg_inv_q_mt % m_tilde
            if rc >= m_tilde // 2:
                rc -= m_tilde
            row.append((y + rc * q_prod) * inv_mt % m)
        out.append(row)
    return out


def behz_fast_floor(xq, xbsk, qs, bsk, t: int):
    """Mirror of behz.fast_floor: floor(t * X / prod(qs)) - alpha in base
    bsk, alpha in [0, k)."""
    k = len(qs)
    n = len(xq[0])
    q_prod = _prod(qs)
    punct = [q_prod // qj for qj in qs]
    inv_punct = [pow(p % qj, -1, qj) for p, qj in zip(punct, qs)]
    zp = [[(int(xq[j][i]) * t % qs[j]) * inv_punct[j] % qs[j]
           for i in range(n)] for j in range(k)]
    out = []
    for mi, m in enumerate(bsk):
        pm = [p % m for p in punct]
        inv_q = pow(q_prod % m, -1, m)
        row = []
        for i in range(n):
            conv = sum(zp[j][i] * pm[j] for j in range(k)) % m
            yb = int(xbsk[mi][i]) * t % m
            row.append((yb - conv) * inv_q % m)
        out.append(row)
    return out


def behz_bsk_to_q(x, qs, b, m_sk: int):
    """Mirror of behz.bsk_to_q (Shenoy-Kumaresan): x (k+1 polys mod
    b + [m_sk]) -> k polys mod qs, exact for centered |X| < prod(b)/2."""
    k = len(b)
    n = len(x[0])
    b_prod = _prod(b)
    punct = [b_prod // bj for bj in b]
    inv_punct = [pow(p % bj, -1, bj) for p, bj in zip(punct, b)]
    inv_bp_msk = pow(b_prod % m_sk, -1, m_sk)
    xp = [[int(x[j][i]) * inv_punct[j] % b[j] for i in range(n)]
          for j in range(k)]
    alphas = []
    for i in range(n):
        cm = sum(xp[j][i] * (punct[j] % m_sk) for j in range(k)) % m_sk
        a = (cm - int(x[k][i])) * inv_bp_msk % m_sk
        alphas.append(a - m_sk if a > m_sk // 2 else a)
    out = []
    for qi in qs:
        pq = [p % qi for p in punct]
        row = []
        for i in range(n):
            cq = sum(xp[j][i] * pq[j] for j in range(k)) % qi
            row.append((cq - alphas[i] * b_prod) % qi)
        out.append(row)
    return out
