// Native host-math runtime for ntt_bfv.
//
// Equivalent of the reference's host-side C++ layer:
//   * 128-bit integer arithmetic      (BFV_Scheme/uint128.h — uint128_t,
//     host64x2 schoolbook 64x64->128, long division by u64)
//   * modular exponentiation/inverse  (BFV_Scheme/helper.h:8-70 —
//     modpow128 / modinv128 / bitReverse)
//   * golden-model negacyclic polymul (BFV_Scheme/helper.h:95-126 —
//     refPolyMul128)
//   * twiddle-table precompute        (BFV_Scheme/parameter.h:5-29 —
//     fillTablePsi128, bit-reversed psi powers)
//   * Salsa20 keystream               (BFV_Scheme/distributions.cuh:48-155 —
//     VecCrypt, 20 rounds, counter mode)
//
// Where the reference emulates 128-bit math from 64-bit limbs by hand
// (shift-add host64x2, restoring long division), we use the compiler's
// unsigned __int128 — the idiomatic native form on a modern host; results
// are bit-identical.  Exposed as a plain C ABI for ctypes (no pybind11 in
// this image).  All moduli are < 2^61 as in the reference's parameter
// families (parameter.h:31-137), so a*b and (x<<64) fit in __int128.
//
// Build: ntt_bfv/native/__init__.py invokes
//   g++ -O2 -shared -fPIC -o libntt_host.so ntt_host.cpp
// on first import; every entry point has a pure-Python fallback.

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;

extern "C" {

// ---------------------------------------------------------------------------
// Scalar modular arithmetic (helper.h:8-70 equivalents).
// ---------------------------------------------------------------------------

u64 nh_mulmod(u64 a, u64 b, u64 q) {
    return (u64)(((u128)a * b) % q);
}

u64 nh_modpow(u64 base, u64 exp, u64 q) {
    // square-and-multiply, as modpow128 (helper.h:8-31)
    u64 r = 1 % q;
    base %= q;
    while (exp) {
        if (exp & 1) r = nh_mulmod(r, base, q);
        base = nh_mulmod(base, base, q);
        exp >>= 1;
    }
    return r;
}

u64 nh_modinv(u64 a, u64 q) {
    // Fermat a^(q-2), q prime — modinv128 (helper.h:33-41)
    return nh_modpow(a, q - 2, q);
}

u64 nh_bitrev(u64 x, int bits) {
    u64 r = 0;
    for (int i = 0; i < bits; i++) { r = (r << 1) | ((x >> i) & 1); }
    return r;
}

// Shoup precomputed companion: floor((w << 64) / q).
u64 nh_shoup(u64 w, u64 q) {
    return (u64)(((u128)w << 64) / q);
}

// Barrett mu for the reference's singleBarrett: floor(2^(2*qbit) / q)
// (computed host-side in demo.cu:156-165).
u64 nh_barrett_mu(u64 q, int qbit) {
    return (u64)((((u128)1) << (2 * qbit)) / q);
}

// ---------------------------------------------------------------------------
// Table precompute (parameter.h:5-29 fillTablePsi128 equivalents).
// ---------------------------------------------------------------------------

// out[i] = base^bitrev(i) mod q for i in [0, n) — the bit-reversed psi
// power table enabling the merged negacyclic NTT.
void nh_fill_bitrev_powers(u64 base, u64 q, u64 n, u64* out) {
    int bits = 0;
    while ((1ull << bits) < n) bits++;
    // powers in natural order first, then scatter by bit-reversal
    u64 v = 1 % q;
    for (u64 i = 0; i < n; i++) {
        out[nh_bitrev(i, bits)] = v;
        v = nh_mulmod(v, base, q);
    }
}

// out[i] = g^i mod q for i in [0, count) (geometric row; twiddle-fix rows).
void nh_geometric_row(u64 g, u64 q, u64 count, u64* out) {
    u64 v = 1 % q;
    for (u64 i = 0; i < count; i++) {
        out[i] = v;
        v = nh_mulmod(v, g, q);
    }
}

// ---------------------------------------------------------------------------
// Golden-model schoolbook negacyclic polymul (helper.h:95-126).
// ---------------------------------------------------------------------------

// c[k] = sum_{i+j=k} a_i b_j - sum_{i+j=k+n} a_i b_j (mod q); O(n^2).
void nh_schoolbook_negacyclic(const u64* a, const u64* b, u64 q, u64 n,
                              u64* c) {
    for (u64 k = 0; k < n; k++) {
        u64 acc = 0;
        for (u64 i = 0; i < n; i++) {
            u64 j = (k >= i) ? (k - i) : (k + n - i);
            u64 t = nh_mulmod(a[i], b[j], q);
            if (k >= i) {
                acc += t;
                if (acc >= q) acc -= q;          // acc, t < q
            } else {                              // wraparound term: subtract
                acc += q - t;
                if (acc >= q) acc -= q;
            }
        }
        c[k] = acc;
    }
}

// ---------------------------------------------------------------------------
// Salsa20 keystream (salsa_common.h / distributions.cuh:48-155).
// ---------------------------------------------------------------------------

static inline u32 rotl32(u32 x, int c) { return (x << c) | (x >> (32 - c)); }

// One 64-byte block: key 32 bytes, nonce 8 bytes, block counter.
// Constants sigma = "expand 32-byte k" (distributions.cuh:13).
static void salsa20_block(const u32 key[8], const u32 nonce[2], u64 counter,
                          u32 out[16]) {
    static const u32 sigma[4] = {0x61707865u, 0x3320646eu,
                                 0x79622d32u, 0x6b206574u};
    u32 s[16];
    s[0] = sigma[0];
    s[1] = key[0]; s[2] = key[1]; s[3] = key[2]; s[4] = key[3];
    s[5] = sigma[1];
    s[6] = nonce[0]; s[7] = nonce[1];
    s[8] = (u32)(counter & 0xffffffffu);
    s[9] = (u32)(counter >> 32);
    s[10] = sigma[2];
    s[11] = key[4]; s[12] = key[5]; s[13] = key[6]; s[14] = key[7];
    s[15] = sigma[3];
    u32 x[16];
    std::memcpy(x, s, sizeof(x));
    for (int round = 0; round < 20; round += 2) {     // ROUNDS=20
        // column round
        x[ 4] ^= rotl32(x[ 0] + x[12],  7);
        x[ 8] ^= rotl32(x[ 4] + x[ 0],  9);
        x[12] ^= rotl32(x[ 8] + x[ 4], 13);
        x[ 0] ^= rotl32(x[12] + x[ 8], 18);
        x[ 9] ^= rotl32(x[ 5] + x[ 1],  7);
        x[13] ^= rotl32(x[ 9] + x[ 5],  9);
        x[ 1] ^= rotl32(x[13] + x[ 9], 13);
        x[ 5] ^= rotl32(x[ 1] + x[13], 18);
        x[14] ^= rotl32(x[10] + x[ 6],  7);
        x[ 2] ^= rotl32(x[14] + x[10],  9);
        x[ 6] ^= rotl32(x[ 2] + x[14], 13);
        x[10] ^= rotl32(x[ 6] + x[ 2], 18);
        x[ 3] ^= rotl32(x[15] + x[11],  7);
        x[ 7] ^= rotl32(x[ 3] + x[15],  9);
        x[11] ^= rotl32(x[ 7] + x[ 3], 13);
        x[15] ^= rotl32(x[11] + x[ 7], 18);
        // row round
        x[ 1] ^= rotl32(x[ 0] + x[ 3],  7);
        x[ 2] ^= rotl32(x[ 1] + x[ 0],  9);
        x[ 3] ^= rotl32(x[ 2] + x[ 1], 13);
        x[ 0] ^= rotl32(x[ 3] + x[ 2], 18);
        x[ 6] ^= rotl32(x[ 5] + x[ 4],  7);
        x[ 7] ^= rotl32(x[ 6] + x[ 5],  9);
        x[ 4] ^= rotl32(x[ 7] + x[ 6], 13);
        x[ 5] ^= rotl32(x[ 4] + x[ 7], 18);
        x[11] ^= rotl32(x[10] + x[ 9],  7);
        x[ 8] ^= rotl32(x[11] + x[10],  9);
        x[ 9] ^= rotl32(x[ 8] + x[11], 13);
        x[10] ^= rotl32(x[ 9] + x[ 8], 18);
        x[12] ^= rotl32(x[15] + x[14],  7);
        x[13] ^= rotl32(x[12] + x[15],  9);
        x[14] ^= rotl32(x[13] + x[12], 13);
        x[15] ^= rotl32(x[14] + x[13], 18);
    }
    for (int i = 0; i < 16; i++) out[i] = x[i] + s[i];
}

// nblocks 64-byte keystream blocks starting at block `counter0`.
void nh_salsa20_keystream(const u32* key8, const u32* nonce2, u64 counter0,
                          u64 nblocks, u32* out) {
    for (u64 b = 0; b < nblocks; b++) {
        salsa20_block(key8, nonce2, counter0 + b, out + 16 * b);
    }
}

}  // extern "C"
