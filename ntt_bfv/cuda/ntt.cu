// Negacyclic NTT / inverse NTT over u64 residues for Hopper (sm_90a),
// called from JAX through the XLA FFI (ntt_bfv/cuda/__init__.py).
//
// Same index algebra and Montgomery arithmetic as the XLA stage loop in
// ops/ntt.py (forward CT, natural in / bit-reversed out; inverse GS with
// per-stage halving that folds n^-1), so outputs are bit-identical to it.
//
// Schedule (the reference's hybrid, ntt_60bit.cuh:267-386, with the
// split set by this card's shared memory):
//   * one row = one polynomial of one modulus; row i uses modulus i % r;
//   * the first K stages run as one global-memory pass (radix-2^K in
//     registers), which leaves 2^K independent sub-transforms per row;
//     each sub-transform then runs all its stages in one block's shared
//     memory.  A sub-transform of up to 2^14 u64 (128 KB) fits the 227 KB
//     a block may use, so K >= log2(n) - 14.  Beyond that, K grows (up to
//     4, keeping sub-transforms of at least 2^10) until there are enough
//     blocks to fill the card: a few rows alone would leave most SMs idle
//     (schedule()).  The inverse runs the two kernels in the opposite
//     order.
// The handlers only enqueue kernels on XLA's stream, so XLA may capture
// them into command buffers (CUDA graphs).

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
typedef unsigned long long u64;

constexpr int kMaxSmemLog = 14;   // largest sub-transform held in shared memory
constexpr int kMinSmemLog = 10;   // smallest sub-transform worth a block
constexpr int kMaxK = 4;          // most stages fused in the global pass
constexpr int kMaxLog = kMaxSmemLog + kMaxK;
constexpr long long kTargetBlocks = 256;  // ~2 blocks per SM on 132 SMs

// Global stages K for n = 2^logn over `rows` rows (mirrored in
// ntt_bfv/cuda/__init__.py schedule()).
static int schedule(int logn, long long rows) {
  int k = logn > kMaxSmemLog ? logn - kMaxSmemLog : 0;
  while (k < kMaxK && logn - k > kMinSmemLog && (rows << k) < kTargetBlocks)
    ++k;
  return k;
}

__device__ __forceinline__ u64 mont_mul(u64 a, u64 b, u64 q, u64 qinv_neg) {
  const u64 lo = a * b;
  const u64 hi = __umul64hi(a, b);
  const u64 m = lo * qinv_neg;
  const u64 t = hi + __umul64hi(m, q) + (lo != 0ULL);
  return t >= q ? t - q : t;
}

__device__ __forceinline__ u64 add_mod(u64 a, u64 b, u64 q) {
  const u64 s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ u64 sub_mod(u64 a, u64 b, u64 q) {
  return a + (a < b ? q : 0ULL) - b;
}

__device__ __forceinline__ u64 halve_mod(u64 x, u64 q) {
  return (x >> 1) + ((q + 1ULL) >> 1) * (x & 1ULL);
}

__device__ __forceinline__ void ct(u64& u, u64& v, u64 w, u64 q, u64 qi) {
  const u64 t = mont_mul(v, w, q, qi);
  v = sub_mod(u, t, q);
  u = add_mod(u, t, q);
}

__device__ __forceinline__ void gs(u64& u, u64& v, u64 w, u64 q, u64 qi) {
  const u64 s = add_mod(u, v, q);
  const u64 d = mont_mul(sub_mod(u, v, q), w, q, qi);
  u = halve_mod(s, q);
  v = halve_mod(d, q);
}

// All stages of one sub-transform of size m = 2^logm in shared memory.
// Block b handles sub-block h = b % H of row b / H (H = n / m), which is
// contiguous in memory.  A local stage with length L reads twiddle
// (H + h) * L + g: the global stage has length H * L and the sub-block's
// groups start at h * L.
template <bool kInverse>
__global__ void smem_stages(const u64* in, u64* out,  // may alias
                            const u64* __restrict__ tab,
                            const u64* __restrict__ qs,
                            const u64* __restrict__ qinvs, int r, int logn,
                            int logm) {
  extern __shared__ u64 buf[];
  const int m = 1 << logm;
  const int logH = logn - logm;
  const long long sub = blockIdx.x;
  const long long row = sub >> logH;
  const long long h = sub & ((1LL << logH) - 1);
  const int mi = static_cast<int>(row % r);
  const u64 q = qs[mi];
  const u64 qi = qinvs[mi];
  const u64* w = tab + (static_cast<size_t>(mi) << logn);
  const u64* src = in + sub * m;
  u64* dst = out + sub * m;

  for (int i = threadIdx.x; i < m; i += blockDim.x) buf[i] = src[i];
  __syncthreads();

  const int half = m >> 1;
  for (int k = 0; k < logm; ++k) {
    const int s = kInverse ? logm - 1 - k : k;
    const int logstep = logm - s - 1;
    const long long base = ((1LL << logH) + h) << s;
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int g = b >> logstep;
      const int iu = (g << (logstep + 1)) + (b & ((1 << logstep) - 1));
      const int iv = iu + (1 << logstep);
      const u64 tw = __ldg(w + base + g);
      u64 u = buf[iu];
      u64 v = buf[iv];
      if (kInverse) gs(u, v, tw, q, qi);
      else ct(u, v, tw, q, qi);
      buf[iu] = u;
      buf[iv] = v;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < m; i += blockDim.x) dst[i] = buf[i];
}

// The first K stages of a row as one pass over global memory: each
// thread owns the 2^K elements j + t * n / 2^K and applies the K stages
// in registers.  Global stage s pairs t with t + 2^(K-s-1) (bit K-s-1 of
// t clear) under twiddle 2^s + (t >> (K - s)).  Rows are independent, so
// in == out is allowed.
template <int K, bool kInverse>
__global__ void global_stages(const u64* in, u64* out,
                              const u64* __restrict__ tab,
                              const u64* __restrict__ qs,
                              const u64* __restrict__ qinvs, int r, int logn,
                              long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= total) return;
  const int logp = logn - K;
  const long long row = idx >> logp;
  const long long j = idx & ((1LL << logp) - 1);
  const int mi = static_cast<int>(row % r);
  const u64 q = qs[mi];
  const u64 qi = qinvs[mi];
  const u64* w = tab + (static_cast<size_t>(mi) << logn);
  const long long base = (row << logn) + j;
  const long long P = 1LL << logp;

  u64 a[1 << K];
#pragma unroll
  for (int t = 0; t < (1 << K); ++t) a[t] = in[base + t * P];

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = kInverse ? K - 1 - k : k;
    const int half = 1 << (K - s - 1);
#pragma unroll
    for (int t = 0; t < (1 << K); ++t) {
      if (t & half) continue;
      const u64 tw = __ldg(w + (1 << s) + (t >> (K - s)));
      if (kInverse) gs(a[t], a[t + half], tw, q, qi);
      else ct(a[t], a[t + half], tw, q, qi);
    }
  }

#pragma unroll
  for (int t = 0; t < (1 << K); ++t) out[base + t * P] = a[t];
}

// Lets both shared-memory kernels use the 128 KB a 2^14 row needs (the
// default cap is 48 KB) on every device.  Called once when the library is
// loaded, so the handlers themselves only launch kernels and XLA can
// capture them into command buffers.
extern "C" int NttInit() {
  int current = 0, count = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess) err = cudaGetDeviceCount(&count);
  const int bytes = (1 << kMaxSmemLog) * static_cast<int>(sizeof(u64));
  for (int d = 0; err == cudaSuccess && d < count; ++d) {
    err = cudaSetDevice(d);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(smem_stages<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(smem_stages<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
  }
  if (count > 0) cudaSetDevice(current);
  return static_cast<int>(err);
}

template <bool kInverse>
static void launch_smem(cudaStream_t stream, const u64* in, u64* out,
                        const u64* tab, const u64* q, const u64* qi, int r,
                        int logn, int logm, long long rows) {
  const int m = 1 << logm;
  const int bytes = m * static_cast<int>(sizeof(u64));
  int threads = m / 8;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const long long blocks = rows << (logn - logm);
  smem_stages<kInverse><<<static_cast<unsigned>(blocks), threads, bytes,
                          stream>>>(in, out, tab, q, qi, r, logn, logm);
}

template <bool kInverse>
static void launch_global(cudaStream_t stream, const u64* in, u64* out,
                          const u64* tab, const u64* q, const u64* qi, int r,
                          int logn, int K, long long rows) {
  const long long total = rows << (logn - K);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  switch (K) {
    case 1:
      global_stages<1, kInverse><<<blocks, threads, 0, stream>>>(
          in, out, tab, q, qi, r, logn, total);
      break;
    case 2:
      global_stages<2, kInverse><<<blocks, threads, 0, stream>>>(
          in, out, tab, q, qi, r, logn, total);
      break;
    case 3:
      global_stages<3, kInverse><<<blocks, threads, 0, stream>>>(
          in, out, tab, q, qi, r, logn, total);
      break;
    default:
      global_stages<4, kInverse><<<blocks, threads, 0, stream>>>(
          in, out, tab, q, qi, r, logn, total);
  }
}

template <bool kInverse>
static ffi::Error NttImpl(cudaStream_t stream, ffi::Buffer<ffi::U64> x,
                          ffi::Buffer<ffi::U64> tab, ffi::Buffer<ffi::U64> q,
                          ffi::Buffer<ffi::U64> qinv,
                          ffi::ResultBuffer<ffi::U64> y) {
  const auto xd = x.dimensions();
  const auto td = tab.dimensions();
  if (xd.size() < 1 || td.size() != 2)
    return ffi::Error::InvalidArgument("ntt: x must have rank >= 1, tables rank 2");
  const long long n = xd.back();
  const long long r = td[0];
  if (td[1] != n)
    return ffi::Error::InvalidArgument("ntt: table width differs from n");
  int logn = 0;
  while ((1LL << logn) < n) ++logn;
  if ((1LL << logn) != n || logn < 1 || logn > kMaxLog)
    return ffi::Error::InvalidArgument("ntt: n must be a power of two in [2, 2^18]");
  if (static_cast<long long>(q.element_count()) != r ||
      static_cast<long long>(qinv.element_count()) != r)
    return ffi::Error::InvalidArgument("ntt: one modulus constant per table row");
  const long long rows = static_cast<long long>(x.element_count()) / n;
  if (rows % r != 0)
    return ffi::Error::InvalidArgument("ntt: row count is not a multiple of r");
  if (rows == 0) return ffi::Error::Success();

  // the FFI's u64 is uint64_t (unsigned long); the kernels use the
  // unsigned long long that __umul64hi and __ldg take
  const u64* in = static_cast<const u64*>(x.untyped_data());
  u64* out = static_cast<u64*>(y->untyped_data());
  const u64* t = static_cast<const u64*>(tab.untyped_data());
  const u64* qp = static_cast<const u64*>(q.untyped_data());
  const u64* qip = static_cast<const u64*>(qinv.untyped_data());
  const int K = schedule(logn, rows);
  const int logm = logn - K;
  const int rr = static_cast<int>(r);

  if (!kInverse) {
    if (K > 0) {
      launch_global<false>(stream, in, out, t, qp, qip, rr, logn, K, rows);
      in = out;
    }
    launch_smem<false>(stream, in, out, t, qp, qip, rr, logn, logm, rows);
  } else {
    launch_smem<true>(stream, in, out, t, qp, qip, rr, logn, logm, rows);
    if (K > 0)
      launch_global<true>(stream, out, out, t, qp, qip, rr, logn, K, rows);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("ntt launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

#define NTT_BINDING                                   \
  ffi::Ffi::Bind()                                    \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()       \
      .Arg<ffi::Buffer<ffi::U64>>()                   \
      .Arg<ffi::Buffer<ffi::U64>>()                   \
      .Arg<ffi::Buffer<ffi::U64>>()                   \
      .Arg<ffi::Buffer<ffi::U64>>()                   \
      .Ret<ffi::Buffer<ffi::U64>>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(NttForward, NttImpl<false>, NTT_BINDING,
                              {ffi::Traits::kCmdBufferCompatible});
XLA_FFI_DEFINE_HANDLER_SYMBOL(NttInverse, NttImpl<true>, NTT_BINDING,
                              {ffi::Traits::kCmdBufferCompatible});
