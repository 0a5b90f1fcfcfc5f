// Forward flash attention (online softmax) for the GPU: two hand-written
// kernels behind one C entry point.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention). Both kernels compute the same function:
//
//   out[b, h, i] = sum_j p_ij v[b, h / group, j],  p = softmax_j(mask(cap(s)))
//   s_ij = (q[b, h, i] . k[b, h / group, j]) * sm_scale
//
// with f32 scores, an optional logit softcap cap * tanh(s / cap), then -1e30
// where masked (causal: j <= i; window: i - j < window), GQA (kv head =
// h / group), f32 running max, denominator and accumulator with the
// reference's guard m_new > -1e30 / 2, fully masked rows giving 0, and the
// output cast to q's dtype. q, k, v and out are contiguous [B, H, S, D].
// When the caller passes an lse buffer ([B * Hq, S] f32; the training
// forward does, serving passes null), both kernels also write each row's
// log-sum-exp m + log(l) in natural log, -inf for a fully masked row (l = 0):
// the backward (flash_attention_bwd.cu) recomputes the probabilities from it.
//
// What bounds it on an H100: the two products are 4 * S^2 * D FLOPs per
// (batch, q-head), halved by the causal mask (6.9e10 at B 4, Hq 16, Hkv 8,
// S 2048, D 128), against 50 MB of q, k, v and out in bf16: operations, at
// ~1400 FLOP/byte against the card's ~300 FLOP/byte ridge, so the products
// belong on the bf16 tensor cores (989 TFLOP/s dense).
//
// 1. Tensor-core kernel (flash_fwd_tc): bf16 and f16 at D 64, 128, 192, 256.
//    * One block per (batch * q-head, 128 query rows): two consumer
//      warpgroups of 64 rows each and a producer warpgroup whose first
//      thread issues every load. The producer is a whole warpgroup so that
//      setmaxnreg can hand its registers to the consumers (24 a thread
//      there, 240 in the consumers): the accumulators of O, S and P stay in
//      registers without spills at every D. Query blocks run heaviest
//      first; kv tiles that the causal or window mask empties for the whole
//      block are never loaded, tiles empty for one warpgroup's rows are
//      skipped by it, and only tiles that cross the diagonal, the window
//      edge or S apply the mask per element.
//    * The producer loads the Q tile once and the K and V tiles
//      (128 keys for D <= 128, 64 for D >= 192) through two 2-stage rings
//      with TMA, each ring slot guarded by a full and an empty mbarrier. The
//      tensor maps are 3-D [B*H, S, D], so rows past S arrive as TMA's zero
//      fill instead of the next head's rows. Boxes are 64 columns (128
//      bytes) wide with the 128-byte swizzle; a D-128 row is two boxes.
//      Shared memory: Q + 2 K + 2 V tiles, 192 KB at D 256, 160 KB at D 128.
//    * S = Q K^T: wgmma m64nBKVk16, Q and K both K-major from shared memory,
//      f32 accumulators. Products of two bf16 (or f16) values are exact in
//      f32, so this differs from the reference only in summation order.
//    * The softmax runs in registers on the accumulator fragment: a thread
//      holds two rows, each row is spread over 4 threads, so a row max or
//      sum is two shuffles. Scores are kept in base 2 (s * scale * log2 e)
//      and exponentiated with exp2f: one MUFU instruction instead of expf's
//      longer sequence, and its few-ulp difference from exp(s - m) is far
//      below the bf16/f16 rounding of p that follows. The row sum l adds the
//      f32 probabilities.
//    * O += P V: wgmma m64nDk16 with A = P from registers. The f32 score
//      accumulator of two n8 column chunks is, pair by pair, the 16-bit A
//      fragment of one k16 step, so P never goes through shared memory. V
//      is read MN-major (D contiguous, the transpose-B bit set), as stored.
//    * P is rounded to bf16 (f16) before P V: the one numerical departure
//      from the reference, which keeps p in f32. It moves the output by
//      about 2^-9 relative, well inside the 2e-2 tolerance of 16-bit inputs
//      (tests/test_torch_flash.py holds a rounded copy of the algorithm
//      against the JAX reference).
//    * Within a warpgroup, tile i's S = Q K^T and tile i-1's O += P V are
//      issued together, and the softmax of tile i runs while P V is still
//      on the tensor cores; the two warpgroups also interleave freely.
//    * Epilogue: divide by l (0 -> 1), convert, store from registers.
//
// 2. CUDA-core kernel (flash_fwd): f32 at every D, and bf16/f16 at D 32,
//    96, 160 and 224. f32 stays off the tensor cores because TF32 keeps
//    about 3 decimal digits and could not hold the f32 tolerance (2e-5) or
//    the f32 serving gate; D values that are not a multiple of a 64-column
//    swizzle box stay too (no config of the zoo uses them). One block per
//    (batch * q-head, 64 query rows), 8 warps of 8 rows, Q in f32 and K/V
//    tiles in the input type in shared memory, both products as scalar f32
//    FMAs, statistics and accumulator in registers.
//
// Which kernel runs depends only on dtype and D (flash_attention_uses_
// tensor_cores); a failed launch or tensor-map encoding is returned as an
// error code, never replaced by the other kernel.
//
// Plain C interface, loaded with ctypes (kernels/_build.py): no PyTorch
// headers, so the build takes seconds. The tensor maps are encoded per
// launch with cuTensorMapEncodeTiled reached through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BKV = 64;             // keys per kv tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;    // query rows per warp
constexpr int PAD = 4;              // elements of padding per Q/K smem row
constexpr float NEG_INF = -1e30f;   // the reference's mask value

// dtype codes of the C interface
enum DType : int { F32 = 0, BF16 = 1, F16 = 2 };

// Four consecutive elements as one aligned word.
template <typename T> struct Pack4;
template <> struct Pack4<float> { using type = float4; };
template <> struct Pack4<__nv_bfloat16> { using type = uint2; };
template <> struct Pack4<__half> { using type = uint2; };

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float f16_lo(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xffffu)));
}
__device__ __forceinline__ float f16_hi(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}

// load4(p): 4 elements at p (aligned to 4 elements) as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(f16_lo(u.x), f16_hi(u.x), f16_lo(u.y), f16_hi(u.y));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// round to nearest even, as torch's .to(dtype) does
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int NC>
constexpr size_t smem_bytes() {
  constexpr int D = NC * 32;
  return sizeof(float) * BQ * (D + PAD)      // Q, f32
         + sizeof(T) * BKV * (D + PAD)       // K tile
         + sizeof(T) * BKV * D               // V tile
         + sizeof(float) * BQ * BKV;         // probabilities
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          int S, int Hq, int group, float scale, int causal, int has_window,
          int window, int has_cap, float cap) {
  constexpr int D = NC * 32;
  constexpr int DP = D + PAD;
  using P4 = typename Pack4<T>::type;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);              // [BQ][DP]
  T* sK = reinterpret_cast<T*>(sQ + BQ * DP);              // [BKV][DP]
  T* sV = sK + BKV * DP;                                   // [BKV][D]
  float* sP = reinterpret_cast<float*>(sV + BKV * D);      // [BQ][BKV]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * ROWS;                        // the warp's rows
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;        // heaviest first
  const int bh = blockIdx.y;                               // b * Hq + h
  const int hkv = Hq / group;
  const size_t kv_head = static_cast<size_t>(bh / Hq) * hkv + (bh % Hq) / group;
  const T* qh = q + static_cast<size_t>(bh) * S * D;
  const T* kh = k + kv_head * S * D;
  const T* vh = v + kv_head * S * D;
  T* oh = o + static_cast<size_t>(bh) * S * D;

  // Q tile -> f32; rows past S are zero
  for (int i = tid; i < BQ * D / 4; i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) x = load4(qh + static_cast<size_t>(q0 + r) * D + c);
    *reinterpret_cast<float4*>(sQ + r * DP + c) = x;
  }

  // kv tiles [kv_lo, kv_hi) that hold a key some row of the block may see
  const int q_last = min(q0 + BQ, S) - 1;
  int kv_lo = 0;
  int kv_hi = (S + BKV - 1) / BKV;
  if (causal) kv_hi = q_last / BKV + 1;
  if (has_window && q0 - window + 1 > 0) kv_lo = (q0 - window + 1) / BKV;

  float m[ROWS], l[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = kv_lo; t < kv_hi; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();   // Q is in place; the last tile's K/V reads are done
    for (int i = tid; i < BKV * D / 4; i += THREADS) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      P4 kx, vx;
      if (kv0 + r < S) {
        const size_t g = static_cast<size_t>(kv0 + r) * D + c;
        kx = *reinterpret_cast<const P4*>(kh + g);
        vx = *reinterpret_cast<const P4*>(vh + g);
      } else {
        // keys past S: zero, so masked p = 0 times v stays 0 (no NaN)
        kx = P4{};
        vx = P4{};
      }
      *reinterpret_cast<P4*>(sK + r * DP + c) = kx;
      *reinterpret_cast<P4*>(sV + r * D + c) = vx;
    }
    __syncthreads();

    // s[i][j]: row r0 + i, key kv0 + lane + 32 j
    float s[ROWS][2];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i][0] = s[i][1] = 0.f;
    const T* ka_row = sK + lane * DP;
    const T* kb_row = sK + (lane + 32) * DP;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 ka = load4(ka_row + d);
      const float4 kb = load4(kb_row + d);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(sQ + (r0 + i) * DP + d);
        s[i][0] = fmaf(qv.x, ka.x, s[i][0]);
        s[i][0] = fmaf(qv.y, ka.y, s[i][0]);
        s[i][0] = fmaf(qv.z, ka.z, s[i][0]);
        s[i][0] = fmaf(qv.w, ka.w, s[i][0]);
        s[i][1] = fmaf(qv.x, kb.x, s[i][1]);
        s[i][1] = fmaf(qv.y, kb.y, s[i][1]);
        s[i][1] = fmaf(qv.z, kb.z, s[i][1]);
        s[i][1] = fmaf(qv.w, kb.w, s[i][1]);
      }
    }

    // scale, softcap, masks, then the online-softmax update per row
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qp = q0 + r0 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = kv0 + lane + 32 * j;
        float x = s[i][j] * scale;
        if (has_cap) x = cap * tanhf(x / cap);
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (has_window) ok = ok && (qp - kp < window);
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      // a row masked so far: exp(NEG_INF - NEG_INF) would be 1
      const bool safe = m_new > NEG_INF / 2;
      const float p0 = safe ? expf(s[i][0] - m_new) : 0.f;
      const float p1 = safe ? expf(s[i][1] - m_new) : 0.f;
      const float alpha = safe ? expf(m[i] - m_new) : 0.f;
      l[i] = alpha * l[i] + warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      sP[(r0 + i) * BKV + lane] = p0;
      sP[(r0 + i) * BKV + lane + 32] = p1;
    }
    __syncwarp();

    // acc[i][c] += sum_j p[r0 + i][j] * v[j][lane + 32 c]
#pragma unroll 2
    for (int j = 0; j < BKV; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[jj][c] = to_f32(sV[(j + jj) * D + lane + 32 * c]);
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(sP + (r0 + i) * BKV + j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][c] = fmaf(p.x, vv[0][c], acc[i][c]);
          acc[i][c] = fmaf(p.y, vv[1][c], acc[i][c]);
          acc[i][c] = fmaf(p.z, vv[2][c], acc[i][c]);
          acc[i][c] = fmaf(p.w, vv[3][c], acc[i][c]);
        }
      }
    }
    __syncwarp();      // the next tile rewrites this warp's sP strip
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qp = q0 + r0 + i;
    if (qp >= S) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      oh[static_cast<size_t>(qp) * D + lane + 32 * c] = from_f32<T>(acc[i][c] / denom);
    }
    if (lse != nullptr && lane == 0) {
      lse[static_cast<size_t>(bh) * S + qp] = l[i] == 0.f ? -INFINITY : m[i] + logf(l[i]);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Hq, int Hkv, int S, float scale,
                         int causal, int has_window, int window, int has_cap,
                         float cap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, NC>();
  auto kernel = flash_fwd<T, NC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * Hq);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Hq, Hq / Hkv, scale,
      causal, has_window, window, has_cap, cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, float* lse, int B, int Hq, int Hkv, int S,
                     float scale, int causal, int has_window, int window,
                     int has_cap, float cap, cudaStream_t stream) {
#define FLASH_CASE(NC)                                                        \
  case NC * 32:                                                               \
    return launch_typed<T, NC>(q, k, v, o, lse, B, Hq, Hkv, S, scale, causal, \
                               has_window, window, has_cap, cap, stream);
  switch (D) {
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

namespace tc {

using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_wait;
using hopper::PANEL_COLS;
using hopper::smem_addr;
using hopper::sw128_desc;

constexpr int BQ = 128;                   // query rows per block
constexpr int WG_ROWS = 64;               // query rows per consumer warpgroup
constexpr int CONSUMERS = BQ / WG_ROWS;   // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
// Registers a thread after setmaxnreg: the block starts with 168 a thread
// (65536 over 384 threads); the producer warpgroup gives all but 24 back and
// the consumers take 240 (128 x 24 + 256 x 240 = 384 x 168).
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int STAGES = 2;                 // slots of the K ring and of the V ring
constexpr float NEG_INF = -1e30f;         // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tiles {
  static_assert(D % PANEL_COLS == 0 && D <= 256, "D is 64, 128, 192 or 256");
  static constexpr int BKV = D <= 128 ? 128 : 64;    // keys per kv tile
  static constexpr int PANELS = D / PANEL_COLS;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;       // one K or one V tile
  // + 1024: the dynamic buffer is aligned up to the swizzle period
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
  static_assert(SMEM <= 227 * 1024, "shared memory of one block");
};

template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One tile's scores of a thread's two rows -> probabilities, in place:
// scale (then softcap) into base 2, mask (MASK: the tile crosses the
// diagonal, the window edge or S), fold into the running max m, and add the
// f32 probabilities to l. Returns each row's rescale factor for O.
template <int BKV, bool CAP, bool MASK>
__device__ __forceinline__ void online_softmax(
    float (&s)[BKV / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    float scale, float cap, int kv0, int row0, int col, int S, int causal,
    int has_window, int window) {
  const float scale_log2 = scale * LOG2E;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int idx = 0; idx < BKV / 2; ++idx) {
    const int r = (idx >> 1) & 1;
    float x = CAP ? cap * tanhf(s[idx] * scale / cap) * LOG2E : s[idx] * scale_log2;
    if (MASK) {
      const int key = kv0 + 8 * (idx >> 2) + col + (idx & 1);
      const int row = row0 + 8 * r;
      bool ok = key < S;
      if (causal) ok = ok && key <= row;
      if (has_window) ok = ok && row - key < window;
      x = ok ? x : NEG_INF;
    }
    s[idx] = x;
    mx[r] = fmaxf(mx[r], x);
  }
  bool safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    // a row masked so far: exp(NEG_INF - NEG_INF) would be 1
    safe[r] = m_new > NEG_INF / 2;
    alpha[r] = safe[r] ? exp2f(m[r] - m_new) : 0.f;
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int idx = 0; idx < BKV / 2; ++idx) {
    const int r = (idx >> 1) & 1;
    const float p = safe[r] ? exp2f(s[idx] - m[r]) : 0.f;
    s[idx] = p;
    sum[r] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(sum[r]);
}

// One consumer warpgroup's 64 query rows: the loop over the kv tiles, then
// the epilogue. Fragment layout of a wgmma m64nN f32 accumulator, thread t
// of the warpgroup (warp w = t / 32, lane l): register 4 j + e holds row
// 16 w + l / 4 + 8 (e / 2) and column 8 j + 2 (l % 4) + (e % 2).
//
// The tiles the masks leave non-empty for these rows form one run; in it,
// tile i's S = Q K^T and tile i-1's O += P V are issued together, and the
// softmax of tile i runs while P V is still on the tensor cores. Tiles
// outside the run are only waited for and released.
template <typename T, int D>
__device__ __forceinline__ void consume(
    unsigned char* sQ, unsigned char* sK, unsigned char* sV, uint64_t* q_full,
    uint64_t* k_full, uint64_t* k_empty, uint64_t* v_full, uint64_t* v_empty,
    T* __restrict__ o, float* __restrict__ lse, int q0, int bh, int kv_lo,
    int n_tiles, int warp, int S, float scale, int causal, int has_window,
    int window, int has_cap, float cap) {
  using C = Tiles<D>;
  constexpr int BKV = C::BKV;
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int qw0 = q0 + wg * WG_ROWS;                  // the warpgroup's rows
  const int row0 = qw0 + 16 * (warp % 4) + lane / 4;  // this thread's rows:
  const int row1 = row0 + 8;                          //   row0 and row0 + 8
  const int col = 2 * (lane % 4);                     // + 8 j + (e % 2)

  float acc[D / 2];
  float s[BKV / 2];
  uint32_t pa[BKV / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};    // running max, base 2
  float l[2] = {0.f, 0.f};            // running denominator
  float alpha[2];

  const uint32_t q_addr = smem_addr(sQ) + wg * WG_ROWS * 128;
  auto stage = [](int i) { return i % STAGES; };
  auto phase = [](int i) { return static_cast<uint32_t>((i / STAGES) & 1); };
  auto kv0_of = [&](int i) { return (kv_lo + i) * BKV; };
  // a tile the masks empty for all 64 rows
  auto idle = [&](int i) {
    const int kv0 = kv0_of(i);
    return (causal && kv0 > qw0 + WG_ROWS - 1) ||
           (has_window && qw0 - (kv0 + BKV - 1) >= window);
  };
  auto skip = [&](int i) {
    mbar_wait(&k_full[stage(i)], phase(i));
    mbar_arrive(&k_empty[stage(i)]);
    mbar_wait(&v_full[stage(i)], phase(i));
    mbar_arrive(&v_empty[stage(i)]);
  };
  // S = Q K_i^T, issued (not waited for)
  auto issue_qk = [&](int i) {
    mbar_wait(&k_full[stage(i)], phase(i));
    const uint32_t k_addr = smem_addr(sK + stage(i) * C::KV_BYTES);
    fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes
      const uint64_t da = sw128_desc(q_addr + (kk / 4) * BQ * 128 + off, 16, 1024);
      const uint64_t db = sw128_desc(k_addr + (kk / 4) * BKV * 128 + off, 16, 1024);
      hopper::wgmma_ss<T, BKV>(s, da, db, kk > 0);
    }
    hopper::wgmma_commit();
  };
  // O += P V_i, issued (not waited for)
  auto issue_pv = [&](int i) {
    mbar_wait(&v_full[stage(i)], phase(i));
    const uint32_t v_addr = smem_addr(sV + stage(i) * C::KV_BYTES);
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(pa[kk]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      // 16 keys = 16 rows of 128 B; the next 64 columns are a panel away
      const uint64_t db = sw128_desc(v_addr + kk * 16 * 128, BKV * 128, 1024);
      hopper::wgmma_rs<T, D>(acc, pa[kk], db);
    }
    hopper::wgmma_commit();
  };
  auto softmax = [&](int i) {
    const int kv0 = kv0_of(i);
    const bool edge = kv0 + BKV > S || (causal && kv0 + BKV - 1 > qw0) ||
                      (has_window && qw0 + WG_ROWS - 1 - kv0 >= window);
    if (edge) {
      if (has_cap) {
        online_softmax<BKV, true, true>(s, m, l, alpha, scale, cap, kv0, row0, col, S,
                                        causal, has_window, window);
      } else {
        online_softmax<BKV, false, true>(s, m, l, alpha, scale, cap, kv0, row0, col, S,
                                         causal, has_window, window);
      }
    } else if (has_cap) {
      online_softmax<BKV, true, false>(s, m, l, alpha, scale, cap, kv0, row0, col, S,
                                       causal, has_window, window);
    } else {
      online_softmax<BKV, false, false>(s, m, l, alpha, scale, cap, kv0, row0, col, S,
                                        causal, has_window, window);
    }
  };
  // rescale O, then P to 16 bits: accumulator registers 8 kk .. 8 kk + 7
  // are the A fragment of k step kk, two at a time
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int idx = 0; idx < D / 2; ++idx) acc[idx] *= alpha[(idx >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        pa[kk][h] = pack2<T>(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1]);
      }
    }
  };

  int t0 = 0, t1 = n_tiles;
  while (t0 < t1 && idle(t0)) ++t0;
  while (t1 > t0 && idle(t1 - 1)) --t1;

  mbar_wait(q_full, 0);
  for (int i = 0; i < t0; ++i) skip(i);
  if (t0 < t1) {
    issue_qk(t0);
    hopper::wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(&k_empty[stage(t0)]);
    softmax(t0);
    rescale_and_pack();
    for (int i = t0 + 1; i < t1; ++i) {
      issue_qk(i);
      issue_pv(i - 1);
      hopper::wgmma_wait<1>();          // S of tile i is in
      fence_regs(s);
      mbar_arrive(&k_empty[stage(i)]);
      softmax(i);                       // beside P V of tile i - 1
      hopper::wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(pa[kk]);
      mbar_arrive(&v_empty[stage(i - 1)]);
      rescale_and_pack();
    }
    issue_pv(t1 - 1);
    hopper::wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(pa[kk]);
    mbar_arrive(&v_empty[stage(t1 - 1)]);
  }
  for (int i = t1; i < n_tiles; ++i) skip(i);

  // lse = m + log(l) in natural log (m is kept in base 2), -inf where l = 0.
  // Each row's m and l are whole in all 4 threads of its quad after the
  // quad reductions; the quad's first thread writes. Rows past S dropped.
  if (lse != nullptr && lane % 4 == 0) {
    constexpr float LN2 = 0.6931471805599453f;
    if (row0 < S) {
      lse[static_cast<size_t>(bh) * S + row0] =
          l[0] == 0.f ? -INFINITY : m[0] * LN2 + logf(l[0]);
    }
    if (row1 < S) {
      lse[static_cast<size_t>(bh) * S + row1] =
          l[1] == 0.f ? -INFINITY : m[1] * LN2 + logf(l[1]);
    }
  }

  // out = acc / l (0 -> 1), rows past S dropped
  const float inv0 = 1.f / (l[0] == 0.f ? 1.f : l[0]);
  const float inv1 = 1.f / (l[1] == 0.f ? 1.f : l[1]);
  T* out0 = o + (static_cast<size_t>(bh) * S + row0) * D + col;
  T* out1 = o + (static_cast<size_t>(bh) * S + row1) * D + col;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0 < S) {
      *reinterpret_cast<uint32_t*>(out0 + 8 * j) =
          pack2<T>(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    }
    if (row1 < S) {
      *reinterpret_cast<uint32_t*>(out1 + 8 * j) =
          pack2<T>(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tmap_q,
             const __grid_constant__ CUtensorMap tmap_k,
             const __grid_constant__ CUtensorMap tmap_v, T* __restrict__ o,
             float* __restrict__ lse, int S, int Hq, int group, float scale,
             int causal, int has_window, int window, int has_cap, float cap) {
  using C = Tiles<D>;
  constexpr int BKV = C::BKV;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[STAGES], k_empty[STAGES];
  __shared__ __align__(8) uint64_t v_full[STAGES], v_empty[STAGES];

  // Q: PANELS panels of BQ rows x 128 B; K and V: STAGES slots of PANELS
  // panels of BKV rows x 128 B. Every panel starts on a 1024-byte boundary.
  unsigned char* sQ = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + C::Q_BYTES;
  unsigned char* sV = sK + STAGES * C::KV_BYTES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int bh = blockIdx.y;                          // b * Hq + h
  const int hkv = Hq / group;
  const int kv_head = (bh / Hq) * hkv + (bh % Hq) / group;

  // kv tiles [kv_lo, kv_lo + n_tiles) that hold a key some row may see
  const int q_last = min(q0 + BQ, S) - 1;
  int kv_lo = 0;
  int kv_hi = (S + BKV - 1) / BKV;
  if (causal) kv_hi = q_last / BKV + 1;
  if (has_window && q0 - window + 1 > 0) kv_lo = (q0 - window + 1) / BKV;
  const int n_tiles = max(kv_hi - kv_lo, 0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], CONSUMERS * 128);
      hopper::mbar_init(&v_empty[s], CONSUMERS * 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= CONSUMERS * 4) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      hopper::mbar_arrive_expect_tx(&q_full, C::Q_BYTES);
      for (int p = 0; p < C::PANELS; ++p) {
        hopper::tma_load_3d(sQ + p * BQ * 128, &tmap_q, &q_full, p * PANEL_COLS, q0, bh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        const uint32_t phase = (i / STAGES) & 1;
        const int kv0 = (kv_lo + i) * BKV;
        // the first pass over the ring finds every slot free
        mbar_wait(&k_empty[st], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&k_full[st], C::KV_BYTES);
        for (int p = 0; p < C::PANELS; ++p) {
          hopper::tma_load_3d(sK + st * C::KV_BYTES + p * BKV * 128, &tmap_k,
                              &k_full[st], p * PANEL_COLS, kv0, kv_head);
        }
        mbar_wait(&v_empty[st], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&v_full[st], C::KV_BYTES);
        for (int p = 0; p < C::PANELS; ++p) {
          hopper::tma_load_3d(sV + st * C::KV_BYTES + p * BKV * 128, &tmap_v,
                              &v_full[st], p * PANEL_COLS, kv0, kv_head);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    consume<T, D>(sQ, sK, sV, &q_full, k_full, k_empty, v_full, v_empty, o, lse, q0,
                  bh, kv_lo, n_tiles, warp, S, scale, causal, has_window, window,
                  has_cap, cap);
  }
}

// ----------------------------------------------------------------- host

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* o, float* lse,
                 int B, int Hq, int Hkv, int S, float scale, int causal,
                 int has_window, int window, int has_cap, float cap,
                 cudaStream_t stream) {
  using C = Tiles<D>;
  hopper::EncodeTiled encode;
  int err = hopper::encoder(&encode);
  if (err != 0) return err;
  constexpr CUtensorMapDataType type = hopper::map_type<T>();
  CUtensorMap tmap_q, tmap_k, tmap_v;
  if ((err = hopper::make_map(encode, &tmap_q, q, type, B * Hq, S, D, BQ)) != 0 ||
      (err = hopper::make_map(encode, &tmap_k, k, type, B * Hkv, S, D, C::BKV)) != 0 ||
      (err = hopper::make_map(encode, &tmap_v, v, type, B * Hkv, S, D, C::BKV)) != 0) {
    return err;
  }
  auto kernel = flash_fwd_tc<T, D>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((S + BQ - 1) / BQ, B * Hq);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(
      tmap_q, tmap_k, tmap_v, static_cast<T*>(o), lse, S, Hq, Hq / Hkv, scale,
      causal, has_window, window, has_cap, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int Hq, int Hkv, int S, float scale, int causal,
             int has_window, int window, int has_cap, float cap,
             cudaStream_t stream) {
#define FLASH_TC_CASE(D_)                                                     \
  case D_:                                                                    \
    return launch_typed<T, D_>(q, k, v, o, lse, B, Hq, Hkv, S, scale, causal, \
                               has_window, window, has_cap, cap, stream);
  switch (D) {
    FLASH_TC_CASE(64) FLASH_TC_CASE(128) FLASH_TC_CASE(192) FLASH_TC_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_TC_CASE
}

}  // namespace tc

extern "C" {

// 1 if flash_attention_launch runs the tensor-core kernel for this dtype
// code and head dim, 0 if the CUDA-core kernel.
int flash_attention_uses_tensor_cores(int dtype, int D) {
  return (dtype == BF16 || dtype == F16) && D % tc::PANEL_COLS == 0 && D >= 64 &&
         D <= 256;
}

// Launches the kernel on `stream` and returns 0, a cudaError_t, or a code
// of the tensor-map encoding (flash_attention_error_string names each).
// q, out: [B, Hq, S, D]; k, v: [B, Hkv, S, D]; all contiguous, of the
// type `dtype` (0 f32, 1 bf16, 2 f16) and aligned to 16 bytes. Hq is a
// multiple of Hkv, D a multiple of 32 up to 256, B * Hq <= 65535.
// has_window = 0 ignores `window`; has_cap = 0 ignores `cap`. lse, when
// not null, is [B * Hq, S] f32 and receives each row's log-sum-exp.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, float* lse, int dtype, int B, int Hq, int Hkv,
                           int S, int D, float sm_scale, int causal,
                           int has_window, int window, int has_cap, float cap,
                           void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || B * Hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flash_attention_uses_tensor_cores(dtype, D)) {
    if (dtype == BF16) {
      return tc::launch_d<__nv_bfloat16>(D, q, k, v, out, lse, B, Hq, Hkv, S,
                                         sm_scale, causal, has_window, window,
                                         has_cap, cap, st);
    }
    return tc::launch_d<__half>(D, q, k, v, out, lse, B, Hq, Hkv, S, sm_scale,
                                causal, has_window, window, has_cap, cap, st);
  }
  cudaError_t err;
  switch (dtype) {
    case F32:
      err = launch_d<float>(D, q, k, v, out, lse, B, Hq, Hkv, S, sm_scale, causal,
                            has_window, window, has_cap, cap, st);
      break;
    case BF16:
      err = launch_d<__nv_bfloat16>(D, q, k, v, out, lse, B, Hq, Hkv, S, sm_scale,
                                    causal, has_window, window, has_cap, cap, st);
      break;
    case F16:
      err = launch_d<__half>(D, q, k, v, out, lse, B, Hq, Hkv, S, sm_scale, causal,
                             has_window, window, has_cap, cap, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int code) { return hopper::error_string(code); }

}  // extern "C"
