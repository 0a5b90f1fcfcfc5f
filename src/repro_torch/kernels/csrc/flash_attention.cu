// Forward flash attention (online softmax), one thread block per
// (batch * q-head, 64-row query block).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention). It computes the same function:
//
//   out[b, h, i] = sum_j p_ij v[b, h / group, j],  p = softmax_j(mask(cap(s)))
//   s_ij = (q[b, h, i] . k[b, h / group, j]) * sm_scale
//
// with an optional logit softcap cap * tanh(s / cap), a causal mask (j <= i),
// a window mask (i - j < window), GQA (kv head = h / group), f32 running
// max, denominator and accumulator, fully masked rows giving 0, and the
// output cast to q's dtype. q, k, v and out are contiguous [B, H, S, D] in
// f32, bf16 or fp16; D is a multiple of 32 up to 256.
//
// It is not carried over block by block. On the TPU the kv axis is a
// sequential grid dimension and the running statistics live in VMEM scratch
// between grid steps; here the kv loop runs inside the block and the
// statistics live in registers:
//
//   * 8 warps, 8 query rows each. The block's Q tile is converted to f32 in
//     shared memory once; each 64-key K/V tile is staged in shared memory in
//     the input type (half the bytes of f32 for bf16, so two blocks fit on
//     an SM at D = 128).
//   * Scores: lane l of a warp owns keys l and l + 32 of the tile for the
//     warp's 8 rows (16 scores per thread), reading 4 values of d at a time:
//     Q as a broadcast float4, K rows padded by 4 elements so the lanes'
//     4-wide loads fall in distinct banks.
//   * Row max and sum are warp shuffles. The probabilities go to a per-warp
//     strip of shared memory, and lane l accumulates output columns
//     l + 32c (c < D / 32) of the warp's 8 rows: acc[8][D / 32] in registers.
//   * kv tiles that the causal or window mask empties for every row of the
//     block are skipped, and query blocks are launched heaviest first.
//
// What bounds it on an H100: the two products are 4 * S^2 * D FLOPs per
// (batch, q-head), halved by the causal mask (6.9e10 at B 4, Hq 16, Hkv 8,
// S 2048, D 128), against 50 MB of q, k, v and out in bf16 there:
// operations, at ~1400 FLOP/byte against the card's ~300 FLOP/byte ridge.
// This kernel does them with scalar f32 FMAs on the CUDA cores (67 TFLOP/s
// peak), not on the tensor cores (989 TFLOP/s bf16), and without
// overlapping tile loads with compute: a simple, correct first version.
// wgmma, TMA and a pipelined ring are later work.
//
// Plain C interface, loaded with ctypes (kernels/_build.py): no PyTorch
// headers, so the build takes seconds.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

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
          const T* __restrict__ v, T* __restrict__ o, int S, int Hq,
          int group, float scale, int causal, int has_window, int window,
          int has_cap, float cap) {
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
  }
}

template <typename T, int NC>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o,
                         int B, int Hq, int Hkv, int S, float scale,
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
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hq / Hkv, scale,
      causal, has_window, window, has_cap, cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int Hq, int Hkv, int S, float scale,
                     int causal, int has_window, int window, int has_cap,
                     float cap, cudaStream_t stream) {
#define FLASH_CASE(NC)                                                        \
  case NC * 32:                                                               \
    return launch_typed<T, NC>(q, k, v, o, B, Hq, Hkv, S, scale, causal,      \
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

extern "C" {

// Launches the kernel on `stream` and returns a cudaError_t (0 = ok).
// q, out: [B, Hq, S, D]; k, v: [B, Hkv, S, D]; all contiguous, of the
// type `dtype` (0 f32, 1 bf16, 2 f16) and aligned to 16 bytes. Hq is a
// multiple of Hkv, D a multiple of 32 up to 256, B * Hq <= 65535.
// has_window = 0 ignores `window`; has_cap = 0 ignores `cap`.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int dtype, int B, int Hq, int Hkv,
                           int S, int D, float sm_scale, int causal,
                           int has_window, int window, int has_cap, float cap,
                           void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || B * Hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case F32:
      err = launch_d<float>(D, q, k, v, out, B, Hq, Hkv, S, sm_scale, causal,
                            has_window, window, has_cap, cap, st);
      break;
    case BF16:
      err = launch_d<__nv_bfloat16>(D, q, k, v, out, B, Hq, Hkv, S, sm_scale,
                                    causal, has_window, window, has_cap, cap, st);
      break;
    case F16:
      err = launch_d<__half>(D, q, k, v, out, B, Hq, Hkv, S, sm_scale, causal,
                             has_window, window, has_cap, cap, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
