// Backward flash attention for the GPU: dQ, dK and dV of flash_attention.cu's
// forward, in three hand-written kernels behind one C entry point.
//
// The JAX package trains through jax.value_and_grad of its attention; its
// Pallas kernel (src/repro/kernels/flash_attention.py::_flash_kernel) has no
// VJP. This source is the gradient of that kernel's function, computed as
// autograd of the plain version computes it (FlashAttention-2's algorithm):
//
//   s_ij = (q_i . k_j) * scale,  c_ij = cap * tanh(s_ij / cap) (or s_ij)
//   P_ij = exp(c_ij - lse_i) where unmasked, else 0  (lse from the forward;
//          a fully masked row has lse = -inf and gives P = 0)
//   D_i  = sum_d dO_id O_id                          (O in the input type)
//   dV_j = sum_i P_ij dO_i,   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i) * (1 - (c_ij / cap)^2 with a softcap)
//   dQ_i = scale sum_j dS_ij k_j,   dK_j = scale sum_i dS_ij q_i
//
// with the forward's masks (causal: j <= i; window: i - j < window) and GQA
// (kv head = h / group). dK and dV sum over the q heads of their group.
//
// What bounds it on an H100: five products of the forward's size, 2.5x its
// FLOPs (1.72e11 at B 4, Hq 16, Hkv 8, S 2048, D 128, causal) against
// ~240 MB of inputs and outputs in bf16, so operations. This first kernel
// runs them on CUDA cores with f32 FMAs (plus two recomputed products in the
// dQ kernel), far from the bf16 tensor-core bound; moving them to wgmma is
// the next step (ROADMAP queue 2). What its design does now:
//
// 1. flash_bwd_delta: D_i, one warp per row.
// 2. flash_bwd_dkdv: one block per (batch * kv head, 64 kv rows). K and V
//    of its rows stay in shared memory in f32; the block loops over the q
//    heads of the group and, for each, over the 32-row query tiles the
//    masks leave non-empty (causal: from the block's first key on; window:
//    up to its last key + window - 1). Each warp owns 8 kv rows, each lane
//    one query of the tile: P^T and dS^T go through a per-warp strip of
//    shared memory into dV += P^T dO and dK += dS^T Q, accumulated in
//    registers. The group's sum stays inside the block: no atomics.
// 3. flash_bwd_dq: one block per (batch * q head, 64 query rows), heaviest
//    first, looping over the 32-key tiles the forward would visit (causal
//    upper bound, window lower bound): each warp owns 8 query rows, each
//    lane one key; dQ += dS K in registers.
// Every element is masked (and rows past S zeroed) in every tile, so the
// skipped ranges only save work.
//
// Plain C interface, loaded with ctypes (kernels/_build.py): no PyTorch
// headers. Errors come back as a cudaError_t, never as a fallback.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int OWN = 64;             // rows a block owns (kv rows, or query rows)
constexpr int STREAM = 32;          // rows of a streamed tile: one per lane
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = OWN / WARPS;   // owned rows per warp
constexpr int PAD = 4;              // elements of padding per smem row

// dtype codes of the C interface (flash_attention.cu's)
enum DType : int { F32 = 0, BF16 = 1, F16 = 2 };

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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Options of one launch, shared by the kernels.
struct Opts {
  int S, Hq, group;
  float scale;
  int causal, has_window, window, has_cap;
  float cap;
};

// P and dS of one score: c is the (capped) scaled score, lse the query
// row's log-sum-exp, dp = dO_i . v_j, delta = D_i.
__device__ __forceinline__ void prob_and_grad(float s, float dp, float lse, float delta,
                                              int qp, int kp, const Opts& o,
                                              float* p_out, float* ds_out) {
  const float x = s * o.scale;
  const float c = o.has_cap ? o.cap * tanhf(x / o.cap) : x;
  bool ok = qp < o.S && kp < o.S && lse > -INFINITY;
  if (o.causal) ok = ok && kp <= qp;
  if (o.has_window) ok = ok && qp - kp < o.window;
  const float p = ok ? expf(c - lse) : 0.f;
  float ds = p * (dp - delta);
  if (o.has_cap) {
    const float t = c / o.cap;
    ds *= 1.f - t * t;
  }
  *p_out = p;
  *ds_out = ds;
}

// rows [r0, r0 + n) of a [S, D] head in the input type -> f32 smem [n][DP],
// zero past S
template <typename T, int D>
__device__ __forceinline__ void load_f32_tile(float* dst, const T* head, int r0, int n, int S) {
  constexpr int DP = D + PAD;
  for (int i = threadIdx.x; i < n * D / 4; i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) x = load4(head + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * DP + c) = x;
  }
}

// rows [r0, r0 + n) of a [S, D] head -> smem [n][DP] in the input type,
// zero past S
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* head, int r0, int n, int S) {
  constexpr int DP = D + PAD;
  using P4 = typename Pack4<T>::type;
  for (int i = threadIdx.x; i < n * D / 4; i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    P4 x{};
    if (r0 + r < S) x = *reinterpret_cast<const P4*>(head + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<P4*>(dst + r * DP + c) = x;
  }
}

template <typename T, int NC>
constexpr size_t smem_bytes() {
  constexpr int DP = NC * 32 + PAD;
  return sizeof(float) * 2 * OWN * DP       // the owned rows' two tiles, f32
         + sizeof(T) * 2 * STREAM * DP      // the streamed tile's two, input type
         + sizeof(float) * 2 * OWN * STREAM // P and dS strips
         + sizeof(float) * 2 * STREAM;      // the streamed rows' lse and D
}

// 1. D_i = sum_d dO_id O_id, one warp per row of [rows, D]
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int rows) {
  constexpr int D = NC * 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                 // whole warps leave together
  const T* orow = o + static_cast<size_t>(row) * D;
  const T* drow = dout + static_cast<size_t>(row) * D;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    acc = fmaf(to_f32(orow[lane + 32 * c]), to_f32(drow[lane + 32 * c]), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// 2. dK, dV of 64 kv rows of one (batch, kv head), over the group's q heads
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, Opts o) {
  constexpr int D = NC * 32;
  constexpr int DP = D + PAD;
  constexpr int JJ = NC <= 4 ? 4 : 2;      // streamed rows per accumulate step

  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);                 // [OWN][DP]
  float* sV = sK + OWN * DP;                                  // [OWN][DP]
  T* sQ = reinterpret_cast<T*>(sV + OWN * DP);                // [STREAM][DP]
  T* sDO = sQ + STREAM * DP;                                  // [STREAM][DP]
  float* sP = reinterpret_cast<float*>(sDO + STREAM * DP);    // [OWN][STREAM]
  float* sDS = sP + OWN * STREAM;                             // [OWN][STREAM]
  float* sL = sDS + OWN * STREAM;                             // [STREAM]
  float* sD = sL + STREAM;                                    // [STREAM]

  const int S = o.S;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * ROWS;                   // the warp's kv rows
  const int k0 = blockIdx.x * OWN;                            // heaviest first (causal)
  const int bkv = blockIdx.y;                                 // b * Hkv + kv head
  const int hkv = o.Hq / o.group;
  const int b = bkv / hkv;
  const int hk = bkv % hkv;

  load_f32_tile<T, D>(sK, k + static_cast<size_t>(bkv) * S * D, k0, OWN, S);
  load_f32_tile<T, D>(sV, v + static_cast<size_t>(bkv) * S * D, k0, OWN, S);

  // query tiles [t_lo, t_hi) that may see a key of the block
  const int k_last = min(k0 + OWN, S) - 1;
  const int t_lo = o.causal ? k0 / STREAM : 0;
  int t_hi = (S + STREAM - 1) / STREAM;
  if (o.has_window) {
    const int q_last = k_last + o.window - 1;   // q - k < window
    t_hi = q_last < 0 ? 0 : min(t_hi, q_last / STREAM + 1);
  }

  float acc_k[ROWS][NC], acc_v[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  }

  for (int g = 0; g < o.group; ++g) {
    const size_t bh = static_cast<size_t>(b) * o.Hq + hk * o.group + g;
    const T* qh = q + bh * S * D;
    const T* doh = dout + bh * S * D;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * STREAM;
      __syncthreads();   // K/V in place; the last tile's reads are done
      load_tile<T, D>(sQ, qh, q0, STREAM, S);
      load_tile<T, D>(sDO, doh, q0, STREAM, S);
      if (threadIdx.x < STREAM) {
        const int qp = q0 + threadIdx.x;
        sL[threadIdx.x] = qp < S ? lse[bh * S + qp] : -INFINITY;
        sD[threadIdx.x] = qp < S ? delta[bh * S + qp] : 0.f;
      }
      __syncthreads();

      // s[i] = k_{r0+i} . q_lane and dp[i] = v_{r0+i} . dO_lane
      float s[ROWS], dp[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) s[i] = dp[i] = 0.f;
      const T* q_row = sQ + lane * DP;
      const T* do_row = sDO + lane * DP;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 qv = load4(q_row + d);
        const float4 dov = load4(do_row + d);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          s[i] = dot4(*reinterpret_cast<const float4*>(sK + (r0 + i) * DP + d), qv, s[i]);
          dp[i] = dot4(*reinterpret_cast<const float4*>(sV + (r0 + i) * DP + d), dov, dp[i]);
        }
      }
      const int qp = q0 + lane;
      const float l_q = sL[lane], d_q = sD[lane];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        prob_and_grad(s[i], dp[i], l_q, d_q, qp, k0 + r0 + i, o,
                      &sP[(r0 + i) * STREAM + lane], &sDS[(r0 + i) * STREAM + lane]);
      }
      __syncwarp();      // the strips are the warp's own rows

      // dV[i] += sum_j P^T[i][j] dO[j],  dK[i] += sum_j dS^T[i][j] Q[j]
      for (int j = 0; j < STREAM; j += JJ) {
        float qq[JJ][NC], oo[JJ][NC];
#pragma unroll
        for (int jj = 0; jj < JJ; ++jj) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            qq[jj][c] = to_f32(sQ[(j + jj) * DP + lane + 32 * c]);
            oo[jj][c] = to_f32(sDO[(j + jj) * DP + lane + 32 * c]);
          }
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
#pragma unroll
          for (int jj = 0; jj < JJ; ++jj) {
            const float p = sP[(r0 + i) * STREAM + j + jj];
            const float ds = sDS[(r0 + i) * STREAM + j + jj];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              acc_v[i][c] = fmaf(p, oo[jj][c], acc_v[i][c]);
              acc_k[i][c] = fmaf(ds, qq[jj][c], acc_k[i][c]);
            }
          }
        }
      }
    }
  }

  T* dkh = dk + static_cast<size_t>(bkv) * S * D;
  T* dvh = dv + static_cast<size_t>(bkv) * S * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int kp = k0 + r0 + i;
    if (kp >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkh[static_cast<size_t>(kp) * D + lane + 32 * c] = from_f32<T>(acc_k[i][c] * o.scale);
      dvh[static_cast<size_t>(kp) * D + lane + 32 * c] = from_f32<T>(acc_v[i][c]);
    }
  }
}

// 3. dQ of 64 query rows of one (batch, q head)
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, Opts o) {
  constexpr int D = NC * 32;
  constexpr int DP = D + PAD;
  constexpr int JJ = NC <= 4 ? 4 : 2;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);                 // [OWN][DP]
  float* sDO = sQ + OWN * DP;                                 // [OWN][DP]
  T* sK = reinterpret_cast<T*>(sDO + OWN * DP);               // [STREAM][DP]
  T* sV = sK + STREAM * DP;                                   // [STREAM][DP]
  float* sDS = reinterpret_cast<float*>(sV + STREAM * DP);    // [OWN][STREAM]

  const int S = o.S;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * ROWS;                   // the warp's query rows
  const int q0 = (gridDim.x - 1 - blockIdx.x) * OWN;          // heaviest first
  const int bh = blockIdx.y;                                  // b * Hq + h
  const int hkv = o.Hq / o.group;
  const size_t kv_head = static_cast<size_t>(bh / o.Hq) * hkv + (bh % o.Hq) / o.group;
  const T* kh = k + kv_head * S * D;
  const T* vh = v + kv_head * S * D;

  load_f32_tile<T, D>(sQ, q + static_cast<size_t>(bh) * S * D, q0, OWN, S);
  load_f32_tile<T, D>(sDO, dout + static_cast<size_t>(bh) * S * D, q0, OWN, S);
  float l_q[ROWS], d_q[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qp = q0 + r0 + i;
    l_q[i] = qp < S ? lse[static_cast<size_t>(bh) * S + qp] : -INFINITY;
    d_q[i] = qp < S ? delta[static_cast<size_t>(bh) * S + qp] : 0.f;
  }

  // key tiles [t_lo, t_hi) that hold a key some row may see (the forward's)
  const int q_last = min(q0 + OWN, S) - 1;
  int t_lo = 0;
  int t_hi = (S + STREAM - 1) / STREAM;
  if (o.causal) t_hi = q_last / STREAM + 1;
  if (o.has_window && q0 - o.window + 1 > 0) t_lo = (q0 - o.window + 1) / STREAM;

  float acc[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * STREAM;
    __syncthreads();   // Q/dO in place; the last tile's reads are done
    load_tile<T, D>(sK, kh, k0, STREAM, S);
    load_tile<T, D>(sV, vh, k0, STREAM, S);
    __syncthreads();

    // s[i] = q_{r0+i} . k_lane and dp[i] = dO_{r0+i} . v_lane
    float s[ROWS], dp[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = dp[i] = 0.f;
    const T* k_row = sK + lane * DP;
    const T* v_row = sV + lane * DP;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 kv = load4(k_row + d);
      const float4 vv = load4(v_row + d);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        s[i] = dot4(*reinterpret_cast<const float4*>(sQ + (r0 + i) * DP + d), kv, s[i]);
        dp[i] = dot4(*reinterpret_cast<const float4*>(sDO + (r0 + i) * DP + d), vv, dp[i]);
      }
    }
    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float p;
      prob_and_grad(s[i], dp[i], l_q[i], d_q[i], q0 + r0 + i, kp, o, &p,
                    &sDS[(r0 + i) * STREAM + lane]);
    }
    __syncwarp();

    // dQ[i] += sum_j dS[i][j] K[j]
    for (int j = 0; j < STREAM; j += JJ) {
      float kk[JJ][NC];
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) kk[jj][c] = to_f32(sK[(j + jj) * DP + lane + 32 * c]);
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
#pragma unroll
        for (int jj = 0; jj < JJ; ++jj) {
          const float ds = sDS[(r0 + i) * STREAM + j + jj];
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds, kk[jj][c], acc[i][c]);
        }
      }
    }
  }

  T* dqh = dq + static_cast<size_t>(bh) * S * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qp = q0 + r0 + i;
    if (qp >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dqh[static_cast<size_t>(qp) * D + lane + 32 * c] = from_f32<T>(acc[i][c] * o.scale);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_typed(const void* q, const void* k, const void* v, const void* out,
                         const float* lse, const void* dout, void* dq, void* dk,
                         void* dv, float* delta, int B, int Hkv, const Opts& o,
                         cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, NC>();
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<T, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;

  const int rows = B * o.Hq * o.S;
  flash_bwd_delta<T, NC><<<(rows + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int tiles = (o.S + OWN - 1) / OWN;
  flash_bwd_dq<T, NC><<<dim3(tiles, B * o.Hq), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), o);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  flash_bwd_dkdv<T, NC><<<dim3(tiles, B * Hkv), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), o);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* out, const float* lse, const void* dout, void* dq,
                     void* dk, void* dv, float* delta, int B, int Hkv, const Opts& o,
                     cudaStream_t stream) {
#define FLASH_BWD_CASE(NC)                                                    \
  case NC * 32:                                                               \
    return launch_typed<T, NC>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, \
                               Hkv, o, stream);
  switch (D) {
    FLASH_BWD_CASE(1) FLASH_BWD_CASE(2) FLASH_BWD_CASE(3) FLASH_BWD_CASE(4)
    FLASH_BWD_CASE(5) FLASH_BWD_CASE(6) FLASH_BWD_CASE(7) FLASH_BWD_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` (no synchronisation) and returns 0
// or a cudaError_t. q, out, dout, dq: [B, Hq, S, D]; k, v, dk, dv:
// [B, Hkv, S, D]; all contiguous, of the type `dtype` (0 f32, 1 bf16,
// 2 f16) and aligned to 16 bytes. lse is the forward's [B * Hq, S] f32
// log-sum-exp; delta is [B * Hq, S] f32 scratch. Hq is a multiple of Hkv,
// D a multiple of 32 up to 256, B * Hq <= 65535. has_window = 0 ignores
// `window`; has_cap = 0 ignores `cap`.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const float* lse, const void* dout,
                               void* dq, void* dk, void* dv, float* delta, int dtype,
                               int B, int Hq, int Hkv, int S, int D, float sm_scale,
                               int causal, int has_window, int window, int has_cap,
                               float cap, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || B * Hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Opts o{S, Hq, Hq / Hkv, sm_scale, causal, has_window, window, has_cap, cap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case F32:
      err = launch_d<float>(D, q, k, v, out, lse, dout, dq, dk, dv, delta, B, Hkv, o, st);
      break;
    case BF16:
      err = launch_d<__nv_bfloat16>(D, q, k, v, out, lse, dout, dq, dk, dv, delta, B,
                                    Hkv, o, st);
      break;
    case F16:
      err = launch_d<__half>(D, q, k, v, out, lse, dout, dq, dk, dv, delta, B, Hkv, o,
                             st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
