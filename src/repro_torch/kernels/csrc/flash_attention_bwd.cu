// Backward flash attention for the GPU: dQ, dK and dV of flash_attention.cu's
// forward, in two sets of three hand-written kernels (tensor cores, CUDA
// cores) behind one C entry point.
//
// The JAX package trains through jax.value_and_grad of its attention; its
// Pallas kernel (src/repro/kernels/flash_attention.py::_flash_kernel) has no
// VJP. This source is the gradient of that kernel's function, computed as
// autograd of the plain version computes it (FlashAttention-2's algorithm):
//
//   s_ij = (q_i . k_j) * scale,  c_ij = cap * tanh(s_ij / cap) (or s_ij)
//   P_ij = exp(c_ij - lse_i) where unmasked, else 0  (lse from the forward;
//          a fully masked row has lse = -inf and gives P = 0)
//   dV_j = sum_i P_ij dO_i,   dP_ij = dO_i . v_j
//   D_i  = sum_j P_ij dP_ij                          (= dO_i . O_i)
//   dS_ij = P_ij (dP_ij - D_i) * (1 - (c_ij / cap)^2 with a softcap)
//   dQ_i = scale sum_j dS_ij k_j,   dK_j = scale sum_i dS_ij q_i
//
// with the forward's masks (causal: j <= i; window: i - j < window) and GQA
// (kv head = h / group). dK and dV sum over the q heads of their group.
//
// D is summed from the P and dP that the backward itself recomputes, not
// taken as dO_i . O_i from the forward's output as FlashAttention-2 does.
// Without a softcap sum_j dS_ij = 0, so a component that every key shares
// leaves the exact dQ; an error e in D breaks that sum and adds
// -e * scale * sum_j P_ij k_j to dQ_i, the keys' shared component times e.
// The output is rounded to 16 bits, and the tensor-core forward rounds P
// before P V, so dO . O errs by ~2^-9 |dO_i| |O_i| against the backward's
// P: on whisper-small's last decoder layer in training, whose keys share a
// mean 13 times their spread, that put dQ 22 % of its max |dQ| off (0.3 %
// with D from the recomputed P). The price is a first sweep of the dQ
// kernels over their kv tiles for S and dP alone; they write D for dK, dV.
//
// What bounds it on an H100: five products of the forward's size, 2.5x its
// FLOPs (1.72e11 at B 4, Hq 16, Hkv 8, S 2048, D 128, causal) against
// ~170 MB of inputs and outputs in bf16, so operations: the products belong
// on the bf16 tensor cores (989 TFLOP/s dense).
//
// 1. Tensor-core kernels: bf16 and f16 at D 64, 128 and 256 (flash_
//    attention_bwd_uses_tensor_cores). Deterministic, no atomics; the design
//    does 9 products of 2 D FLOP a (q, k) pair where the bound counts 5: 2
//    for an exact dQ without an f32 scratch, 2 for D (above). The share of
//    the work is tcb::Plan's.
//    * flash_bwd_prep: one thread a row of [B * Hq, S_pad] (S rounded up to
//      64): lse * log2 e with +inf for a fully masked row and for rows past
//      S, so that P = exp2(c log2 e - lse2) is 0 there with no test, into a
//      padded workspace that 256-byte bulk copies read.
//    * flash_bwd_dkdv_tc at D 64 and 128: one block per (batch * kv head,
//      128 kv rows), kv blocks heaviest first. A producer warpgroup
//      (setmaxnreg 24) whose first thread issues every load, and two
//      consumer warpgroups of 64 kv rows each (240). K and V of the block's
//      rows arrive once by TMA; Q and dO tiles of 64 query rows, with their
//      64 lse2 and D values (bulk copies), stream through a 2-stage ring
//      with full/empty mbarriers, over every q head of the group and the q
//      tiles the masks leave non-empty for the block. Per tile a consumer
//      runs
//        S^T = K Q^T and dP^T = V dO^T   (wgmma_ss, m64n64, K-major both),
//        P^T and dS^T in registers       (lse2 and D by the fragment's column),
//        dV += P^T dO and dK += dS^T Q   (wgmma_rs, m64nD, dO and Q MN-major),
//      P^T and dS^T going from the f32 accumulator fragment to the 16-bit A
//      fragment pair by pair, as flash_attention.cu feeds P V. The GQA sum
//      stays in the f32 dK and dV accumulators (64 + 64 registers a thread
//      at D 128). Tiles empty for a warpgroup's rows are only waited for
//      and released; only tiles that cross the diagonal, the window edge or
//      S mask per element. Shared memory at D 128: K and V 64 KB, the ring
//      2 x (16 + 16) KB, the rows 2 KB.
//    * flash_bwd_dkdv_tc at D 256, where that shape fits neither the block's
//      227 KB (128 kv rows of K and V 128 KB, the ring 128 KB) nor a
//      thread's 255 registers (dK and dV of 64 rows at D 256: 256 a
//      thread): one block per (batch * kv head, 64 kv rows), K and V 64 KB,
//      the ring of 64-row Q and dO tiles 128 KB; its two consumer
//      warpgroups split D into halves (split_consume). S^T and dP^T are
//      computed once, each warpgroup scoring half of the tile's queries
//      (m64n32 over the full D); P^T and dS^T go through shared memory in
//      16 bits (8 KB each), and each warpgroup adds its half of D, dV[:, h]
//      += P^T dO[:, h] and dK[:, h] += dS^T Q[:, h] (wgmma from shared
//      memory, m64n128): 64 + 64 accumulator registers a thread.
//    * flash_bwd_dq_tc: one block per (batch * q head, 128 query rows; 64 at
//      D 256 with one consumer warpgroup, whose dQ takes 128 registers a
//      thread), shaped like flash_fwd_tc: Q and dO arrive once, K and V
//      tiles of 64 keys stream through the ring twice. First sweep, per
//      tile: S = Q K^T and dP = dO V^T (wgmma_ss), P in registers, D_i += P
//      dP by row; then D goes to the padded workspace (0 past S) for
//      flash_bwd_dkdv_tc, launched after. Second sweep, per tile: S and dP
//      again, P and dS in registers (lse2 and D by row), dQ += dS K
//      (wgmma_rs, K MN-major as the forward reads V).
//    * Numerics: P^T and dS^T (dS) are rounded to the input type before
//      their products, where the plain version keeps them in f32 (in
//      registers, or at D 256 in shared memory for dK and dV); dQ's
//      epilogue then takes out each row's sum of dS's rounding errors times
//      the row's own key, with a softcap as without (dq_consume says why).
//      Every sum stays f32 (tests/test_torch_flash_grad.py holds a rounded
//      copy of the algorithm against the JAX reference).
//    * Per tile, the two products that read a ring slot are issued as one
//      group and waited for before the elementwise work; the other consumer
//      warpgroup's products fill the tensor cores meanwhile (at D 256 the
//      two warpgroups of dkdv work in step, joined by named barriers, and
//      dq has one).
//
// 2. CUDA-core kernels: f32 at every D, and bf16/f16 at D 32, 96, 160, 192
//    and 224 (D 192 splits into halves of 96 columns, which are not whole
//    128-byte panels). Both products of a pair run as f32 FMAs, with
//    FlashAttention-2's split:
//    a. flash_bwd_dq: one block per (batch * q head, 64 query rows),
//       heaviest first, looping twice over the 32-key tiles the forward
//       would visit (causal upper bound, window lower bound): each warp owns
//       8 query rows, each lane one key. The first loop sums D_i = sum_j
//       P_ij dP_ij by row and writes it for flash_bwd_dkdv, launched after;
//       the second accumulates dQ += dS K in registers.
//    b. flash_bwd_dkdv: one block per (batch * kv head, 64 kv rows). K and V
//       of its rows stay in shared memory in f32; the block loops over the
//       q heads of the group and, for each, over the 32-row query tiles the
//       masks leave non-empty (causal: from the block's first key on;
//       window: up to its last key + window - 1). Each warp owns 8 kv rows,
//       each lane one query of the tile: P^T and dS^T go through a per-warp
//       strip of shared memory into dV += P^T dO and dK += dS^T Q,
//       accumulated in registers. The group's sum stays inside the block.
//    Every element is masked (and rows past S zeroed) in every tile, so the
//    skipped ranges only save work.
//
// Which kernels run depends only on dtype and D; a failed launch or
// tensor-map encoding is returned as an error code, never replaced by the
// other kernels.
//
// Plain C interface, loaded with ctypes (kernels/_build.py): no PyTorch
// headers.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// A compile-time bool passed as a value (a variant of a generic lambda).
template <bool B> struct Flag { static constexpr bool value = B; };

// Options of one launch, shared by the kernels.
struct Opts {
  int S, Hq, group;
  float scale;
  int causal, has_window, window, has_cap;
  float cap;
};

// P of one score s = q_i . k_j (query qp, key kp) and, in *c, its capped
// scaled score; lse is the query row's log-sum-exp.
__device__ __forceinline__ float prob(float s, float lse, int qp, int kp, const Opts& o,
                                      float* c) {
  const float x = s * o.scale;
  *c = o.has_cap ? o.cap * tanhf(x / o.cap) : x;
  bool ok = qp < o.S && kp < o.S && lse > -INFINITY;
  if (o.causal) ok = ok && kp <= qp;
  if (o.has_window) ok = ok && qp - kp < o.window;
  return ok ? expf(*c - lse) : 0.f;
}

// P and dS of one score: dp = dO_i . v_j, delta = D_i.
__device__ __forceinline__ void prob_and_grad(float s, float dp, float lse, float delta,
                                              int qp, int kp, const Opts& o,
                                              float* p_out, float* ds_out) {
  float c;
  const float p = prob(s, lse, qp, kp, o, &c);
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

// 3. D and dQ of 64 query rows of one (batch, q head)
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ delta,
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
    d_q[i] = 0.f;
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

  // the first sweep sums D_i = sum_j P_ij dP_ij by row (each lane its keys,
  // then the warp), which goes to `delta` for flash_bwd_dkdv; the second
  // accumulates dQ
  auto finish_d = [&]() {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      d_q[i] = warp_sum(d_q[i]);
      const int qp = q0 + r0 + i;
      if (lane == 0 && qp < S) delta[static_cast<size_t>(bh) * S + qp] = d_q[i];
    }
  };
  const int n = max(t_hi - t_lo, 0);
  if (n == 0) finish_d();
  for (int t = 0; t < 2 * n; ++t) {
    const bool sweep_d = t < n;
    const int k0 = (t_lo + t % n) * STREAM;
    if (t == n) finish_d();
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
    if (sweep_d) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        float c;
        d_q[i] = fmaf(prob(s[i], l_q[i], q0 + r0 + i, kp, o, &c), dp[i], d_q[i]);
      }
      continue;
    }
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
cudaError_t launch_typed(const void* q, const void* k, const void* v, const float* lse,
                         const void* dout, void* dq, void* dk, void* dv, float* delta,
                         int B, int Hkv, const Opts& o, cudaStream_t stream) {
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
                     const float* lse, const void* dout, void* dq, void* dk, void* dv,
                     float* delta, int B, int Hkv, const Opts& o, cudaStream_t stream) {
  // 16-bit inputs at D 64, 128 and 256 take the tensor-core kernels
  // (flash_attention_bwd_uses_tensor_cores): no CUDA-core instance of those
  constexpr bool IS_F32 = sizeof(T) == 4;
#define FLASH_BWD_CASE(NC)                                                               \
  case NC * 32:                                                                          \
    return launch_typed<T, NC>(q, k, v, lse, dout, dq, dk, dv, delta, B, Hkv, o, stream);
#define FLASH_BWD_F32_CASE(NC)                                                           \
  case NC * 32:                                                                          \
    if constexpr (IS_F32) {                                                              \
      return launch_typed<T, NC>(q, k, v, lse, dout, dq, dk, dv, delta, B, Hkv, o,       \
                                 stream);                                                \
    }                                                                                    \
    return cudaErrorInvalidValue;
  switch (D) {
    FLASH_BWD_CASE(1) FLASH_BWD_F32_CASE(2) FLASH_BWD_CASE(3) FLASH_BWD_F32_CASE(4)
    FLASH_BWD_CASE(5) FLASH_BWD_CASE(6) FLASH_BWD_CASE(7) FLASH_BWD_F32_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_F32_CASE
#undef FLASH_BWD_CASE
}

}  // namespace

namespace tcb {

using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_wait;
using hopper::PANEL_COLS;
using hopper::smem_addr;
using hopper::sw128_desc;

constexpr int WG_ROWS = 64;                     // rows of one wgmma accumulator
constexpr int TILE = 64;                        // rows of a streamed tile
constexpr int STAGES = 2;                       // slots of the ring
// Registers a thread after setmaxnreg in the kernels with two consumer
// warpgroups, as in flash_fwd_tc: 128 x 24 + 256 x 240 = 384 x 168, the
// block's 65536.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int SPLIT_BAR = 1;                    // named barrier of split_consume
constexpr int PREP_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// S rounded up to whole streamed tiles: the row length of the workspace
__host__ __device__ __forceinline__ int padded(int S) { return (S + TILE - 1) / TILE * TILE; }

// How the two kernels share the work at head dim D (see the note at the top).
//   D 64, 128: each kernel owns 128 rows, two consumer warpgroups of 64.
//   D 256: dq owns 64 query rows, one consumer warpgroup (its dQ alone is
//   128 f32 registers a thread); dkdv owns 64 kv rows and its two consumer
//   warpgroups split D (split_consume).
template <int D>
struct Plan {
  static_assert(D == 64 || D == 128 || D == 256, "D is 64, 128 or 256");
  static constexpr bool SPLIT = D == 256;
  static constexpr int PANELS = D / PANEL_COLS;
  static constexpr int DQ_WGS = SPLIT ? 1 : 2;        // dq's consumer warpgroups
  static constexpr int DQ_OWN = DQ_WGS * WG_ROWS;     // query rows a dq block owns
  static constexpr int KV_OWN = SPLIT ? 64 : 128;     // kv rows a dkdv block owns
  static constexpr int DQ_THREADS = (DQ_WGS + 1) * 128;   // + the producer warpgroup
  static constexpr int KV_THREADS = 3 * 128;
  static constexpr int TILE_BYTES = TILE * D * 2;     // one streamed tile
  static constexpr int ROW_BYTES = TILE * 4;          // a streamed tile's lse2 or D
  static constexpr int RING = STAGES * 2 * TILE_BYTES;
  static constexpr int PT_BYTES = TILE * TILE * 2;    // split_consume's P^T or dS^T
  // dq: Q and dO of the owned rows, the ring of K and V tiles; dkdv: K and
  // V, the ring of Q and dO tiles and their rows, P^T and dS^T when split.
  // + 1024: the dynamic buffer is aligned up to the swizzle period.
  static constexpr int DQ_SMEM = 2 * DQ_OWN * D * 2 + RING + 1024;
  static constexpr int KV_SMEM = 2 * KV_OWN * D * 2 + RING + STAGES * 2 * ROW_BYTES
                                 + (SPLIT ? 2 * PT_BYTES : 0) + 1024;
  static_assert(DQ_SMEM <= 227 * 1024 && KV_SMEM <= 227 * 1024,
                "shared memory of one block");
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
// pack2's inverse
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t w);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t w) {
  return make_float2(bf16_lo(w), bf16_hi(w));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t w) {
  return make_float2(f16_lo(w), f16_hi(w));
}

// lse2 of every row of [B * Hq, S_pad], one thread a row.
__global__ void __launch_bounds__(PREP_THREADS)
flash_bwd_prep(const float* __restrict__ lse, float* __restrict__ lse2, int S, int rows) {
  const int row = blockIdx.x * PREP_THREADS + threadIdx.x;
  if (row >= rows) return;
  const int S_pad = padded(S);
  const int qp = row % S_pad;
  float l2 = INFINITY;
  if (qp < S) {
    const float l = lse[static_cast<size_t>(row / S_pad) * S + qp];
    l2 = l > -INFINITY ? l * LOG2E : INFINITY;
  }
  lse2[row] = l2;
}

// P and dS of one accumulator element: s the raw dot product, dp the other
// product's element, lse2 and dl its query row's values; `ok` false masks.
template <bool CAP>
__device__ __forceinline__ void p_and_ds(float& s, float& dp, float lse2, float dl, bool ok,
                                         float scale_log2, float scale_cap, float cap_log2) {
  float x, f = 1.f;
  if (CAP) {
    const float t = tanhf(s * scale_cap);   // c / cap
    x = t * cap_log2;
    f = 1.f - t * t;
  } else {
    x = s * scale_log2;
  }
  const float p = ok ? exp2f(x - lse2) : 0.f;
  float ds = p * (dp - dl);
  if (CAP) ds *= f;
  s = p;
  dp = ds;
}

// Packs an accumulator of N / 2 registers into the 16-bit A fragments of
// N / 16 k steps: registers 8 kk .. 8 kk + 7 are step kk's, two at a time.
template <typename T, int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 4; ++h) a[kk][h] = pack2<T>(x[8 * kk + 2 * h], x[8 * kk + 2 * h + 1]);
  }
}

// D[64 x N] (=) A B^T over D / 16 k steps: A 64 rows at a_addr in panels
// a_panel bytes apart, B N rows at b_addr in panels b_panel apart, both
// K-major, 128-byte swizzled. Issued, not committed.
template <typename T, int D, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint32_t a_addr, int a_panel,
                                         uint32_t b_addr, int b_panel) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes
    hopper::wgmma_ss<T, N>(d, sw128_desc(a_addr + (kk / 4) * a_panel + off, 16, 1024),
                           sw128_desc(b_addr + (kk / 4) * b_panel + off, 16, 1024), kk > 0);
  }
}

// D[64 x D] += A B over TILE / 16 k steps: A fragments in registers, B
// [TILE rows x D] MN-major at b_addr (a TILE-row tile: panels TILE * 128
// bytes apart). Issued, not committed.
template <typename T, int D>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2], const uint32_t (&a)[TILE / 16][4],
                                         uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    hopper::wgmma_rs<T, D>(d, a[kk], sw128_desc(b_addr + kk * 16 * 128, TILE * 128, 1024));
  }
}

// D[64 x N] += A B over TILE / 16 k steps: A [64 x TILE] K-major at a_addr
// (one 128-byte swizzled panel), B [TILE rows x N] MN-major at b_addr in
// panels TILE * 128 bytes apart. Issued, not committed.
template <typename T, int N>
__device__ __forceinline__ void issue_st(float (&d)[N / 2], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    hopper::wgmma_st<T, N>(d, sw128_desc(a_addr + kk * 32, 16, 1024),
                           sw128_desc(b_addr + kk * 16 * 128, TILE * 128, 1024));
  }
}

// Stores rows row0 and row0 + 8 (those below S) of a 64 x N accumulator,
// times `mul`, into a [S, D] head at column col + 8 j + (e % 2).
template <typename T, int N, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2], T* __restrict__ head,
                                           int row0, int col, int S, float mul) {
  T* out0 = head + static_cast<size_t>(row0) * D + col;
  T* out1 = out0 + 8 * D;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    if (row0 < S) {
      *reinterpret_cast<uint32_t*>(out0 + 8 * j) =
          pack2<T>(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    }
    if (row0 + 8 < S) {
      *reinterpret_cast<uint32_t*>(out1 + 8 * j) =
          pack2<T>(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    }
  }
}

// Masks of one tile of TILE queries from q0 against `rows` kv rows from kw0:
//   tile_idle: every pair masked, or the rows all past S;
//   tile_edge: some pair masked.
__device__ __forceinline__ bool tile_idle(int q0, int kw0, int rows, const Opts& o) {
  return kw0 >= o.S || (o.causal && q0 + TILE - 1 < kw0) ||
         (o.has_window && q0 - (kw0 + rows - 1) >= o.window);
}
__device__ __forceinline__ bool tile_edge(int q0, int kw0, int rows, const Opts& o) {
  return q0 + TILE > o.S || kw0 + rows > o.S || (o.causal && kw0 + rows - 1 > q0) ||
         (o.has_window && q0 + TILE - 1 - kw0 >= o.window);
}

// P^T, dS^T in place of S^T, dP^T (an accumulator of N query columns from
// q0: register 4 j + e at kv row row0 + 8 (e / 2), query q0 + 8 j + col +
// (e % 2)); lse2 and D by column, sL and sD from q0.
template <bool CAP, bool MASK, int N>
__device__ __forceinline__ void grads_masked(float (&s)[N / 2], float (&dp)[N / 2], int q0, int row0,
                                        int col, const float* sL, const float* sD,
                                        const Opts& o) {
  const float scale_log2 = o.scale * LOG2E;
  const float scale_cap = o.has_cap ? o.scale / o.cap : 0.f;
  const float cap_log2 = o.cap * LOG2E;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * j + col);
    const float2 dl = *reinterpret_cast<const float2*>(sD + 8 * j + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + 8 * j + col + (e & 1);
      const int kv = row0 + 8 * (e >> 1);
      bool ok = true;
      if (MASK) {
        ok = q < o.S && kv < o.S;
        if (o.causal) ok = ok && kv <= q;
        if (o.has_window) ok = ok && q - kv < o.window;
      }
      p_and_ds<CAP>(s[4 * j + e], dp[4 * j + e], (e & 1) ? l2.y : l2.x, (e & 1) ? dl.y : dl.x,
                    ok, scale_log2, scale_cap, cap_log2);
    }
  }
}

template <int N>
__device__ __forceinline__ void grads_t(float (&s)[N / 2], float (&dp)[N / 2], int q0, int row0,
                                        int col, const float* sL, const float* sD, bool edge,
                                        const Opts& o) {
  if (edge) {
    if (o.has_cap) grads_masked<true, true, N>(s, dp, q0, row0, col, sL, sD, o);
    else grads_masked<false, true, N>(s, dp, q0, row0, col, sL, sD, o);
  } else if (o.has_cap) {
    grads_masked<true, false, N>(s, dp, q0, row0, col, sL, sD, o);
  } else {
    grads_masked<false, false, N>(s, dp, q0, row0, col, sL, sD, o);
  }
}

// One consumer warpgroup of flash_bwd_dkdv_tc at D 64 and 128: its 64 kv
// rows' dK and dV over the ring's tiles, then the epilogue. Fragment layout
// of a wgmma m64nN f32 accumulator, thread t of the warpgroup (warp w = t /
// 32, lane l): register 4 j + e holds row 16 w + l / 4 + 8 (e / 2) and
// column 8 j + 2 (l % 4) + (e % 2); here rows are kv rows and columns the
// tile's queries.
template <typename T, int D>
__device__ __forceinline__ void dkdv_consume(
    unsigned char* sK, unsigned char* sV, unsigned char* sRing, const float* sRows,
    uint64_t* kv_full, uint64_t* full, uint64_t* empty, T* __restrict__ dk,
    T* __restrict__ dv, int bkv, int k0, int t_lo, int n_t, int n_tiles, int warp,
    const Opts& o) {
  using C = Plan<D>;
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int kw0 = k0 + wg * WG_ROWS;                  // the warpgroup's kv rows
  const int row0 = kw0 + 16 * (warp % 4) + lane / 4;  // this thread's: row0, row0 + 8
  const int col = 2 * (lane % 4);                     // + 8 j + (e % 2)

  float acc_k[D / 2], acc_v[D / 2], s[TILE / 2], dp[TILE / 2];
  uint32_t pa[TILE / 16][4], da[TILE / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TILE / 2; ++i) s[i] = dp[i] = 0.f;

  const uint32_t k_addr = smem_addr(sK) + wg * WG_ROWS * 128;
  const uint32_t v_addr = smem_addr(sV) + wg * WG_ROWS * 128;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    const int q0 = (t_lo + i % n_t) * TILE;
    mbar_wait(&full[st], (i / STAGES) & 1);
    if (!tile_idle(q0, kw0, WG_ROWS, o)) {
      const uint32_t q_addr = smem_addr(sRing + st * 2 * C::TILE_BYTES);
      const uint32_t do_addr = q_addr + C::TILE_BYTES;
      const float* sL = sRows + st * 2 * TILE;
      // S^T = K Q^T, dP^T = V dO^T
      fence_regs(s);
      fence_regs(dp);
      hopper::wgmma_fence();
      issue_ss<T, D, TILE>(s, k_addr, C::KV_OWN * 128, q_addr, TILE * 128);
      issue_ss<T, D, TILE>(dp, v_addr, C::KV_OWN * 128, do_addr, TILE * 128);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      grads_t<TILE>(s, dp, q0, row0, col, sL, sL + TILE, tile_edge(q0, kw0, WG_ROWS, o), o);
      pack_a<T, TILE>(s, pa);
      pack_a<T, TILE>(dp, da);
      // dV += P^T dO, dK += dS^T Q
      fence_regs(acc_v);
      fence_regs(acc_k);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      hopper::wgmma_fence();
      issue_rs<T, D>(acc_v, pa, do_addr);
      issue_rs<T, D>(acc_k, da, q_addr);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
    }
    mbar_arrive(&empty[st]);
  }

  const size_t head = static_cast<size_t>(bkv) * o.S * D;
  store_rows<T, D, D>(acc_k, dk + head, row0, col, o.S, o.scale);
  store_rows<T, D, D>(acc_v, dv + head, row0, col, o.S, 1.f);
}

// One consumer warpgroup of flash_bwd_dkdv_tc at D 256, where one
// warpgroup cannot hold dK and dV of its rows (256 + 256 f32 registers a
// thread at 64 rows). Both warpgroups own the block's 64 kv rows and split
// the work of each tile:
//   * S^T = K Q^T and dP^T = V dO^T once: warpgroup w takes the tile's
//     queries 32 w .. 32 w + 31 (wgmma_ss m64n32 over the full D);
//   * its P^T and dS^T, rounded to 16 bits, go to shared memory (one
//     128-byte swizzled panel each, as wgmma's K-major A reads it), and a
//     named barrier joins the two halves;
//   * dV[:, 128 w ..] += P^T dO[:, 128 w ..] and dK[:, 128 w ..] += dS^T
//     Q[:, 128 w ..] (wgmma_st m64n128, A = the whole P^T or dS^T), 64 + 64
//     accumulator registers a thread;
//   * a second barrier frees P^T and dS^T for the next tile.
template <typename T>
__device__ __forceinline__ void split_consume(
    unsigned char* sK, unsigned char* sV, unsigned char* sRing, const float* sRows,
    unsigned char* sPt, unsigned char* sDSt, uint64_t* kv_full, uint64_t* full,
    uint64_t* empty, T* __restrict__ dk, T* __restrict__ dv, int bkv, int k0, int t_lo,
    int n_t, int n_tiles, int warp, const Opts& o) {
  constexpr int D = 256;
  constexpr int HALF = D / 2;
  constexpr int QW = TILE / 2;                        // queries a warpgroup scores
  using C = Plan<D>;
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int r_loc = 16 * (warp % 4) + lane / 4;       // this thread's rows: r_loc, + 8
  const int row0 = k0 + r_loc;
  const int col = 2 * (lane % 4);                     // + 8 j + (e % 2)

  float acc_k[HALF / 2], acc_v[HALF / 2], s[QW / 2], dp[QW / 2];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < QW / 2; ++i) s[i] = dp[i] = 0.f;

  const uint32_t k_addr = smem_addr(sK);
  const uint32_t v_addr = smem_addr(sV);
  const uint32_t pt_addr = smem_addr(sPt);
  const uint32_t dst_addr = smem_addr(sDSt);
  // two 16-bit values at (kv row r, query c), c even, of a swizzled panel
  auto put = [&](unsigned char* panel, int r, int c, float lo, float hi) {
    const int off = r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) * 2));
    *reinterpret_cast<uint32_t*>(panel + off) = pack2<T>(lo, hi);
  };

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    const int q0 = (t_lo + i % n_t) * TILE;
    mbar_wait(&full[st], (i / STAGES) & 1);
    if (!tile_idle(q0, k0, C::KV_OWN, o)) {
      const uint32_t q_addr = smem_addr(sRing + st * 2 * C::TILE_BYTES);
      const uint32_t do_addr = q_addr + C::TILE_BYTES;
      const float* sL = sRows + st * 2 * TILE;
      // S^T, dP^T of this warpgroup's queries
      fence_regs(s);
      fence_regs(dp);
      hopper::wgmma_fence();
      issue_ss<T, D, QW>(s, k_addr, C::KV_OWN * 128, q_addr + wg * QW * 128, TILE * 128);
      issue_ss<T, D, QW>(dp, v_addr, C::KV_OWN * 128, do_addr + wg * QW * 128, TILE * 128);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      grads_t<QW>(s, dp, q0 + wg * QW, row0, col, sL + wg * QW, sL + TILE + wg * QW,
                  tile_edge(q0, k0, C::KV_OWN, o), o);
#pragma unroll
      for (int j = 0; j < QW / 8; ++j) {
        const int c = wg * QW + 8 * j + col;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          put(sPt, r_loc + 8 * h, c, s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
          put(sDSt, r_loc + 8 * h, c, dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]);
        }
      }
      hopper::fence_async_smem();
      hopper::bar_sync(SPLIT_BAR, 256);
      // dV[:, half] += P^T dO[:, half], dK[:, half] += dS^T Q[:, half]
      fence_regs(acc_v);
      fence_regs(acc_k);
      hopper::wgmma_fence();
      issue_st<T, HALF>(acc_v, pt_addr, do_addr + wg * 2 * TILE * 128);
      issue_st<T, HALF>(acc_k, dst_addr, q_addr + wg * 2 * TILE * 128);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      hopper::bar_sync(SPLIT_BAR, 256);
    }
    mbar_arrive(&empty[st]);
  }

  const size_t head = static_cast<size_t>(bkv) * o.S * D + wg * HALF;
  store_rows<T, HALF, D>(acc_k, dk + head, row0, col, o.S, o.scale);
  store_rows<T, HALF, D>(acc_v, dv + head, row0, col, o.S, 1.f);
}

template <typename T, int D>
__global__ void __launch_bounds__(Plan<D>::KV_THREADS, 1)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tmap_q,
                  const __grid_constant__ CUtensorMap tmap_do,
                  const __grid_constant__ CUtensorMap tmap_k,
                  const __grid_constant__ CUtensorMap tmap_v,
                  const float* __restrict__ lse2, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv, Opts o) {
  using C = Plan<D>;
  constexpr int OWN = C::KV_OWN;
  constexpr int OWN_BYTES = OWN * D * 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  // K, V: PANELS panels of OWN rows x 128 B; the ring: per slot a Q and a
  // dO tile of PANELS panels of TILE rows; at D 256 P^T and dS^T (a panel
  // of TILE rows each); then per slot TILE lse2 and TILE D values. Every
  // panel starts on a 1024-byte boundary.
  unsigned char* sK = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + OWN_BYTES;
  unsigned char* sRing = sV + OWN_BYTES;
  unsigned char* sPt = sRing + C::RING;
  unsigned char* sDSt = sPt + C::PT_BYTES;
  float* sRows = reinterpret_cast<float*>(sRing + C::RING + (C::SPLIT ? 2 * C::PT_BYTES : 0));

  const int S = o.S;
  const int bkv = blockIdx.x;                   // b * Hkv + kv head
  const int k0 = blockIdx.y * OWN;              // heaviest first under the causal mask
  const int hkv = o.Hq / o.group;
  const int bh0 = (bkv / hkv) * o.Hq + (bkv % hkv) * o.group;   // the group's first q head

  // q tiles [t_lo, t_lo + n_t) that may see a key of the block, for each of
  // the group's q heads: tile i is head bh0 + i / n_t, tile t_lo + i % n_t
  const int k_last = min(k0 + OWN, S) - 1;
  const int t_lo = o.causal ? k0 / TILE : 0;
  int t_hi = (S + TILE - 1) / TILE;
  if (o.has_window) {
    const int q_last = k_last + o.window - 1;   // q - k < window
    t_hi = q_last < 0 ? 0 : min(t_hi, q_last / TILE + 1);
  }
  const int n_t = max(t_hi - t_lo, 0);
  const int n_tiles = o.group * n_t;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&kv_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], 2 * 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 2 * 4) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * 128) {
      hopper::mbar_arrive_expect_tx(&kv_full, 2 * OWN_BYTES);
      for (int p = 0; p < C::PANELS; ++p) {
        hopper::tma_load_3d(sK + p * OWN * 128, &tmap_k, &kv_full, p * PANEL_COLS, k0, bkv);
        hopper::tma_load_3d(sV + p * OWN * 128, &tmap_v, &kv_full, p * PANEL_COLS, k0, bkv);
      }
      const int S_pad = padded(S);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        const int bh = bh0 + i / n_t;
        const int q0 = (t_lo + i % n_t) * TILE;
        unsigned char* sQ = sRing + st * 2 * C::TILE_BYTES;
        float* sL = sRows + st * 2 * TILE;
        // the first pass over the ring finds every slot free
        mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], 2 * C::TILE_BYTES + 2 * C::ROW_BYTES);
        for (int p = 0; p < C::PANELS; ++p) {
          hopper::tma_load_3d(sQ + p * TILE * 128, &tmap_q, &full[st], p * PANEL_COLS, q0, bh);
          hopper::tma_load_3d(sQ + C::TILE_BYTES + p * TILE * 128, &tmap_do, &full[st],
                              p * PANEL_COLS, q0, bh);
        }
        const size_t row = static_cast<size_t>(bh) * S_pad + q0;
        hopper::bulk_load(sL, lse2 + row, C::ROW_BYTES, &full[st]);
        hopper::bulk_load(sL + TILE, delta + row, C::ROW_BYTES, &full[st]);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    if constexpr (C::SPLIT) {
      split_consume<T>(sK, sV, sRing, sRows, sPt, sDSt, &kv_full, full, empty, dk, dv, bkv,
                       k0, t_lo, n_t, n_tiles, warp, o);
    } else {
      dkdv_consume<T, D>(sK, sV, sRing, sRows, &kv_full, full, empty, dk, dv, bkv, k0, t_lo,
                         n_t, n_tiles, warp, o);
    }
  }
}

// One consumer warpgroup of flash_bwd_dq_tc: its 64 query rows' D over the
// ring's first sweep of the kv tiles, written to `delta`, then their dQ over
// the second sweep, then the epilogue (the accumulator layout above; rows
// are queries and columns the tile's keys).
//
// dS is rounded to 16 bits before dQ += dS K, so dQ_i takes the rounding
// errors' sum e_i = sum_j (dS~_ij - dS_ij) times the keys' shared
// component (the note on D at the top): ~2e-2 of max |dQ| at a shared mean
// 16 times the spread, 5e-2 at 32, with a softcap as without. The epilogue
// takes scale e_i k_i out, the row's own key k_i standing in for the
// shared part; e_i is summed in f32 from the rounded dS that the product
// took and the f32 dS it was rounded from. (Without a softcap sum_j dS_ij
// is 0, and the rounded sum alone would do; with one it is not.)
template <typename T, int D>
__device__ __forceinline__ void dq_consume(
    unsigned char* sQ, unsigned char* sDO, unsigned char* sRing, uint64_t* q_full,
    uint64_t* full, uint64_t* empty, const float* __restrict__ lse2,
    float* __restrict__ delta, const T* __restrict__ kh, T* __restrict__ dq, int bh,
    int q0, int kv_lo, int n_tiles, int warp, const Opts& o) {
  using C = Plan<D>;
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int qw0 = q0 + wg * WG_ROWS;                  // the warpgroup's query rows
  const int row0 = qw0 + 16 * (warp % 4) + lane / 4;  // this thread's: row0, row0 + 8
  const int col = 2 * (lane % 4);                     // + 8 j + (e % 2)
  const float scale_log2 = o.scale * LOG2E;
  const float scale_cap = o.has_cap ? o.scale / o.cap : 0.f;
  const float cap_log2 = o.cap * LOG2E;

  // the rows' lse2 (rows past S: +inf, as the workspace's pad), D, summed
  // over the first sweep, and the rounding errors' sum of their dS
  float l2[2], dl[2] = {0.f, 0.f}, ds_err[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    l2[r] = row < o.S ? lse2[static_cast<size_t>(bh) * padded(o.S) + row] : INFINITY;
  }

  float acc[D / 2], s[TILE / 2], dp[TILE / 2];
  uint32_t da[TILE / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TILE / 2; ++i) s[i] = dp[i] = 0.f;

  const uint32_t q_addr = smem_addr(sQ) + wg * WG_ROWS * 128;
  const uint32_t do_addr = smem_addr(sDO) + wg * WG_ROWS * 128;
  auto idle = [&](int kv0) {
    return qw0 >= o.S || (o.causal && kv0 > qw0 + WG_ROWS - 1) ||
           (o.has_window && qw0 - (kv0 + TILE - 1) >= o.window);
  };
  auto edge = [&](int kv0) {
    return kv0 + TILE > o.S || qw0 + WG_ROWS > o.S || (o.causal && kv0 + TILE - 1 > qw0) ||
           (o.has_window && qw0 + WG_ROWS - 1 - kv0 >= o.window);
  };
  // whether accumulator element idx (row r = (idx >> 1) & 1) is unmasked
  auto keep = [&](int kv0, int idx) {
    const int key = kv0 + 8 * (idx >> 2) + col + (idx & 1);
    const int row = row0 + 8 * ((idx >> 1) & 1);
    bool ok = key < o.S && row < o.S;
    if (o.causal) ok = ok && key <= row;
    if (o.has_window) ok = ok && row - key < o.window;
    return ok;
  };
  // first sweep: D += P dP by row, P from S (dP untouched)
  auto row_dots = [&](int kv0, auto cap, auto mask) {
    constexpr bool CAP = decltype(cap)::value;
    constexpr bool MASK = decltype(mask)::value;
#pragma unroll
    for (int idx = 0; idx < TILE / 2; ++idx) {
      const int r = (idx >> 1) & 1;
      float p = s[idx], unused = 0.f;
      p_and_ds<CAP>(p, unused, l2[r], 0.f, !MASK || keep(kv0, idx), scale_log2, scale_cap,
                    cap_log2);
      dl[r] = fmaf(p, dp[idx], dl[r]);
    }
  };
  // second sweep: P, dS in place of S, dP; lse2 and D by row (the query)
  auto grads = [&](int kv0, auto cap, auto mask) {
    constexpr bool CAP = decltype(cap)::value;
    constexpr bool MASK = decltype(mask)::value;
#pragma unroll
    for (int idx = 0; idx < TILE / 2; ++idx) {
      const int r = (idx >> 1) & 1;
      p_and_ds<CAP>(s[idx], dp[idx], l2[r], dl[r], !MASK || keep(kv0, idx), scale_log2,
                    scale_cap, cap_log2);
    }
  };
  // D of the rows: the quad's four partial sums, each row's in all four;
  // the quad's first thread writes it (0 past S) for flash_bwd_dkdv_tc,
  // every row of the padded workspace that this warpgroup owns
  auto finish_d = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
      const int row = row0 + 8 * r;
      if (lane % 4 == 0 && row < padded(o.S)) {
        delta[static_cast<size_t>(bh) * padded(o.S) + row] = row < o.S ? dl[r] : 0.f;
      }
    }
  };

  mbar_wait(q_full, 0);
  if (n_tiles == 0) finish_d();
  for (int i = 0; i < 2 * n_tiles; ++i) {
    const int st = i % STAGES;
    const bool sweep_d = i < n_tiles;
    const int kv0 = (kv_lo + i % n_tiles) * TILE;
    if (i == n_tiles) finish_d();
    mbar_wait(&full[st], (i / STAGES) & 1);
    if (!idle(kv0)) {
      const uint32_t k_addr = smem_addr(sRing + st * 2 * C::TILE_BYTES);
      const uint32_t v_addr = k_addr + C::TILE_BYTES;
      // S = Q K^T, dP = dO V^T
      fence_regs(s);
      fence_regs(dp);
      hopper::wgmma_fence();
      issue_ss<T, D, TILE>(s, q_addr, C::DQ_OWN * 128, k_addr, TILE * 128);
      issue_ss<T, D, TILE>(dp, do_addr, C::DQ_OWN * 128, v_addr, TILE * 128);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (sweep_d) {
        if (edge(kv0)) {
          if (o.has_cap) row_dots(kv0, Flag<true>{}, Flag<true>{});
          else row_dots(kv0, Flag<false>{}, Flag<true>{});
        } else if (o.has_cap) {
          row_dots(kv0, Flag<true>{}, Flag<false>{});
        } else {
          row_dots(kv0, Flag<false>{}, Flag<false>{});
        }
        mbar_arrive(&empty[st]);
        continue;
      }
      if (edge(kv0)) {
        if (o.has_cap) grads(kv0, Flag<true>{}, Flag<true>{});
        else grads(kv0, Flag<false>{}, Flag<true>{});
      } else if (o.has_cap) {
        grads(kv0, Flag<true>{}, Flag<false>{});
      } else {
        grads(kv0, Flag<false>{}, Flag<false>{});
      }
      pack_a<T, TILE>(dp, da);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {        // registers 8 kk + 2 h, + 1: row h % 2
          const float2 x = unpack2<T>(da[kk][h]);
          ds_err[h & 1] += (x.x - dp[8 * kk + 2 * h]) + (x.y - dp[8 * kk + 2 * h + 1]);
        }
      }
      // dQ += dS K
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) fence_regs(da[kk]);
      hopper::wgmma_fence();
      issue_rs<T, D>(acc, da, k_addr);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) fence_regs(da[kk]);
    }
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ds_err[r] += __shfl_xor_sync(0xffffffffu, ds_err[r], 1);
    ds_err[r] += __shfl_xor_sync(0xffffffffu, ds_err[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= o.S) continue;
    const T* k_row = kh + static_cast<size_t>(row) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 kv = unpack2<T>(*reinterpret_cast<const uint32_t*>(k_row + 8 * j));
      acc[4 * j + 2 * r] -= ds_err[r] * kv.x;
      acc[4 * j + 2 * r + 1] -= ds_err[r] * kv.y;
    }
  }
  store_rows<T, D, D>(acc, dq + static_cast<size_t>(bh) * o.S * D, row0, col, o.S, o.scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(Plan<D>::DQ_THREADS, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tmap_q,
                const __grid_constant__ CUtensorMap tmap_do,
                const __grid_constant__ CUtensorMap tmap_k,
                const __grid_constant__ CUtensorMap tmap_v,
                const float* __restrict__ lse2, float* __restrict__ delta,
                const T* __restrict__ k, T* __restrict__ dq, Opts o) {
  using C = Plan<D>;
  constexpr int OWN = C::DQ_OWN;
  constexpr int OWN_BYTES = OWN * D * 2;
  constexpr int WGS = C::DQ_WGS;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  // Q, dO: PANELS panels of OWN rows x 128 B; the ring: per slot a K and a
  // V tile of PANELS panels of TILE rows.
  unsigned char* sQ = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sDO = sQ + OWN_BYTES;
  unsigned char* sRing = sDO + OWN_BYTES;

  const int S = o.S;
  const int bh = blockIdx.x;                             // b * Hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * OWN;     // heaviest first
  const int hkv = o.Hq / o.group;
  const int kv_head = (bh / o.Hq) * hkv + (bh % o.Hq) / o.group;

  // kv tiles [kv_lo, kv_lo + n_tiles) that hold a key some row may see
  const int q_last = min(q0 + OWN, S) - 1;
  int kv_lo = 0;
  int kv_hi = (S + TILE - 1) / TILE;
  if (o.causal) kv_hi = q_last / TILE + 1;
  if (o.has_window && q0 - o.window + 1 > 0) kv_lo = (q0 - o.window + 1) / TILE;
  const int n_tiles = max(kv_hi - kv_lo, 0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], WGS * 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= WGS * 4) {
    // ---------------------------------------------------------- producer
    // (one consumer warpgroup: 256 threads fit 255 registers each, and
    // no redistribution is needed)
    if constexpr (WGS == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    }
    if (threadIdx.x == WGS * 128) {
      hopper::mbar_arrive_expect_tx(&q_full, 2 * OWN_BYTES);
      for (int p = 0; p < C::PANELS; ++p) {
        hopper::tma_load_3d(sQ + p * OWN * 128, &tmap_q, &q_full, p * PANEL_COLS, q0, bh);
        hopper::tma_load_3d(sDO + p * OWN * 128, &tmap_do, &q_full, p * PANEL_COLS, q0, bh);
      }
      for (int i = 0; i < 2 * n_tiles; ++i) {      // two sweeps
        const int st = i % STAGES;
        const int kv0 = (kv_lo + i % n_tiles) * TILE;
        unsigned char* sK = sRing + st * 2 * C::TILE_BYTES;
        mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], 2 * C::TILE_BYTES);
        for (int p = 0; p < C::PANELS; ++p) {
          hopper::tma_load_3d(sK + p * TILE * 128, &tmap_k, &full[st], p * PANEL_COLS, kv0,
                              kv_head);
          hopper::tma_load_3d(sK + C::TILE_BYTES + p * TILE * 128, &tmap_v, &full[st],
                              p * PANEL_COLS, kv0, kv_head);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    if constexpr (WGS == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    }
    dq_consume<T, D>(sQ, sDO, sRing, &q_full, full, empty, lse2, delta,
                     k + static_cast<size_t>(kv_head) * S * D, dq, bh, q0, kv_lo, n_tiles,
                     warp, o);
  }
}

// ----------------------------------------------------------------- host

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, const float* lse,
                 const void* dout, void* dq, void* dk, void* dv, float* work, int B,
                 int Hkv, const Opts& o, cudaStream_t stream) {
  using C = Plan<D>;
  const int S = o.S;
  const int rows = B * o.Hq * padded(S);
  float* lse2 = work;
  float* delta = work + rows;

  hopper::EncodeTiled encode;
  int err = hopper::encoder(&encode);
  if (err != 0) return err;
  constexpr CUtensorMapDataType type = hopper::map_type<T>();
  // maps with boxes of the owned rows (DQ_OWN, KV_OWN) and of the streamed
  // tiles (TILE)
  CUtensorMap q_own, do_own, k_tile, v_tile, q_tile, do_tile, k_own, v_own;
  if ((err = hopper::make_map(encode, &q_own, q, type, B * o.Hq, S, D, C::DQ_OWN)) != 0 ||
      (err = hopper::make_map(encode, &do_own, dout, type, B * o.Hq, S, D, C::DQ_OWN)) != 0 ||
      (err = hopper::make_map(encode, &k_tile, k, type, B * Hkv, S, D, TILE)) != 0 ||
      (err = hopper::make_map(encode, &v_tile, v, type, B * Hkv, S, D, TILE)) != 0 ||
      (err = hopper::make_map(encode, &q_tile, q, type, B * o.Hq, S, D, TILE)) != 0 ||
      (err = hopper::make_map(encode, &do_tile, dout, type, B * o.Hq, S, D, TILE)) != 0 ||
      (err = hopper::make_map(encode, &k_own, k, type, B * Hkv, S, D, C::KV_OWN)) != 0 ||
      (err = hopper::make_map(encode, &v_own, v, type, B * Hkv, S, D, C::KV_OWN)) != 0) {
    return err;
  }
  cudaError_t cerr = cudaFuncSetAttribute(flash_bwd_dq_tc<T, D>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          C::DQ_SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cerr = cudaFuncSetAttribute(flash_bwd_dkdv_tc<T, D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, C::KV_SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);

  flash_bwd_prep<<<(rows + PREP_THREADS - 1) / PREP_THREADS, PREP_THREADS, 0, stream>>>(
      lse, lse2, S, rows);
  if ((cerr = cudaGetLastError()) != cudaSuccess) return static_cast<int>(cerr);

  flash_bwd_dq_tc<T, D><<<dim3(B * o.Hq, (S + C::DQ_OWN - 1) / C::DQ_OWN), C::DQ_THREADS,
                          C::DQ_SMEM, stream>>>(
      q_own, do_own, k_tile, v_tile, lse2, delta, static_cast<const T*>(k),
      static_cast<T*>(dq), o);
  if ((cerr = cudaGetLastError()) != cudaSuccess) return static_cast<int>(cerr);

  flash_bwd_dkdv_tc<T, D><<<dim3(B * Hkv, (S + C::KV_OWN - 1) / C::KV_OWN), C::KV_THREADS,
                            C::KV_SMEM, stream>>>(
      q_tile, do_tile, k_own, v_own, lse2, delta, static_cast<T*>(dk), static_cast<T*>(dv), o);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, const float* lse,
             const void* dout, void* dq, void* dk, void* dv, float* work, int B, int Hkv,
             const Opts& o, cudaStream_t stream) {
  switch (D) {
    case 64:
      return tcb::launch_typed<T, 64>(q, k, v, lse, dout, dq, dk, dv, work, B, Hkv, o, stream);
    case 128:
      return tcb::launch_typed<T, 128>(q, k, v, lse, dout, dq, dk, dv, work, B, Hkv, o,
                                       stream);
    case 256:
      return tcb::launch_typed<T, 256>(q, k, v, lse, dout, dq, dk, dv, work, B, Hkv, o,
                                       stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tcb

extern "C" {

// 1 if flash_attention_bwd_launch runs the tensor-core kernels for this
// dtype code and head dim, 0 if the CUDA-core ones.
int flash_attention_bwd_uses_tensor_cores(int dtype, int D) {
  return (dtype == BF16 || dtype == F16) && (D == 64 || D == 128 || D == 256);
}

// Launches the three kernels on `stream` (no synchronisation) and returns 0,
// a cudaError_t or a code of the tensor-map encoding
// (flash_attention_bwd_error_string names each). q, dout, dq:
// [B, Hq, S, D]; k, v, dk, dv: [B, Hkv, S, D]; all contiguous, of the type
// `dtype` (0 f32, 1 bf16, 2 f16) and aligned to 16 bytes. lse is the
// forward's [B * Hq, S] f32 log-sum-exp; work is f32 scratch of
// 2 * B * Hq * S_pad values, S_pad = S rounded up to a multiple of 64,
// aligned to 256 bytes. Hq is a multiple of Hkv, D a multiple of 32 up to
// 256, B * Hq <= 65535. has_window = 0 ignores `window`; has_cap = 0
// ignores `cap`.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const float* lse, const void* dout,
                               void* dq, void* dk, void* dv, float* work, int dtype,
                               int B, int Hq, int Hkv, int S, int D, float sm_scale,
                               int causal, int has_window, int window, int has_cap,
                               float cap, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || B * Hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Opts o{S, Hq, Hq / Hkv, sm_scale, causal, has_window, window, has_cap, cap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flash_attention_bwd_uses_tensor_cores(dtype, D)) {
    if (dtype == BF16) {
      return tcb::launch_d<__nv_bfloat16>(D, q, k, v, lse, dout, dq, dk, dv, work, B, Hkv, o,
                                          st);
    }
    return tcb::launch_d<__half>(D, q, k, v, lse, dout, dq, dk, dv, work, B, Hkv, o, st);
  }
  float* delta = work;
  cudaError_t err;
  switch (dtype) {
    case F32:
      err = launch_d<float>(D, q, k, v, lse, dout, dq, dk, dv, delta, B, Hkv, o, st);
      break;
    case BF16:
      err = launch_d<__nv_bfloat16>(D, q, k, v, lse, dout, dq, dk, dv, delta, B, Hkv, o,
                                    st);
      break;
    case F16:
      err = launch_d<__half>(D, q, k, v, lse, dout, dq, dk, dv, delta, B, Hkv, o, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int code) { return hopper::error_string(code); }

}  // extern "C"
