// Batched execution of a modulo-scheduled CGRA program, one thread per lane.
//
// Replaces the TPU kernel src/repro/kernels/cgra_sim.py::_cgra_sim_kernel
// (launched by cgra_sim_pallas). It computes the same function: the trace
// [C, pes, B] of every value each PE produces at each cycle, for B
// independent data streams running the same mapped loop. It computes it the
// way the trace-indexed oracle does (src/repro/kernels/ref.py,
// cgra_sim_reference), not the way the TPU kernel does:
//
//   * operands are read by integer index from the trace, trace[c - delta,
//     src_pe, lane], where the TPU kernel gathers from a register ring with
//     one-hot matmuls;
//   * the op is selected by its opcode, where the TPU kernel evaluates all
//     21 ops and blends them by a one-hot weight (which turns an overflowing
//     unselected candidate into inf * 0 = NaN; this kernel has no such NaN);
//   * a node's input stream is read straight from inputs[slot, it, lane],
//     so no dense [C, pes, B] injection array is ever built.
//
// What bounds it on an H100: the trace is the output, C * pes * B * 4 bytes
// (about 8.5 GB for a 20x20 fabric, 325 cycles and 16384 lanes), written
// once; the caller zero-fills it with torch.zeros and this kernel overwrites
// only the cells of firing nodes. Every other byte (the input streams and
// the per-node tables) is small beside it. The operand reads hit values the
// same thread wrote at most `ring` cycles earlier, a few MB across all lanes,
// so they are served from L2. The kernel is therefore bound by the trace's
// write bandwidth; the cycle loop is sequential per lane and its latency is
// hidden only by the number of lanes in flight.
//
// Lanes are independent, so nothing is shared or synchronised: each thread
// walks the cycles in order and, at cycle c, the nodes of kernel step
// c % ii. Writes trace[c, pe, lane] are coalesced across a warp because the
// lane is the innermost index. Offsets are 64-bit: C * pes * B exceeds 2^31
// at full size.
//
// Bit-exactness with the oracle: build without fast math and with
// -fmad=false, and write the arithmetic with the _rn intrinsics, so every op
// rounds exactly as numpy's float32 does. Bitwise ops work on
// (int64)|x| & 0xFFFF, with 0 for |x| >= 2^63, inf and NaN (what numpy's
// cast gives on x86), and shift by (ib % 8).
//
// Plain C interface, loaded with ctypes (kernels/_build.py): no PyTorch
// headers, so the build takes seconds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Opcode numbering: repro_torch.core.simulate.OPCODES.
enum Op : int {
  OP_INPUT = 0, OP_CONST, OP_LOAD, OP_STORE, OP_ADD, OP_SUB, OP_MUL, OP_DIV,
  OP_AND, OP_OR, OP_XOR, OP_SHL, OP_SHR, OP_MIN, OP_MAX, OP_NEG, OP_NOT,
  OP_ABS, OP_MOV, OP_PHI, OP_CMP,
};

__device__ __forceinline__ long long mask16(float x) {
  const float ax = fabsf(x);
  // 0x1p63f = 2^63; NaN fails the comparison and gives 0 as well
  return ax < 0x1p63f ? (static_cast<long long>(ax) & 0xFFFF) : 0LL;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  // numpy.minimum propagates NaN; fminf would drop it
  if (isnan(a) || isnan(b)) return __fadd_rn(a, b);
  return a < b ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a) || isnan(b)) return __fadd_rn(a, b);
  return a > b ? a : b;
}

__device__ __forceinline__ float alu(int op, float a, float b, float imm) {
  switch (op) {
    case OP_CONST: return imm;
    case OP_LOAD:
    case OP_STORE:
    case OP_MOV: return a;
    case OP_ADD:
    case OP_PHI: return __fadd_rn(a, b);
    case OP_SUB: return __fsub_rn(a, b);
    case OP_MUL: return __fmul_rn(a, b);
    case OP_DIV: return b != 0.0f ? __fdiv_rn(a, b) : 0.0f;
    case OP_MIN: return nan_min(a, b);
    case OP_MAX: return nan_max(a, b);
    case OP_NEG: return -a;
    case OP_ABS: return fabsf(a);
    case OP_CMP: return a > b ? 1.0f : 0.0f;
    default: break;
  }
  const long long ia = mask16(a);
  const long long ib = mask16(b);
  const int sh = static_cast<int>(ib % 8);
  switch (op) {
    case OP_AND: return static_cast<float>(ia & ib);
    case OP_OR: return static_cast<float>(ia | ib);
    case OP_XOR: return static_cast<float>(ia ^ ib);
    case OP_SHL: return static_cast<float>((ia << sh) & 0xFFFF);
    case OP_SHR: return static_cast<float>(ia >> sh);
    case OP_NOT: return static_cast<float>(~ia & 0xFFFF);
    default: return 0.0f;  // unreachable: the wrapper validates opcodes
  }
}

__global__ void cgra_sim_kernel(
    const int* __restrict__ step_ptr,    // [ii + 1] node range of each step
    const int* __restrict__ node_pe,     // [n]
    const int* __restrict__ node_op,     // [n]
    const int* __restrict__ node_t0,     // [n] first firing cycle (t_abs)
    const int* __restrict__ node_src,    // [n, 2] operand PE, -1 = none
    const int* __restrict__ node_delta,  // [n, 2] cycles since produced
    const float* __restrict__ node_imm,  // [n]
    const int* __restrict__ node_in,     // [n] input stream slot, -1 = none
    const float* __restrict__ inputs,    // [n_in, num_iters, batch]
    float* __restrict__ trace,           // [num_cycles, pes, batch], zeroed
    int ii, int pes, int num_cycles, int num_iters, int batch) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const int64_t row = static_cast<int64_t>(batch);
  const int64_t plane = static_cast<int64_t>(pes) * row;
  const int last = (num_iters - 1) * ii;  // last firing is t0 + last
  for (int c = 0; c < num_cycles; ++c) {
    const int k = c % ii;
    const int end = __ldg(step_ptr + k + 1);
    for (int n = __ldg(step_ptr + k); n < end; ++n) {
      const int t0 = __ldg(node_t0 + n);
      if (c < t0 || c > t0 + last) continue;
      const int op = __ldg(node_op + n);
      float v;
      if (op == OP_INPUT) {
        const int it = (c - t0) / ii;
        const int64_t slot = __ldg(node_in + n);
        v = inputs[(slot * num_iters + it) * row + lane];
      } else {
        float ab[2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int sp = __ldg(node_src + 2 * n + s);
          const int src_c = c - __ldg(node_delta + 2 * n + s);
          ab[s] = (sp < 0 || src_c < 0)
                      ? 0.0f
                      : trace[src_c * plane + sp * row + lane];
        }
        v = alu(op, ab[0], ab[1], __ldg(node_imm + n));
      }
      trace[c * plane + __ldg(node_pe + n) * row + lane] = v;
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
int cgra_sim_launch(const int* step_ptr, const int* node_pe,
                    const int* node_op, const int* node_t0,
                    const int* node_src, const int* node_delta,
                    const float* node_imm, const int* node_in,
                    const float* inputs, float* trace, int ii, int pes,
                    int num_cycles, int num_iters, int batch,
                    int block_threads, void* stream) {
  const int blocks = (batch + block_threads - 1) / block_threads;
  cgra_sim_kernel<<<blocks, block_threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      step_ptr, node_pe, node_op, node_t0, node_src, node_delta, node_imm,
      node_in, inputs, trace, ii, pes, num_cycles, num_iters, batch);
  return static_cast<int>(cudaGetLastError());
}

const char* cgra_sim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
