// Batched damped-SPD solve for FedNew's client sub-problem (paper eq. 9):
// x_i = (A_i + damping I)^{-1} b_i by a fixed number of conjugate-gradient
// iterations, one thread block per client.
//
// Replaces src/repro/kernels/client_solve/client_solve.py::client_solve_cg
// (the Pallas TPU kernel, pl.pallas_call at line 68), with the same
// recurrences and the same guarded denominators
// (alpha = rs / max(denom, 1e-30) if denom > 0 else 0, likewise beta).
//
// What bounds it on an H100: reading A. At w8a (n = 60, d = 267) the
// Hessians are 60 * 267^2 * 4 B = 17.1 MB, 5.1 us at 3.35 TB/s; the
// 32 * 2 n d^2 = 274 MFLOP of matvecs are far below the float32 peak.
//
// Design. The TPU kernel keeps A_i resident in VMEM. On Hopper a block has
// at most 227 KB of shared memory and A_i is 285 KB at d = 267 (the TPU
// wrapper's pad to 384 would make it 590 KB), so A_i stays in device memory:
// every iteration streams A_i's rows again, and after the first iteration
// they come from the 50 MB L2, which holds all 60 clients' A. Only the CG
// vectors x, r, p and Ap (4 d floats, 4.3 KB at d = 267) live in shared
// memory. In the matvec each warp takes whole rows, its lanes read a row
// with coalesced loads, and a shuffle reduction sums it; the dot products
// are block reductions. The kernel computes its own matvec (no cuBLAS).
//
// Entry point (plain C, loaded with ctypes): client_solve_launch returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Sum of v over the block, returned to every thread. The leading barrier
// keeps `partial` from being overwritten while a previous call still reads
// it; the trailing one publishes every thread's earlier shared-memory
// writes to the whole block.
__device__ __forceinline__ float block_sum(float v, float* partial) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  return warp_sum(lane < kWarps ? partial[lane] : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
client_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                    float* __restrict__ x_out, int d, float damping,
                    int iters) {
  extern __shared__ float vec[];  // x, r, p, Ap: 4 d floats
  __shared__ float partial[kWarps];
  float* x = vec;
  float* r = x + d;
  float* p = r + d;
  float* ap = p + d;

  const float* Ai = A + static_cast<size_t>(blockIdx.x) * d * d;
  const float* bi = b + static_cast<size_t>(blockIdx.x) * d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float part = 0.0f;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const float v = bi[j];
    x[j] = 0.0f;
    r[j] = v;
    p[j] = v;
    part += v * v;
  }
  float rs = block_sum(part, partial);

  for (int it = 0; it < iters; ++it) {
    // Ap = A p + damping p, and this warp's share of p . Ap
    float pap = 0.0f;
    for (int row = warp; row < d; row += kWarps) {
      const float* a_row = Ai + static_cast<size_t>(row) * d;
      float acc = 0.0f;
      for (int j = lane; j < d; j += 32) acc += a_row[j] * p[j];
      acc = warp_sum(acc);
      const float v = acc + damping * p[row];
      if (lane == 0) {
        ap[row] = v;
        pap += p[row] * v;
      }
    }
    const float denom = block_sum(pap, partial);
    const float alpha = denom > 0.0f ? rs / fmaxf(denom, 1e-30f) : 0.0f;

    float rr = 0.0f;
    for (int j = threadIdx.x; j < d; j += kThreads) {
      x[j] += alpha * p[j];
      const float rj = r[j] - alpha * ap[j];
      r[j] = rj;
      rr += rj * rj;
    }
    const float rs_new = block_sum(rr, partial);
    const float beta = rs > 0.0f ? rs_new / fmaxf(rs, 1e-30f) : 0.0f;
    for (int j = threadIdx.x; j < d; j += kThreads) p[j] = r[j] + beta * p[j];
    rs = rs_new;
    __syncthreads();  // the next matvec reads all of p
  }

  float* xi = x_out + static_cast<size_t>(blockIdx.x) * d;
  for (int j = threadIdx.x; j < d; j += kThreads) xi[j] = x[j];
}

}  // namespace

extern "C" int client_solve_launch(const float* A, const float* b, float* x,
                                   int n, int d, float damping, int iters,
                                   void* stream) {
  const size_t smem = 4 * static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        client_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  client_solve_kernel<<<n, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(A, b, x, d,
                                                             damping, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* client_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
