// Causal sliding-window attention forward with GQA and an optional logit
// softcap, in the model's (B, S, H, Dh) layout.
//
// Replaces src/repro/kernels/swa_attention/swa_attention.py::swa_attention_fwd
// (the Pallas TPU kernel, pl.pallas_call at line 101). Same semantics: key k
// is valid for query q iff q - window < k <= q; query head h reads kv head
// h / (H / Hkv); scores s = q.k * Dh^-0.5, then cap * tanh(s / cap) when
// capped, masked to -1e30; online softmax (m, l, acc) in float32; output
// acc / max(l, 1e-30) in q's dtype. Inputs are float32 or bfloat16; every
// tile is widened to float32 on load, so both types share the arithmetic.
//
// What bounds it on an H100, at gemma3-4b's prefill (B = 4, S = 4096, H = 8,
// Dh = 256, window 1024, bf16): operations. The band needs
// 4 B H Dh sum_q min(q + 1, window) = 1.20e11 FLOP, 0.122 ms at the bf16
// tensor-core peak of 989 TFLOP/s; q, k, v and the output are 201 MB, 0.060
// ms at 3.35 TB/s. This kernel computes on the CUDA cores in float32 (67
// TFLOP/s peak, 1.8 ms for the same work), so it sits far above the bound;
// wgmma and TMA are for a later change.
//
// Design. The TPU kernel walks a sequential grid (BH, nq, nwin) and carries
// (m, l, acc) in VMEM scratch from one grid step to the next. Blocks on
// Hopper run in no order, so one block owns one (b, h, tile of 64 queries)
// and walks the key tiles of its band, [q0 - window + 1, q_last], in a loop
// of its own, with (m, l) in shared memory and acc in registers. VMEM holds
// many megabytes; a block here has 227 KB of shared memory. At Dh = 256 the
// float32 Q, K and V tiles (64 rows each, rows padded by 4 floats so the
// 16-byte loads of the score loop hit distinct banks) take 195 KB and the
// 64 x 64 score tile 17 KB: 213 KB, one block per SM. The 64 x 256 float32
// accumulator lives in registers, 64 per thread. The ragged edge (S not a
// multiple of 64) is masked in the kernel: rows past S load as zeros, keys
// past S are masked, queries past S are not written.
//
// Entry point (plain C, loaded with ctypes): swa_attention_launch returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kPad = 4;        // floats of padding per Q/K/V tile row
constexpr int kLdP = kBK + 4;  // row stride of the score tile
constexpr int kMaxDh = 256;    // 8 accumulator columns of 32 lanes
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows [row0, row0 + 64) of one head's (S, Dh) slab, widened to float32,
// into a tile with row stride ld; rows at or past S are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          int64_t row_stride, int row0, int S,
                                          int Dh, int ld) {
  const int per_row = Dh / 4;
  for (int idx = threadIdx.x; idx < kBQ * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * 4;
    const int row = row0 + r;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < S) val = load4(base + static_cast<int64_t>(row) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S,
                     int G, int Dh, int window, float scale, float cap,
                     int has_cap, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                     int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                     int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                     int64_t o_sh) {
  extern __shared__ float4 smem4[];
  const int ld = Dh + kPad;
  float* Qs = reinterpret_cast<float*>(smem4);  // kBQ x ld
  float* Ks = Qs + kBQ * ld;                     // kBK x ld
  float* Vs = Ks + kBK * ld;                     // kBK x ld
  float* Ps = Vs + kBK * ld;                     // kBQ x kLdP: scores, then p
  float* m_s = Ps + kBQ * kLdP;                  // running max per query
  float* l_s = m_s + kBQ;                        // running sum per query
  float* c_s = l_s + kBQ;                        // this tile's rescale factor

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const T* qh = q + b * q_sb + h * q_sh;
  const T* kh = k + b * k_sb + hk * k_sh;
  const T* vh = v + b * v_sb + hk * v_sh;

  load_tile(Qs, qh, q_ss, q0, S, Dh, ld);
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }

  // score phase: this thread's scores are rows sr + 16 i, keys sc + 16 j
  const int sr = tid >> 4;
  const int sc = tid & 15;
  // value phase: its outputs are rows pr + 8 i, columns lane + 32 j
  const int lane = tid & 31;
  const int pr = tid >> 5;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int t_first = max(0, q0 - window + 1) / kBK;
  const int t_last = q_last / kBK;
  for (int t = t_first; t <= t_last; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers of Ks, Vs and Ps are done
    load_tile(Ks, kh, k_ss, k0, S, Dh, ld);
    load_tile(Vs, vh, v_ss, k0, S, Dh, ld);
    __syncthreads();

    // scores: 4 x 4 per thread, 16-byte shared-memory loads along Dh
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
    for (int d = 0; d < Dh; d += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (sr + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = *reinterpret_cast<const float4*>(Ks + (sc + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j];
          x = fmaf(a[i].x, kk[j].x, x);
          x = fmaf(a[i].y, kk[j].y, x);
          x = fmaf(a[i].z, kk[j].z, x);
          x = fmaf(a[i].w, kk[j].w, x);
          s[i][j] = x;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = sr + 16 * i;
      const int qi = q0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = sc + 16 * j;
        const int kj = k0 + col;
        float x = s[i][j] * scale;
        if (has_cap) x = cap * tanhf(x / cap);
        const bool ok = kj <= qi && kj > qi - window && kj < S;
        Ps[row * kLdP + col] = ok ? x : kNegInf;
      }
    }
    __syncthreads();

    // online softmax over the tile: 4 threads per query row
    {
      const int row = tid >> 2;
      const int part = tid & 3;
      float* prow = Ps + row * kLdP;
      float mx = kNegInf;
      for (int j = part; j < kBK; j += 4) mx = fmaxf(mx, prow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = part; j < kBK; j += 4) {
        const float p = expf(prow[j] - m_new);
        prow[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[row] = corr;
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p V
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float corr = c_s[pr + 8 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }
    for (int j0 = 0; j0 < kBK; j0 += 4) {
      float4 p4[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) p4[i] = *reinterpret_cast<const float4*>(Ps + (pr + 8 * i) * kLdP + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j0 + jj) * ld + lane;
        float vv[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) vv[c] = (lane + 32 * c < Dh) ? vrow[32 * c] : 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = jj == 0 ? p4[i].x : jj == 1 ? p4[i].y : jj == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* oh = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = pr + 8 * i;
    const int qi = q0 + row;
    if (qi >= S) continue;
    const float denom = fmaxf(l_s[row], 1e-30f);
    T* orow = oh + static_cast<int64_t>(qi) * o_ss;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int e = lane + 32 * c;
      if (e < Dh) store1(orow + e, acc[i][c] / denom);
    }
  }
}

size_t smem_bytes(int Dh) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBK) * (Dh + kPad) + kBQ * kLdP + 3 * kBQ);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hkv, int Dh, int window, float scale, float cap,
           int has_cap, const int64_t* st, cudaStream_t stream) {
  const size_t smem = smem_bytes(Dh);
  cudaError_t err = cudaFuncSetAttribute(
      swa_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  swa_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H / Hkv, Dh, window,
      scale, cap, has_cap, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. strides: the (batch, sequence, head) element
// strides of q, k, v and out, in that order; Dh is contiguous. The caller
// checks 1 <= Dh <= 256, Dh % 4 == 0, H % Hkv == 0 and 16-byte alignment.
extern "C" int swa_attention_launch(const void* q, const void* k,
                                    const void* v, void* out, int dtype, int B,
                                    int S, int H, int Hkv, int Dh, int window,
                                    float scale, float cap, int has_cap,
                                    const int64_t* strides, void* stream) {
  if (Dh > kMaxDh || Dh % 4 != 0 || Hkv <= 0 || H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, out, B, S, H, Hkv, Dh, window, scale, cap,
                         has_cap, strides, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, out, B, S, H, Hkv, Dh, window,
                                 scale, cap, has_cap, strides, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* swa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
