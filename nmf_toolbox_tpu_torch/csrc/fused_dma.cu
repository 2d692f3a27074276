// Streamed KL W-phase kernel for Hopper (sm_90a), f32:
//   out (m, k) = (V / (W H)) @ H'
//
// CUDA counterpart of the Pallas kernel in
// nmf_toolbox_tpu/ops/pallas/fused_dma.py (kl_phi_dot_ht_dma), the
// manually double-buffered variant of the fused W-phase.  Where
// fused.cu's w_phase_kernel loads its tiles with plain loads and may
// split the n loop into spans summed by a second kernel, this kernel:
//   * gives one block a TM-row block of the output for the whole n loop:
//     the sum over n stays in the block's registers, with no span split,
//     scratch buffer or second kernel;
//   * keeps the block's W rows (TM x k) resident in shared memory, as the
//     Pallas kernel keeps its W row block in VMEM;
//   * streams each V tile (TM x TN) and the H tile it meets (k x TN) from
//     device memory into shared memory through a two-stage cp.async
//     pipeline: the copy of tile j+1 is issued before the compute on
//     tile j, as the Pallas kernel's two-slot make_async_copy buffer
//     does.  H (4 MB at n = 10 000, k = 100) does not fit in shared
//     memory as it fits in VMEM, so it is streamed with V and served
//     from L2 to the blocks after the first.
// Per tile, V_hat = W_rows @ H_tile is rebuilt in registers with f32
// FMAs, the ratio V / V_hat goes to shared memory, and the contraction
// with H_tile' adds into the block's (TM, k) accumulators.  Tensor cores
// are not used; the Pallas kernel's bf16 MXU inputs are not copied.
//
// Bound on the H100: arithmetic.  4mnk FLOPs against one 4mn-byte read
// of V: about 100 FLOP/byte at k = 100, far above the card's f32 ratio.
//
// Scope: 1 <= k <= 512 (the Pallas kernel's documented scope), any
// (m, n).  Rows past m and columns past n load as zero and no ratio is
// formed there; inside the matrix the ratio carries no guard, as in
// Pallas.  Row-major contiguous operands.
//
// Shapes: 256 threads as a 16 x 16 grid (tx, ty).  TM = 32 rows per block
// (2 per thread), TN = 32 columns per tile.  The output's k columns are
// spread over tx (column tx + 16 b), so a thread holds 2 x NB
// accumulators with 16 * NB >= k: NB is a template parameter, picked per
// launch as the smallest power of two that covers k.
// Grid fill: cdiv(m, 32) blocks.  16-row blocks would double the blocks
// at thin m, but measured slower at all three shapes of the W-phase
// comparison (each H tile serves half the rows), so the grid stays at
// 32 rows, under-filled where m is small.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int RM = 2;            // output rows per thread
constexpr int TM = 16 * RM;      // output rows per block
constexpr int TN = 32;           // V columns per tile
constexpr int HSTR = TN + 4;     // padded H / ratio row: float4-aligned, and
                                 // 8 consecutive rows hit 8 distinct bank quads
constexpr int STAGES = 2;        // cp.async pipeline depth
constexpr int MAX_K = 512;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round16(int k) { return cdiv(k, 16) * 16; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Shared-memory floats of one block: resident W rows (transposed), the
// STAGES ring of V and H tiles, and the ratio tile.
constexpr size_t dma_smem_floats(int k) {
  return (size_t)TM * round16(k)                 // Ws[c][r]
         + (size_t)STAGES * TM * TN              // Vs[s][r][t]
         + (size_t)STAGES * round16(k) * HSTR    // Hs[s][c][t]
         + (size_t)TM * HSTR;                    // Ps[r][t]
}

// Issue the cp.async copies of tile jt (V rows i0.., columns jt*TN..;
// H rows 0..k-1, same columns) into stage buffers Vs, Hs.  vec: n % 4 == 0
// and 16-byte aligned bases, so every 16-byte chunk lies wholly inside or
// wholly outside the matrix.
__device__ __forceinline__ void load_tile(const float* __restrict__ V,
                                          const float* __restrict__ H,
                                          float* Vs, float* Hs, int m, int n,
                                          int k, int i0, int jt, bool vec) {
  const int tid = threadIdx.x, j0 = jt * TN;
  if (vec) {
    for (int e = tid; e < TM * TN / 4; e += NT) {
      const int r = e / (TN / 4), t = 4 * (e % (TN / 4));
      const int gi = i0 + r, gj = j0 + t;
      const bool ok = gi < m && gj < n;
      cp_async16(&Vs[r * TN + t], ok ? V + (size_t)gi * n + gj : V, ok);
    }
    for (int e = tid; e < k * TN / 4; e += NT) {
      const int c = e / (TN / 4), t = 4 * (e % (TN / 4));
      const int gj = j0 + t;
      const bool ok = gj < n;
      cp_async16(&Hs[c * HSTR + t], ok ? H + (size_t)c * n + gj : H, ok);
    }
  } else {
    for (int e = tid; e < TM * TN; e += NT) {
      const int r = e / TN, t = e % TN;
      const int gi = i0 + r, gj = j0 + t;
      const bool ok = gi < m && gj < n;
      cp_async4(&Vs[r * TN + t], ok ? V + (size_t)gi * n + gj : V, ok);
    }
    for (int e = tid; e < k * TN; e += NT) {
      const int c = e / TN, t = e % TN;
      const int gj = j0 + t;
      const bool ok = gj < n;
      cp_async4(&Hs[c * HSTR + t], ok ? H + (size_t)c * n + gj : H, ok);
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(NT)
kl_dma_kernel(const float* __restrict__ V, const float* __restrict__ W,
              const float* __restrict__ H, float* __restrict__ out, int m,
              int n, int k, bool vec) {
  extern __shared__ float4 smem4[];
  const int kr = round16(k);
  float* Ws = reinterpret_cast<float*>(smem4);   // [kr][TM]
  float* Vs = Ws + (size_t)kr * TM;              // [STAGES][TM][TN]
  float* Hs = Vs + STAGES * TM * TN;             // [STAGES][kr][HSTR]
  float* Ps = Hs + (size_t)STAGES * kr * HSTR;   // [TM][HSTR]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.x * TM;
  const int tiles = cdiv(n, TN);

  // Tile 0 in flight first; the W rows and the zero pad rows of H
  // (k..kr-1, never written by the copies) load meanwhile.
  load_tile(V, H, Vs, Hs, m, n, k, i0, 0, vec);
  cp_async_commit();
  for (int e = tid; e < TM * kr; e += NT) {
    const int r = e / kr, c = e % kr, gi = i0 + r;
    Ws[c * TM + r] = (gi < m && c < k) ? W[(size_t)gi * k + c] : 0.f;
  }
  for (int e = tid; e < STAGES * (kr - k) * HSTR; e += NT) {
    const int s = e / ((kr - k) * HSTR), q = e % ((kr - k) * HSTR);
    Hs[(size_t)s * kr * HSTR + (size_t)k * HSTR + q] = 0.f;
  }

  float o[RM][NB];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) o[a][b] = 0.f;

  for (int jt = 0; jt < tiles; ++jt) {
    const int s = jt % STAGES;
    if (jt + 1 < tiles)
      load_tile(V, H, Vs + ((jt + 1) % STAGES) * TM * TN,
                Hs + (size_t)((jt + 1) % STAGES) * kr * HSTR, m, n, k, i0,
                jt + 1, vec);
    cp_async_commit();   // possibly empty: keeps one group per tile
    cp_async_wait<1>();  // all but the newest group done: tile jt has landed
    __syncthreads();
    const float* Vt = Vs + s * TM * TN;
    const float* Ht = Hs + (size_t)s * kr * HSTR;

    // V_hat[RM*ty + a, 2*tx + b] over c = 0..k-1, in order.
    float vh[RM][2];
#pragma unroll
    for (int a = 0; a < RM; ++a) vh[a][0] = vh[a][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < k; ++c) {
      const float2 h = *reinterpret_cast<const float2*>(&Ht[c * HSTR + 2 * tx]);
      const float2 w2 = *reinterpret_cast<const float2*>(&Ws[c * TM + 2 * ty]);
      const float w[RM] = {w2.x, w2.y};
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        vh[a][0] = fmaf(w[a], h.x, vh[a][0]);
        vh[a][1] = fmaf(w[a], h.y, vh[a][1]);
      }
    }
    // The ratio, zero outside the matrix.
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int r = RM * ty + a, gi = i0 + r, t = 2 * tx, gj = jt * TN + t;
      const float2 v = *reinterpret_cast<const float2*>(&Vt[r * TN + t]);
      float2 p;
      p.x = (gi < m && gj < n) ? v.x / vh[a][0] : 0.f;
      p.y = (gi < m && gj + 1 < n) ? v.y / vh[a][1] : 0.f;
      *reinterpret_cast<float2*>(&Ps[r * HSTR + t]) = p;
    }
    __syncthreads();

    // o[a][b] += sum_t Ps[RM*ty + a, t] * Ht[tx + 16 b, t]
#pragma unroll
    for (int t = 0; t < TN; t += 4) {
      float4 p[RM];
#pragma unroll
      for (int a = 0; a < RM; ++a)
        p[a] = *reinterpret_cast<const float4*>(&Ps[(RM * ty + a) * HSTR + t]);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (16 * b < k) {  // uniform over the block
          const float4 h = *reinterpret_cast<const float4*>(&Ht[(tx + 16 * b) * HSTR + t]);
#pragma unroll
          for (int a = 0; a < RM; ++a) {
            o[a][b] = fmaf(p[a].x, h.x, o[a][b]);
            o[a][b] = fmaf(p[a].y, h.y, o[a][b]);
            o[a][b] = fmaf(p[a].z, h.z, o[a][b]);
            o[a][b] = fmaf(p[a].w, h.w, o[a][b]);
          }
        }
      }
    }
    __syncthreads();  // stage s is refilled by the next iteration's copies
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int gi = i0 + RM * ty + a;
    if (gi >= m) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int c = tx + 16 * b;
      if (c < k) out[(size_t)gi * k + c] = o[a][b];
    }
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, float*,
                          int, int, int, bool);

KernelFn kernel_for(int k) {
  if (k <= 32) return kl_dma_kernel<2>;
  if (k <= 64) return kl_dma_kernel<4>;
  if (k <= 128) return kl_dma_kernel<8>;
  if (k <= 256) return kl_dma_kernel<16>;
  return kl_dma_kernel<32>;
}

}  // namespace

extern "C" {

// The dma kernel's dynamic shared memory per block, in bytes.
long long nmf_dma_smem_bytes(int k) {
  return (long long)sizeof(float) * dma_smem_floats(k);
}

// out (m, k) = (V / (W H)) @ H'.  1 <= k <= 512; returns cudaGetLastError()
// (cudaErrorInvalidValue for k outside that range).
int nmf_kl_phi_dot_ht_dma(const float* V, const float* W, const float* H,
                          float* out, int m, int n, int k, void* stream) {
  if (k < 1 || k > MAX_K || m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(V) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(H) % 16 == 0;
  const KernelFn fn = kernel_for(k);
  const size_t smem = sizeof(float) * dma_smem_floats(k);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<cdiv(m, TM), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      V, W, H, out, m, n, k, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
