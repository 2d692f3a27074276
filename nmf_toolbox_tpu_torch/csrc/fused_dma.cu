// Streamed KL W-phase kernel for Hopper (sm_90a), f32:
//   out (m, k) = (V / (W H)) @ H'
//
// CUDA counterpart of the Pallas kernel in
// nmf_toolbox_tpu/ops/pallas/fused_dma.py (kl_phi_dot_ht_dma), the
// manually double-buffered variant of the fused W-phase.  Where
// fused.cu's phase_kernel cuts k into output chunks of at most 128 (each
// rebuilding V_hat over all of k) and may cut the n loop into spans
// summed by a second kernel, this kernel:
//   * gives one block a TM-row block of the output for the whole n loop:
//     the sum over n stays in the block's registers, with no span split,
//     scratch buffer or second kernel, so reruns give identical bits;
//   * keeps the block's W rows (TM x k) resident in shared memory, as the
//     Pallas kernel keeps its W row block in VMEM;
//   * streams each V tile (TM x TN) and the H tile it meets (k x TN)
//     through a two-stage cp.async ring: the copy of tile j+1 is issued
//     before the compute on tile j, as the Pallas kernel's two-slot
//     make_async_copy buffer does;
//   * builds V_hat over all of k once per tile, for every k <= 512.
//
// Both products run on the tensor cores in 3xTF32 (mma.sync m16n8k8), as
// in fused.cu: an f32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), a product is lo*hi + hi*lo + hi*hi (small terms first,
// lo*lo dropped) with f32 accumulation.  The tensor cores truncate as
// they accumulate, so each tile's second product starts from zeroed
// fragments and reaches the running output through one rounded f32 add.
// Each landed H tile is split once for all warps (hi in place, lo
// beside it); the resident W rows are split as they are read, since a
// hi/lo copy of them beside the H ring costs a block per SM (PERF.md §6).
//
// Warps: RW row groups of 16 rows by CW column groups.  Warp (rg, cg)
// owns output rows 16 rg.. and the cg-th group of kcw <= 128 columns of
// k, whose 16 x kcw accumulators (kcw / 2 a thread) stay in its
// registers for the whole loop.  Per tile it forms its part of V_hat,
// the contraction over its own columns of k, for its 16 rows and all TN
// columns.  With one column group that is V_hat itself; with several,
// the parts pass through shared memory and each warp adds its row
// group's CW parts in a fixed order.  The field V / V_hat is then formed
// in registers in the accumulator layout and fed to the second product
// as the A operand straight from registers, with the loop index permuted
// inside each group of 8 (as fused.cu does), against the H tile's rows
// of the warp's output columns.  The tier (RW, CW, output subtiles per
// warp) is picked per launch from k: see TIERS.
//
// Bound on the H100: arithmetic.  4mnk FLOPs against one 4mn-byte read
// of V: about 100 FLOP/byte at k = 100.
//
// Scope: 1 <= k <= 512 (the Pallas kernel's documented scope), any
// (m, n).  Rows past m and columns past n load as zero and no ratio is
// formed there; inside the matrix the ratio carries no guard, as in
// Pallas.  Row-major contiguous operands.

#include "tile_ops.cuh"

namespace {

constexpr int TN = 24;      // V columns per loop tile
// Stride of the [c][l] H tiles and the [r][l] V and V_hat-part tiles: 24
// mod 32, so each warp's fragment loads (at (t, g) and float2 at (g, 2t))
// hit 32 distinct banks.  The [r][c] W rows use k8 + 4 (4 mod 8).
constexpr int CS = TN;
constexpr int STAGES = 2;   // cp.async ring depth
constexpr int MAX_K = 512;

__host__ __device__ constexpr int kpad(int k) { return 8 * cdiv(k, 8); }

// Block of RW x CW warps: rows 16 RW, output columns of k in CW groups of
// at most 8 NKW.
template <int RW, int CW, int NKW>
__global__ void __launch_bounds__(32 * RW * CW, CW == 1 ? 2 : 1)
kl_dma_kernel(const float* __restrict__ V, const float* __restrict__ W,
              const float* __restrict__ H, float* __restrict__ out, int m,
              int n, int k, bool vec, bool vecw) {
  constexpr int NT = 32 * RW * CW, TM = 16 * RW, NJ = TN / 8;
  extern __shared__ float4 smem4[];
  const int k8 = kpad(k), ks = k8 + 4;
  const int kcw = 8 * cdiv(k8 / 8, CW);        // columns of k per column group
  float* Ws = reinterpret_cast<float*>(smem4);  // [TM][ks] W rows
  float* Hs0 = Ws + TM * ks;                    // [STAGES][k8][CS] H tiles
  float* Hl = Hs0 + STAGES * k8 * CS;           // [k8][CS] lo of the current one
  float* Vs0 = Hl + k8 * CS;                    // [STAGES][TM][CS] V tiles
  float* Xs = Vs0 + STAGES * TM * CS;           // [CW][TM][CS] V_hat parts (CW > 1)

  const int r0 = blockIdx.x * TM, tiles = cdiv(n, TN);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5, cg = warp % CW;
  const int wr = 16 * (warp / CW);  // this warp's first row
  const int c0 = cg * kcw;          // its first column of k
  const int nk = k8 > c0 ? min(kcw, k8 - c0) / 8 : 0;  // its k-steps

  // Tile q: H rows 0..k8 (zero from k) and V rows r0.., columns q TN..
  auto issue = [&](int q) {
    const int st = q % STAGES, l0 = q * TN;
    copy_tile<NT>(Hs0 + st * k8 * CS, CS, H, n, 0, l0, k8, TN, k, n, vec);
    copy_tile<NT>(Vs0 + st * TM * CS, CS, V, n, r0, l0, TM, TN, m, n, vec);
  };
  // The W rows (zero past m and k) travel with tile 0.
  copy_tile<NT>(Ws, ks, W, k, r0, 0, TM, k8, m, k, vecw);
  issue(0);
  cp_async_commit();

  // o[p]: rows (g, g + 8) x columns c0 + 8p + (2t, 2t + 1).
  float o[NKW][4];
#pragma unroll
  for (int p = 0; p < NKW; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[p][e] = 0.f;

  for (int q = 0; q < tiles; ++q) {
    if (q + 1 < tiles) issue(q + 1);
    cp_async_commit();   // possibly empty: keeps one group per tile
    cp_async_wait<1>();  // all but the newest group done: tile q has landed
    __syncthreads();
    const int st = q % STAGES, l0 = q * TN;
    float* Hs = Hs0 + st * k8 * CS;
    const float* Vt = Vs0 + st * TM * CS;
    split_tile<NT>(Hs, Hl, k8 * CS);
    __syncthreads();

    // This warp's part of V_hat (rows wr.., the tile's TN columns): acc
    // the hi*hi products, acs the two small ones, as two chains.
    float acc[NJ][4], acs[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = acs[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk) {
      const int c = c0 + 8 * kk + t, a0 = (wr + g) * ks + c;
      const int ia[4] = {a0, a0 + 8 * ks, a0 + 4, a0 + 8 * ks + 4};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(Ws[ia[i]], ah[i], al[i]);
      uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        bh[j][0] = __float_as_uint(Hs[c * CS + 8 * j + g]);
        bh[j][1] = __float_as_uint(Hs[(c + 4) * CS + 8 * j + g]);
        bl[j][0] = __float_as_uint(Hl[c * CS + 8 * j + g]);
        bl[j][1] = __float_as_uint(Hl[(c + 4) * CS + 8 * j + g]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma(acs[j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma(acs[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma(acc[j], ah, bh[j][0], bh[j][1]);
    }
    // vh[j]: V_hat at rows (g, g + 8) x columns 8j + (2t, 2t + 1).
    float vh[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) vh[j][e] = acs[j][e] + acc[j][e];
    if constexpr (CW > 1) {
      // Parts through shared memory, added over column groups in order.
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(&Xs[(cg * TM + wr + g + 8 * h) * CS + 8 * j + 2 * t]) =
              make_float2(vh[j][2 * h], vh[j][2 * h + 1]);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = (wr + g + 8 * h) * CS + 8 * j + 2 * t;
          float2 s = *reinterpret_cast<const float2*>(&Xs[i]);
#pragma unroll
          for (int u = 1; u < CW; ++u) {
            const float2 x = *reinterpret_cast<const float2*>(&Xs[u * TM * CS + i]);
            s.x += x.x;
            s.y += x.y;
          }
          vh[j][2 * h] = s.x;
          vh[j][2 * h + 1] = s.y;
        }
    }

    // The field, split, in A order: (g, l) (g+8, l) (g, l+1) (g+8, l+1)
    // with l = 8j + 2t; zero outside the matrix.
    uint32_t ph[NJ][4], pl[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int l = 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + g + 8 * h;
        const float2 v = *reinterpret_cast<const float2*>(&Vt[r * CS + l]);
        const bool in_r = r0 + r < m;
        const bool in0 = in_r && l0 + l < n, in1 = in_r && l0 + l + 1 < n;
        split(in0 ? v.x / vh[j][2 * h] : 0.f, ph[j][h], pl[j][h]);
        split(in1 ? v.y / vh[j][2 * h + 1] : 0.f, ph[j][h + 2], pl[j][h + 2]);
      }
    }
    // out += field x H' over this tile: the field's fragment j meets H
    // rows c0 + 8p + g at columns (8j + 2t, 8j + 2t + 1).  GP output
    // subtiles at a time, with no branch inside a group, keep 2 GP chains
    // in flight; a subtile past the warp's columns reads a valid row and
    // its sums are never stored.
    constexpr int GP = 2;
#pragma unroll
    for (int p0 = 0; p0 < NKW; p0 += GP) {
      if (p0 < nk) {
        float s[GP][4], hh[GP][4];
#pragma unroll
        for (int i = 0; i < GP; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] = hh[i][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int i = 0; i < GP; ++i) {
            const int c = c0 + min(8 * (p0 + i), 8 * (nk - 1)) + g, l = 8 * j + 2 * t;
            const float2 bh = *reinterpret_cast<const float2*>(&Hs[c * CS + l]);
            const float2 bl = *reinterpret_cast<const float2*>(&Hl[c * CS + l]);
            const uint32_t b0h = __float_as_uint(bh.x), b1h = __float_as_uint(bh.y);
            mma(s[i], pl[j], b0h, b1h);
            mma(s[i], ph[j], __float_as_uint(bl.x), __float_as_uint(bl.y));
            mma(hh[i], ph[j], b0h, b1h);
          }
        }
#pragma unroll
        for (int i = 0; i < GP; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[p0 + i][e] += s[i][e] + hh[i][e];
      }
    }
    __syncthreads();  // stage st and Hl are refilled next
  }

#pragma unroll
  for (int p = 0; p < NKW; ++p) {
    if (p >= nk) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + wr + g + 8 * (e >> 1), c = c0 + 8 * p + 2 * t + (e & 1);
      if (r < m && c < k) out[(size_t)r * k + c] = o[p][e];
    }
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, float*,
                          int, int, int, bool, bool);

struct Tier {
  int max_k;     // the largest k this tier takes
  int rw, cw;    // row groups of 16 rows, column groups of k
  KernelFn fn;
};

template <int MAXK, int RW, int CW, int NKW>
Tier tier() {
  static_assert(8 * NKW * CW >= kpad(MAXK), "a warp's accumulators must cover its columns");
  return {MAXK, RW, CW, kl_dma_kernel<RW, CW, NKW>};
}

// The first tier whose max_k covers k launches.  Up to k = 128, one
// column group (V_hat in registers) on 64-row blocks of 4 warps, 3
// blocks per SM at k = 100; above, 48-row blocks with the columns in 2
// groups up to k = 256 (2 blocks per SM up to k = 200) and in 4 up to k
// = 424, the largest k whose block fits; beyond, 32-row blocks.  48-row
// blocks put every block of a 10 000-row problem on the card at once
// (209 blocks, 2 per SM on 132 SMs).  A source that defines
// NMF_DMA_TIERS before including this file launches its own table
// (benchmarks_torch/dma_tiers.py).
#ifndef NMF_DMA_TIERS
#define NMF_DMA_TIERS                                      \
  tier<128, 4, 1, 16>(), tier<256, 3, 2, 16>(),           \
      tier<424, 3, 4, 16>(), tier<MAX_K, 2, 4, 16>()
#endif
const Tier TIERS[] = {NMF_DMA_TIERS};

const Tier& tier_for(int k) {
  int i = 0;
  while (TIERS[i].max_k < k) ++i;
  return TIERS[i];
}

// Shared-memory floats of one block of tier t at k: the W rows, the H
// ring and the lo of the current H tile, the V ring, and the V_hat parts
// of several column groups.
size_t dma_floats(const Tier& t, int k) {
  const size_t tm = 16 * t.rw, k8 = kpad(k);
  return tm * (k8 + 4) + (STAGES + 1) * k8 * CS +
         STAGES * tm * CS + (t.cw > 1 ? t.cw * tm * CS : 0);
}

}  // namespace

extern "C" {

// The dma kernel's dynamic shared memory per block, in bytes (0 for k
// outside 1..512).
long long nmf_dma_smem_bytes(int k) {
  if (k < 1 || k > MAX_K) return 0;
  return (long long)(sizeof(float) * dma_floats(tier_for(k), k));
}

// The tier that k launches (its index in TIERS; -1 for k outside
// 1..512), and in info: rows per block, warps per block, column groups,
// and blocks per SM from the occupancy API on the current device (0 if
// that fails).
int nmf_dma_tier(int k, int* info) {
  if (k < 1 || k > MAX_K) return -1;
  const Tier& t = tier_for(k);
  const int threads = 32 * t.rw * t.cw, smem = (int)nmf_dma_smem_bytes(k);
  int per_sm = 0;
  if (cudaFuncSetAttribute(t.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, t.fn, threads, smem) != cudaSuccess)
    per_sm = 0;
  info[0] = 16 * t.rw;
  info[1] = threads / 32;
  info[2] = t.cw;
  info[3] = per_sm;
  return (int)(&t - TIERS);
}

// out (m, k) = (V / (W H)) @ H'.  1 <= k <= 512; returns cudaGetLastError()
// (cudaErrorInvalidValue for k outside that range).
int nmf_kl_phi_dot_ht_dma(const float* V, const float* W, const float* H,
                          float* out, int m, int n, int k, void* stream) {
  if (k < 1 || k > MAX_K || m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const Tier& t = tier_for(k);
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(V) |
                                   reinterpret_cast<uintptr_t>(H)) % 16 == 0;
  const bool vecw = k % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  const size_t smem = sizeof(float) * dma_floats(t, k);
  cudaError_t err = cudaFuncSetAttribute(
      t.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  t.fn<<<cdiv(m, 16 * t.rw), 32 * t.rw * t.cw, smem, s>>>(V, W, H, out, m, n, k, vec, vecw);
  return (int)cudaGetLastError();
}

}  // extern "C"
