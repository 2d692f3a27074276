// Fused KL / IS multiplicative-update kernels for Hopper (sm_90a), f32.
//
// CUDA counterparts of the three Pallas kernels in
// nmf_toolbox_tpu/ops/pallas/fused.py (phi_dot_ht, wt_dot_phi,
// cost_terms).  Each rebuilds tiles of the reconstruction V_hat = W H in
// registers with f32 FMAs on the CUDA cores, applies the divergence
// field elementwise and contracts it in the same pass, so neither V_hat
// nor the field ever reaches device memory.  Tensor cores are not used.
//
// Layouts: V (m, n), W (m, k), H (k, n), all row-major and contiguous.
// Any (m, n) and 1 <= k <= 1024: ragged edges are bounds-checked (zero
// loads outside the matrix, no field computed there), and inside the
// matrix the fields carry no guard, exactly as the Pallas kernels.
//
// Blocks run in no fixed order, so nothing carries between blocks:
//   * W-phase: a block owns TM rows of the (m, k) output and loops over
//     a span of n inside the block.
//   * H-phase: a block owns TN columns of the (k, n) output and loops
//     over a span of m inside the block.
//   * cost: each block writes its tile's sum to a partial buffer; a
//     second one-block kernel adds the partials in a fixed order, so
//     repeated runs give identical bits (no atomics).
// The phases split their loop axis into spans (blockIdx.z) when the
// output alone gives too few blocks to fill the card: each span writes
// a partial output, and a second kernel adds the partials in span order,
// so results stay deterministic.  span_tiles() picks the spans from the
// SM count.
// The output's k axis is cut into KC-wide chunks over blockIdx.y; a
// block rebuilds the full V_hat tile (a reduction over all of k) for its
// chunk, so k > KC costs ceil(k / KC) rebuilds of V_hat.  The main
// shapes (k <= 128) run one chunk.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;   // threads per block, viewed as a 16 x 16 grid
constexpr int TM = 64;    // V rows per tile (4 per thread row)
constexpr int TN = 64;    // V columns per tile (4 per thread column)
constexpr int KB = 16;    // k-depth of one V_hat step
constexpr int KC = 128;   // output k-chunk per block
constexpr int WSTR = TM + 4;  // padded row of the transposed W step buffer

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// acc[a][b] = V_hat[i0 + ty*4 + a, j0 + tx + 16*b] for the TM x TN tile,
// summed over c = 0..k-1 in order with f32 FMAs.  W and H stream through
// the step buffers Ws[KB][WSTR] (transposed) and Hs[KB][TN].  Entries
// outside the matrix come out 0.  Ends with a barrier, so the caller may
// reuse the buffers.
__device__ __forceinline__ void vhat_tile(const float* __restrict__ W,
                                          const float* __restrict__ H,
                                          int m, int n, int k, int i0, int j0,
                                          float* Ws, float* Hs,
                                          float (&acc)[4][TN / 16]) {
  constexpr int RN = TN / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < RN; ++b) acc[a][b] = 0.f;

  for (int c0 = 0; c0 < k; c0 += KB) {
#pragma unroll
    for (int q = 0; q < TM * KB / NT; ++q) {  // lanes run along c: coalesced
      const int e = tid + q * NT, r = e / KB, c = e % KB;
      const int gi = i0 + r, gc = c0 + c;
      Ws[c * WSTR + r] = (gi < m && gc < k) ? W[(size_t)gi * k + gc] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < KB * TN / NT; ++q) {  // lanes run along t: coalesced
      const int e = tid + q * NT, c = e / TN, t = e % TN;
      const int gc = c0 + c, gj = j0 + t;
      Hs[c * TN + t] = (gc < k && gj < n) ? H[(size_t)gc * n + gj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KB; ++c) {
      const float4 w = *reinterpret_cast<const float4*>(&Ws[c * WSTR + ty * 4]);
      float h[RN];
#pragma unroll
      for (int b = 0; b < RN; ++b) h[b] = Hs[c * TN + tx + 16 * b];
#pragma unroll
      for (int b = 0; b < RN; ++b) {
        acc[0][b] = fmaf(w.x, h[b], acc[0][b]);
        acc[1][b] = fmaf(w.y, h[b], acc[1][b]);
        acc[2][b] = fmaf(w.z, h[b], acc[2][b]);
        acc[3][b] = fmaf(w.w, h[b], acc[3][b]);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// W-phase: out1 = Phi1 @ H', out2 = Phi2 @ H' (IS only), both (m, k).
// kl: Phi1 = V / V_hat.   is: Phi1 = V / V_hat^2, Phi2 = 1 / V_hat.
// ---------------------------------------------------------------------------

constexpr int W_HSTR = KC + 4;  // padded row of H3[t][c]

template <bool IS>
constexpr size_t w_phase_smem() {
  return sizeof(float) * (KB * WSTR + KB * TN + TN * W_HSTR
                          + (IS ? 2 : 1) * TN * WSTR);
}

// Block (x, y, z): rows x*TM.., output columns y*KC.., columns of V in
// [z*span, (z+1)*span); writes out[z] (each out an (m, k) array).
template <bool IS>
__global__ void __launch_bounds__(NT, 2)
w_phase_kernel(const float* __restrict__ V, const float* __restrict__ W,
               const float* __restrict__ H, float* __restrict__ out1,
               float* __restrict__ out2, int m, int n, int k, int span) {
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);  // [KB][WSTR]
  float* Hs = Ws + KB * WSTR;                   // [KB][TN]
  float* H3 = Hs + KB * TN;                     // [TN][W_HSTR]: H[kc0 + c, j0 + t]
  float* P1 = H3 + TN * W_HSTR;                 // [TN][WSTR]: Phi1[i0 + r, j0 + t]
  float* P2 = P1 + TN * WSTR;                   // IS only

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.x * TM, kc0 = blockIdx.y * KC;
  const int j_begin = blockIdx.z * span, j_end = min(n, j_begin + span);
  out1 += (size_t)blockIdx.z * m * k;
  if (IS) out2 += (size_t)blockIdx.z * m * k;

  float o1[4][8], o2[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) o1[a][b] = o2[a][b] = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += TN) {
    float acc[4][TN / 16];
    vhat_tile(W, H, m, n, k, i0, j0, Ws, Hs, acc);

    // Fields for this thread's 4 x 4 entries, stored transposed.
#pragma unroll
    for (int b = 0; b < TN / 16; ++b) {
      const int t = tx + 16 * b, gj = j0 + t;
      float p1[4], p2[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int gi = i0 + ty * 4 + a;
        p1[a] = 0.f;
        p2[a] = 0.f;
        if (gi < m && gj < n) {
          const float v = V[(size_t)gi * n + gj], vh = acc[a][b];
          if (IS) {
            p1[a] = v / (vh * vh);
            p2[a] = 1.f / vh;
          } else {
            p1[a] = v / vh;
          }
        }
      }
      *reinterpret_cast<float4*>(&P1[t * WSTR + ty * 4]) =
          make_float4(p1[0], p1[1], p1[2], p1[3]);
      if (IS)
        *reinterpret_cast<float4*>(&P2[t * WSTR + ty * 4]) =
            make_float4(p2[0], p2[1], p2[2], p2[3]);
    }
    // This block's k-chunk of the H tile, transposed.
#pragma unroll 4
    for (int q = 0; q < KC * TN / NT; ++q) {
      const int e = tid + q * NT, c = e / TN, t = e % TN;
      const int gc = kc0 + c, gj = j0 + t;
      H3[t * W_HSTR + c] = (gc < k && gj < n) ? H[(size_t)gc * n + gj] : 0.f;
    }
    __syncthreads();

    // o[a][b] += sum_t Phi[ty*4 + a, t] * H[kc0 + tx*8 + b, t]
#pragma unroll 4
    for (int t = 0; t < TN; ++t) {
      const float4 p = *reinterpret_cast<const float4*>(&P1[t * WSTR + ty * 4]);
      const float4 h0 = *reinterpret_cast<const float4*>(&H3[t * W_HSTR + tx * 8]);
      const float4 h1 = *reinterpret_cast<const float4*>(&H3[t * W_HSTR + tx * 8 + 4]);
      const float pa[4] = {p.x, p.y, p.z, p.w};
      const float hb[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) o1[a][b] = fmaf(pa[a], hb[b], o1[a][b]);
      if (IS) {
        const float4 s = *reinterpret_cast<const float4*>(&P2[t * WSTR + ty * 4]);
        const float sa[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) o2[a][b] = fmaf(sa[a], hb[b], o2[a][b]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gi = i0 + ty * 4 + a;
    if (gi >= m) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int gc = kc0 + tx * 8 + b;
      if (gc < k) {
        out1[(size_t)gi * k + gc] = o1[a][b];
        if (IS) out2[(size_t)gi * k + gc] = o2[a][b];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// H-phase: out1 = W' @ Phi1, out2 = W' @ Phi2 (IS only), both (k, n).
// ---------------------------------------------------------------------------

template <bool IS>
constexpr size_t h_phase_smem() {
  return sizeof(float) * (KB * WSTR + KB * TN + TM * KC + (IS ? 2 : 1) * TM * TN);
}

// Block (x, y, z): columns x*TN.., output rows y*KC.., rows of V in
// [z*span, (z+1)*span); writes out[z] (each out a (k, n) array).
template <bool IS>
__global__ void __launch_bounds__(NT, 2)
h_phase_kernel(const float* __restrict__ V, const float* __restrict__ W,
               const float* __restrict__ H, float* __restrict__ out1,
               float* __restrict__ out2, int m, int n, int k, int span) {
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);  // [KB][WSTR]
  float* Hs = Ws + KB * WSTR;                   // [KB][TN]
  float* W3 = Hs + KB * TN;                     // [TM][KC]: W[i0 + r, kc0 + c]
  float* P1 = W3 + TM * KC;                     // [TM][TN]: Phi1[i0 + r, j0 + t]
  float* P2 = P1 + TM * TN;                     // IS only

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int j0 = blockIdx.x * TN, kc0 = blockIdx.y * KC;
  const int i_begin = blockIdx.z * span, i_end = min(m, i_begin + span);
  out1 += (size_t)blockIdx.z * k * n;
  if (IS) out2 += (size_t)blockIdx.z * k * n;

  float o1[8][4], o2[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) o1[a][b] = o2[a][b] = 0.f;

  for (int i0 = i_begin; i0 < i_end; i0 += TM) {
    float acc[4][TN / 16];
    vhat_tile(W, H, m, n, k, i0, j0, Ws, Hs, acc);

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a, gi = i0 + r;
#pragma unroll
      for (int b = 0; b < TN / 16; ++b) {
        const int t = tx + 16 * b, gj = j0 + t;
        float p1 = 0.f, p2 = 0.f;
        if (gi < m && gj < n) {
          const float v = V[(size_t)gi * n + gj], vh = acc[a][b];
          if (IS) {
            p1 = v / (vh * vh);
            p2 = 1.f / vh;
          } else {
            p1 = v / vh;
          }
        }
        P1[r * TN + t] = p1;
        if (IS) P2[r * TN + t] = p2;
      }
    }
    // This block's k-chunk of the W tile.
#pragma unroll 4
    for (int q = 0; q < TM * KC / NT; ++q) {
      const int e = tid + q * NT, r = e / KC, c = e % KC;
      const int gi = i0 + r, gc = kc0 + c;
      W3[r * KC + c] = (gi < m && gc < k) ? W[(size_t)gi * k + gc] : 0.f;
    }
    __syncthreads();

    // o[a][b] += sum_r W[i0 + r, kc0 + ty*8 + a] * Phi[r, tx*4 + b]
#pragma unroll 4
    for (int r = 0; r < TM; ++r) {
      const float4 w0 = *reinterpret_cast<const float4*>(&W3[r * KC + ty * 8]);
      const float4 w1 = *reinterpret_cast<const float4*>(&W3[r * KC + ty * 8 + 4]);
      const float4 p = *reinterpret_cast<const float4*>(&P1[r * TN + tx * 4]);
      const float wa[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float pb[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) o1[a][b] = fmaf(wa[a], pb[b], o1[a][b]);
      if (IS) {
        const float4 q = *reinterpret_cast<const float4*>(&P2[r * TN + tx * 4]);
        const float qb[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) o2[a][b] = fmaf(wa[a], qb[b], o2[a][b]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int gc = kc0 + ty * 8 + a;
    if (gc >= k) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gj = j0 + tx * 4 + b;
      if (gj < n) {
        out1[(size_t)gc * n + gj] = o1[a][b];
        if (IS) out2[(size_t)gc * n + gj] = o2[a][b];
      }
    }
  }
}

// out[i] = sum over spans z, in order, of part[z * count + i].
__global__ void __launch_bounds__(NT)
sum_spans_kernel(const float* __restrict__ part, int spans, size_t count,
                 float* __restrict__ out) {
  const size_t stride = (size_t)gridDim.x * NT;
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < count; i += stride) {
    float s = part[i];
    for (int z = 1; z < spans; ++z) s += part[(size_t)z * count + i];
    out[i] = s;
  }
}

// ---------------------------------------------------------------------------
// Cost terms.  kl: s1 = sum V * log(V_hat).  is: s1 = sum log(V_hat),
// s2 = sum V / V_hat.  Terms are f32 (as the Pallas kernel forms them);
// their sums are f64, in a fixed order.
// ---------------------------------------------------------------------------

constexpr int RED_NT = 1024;

constexpr size_t cost_smem() {
  return sizeof(float) * (KB * WSTR + KB * TN) + sizeof(double) * NT;
}

// Fixed-order tree sum of red[0..count) (count a power of two, every
// thread of the block taking part); returns the total to all threads.
__device__ __forceinline__ double block_sum(double* red, int count) {
  for (int s = count / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const double total = red[0];
  __syncthreads();
  return total;
}

template <bool IS>
__global__ void __launch_bounds__(NT)
cost_tile_kernel(const float* __restrict__ V, const float* __restrict__ W,
                 const float* __restrict__ H, double* __restrict__ part1,
                 double* __restrict__ part2, int m, int n, int k) {
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);
  float* Hs = Ws + KB * WSTR;
  double* red = reinterpret_cast<double*>(Hs + KB * TN);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int j0 = blockIdx.x * TN, i0 = blockIdx.y * TM;
  float acc[4][TN / 16];
  vhat_tile(W, H, m, n, k, i0, j0, Ws, Hs, acc);

  double s1 = 0.0, s2 = 0.0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gi = i0 + ty * 4 + a;
#pragma unroll
    for (int b = 0; b < TN / 16; ++b) {
      const int gj = j0 + tx + 16 * b;
      if (gi < m && gj < n) {
        const float v = V[(size_t)gi * n + gj], vh = acc[a][b];
        if (IS) {
          s1 += (double)logf(vh);
          s2 += (double)(v / vh);
        } else {
          s1 += (double)(v * logf(vh));
        }
      }
    }
  }
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  red[tid] = s1;
  __syncthreads();
  s1 = block_sum(red, NT);
  if (tid == 0) part1[blk] = s1;
  if (IS) {
    red[tid] = s2;
    __syncthreads();
    s2 = block_sum(red, NT);
    if (tid == 0) part2[blk] = s2;
  }
}

// out[0] = (float) sum(part[0..count)), in a fixed order.
__global__ void __launch_bounds__(RED_NT)
reduce_partials_kernel(const double* __restrict__ part, size_t count,
                       float* __restrict__ out) {
  __shared__ double red[RED_NT];
  double s = 0.0;
  for (size_t i = threadIdx.x; i < count; i += RED_NT) s += part[i];
  red[threadIdx.x] = s;
  __syncthreads();
  s = block_sum(red, RED_NT);
  if (threadIdx.x == 0) out[0] = (float)s;
}

// Spans to cut a loop of `tiles` tiles into, for a grid of `blocks`
// blocks per span: enough blocks for about 8 per SM (4 waves at 2
// resident blocks), each span keeping at least 8 tiles, and no empty
// span.  Returns the tiles per span.
int span_tiles(int blocks, int tiles) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 0;  // the launch that follows reports the error
  int spans = cdiv(8 * sms, blocks);
  if (spans > tiles / 8) spans = tiles / 8;
  if (spans < 1) spans = 1;
  return cdiv(tiles, spans);
}

// Launch the (x, y, spans) grid of a phase kernel into `out` directly
// (one span) or into `part` followed by the span sum.
// `tiles` counts the loop axis in tiles of `tile` elements; dynamic
// shared memory above 48 KB needs the kernel's opt-in.
template <typename Kernel>
cudaError_t launch_phase(Kernel kernel, size_t smem, dim3 grid, int tiles,
                         int tile, const float* V, const float* W,
                         const float* H, float* out1, float* out2, float* part,
                         size_t count, int m, int n, int k, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int per = span_tiles(grid.x * grid.y, tiles);
  grid.z = cdiv(tiles, per);
  if (grid.z == 1) {
    kernel<<<grid, NT, smem, s>>>(V, W, H, out1, out2, m, n, k, per * tile);
    return cudaGetLastError();
  }
  float* part2 = out2 ? part + (size_t)grid.z * count : nullptr;
  kernel<<<grid, NT, smem, s>>>(V, W, H, part, part2, m, n, k, per * tile);
  const int blocks = (int)((count + NT - 1) / NT < 65535 ? (count + NT - 1) / NT : 65535);
  sum_spans_kernel<<<blocks, NT, 0, s>>>(part, grid.z, count, out1);
  if (out2) sum_spans_kernel<<<blocks, NT, 0, s>>>(part2, grid.z, count, out2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nmf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of scratch a phase needs for its span partials (0: none).
// phase: 0 = W-phase (phi_dot_ht), 1 = H-phase (wt_dot_phi); mode: 0 =
// kl, 1 = is.  Reads the current device's SM count, as the launch does.
long long nmf_phase_scratch(int phase, int m, int n, int k, int mode) {
  const int kc = cdiv(k, KC);
  const int blocks = phase == 0 ? cdiv(m, TM) * kc : cdiv(n, TN) * kc;
  const int tiles = phase == 0 ? cdiv(n, TN) : cdiv(m, TM);
  const int spans = cdiv(tiles, span_tiles(blocks, tiles));
  const long long count = (long long)(phase == 0 ? m : n) * k;
  return spans == 1 ? 0 : (mode == 1 ? 2 : 1) * spans * count;
}

// mode: 0 = kl (out2 unused, may be NULL), 1 = is.  part: the scratch
// nmf_phase_scratch(0, ...) asks for (NULL when it asks for none).
int nmf_phi_dot_ht(const float* V, const float* W, const float* H,
                   float* out1, float* out2, float* part, int m, int n, int k,
                   int mode, void* stream) {
  const dim3 grid(cdiv(m, TM), cdiv(k, KC));
  const size_t count = (size_t)m * k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1)
    return (int)launch_phase(w_phase_kernel<true>, w_phase_smem<true>(), grid,
                             cdiv(n, TN), TN, V, W, H, out1, out2, part, count, m, n, k, s);
  return (int)launch_phase(w_phase_kernel<false>, w_phase_smem<false>(), grid,
                           cdiv(n, TN), TN, V, W, H, out1, nullptr, part, count, m, n, k, s);
}

int nmf_wt_dot_phi(const float* V, const float* W, const float* H,
                   float* out1, float* out2, float* part, int m, int n, int k,
                   int mode, void* stream) {
  const dim3 grid(cdiv(n, TN), cdiv(k, KC));
  const size_t count = (size_t)k * n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1)
    return (int)launch_phase(h_phase_kernel<true>, h_phase_smem<true>(), grid,
                             cdiv(m, TM), TM, V, W, H, out1, out2, part, count, m, n, k, s);
  return (int)launch_phase(h_phase_kernel<false>, h_phase_smem<false>(), grid,
                           cdiv(m, TM), TM, V, W, H, out1, nullptr, part, count, m, n, k, s);
}

// Number of per-block partial sums cost_terms needs (per output).
long long nmf_cost_partials(int m, int n) {
  return (long long)cdiv(n, TN) * cdiv(m, TM);
}

// out[0] = s1 and, for is, out[1] = s2.  part: 2 * nmf_cost_partials(m, n)
// doubles of scratch.
int nmf_cost_terms(const float* V, const float* W, const float* H,
                   double* part, float* out, int m, int n, int k, int mode,
                   void* stream) {
  const dim3 grid(cdiv(n, TN), cdiv(m, TM));
  const size_t count = (size_t)grid.x * grid.y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1)
    cost_tile_kernel<true><<<grid, NT, cost_smem(), s>>>(V, W, H, part, part + count, m, n, k);
  else
    cost_tile_kernel<false><<<grid, NT, cost_smem(), s>>>(V, W, H, part, nullptr, m, n, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<1, RED_NT, 0, s>>>(part, count, out);
  if (mode == 1) reduce_partials_kernel<<<1, RED_NT, 0, s>>>(part + count, count, out + 1);
  return (int)cudaGetLastError();
}

}  // extern "C"
