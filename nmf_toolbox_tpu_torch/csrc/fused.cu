// Fused KL / IS multiplicative-update kernels for Hopper (sm_90a), f32.
//
// CUDA counterparts of the three Pallas kernels in
// nmf_toolbox_tpu/ops/pallas/fused.py (phi_dot_ht, wt_dot_phi,
// cost_terms).  Each rebuilds tiles of the reconstruction V_hat = W H on
// the chip, applies the divergence field elementwise and contracts it in
// the same pass, so neither V_hat nor the field ever reaches device
// memory.
//
// Layouts: V (m, n), W (m, k), H (k, n), all row-major and contiguous.
// Any (m, n) and 1 <= k <= 1024: ragged edges are bounds-checked (zero
// loads outside the matrix, no field computed there), and inside the
// matrix the fields carry no guard, exactly as the Pallas kernels.
//
// W- and H-phase (phase_kernel): two chained GEMMs per tile, shaped like
// FlashAttention's forward pass, on the tensor cores in 3xTF32
// (mma.sync m16n8k8): every f32 operand x is split once, as it leaves
// shared memory, into hi = tf32(x) and lo = tf32(x - hi), and a product
// is lo*hi + hi*lo + hi*hi (small terms first, lo*lo dropped) with f32
// accumulation, which keeps f32's accuracy at the tensor cores' rate.
// The H-phase is the W-phase of the transposed problem,
//   wt_dot_phi(V, W, H) = phi_dot_ht(V', H', W')',
// so one body serves both (template TRANS): it reads its tiles through
// transposing accessors and writes its output transposed.  A warp owns 16
// output rows and keeps their accumulators in registers for its whole
// loop; per loop tile it builds its V_hat fragment, forms the field from
// the f32 accumulator and feeds it to the second product as the A
// operand straight from registers, with the loop index permuted inside
// each group of 8 so that the accumulator layout serves as the A layout
// (the contraction does not depend on order).  The tensor cores truncate
// as they accumulate, so each tile's products start from zero and reach
// the running output through one rounded f32 add.  Tiles of W, H and V
// stream through a two-stage cp.async ring in shared memory, and each
// H tile (W-phase) or W tile (H-phase) is split once there for all
// warps.  What bounds it: the latency of the mma chains at the 2-3
// blocks of 4 warps per SM that the output accumulators' registers allow.
// Blocks run in no fixed order, so a block owns its output rows for a
// span of the loop axis (blockIdx.z); with several spans each writes a
// partial output and a second kernel adds them in span order
// (deterministic).  span_tiles() picks the spans from the kernel's
// occupancy.  k is padded to 8 and cut into output chunks of at most 128
// over blockIdx.y; each chunk's block rebuilds V_hat over all of k.
//
// cost (cost_kernel): one GEMM tile per block with a reducing epilogue.
// A block of 8 warps rebuilds a 128 x 128 tile of V_hat on the tensor
// cores in the same 3xTF32 as the phases, 64 x 32 per warp, streaming k
// in slabs of 32 through a two-stage cp.async ring; each warp splits the
// operands it reads as they leave shared memory.  The V tile follows
// into the ring by cp.async, and the epilogue forms the terms in
// registers in the accumulator layout and sums them in a fixed order
// (f32 per row of a thread, then f64 over rows, warp and block) into one
// partial per block; a one-block kernel adds the partials in a fixed
// order, so repeated runs give identical bits (no atomics).
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include "tile_ops.cuh"

namespace {

// ---------------------------------------------------------------------------
// W-phase: out1 = Phi1 @ H', out2 = Phi2 @ H' (IS only), both (m, k).
// H-phase: out1 = W' @ Phi1, out2 = W' @ Phi2 (IS only), both (k, n).
// kl: Phi1 = V / V_hat.   is: Phi1 = V / V_hat^2, Phi2 = 1 / V_hat.
//
// In the W-phase's terms: "rows" r are the output's rows (W-phase: rows
// of V; H-phase: columns of V), the "loop" axis l is summed over (W-phase:
// columns of V; H-phase: rows of V), c runs over k.  A is the block's
// rows of W (H-phase: of H'), B the loop tile of H (H-phase: of W').
// ---------------------------------------------------------------------------

constexpr int PNT = 128;        // threads per phase block: 4 warps
constexpr int PR = 64;          // output rows per block, 16 per warp
// Loop-axis tile: kl 24, is 32 (is has twice the second product per tile).
__host__ __device__ constexpr int loop_tile(bool is) { return is ? 32 : 24; }
constexpr int STAGES = 2;       // cp.async ring depth
constexpr int MAX_CHUNK = 128;  // widest output k-chunk
constexpr int NKMAX = MAX_CHUNK / 8;
// Padded strides, in floats.  Each makes the fragment loads of a warp hit
// 32 distinct banks: a [c][x] tile read at (t, g) needs a stride of 8 or
// 24 mod 32, a [x][c] tile read at (g, t) a stride of 4 mod 8.  The
// [x][c] tiles of W use kcw + 4 (kcw a multiple of 8).
// W-phase B [c][l] and V [r][l]: the loop tile, padded to 8 or 24 mod 32.
__host__ __device__ constexpr int cstr(bool is) {
  return loop_tile(is) % 16 == 8 ? loop_tile(is) : loop_tile(is) + 8;
}
constexpr int HA_STR = PR + 8;  // H-phase A [c][r]
constexpr int HV_STR = PR + 4;  // H-phase V [l][r]: read at (2t, g)

struct PhaseLayout {
  int chunks;  // output k-chunks (blockIdx.y)
  int kcw;     // chunk width: a multiple of 8, at most MAX_CHUNK
  int kstr;    // stride of the [x][c] tiles of W
  int a, b, v; // floats of one A, B and V buffer (and of the B lo buffer)
  int a_bufs;  // A buffers: 1 (loaded once) when there is one chunk
  int floats;  // dynamic shared memory, in floats
};

__host__ __device__ inline PhaseLayout phase_layout(bool trans, bool is, int k) {
  PhaseLayout p;
  const int k8 = cdiv(k, 8);
  p.chunks = cdiv(k8, MAX_CHUNK / 8);
  p.kcw = 8 * cdiv(k8, p.chunks);
  p.kstr = p.kcw + 4;
  p.a = trans ? p.kcw * HA_STR : PR * p.kstr;
  p.b = trans ? loop_tile(is) * p.kstr : p.kcw * cstr(is);
  p.v = trans ? loop_tile(is) * HV_STR : PR * cstr(is);
  p.a_bufs = p.chunks > 1 ? STAGES : 1;
  p.floats = p.a_bufs * p.a + STAGES * (p.b + p.v) + p.b;
  return p;
}

// Tile accessors in the W-phase's terms (see above).
template <bool TRANS>
__device__ __forceinline__ float a_at(const float* A, int kstr, int r, int c) {
  return TRANS ? A[c * HA_STR + r] : A[r * kstr + c];
}
template <bool TRANS, int CS>
__device__ __forceinline__ float b_at(const float* B, int kstr, int c, int l) {
  return TRANS ? B[l * kstr + c] : B[c * CS + l];
}
// (B[c][l], B[c][l + 1]), l even.
template <bool TRANS, int CS>
__device__ __forceinline__ float2 b_pair(const float* B, int kstr, int c, int l) {
  if (TRANS) return make_float2(B[l * kstr + c], B[(l + 1) * kstr + c]);
  return *reinterpret_cast<const float2*>(&B[c * CS + l]);
}
template <bool TRANS, int CS>
__device__ __forceinline__ float2 v_pair(const float* Vt, int r, int l) {
  if (TRANS) return make_float2(Vt[l * HV_STR + r], Vt[(l + 1) * HV_STR + r]);
  return *reinterpret_cast<const float2*>(&Vt[r * CS + l]);
}

// Block (x, y, z): output rows x*PR.., output k-chunk y, loop axis in
// [z*span, (z+1)*span); writes out[z] (each out an (m, k) array, or
// (k, n) for TRANS).
template <bool TRANS, bool IS>
__global__ void __launch_bounds__(PNT, 2)
phase_kernel(const float* __restrict__ V, const float* __restrict__ W,
             const float* __restrict__ H, float* __restrict__ out1,
             float* __restrict__ out2, int m, int n, int k, int span, bool vec) {
  extern __shared__ float4 smem4[];
  constexpr int PL = loop_tile(IS), CSTR = cstr(IS);
  const PhaseLayout lay = phase_layout(TRANS, IS, k);
  float* As0 = reinterpret_cast<float*>(smem4);  // [a_bufs] A buffers
  float* Bs0 = As0 + lay.a_bufs * lay.a;         // [STAGES] B buffers
  float* Vs0 = Bs0 + STAGES * lay.b;             // [STAGES] V buffers
  float* Bl = Vs0 + STAGES * lay.v;              // lo parts of the current B

  const int M = TRANS ? n : m, L = TRANS ? m : n;
  const int S = lay.chunks, kcw = lay.kcw, kstr = lay.kstr, nk = kcw / 8;
  const int r0 = blockIdx.x * PR, y = blockIdx.y;
  const int l_begin = blockIdx.z * span, l_end = min(L, l_begin + span);
  const int units = cdiv(l_end - l_begin, PL) * S;
  out1 += (size_t)blockIdx.z * M * k;
  if (IS) out2 += (size_t)blockIdx.z * M * k;

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = 16 * (threadIdx.x >> 5);  // this warp's first row

  // Unit q: loop tile q / S, k-slab q % S, with this block's own chunk y
  // last, so that its B slab is still in the ring for the second product.
  // The V tile comes with the last slab; with one chunk A loads once.
  auto issue = [&](int q) {
    const int u = q % S, st = q % STAGES;
    const int c0 = kcw * (u == S - 1 ? y : (u < y ? u : u + 1));
    const int l0 = l_begin + (q / S) * PL;
    float* As = As0 + (S > 1 ? st : 0) * lay.a;
    float* Bs = Bs0 + st * lay.b;
    float* Vs = Vs0 + st * lay.v;
    if (TRANS) {
      if (S > 1 || q == 0) copy_tile<PNT>(As, HA_STR, H, n, c0, r0, kcw, PR, k, n, vec);
      copy_tile<PNT>(Bs, kstr, W, k, l0, c0, PL, kcw, m, k, vec);
      if (u == S - 1) copy_tile<PNT>(Vs, HV_STR, V, n, l0, r0, PL, PR, m, n, vec);
    } else {
      if (S > 1 || q == 0) copy_tile<PNT>(As, kstr, W, k, r0, c0, PR, kcw, m, k, vec);
      copy_tile<PNT>(Bs, CSTR, H, n, c0, l0, kcw, PL, k, n, vec);
      if (u == S - 1) copy_tile<PNT>(Vs, CSTR, V, n, r0, l0, PR, PL, m, n, vec);
    }
  };

  // acc: V_hat's hi*hi products, acs: its two small ones, as two chains
  // (is keeps all three in acc: its second output needs the registers).
  float o1[NKMAX][4], o2[NKMAX][4], acc[PL / 8][4], acs[PL / 8][4];
#pragma unroll
  for (int p = 0; p < NKMAX; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) o1[p][e] = o2[p][e] = 0.f;

  if (units > 0) issue(0);
  cp_async_commit();
  for (int q = 0; q < units; ++q) {
    if (q + 1 < units) issue(q + 1);
    cp_async_commit();   // possibly empty: keeps one group per unit
    cp_async_wait<1>();  // all but the newest group done: unit q has landed
    __syncthreads();
    const int u = q % S, st = q % STAGES;
    const float* As = As0 + (S > 1 ? st : 0) * lay.a;
    float* Bs = Bs0 + st * lay.b;
    // Split the landed B tile once for all warps: hi in place, lo in Bl.
    split_tile<PNT>(Bs, Bl, lay.b);
    __syncthreads();

    if (u == 0) {
#pragma unroll
      for (int j = 0; j < PL / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = acs[j][e] = 0.f;
    }
    // V_hat fragment (rows wr.., the loop tile) += A slab x B slab.
#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk) {
      const int c = 8 * kk + t;
      uint32_t ah[4], al[4];
      split(a_at<TRANS>(As, kstr, wr + g, c), ah[0], al[0]);
      split(a_at<TRANS>(As, kstr, wr + g + 8, c), ah[1], al[1]);
      split(a_at<TRANS>(As, kstr, wr + g, c + 4), ah[2], al[2]);
      split(a_at<TRANS>(As, kstr, wr + g + 8, c + 4), ah[3], al[3]);
      uint32_t bh[PL / 8][2], bl[PL / 8][2];
#pragma unroll
      for (int j = 0; j < PL / 8; ++j) {
        bh[j][0] = __float_as_uint(b_at<TRANS, CSTR>(Bs, kstr, c, 8 * j + g));
        bh[j][1] = __float_as_uint(b_at<TRANS, CSTR>(Bs, kstr, c + 4, 8 * j + g));
        bl[j][0] = __float_as_uint(b_at<TRANS, CSTR>(Bl, kstr, c, 8 * j + g));
        bl[j][1] = __float_as_uint(b_at<TRANS, CSTR>(Bl, kstr, c + 4, 8 * j + g));
      }
#pragma unroll
      for (int j = 0; j < PL / 8; ++j) mma(IS ? acc[j] : acs[j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < PL / 8; ++j) mma(IS ? acc[j] : acs[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < PL / 8; ++j) mma(acc[j], ah, bh[j][0], bh[j][1]);
    }

    if (u == S - 1) {
      // The field, then out += Phi x B' over this tile.  acc[j] holds
      // rows (g, g + 8) x columns (8j + 2t, 8j + 2t + 1); taken as the A
      // fragment with its k index t -> column 2t, t + 4 -> 2t + 1, it
      // meets B rows (8j + 2t, 8j + 2t + 1) of the chunk's slab.
      const float* Vt = Vs0 + st * lay.v;
      const int l0 = l_begin + (q / S) * PL;
      // Split field fragments, in A order: (g,l) (g+8,l) (g,l+1) (g+8,l+1).
      uint32_t ph[PL / 8][4], pl[PL / 8][4], qh[PL / 8][4], ql[PL / 8][4];
#pragma unroll
      for (int j = 0; j < PL / 8; ++j) {
        const int l = 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wr + g + 8 * h;
          const float2 v = v_pair<TRANS, CSTR>(Vt, r, l);
          const bool in_r = r0 + r < M;
          const bool in0 = in_r && l0 + l < L, in1 = in_r && l0 + l + 1 < L;
          const float vh0 = acs[j][2 * h] + acc[j][2 * h];
          const float vh1 = acs[j][2 * h + 1] + acc[j][2 * h + 1];
          if (IS) {
            split(in0 ? v.x / (vh0 * vh0) : 0.f, ph[j][h], pl[j][h]);
            split(in1 ? v.y / (vh1 * vh1) : 0.f, ph[j][h + 2], pl[j][h + 2]);
            split(in0 ? 1.f / vh0 : 0.f, qh[j][h], ql[j][h]);
            split(in1 ? 1.f / vh1 : 0.f, qh[j][h + 2], ql[j][h + 2]);
          } else {
            split(in0 ? v.x / vh0 : 0.f, ph[j][h], pl[j][h]);
            split(in1 ? v.y / vh1 : 0.f, ph[j][h + 2], pl[j][h + 2]);
          }
        }
      }
      // The tensor cores truncate as they accumulate, so this tile's
      // products go to zeroed fragments first (small and hi*hi terms in
      // two chains) and reach the running output through one rounded f32
      // add per tile.  GP output subtiles at a time, with no branch
      // inside a group, keep 2 * GP (is: 4) chains of mma in flight; rows
      // past the chunk read a valid row and their sums are never stored.
      constexpr int GP = IS ? 1 : 2;
#pragma unroll
      for (int p0 = 0; p0 < NKMAX; p0 += GP) {
        if (p0 < nk) {
          float s1[GP][4], h1[GP][4], s2[GP][4], h2[GP][4];
#pragma unroll
          for (int i = 0; i < GP; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) s1[i][e] = h1[i][e] = s2[i][e] = h2[i][e] = 0.f;
#pragma unroll
          for (int j = 0; j < PL / 8; ++j) {
#pragma unroll
            for (int i = 0; i < GP; ++i) {
              const int c = min(8 * (p0 + i), kcw - 8) + g, l = 8 * j + 2 * t;
              const float2 bh = b_pair<TRANS, CSTR>(Bs, kstr, c, l);
              const float2 bl = b_pair<TRANS, CSTR>(Bl, kstr, c, l);
              const uint32_t b0h = __float_as_uint(bh.x), b1h = __float_as_uint(bh.y);
              const uint32_t b0l = __float_as_uint(bl.x), b1l = __float_as_uint(bl.y);
              mma(s1[i], pl[j], b0h, b1h);
              mma(s1[i], ph[j], b0l, b1l);
              mma(h1[i], ph[j], b0h, b1h);
              if (IS) {
                mma(s2[i], ql[j], b0h, b1h);
                mma(s2[i], qh[j], b0l, b1l);
                mma(h2[i], qh[j], b0h, b1h);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < GP; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              o1[p0 + i][e] += s1[i][e] + h1[i][e];
              if (IS) o2[p0 + i][e] += s2[i][e] + h2[i][e];
            }
        }
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration's copies
  }

  // o[p] holds rows (g, g + 8) x chunk columns (8p + 2t, 8p + 2t + 1).
#pragma unroll
  for (int p = 0; p < NKMAX; ++p) {
    if (p >= nk) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + wr + g + 8 * (e >> 1), c = y * kcw + 8 * p + 2 * t + (e & 1);
      if (r < M && c < k) {
        const size_t i = TRANS ? (size_t)c * n + r : (size_t)r * k + c;
        out1[i] = o1[p][e];
        if (IS) out2[i] = o2[p][e];
      }
    }
  }
}

constexpr int SUM_NT = 256;  // threads per span-sum block

// out[i] = sum over spans z, in order, of part[z * count + i].
__global__ void __launch_bounds__(SUM_NT)
sum_spans_kernel(const float* __restrict__ part, int spans, size_t count,
                 float* __restrict__ out) {
  const size_t stride = (size_t)gridDim.x * SUM_NT;
  for (size_t i = (size_t)blockIdx.x * SUM_NT + threadIdx.x; i < count; i += stride) {
    float s = part[i];
    for (int z = 1; z < spans; ++z) s += part[(size_t)z * count + i];
    out[i] = s;
  }
}

// ---------------------------------------------------------------------------
// Cost terms.  kl: s1 = sum V * log(V_hat).  is: s1 = sum log(V_hat),
// s2 = sum V / V_hat.  Terms are f32 (as the Pallas kernel forms them);
// their sums are f64, in a fixed order.
//
// A block rebuilds the CM x CN tile of V_hat at (blockIdx.y, blockIdx.x):
// its 8 warps are 2 x 4, warp w owning rows 64 (w / 4).. and columns
// 32 (w % 4).., 4 x 4 m16n8k8 accumulators, so each k-step issues 16
// independent chains of three products.  Two blocks share an SM (117
// registers).  Measured against this design on an H100 (PERF.md §6): 4
// warps of 64 x 64 (198 registers) are 17-25 % slower; splitting each
// slab into hi and lo once in shared memory, 14-29 % slower; reading V
// from device memory in the accumulator layout in the epilogue, 7-14 %
// slower.
// The tensor cores truncate as they accumulate; one chain per output
// holds 3 k / 8 adds (384 at k = 1024), which keeps the sums within 1e-4
// (tests/test_torch_tf32.py emulates it).
// ---------------------------------------------------------------------------

constexpr int CM = 128, CN = 128;   // V_hat tile per block
constexpr int CWM = 64, CWN = 32;   // V_hat tile per warp
constexpr int CMI = CWM / 16, CNJ = CWN / 8;      // m16n8 tiles per warp
constexpr int CNT = 32 * (CM / CWM) * (CN / CWN);  // threads per cost block: 8 warps
constexpr int CK = 32;              // k-depth of one slab: 4 k-steps of 8
// Padded strides, in floats: the A slab [r][c] is read at (g, t) (a stride
// of 4 mod 8), the B slab [c][j] at (t, g) (8 or 24 mod 32); either way a
// warp's fragment load hits 32 distinct banks.
constexpr int CA_STR = CK + 4, CB_STR = CN + 8;
constexpr int CA = CM * CA_STR, CB = CK * CB_STR;  // floats of one slab each
constexpr int RED_NT = 1024;

// [STAGES] slabs of W (A) and H (B).  After the products the stages hold
// the block's V tile, [CM][CB_STR].
constexpr size_t cost_smem() { return sizeof(float) * STAGES * (CA + CB); }
static_assert(CM * CB_STR <= STAGES * (CA + CB), "the V tile must fit the ring");

// Fixed-order butterfly sum over the warp; every lane gets the total.
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The block's total of x over its threads, in a fixed order, in thread 0.
__device__ __forceinline__ double block_total(double x, double* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = red[0];
#pragma unroll
  for (int w = 1; w < CNT / 32; ++w) s += red[w];
  return s;
}

// part1[b] (and part2[b] for IS) = this block's sums, b the block's index
// in the grid.  vec: 16-byte copies of W and H; vecv: of V.
template <bool IS>
__global__ void __launch_bounds__(CNT, 2)
cost_kernel(const float* __restrict__ V, const float* __restrict__ W,
            const float* __restrict__ H, double* __restrict__ part1,
            double* __restrict__ part2, int m, int n, int k, bool vec, bool vecv) {
  extern __shared__ float4 smem4[];
  float* S0 = reinterpret_cast<float*>(smem4);  // [STAGES] (A, B) slabs
  __shared__ double red[2][CNT / 32];

  const int i0 = blockIdx.y * CM, j0 = blockIdx.x * CN;
  const int slabs = cdiv(k, CK), k8 = 8 * cdiv(k, 8);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int wr = CWM * (warp / (CN / CWN)), wc = CWN * (warp % (CN / CWN));
  auto stage = [&](int s) { return S0 + (s % STAGES) * (CA + CB); };

  // Slab s: W[i0.., 32 s..] and H[32 s.., j0..], zero outside the matrix
  // (so k is padded with zeros to the slab).
  auto issue = [&](int s) {
    float* As = stage(s);
    copy_tile<CNT>(As, CA_STR, W, k, i0, CK * s, CM, CK, m, k, vec);
    copy_tile<CNT>(As + CA, CB_STR, H, n, CK * s, j0, CK, CN, k, n, vec);
  };

  // acc[i][j]: rows wr + 16 i + (g, g + 8) x columns wc + 8 j + (2t, 2t + 1).
  float acc[CMI][CNJ][4];
#pragma unroll
  for (int i = 0; i < CMI; ++i)
#pragma unroll
    for (int j = 0; j < CNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  issue(0);
  cp_async_commit();
  for (int s = 0; s < slabs; ++s) {
    if (s + 1 < slabs) issue(s + 1);
    cp_async_commit();   // possibly empty: keeps one group per slab
    cp_async_wait<1>();  // all but the newest group done: slab s has landed
    __syncthreads();
    const float* As = stage(s);
    const float* Bs = As + CA;
    const int steps = min(CK, k8 - CK * s) / 8;
#pragma unroll
    for (int kk = 0; kk < CK / 8; ++kk) {
      if (kk < steps) {
        const int c = 8 * kk + t;
        uint32_t ah[CMI][4], al[CMI][4], bh[CNJ][2], bl[CNJ][2];
#pragma unroll
        for (int i = 0; i < CMI; ++i) {
          const int r = (wr + 16 * i + g) * CA_STR + c;
          split(As[r], ah[i][0], al[i][0]);
          split(As[r + 8 * CA_STR], ah[i][1], al[i][1]);
          split(As[r + 4], ah[i][2], al[i][2]);
          split(As[r + 8 * CA_STR + 4], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < CNJ; ++j) {
          const int q = c * CB_STR + wc + 8 * j + g;
          split(Bs[q], bh[j][0], bl[j][0]);
          split(Bs[q + 4 * CB_STR], bh[j][1], bl[j][1]);
        }
        // The small products first, then hi * hi; CMI * CNJ chains in flight.
#pragma unroll
        for (int i = 0; i < CMI; ++i)
#pragma unroll
          for (int j = 0; j < CNJ; ++j) mma(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
        for (int i = 0; i < CMI; ++i)
#pragma unroll
          for (int j = 0; j < CNJ; ++j) mma(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
        for (int i = 0; i < CMI; ++i)
#pragma unroll
          for (int j = 0; j < CNJ; ++j) mma(acc[i][j], ah[i], bh[j][0], bh[j][1]);
      }
    }
    __syncthreads();  // stage s is refilled next
  }

  // Epilogue.  The V tile goes to the ring, now free, by cp.async (every
  // copy in flight at once); then each thread forms its f32 terms in the
  // accumulator layout, zero outside the matrix, sums each row's 2 CNJ in
  // f32 and the rows in f64.
  float* Vs = S0;  // [CM][CB_STR]
  copy_tile<CNT>(Vs, CB_STR, V, n, i0, j0, CM, CN, m, n, vecv);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  double s1 = 0.0, s2 = 0.0;
#pragma unroll
  for (int i = 0; i < CMI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + 16 * i + g + 8 * h;
      const bool in_r = i0 + r < m;
      float f1 = 0.f, f2 = 0.f;
#pragma unroll
      for (int j = 0; j < CNJ; ++j) {
        const int c = wc + 8 * j + 2 * t;
        const bool in0 = in_r && j0 + c < n, in1 = in_r && j0 + c + 1 < n;
        const float2 v = *reinterpret_cast<const float2*>(&Vs[r * CB_STR + c]);
        const float vh0 = acc[i][j][2 * h], vh1 = acc[i][j][2 * h + 1];
        if (IS) {
          f1 += (in0 ? logf(vh0) : 0.f) + (in1 ? logf(vh1) : 0.f);
          f2 += (in0 ? v.x / vh0 : 0.f) + (in1 ? v.y / vh1 : 0.f);
        } else {
          f1 += (in0 ? v.x * logf(vh0) : 0.f) + (in1 ? v.y * logf(vh1) : 0.f);
        }
      }
      s1 += (double)f1;
      s2 += (double)f2;
    }
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  s1 = block_total(s1, red[0]);
  if (threadIdx.x == 0) part1[blk] = s1;
  if (IS) {
    s2 = block_total(s2, red[1]);
    if (threadIdx.x == 0) part2[blk] = s2;
  }
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

// Tiles per span for a loop of `tiles` tiles, `blocks` blocks per span and
// `slots` blocks resident on the card at once.  A block takes about 4
// tiles' time of its own (its A tile, the ring's fill, the epilogue; the
// best of 0, 4, 8, 16 and 32 at 40 000x10 000 k=100 on an H100) plus one
// per tile, so a run of s spans takes about ceil(blocks * s / slots)
// waves of ceil(tiles / s) + 4; this picks the s that minimizes that
// (ties: fewer spans, as each adds a partial output), each span keeping
// at least 8 tiles.
int span_tiles(int blocks, int tiles, int slots) {
  if (slots < 1) return tiles;  // the launch that follows reports the error
  int best = 1;
  long long best_time = -1;
  for (int s = 1; s <= tiles / 8 || s == 1; ++s) {
    const long long time = (((long long)blocks * s + slots - 1) / slots) * (cdiv(tiles, s) + 4);
    if (best_time < 0 || time < best_time) {
      best_time = time;
      best = s;
    }
  }
  return cdiv(tiles, best);
}

using PhaseKernel = void (*)(const float*, const float*, const float*, float*,
                             float*, int, int, int, int, bool);

// How a phase (trans: the H-phase) launches: output row blocks by
// k-chunks by spans of the loop axis, sized from the kernel's occupancy
// on the current device.  Dynamic shared memory above 48 KB needs the
// kernel's opt-in, given here.
struct PhasePlan {
  PhaseKernel kernel;
  size_t smem;
  dim3 grid;
  int span;  // loop-axis elements per span
};

cudaError_t plan_phase(bool trans, bool is, int m, int n, int k, PhasePlan* p) {
  p->kernel = trans ? (is ? phase_kernel<true, true> : phase_kernel<true, false>)
                    : (is ? phase_kernel<false, true> : phase_kernel<false, false>);
  const PhaseLayout lay = phase_layout(trans, is, k);
  p->smem = sizeof(float) * lay.floats;
  p->grid = dim3(cdiv(trans ? n : m, PR), lay.chunks);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(p->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p->smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p->kernel, PNT, p->smem);
  const int tiles = cdiv(trans ? m : n, loop_tile(is));
  const int per = span_tiles(p->grid.x * p->grid.y, tiles, per_sm * sms);
  p->grid.z = cdiv(tiles, per);
  p->span = per * loop_tile(is);
  return err;
}

// Launch a phase kernel into `out` directly (one span) or into `part`
// followed by the span sum.
template <bool TRANS>
cudaError_t launch_phase(const float* V, const float* W, const float* H,
                         float* out1, float* out2, float* part, int m, int n,
                         int k, bool is, cudaStream_t s) {
  PhasePlan p;
  const cudaError_t err = plan_phase(TRANS, is, m, n, k, &p);
  if (err != cudaSuccess) return err;
  const bool vec = n % 4 == 0 && k % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(V) | reinterpret_cast<uintptr_t>(W) |
                    reinterpret_cast<uintptr_t>(H)) % 16 == 0;
  if (p.grid.z == 1) {
    p.kernel<<<p.grid, PNT, p.smem, s>>>(V, W, H, out1, out2, m, n, k, p.span, vec);
    return cudaGetLastError();
  }
  const size_t count = (size_t)(TRANS ? n : m) * k;
  float* part2 = is ? part + (size_t)p.grid.z * count : nullptr;
  p.kernel<<<p.grid, PNT, p.smem, s>>>(V, W, H, part, part2, m, n, k, p.span, vec);
  const int blocks = (int)((count + SUM_NT - 1) / SUM_NT < 65535 ? (count + SUM_NT - 1) / SUM_NT : 65535);
  sum_spans_kernel<<<blocks, SUM_NT, 0, s>>>(part, p.grid.z, count, out1);
  if (is) sum_spans_kernel<<<blocks, SUM_NT, 0, s>>>(part2, p.grid.z, count, out2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nmf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of scratch a phase needs for its span partials (0: none, or the
// launch will report an error).  phase: 0 = W-phase (phi_dot_ht), 1 =
// H-phase (wt_dot_phi); mode: 0 = kl, 1 = is.  Plans on the current
// device, as the launch does.
long long nmf_phase_scratch(int phase, int m, int n, int k, int mode) {
  PhasePlan p;
  if (plan_phase(phase == 1, mode == 1, m, n, k, &p) != cudaSuccess || p.grid.z == 1) return 0;
  const long long count = (long long)(phase == 0 ? m : n) * k;
  return (mode == 1 ? 2 : 1) * (long long)p.grid.z * count;
}

// mode: 0 = kl (out2 unused, may be NULL), 1 = is.  part: the scratch
// nmf_phase_scratch(0, ...) asks for (NULL when it asks for none).
int nmf_phi_dot_ht(const float* V, const float* W, const float* H,
                   float* out1, float* out2, float* part, int m, int n, int k,
                   int mode, void* stream) {
  return (int)launch_phase<false>(V, W, H, out1, out2, part, m, n, k, mode == 1,
                                  static_cast<cudaStream_t>(stream));
}

int nmf_wt_dot_phi(const float* V, const float* W, const float* H,
                   float* out1, float* out2, float* part, int m, int n, int k,
                   int mode, void* stream) {
  return (int)launch_phase<true>(V, W, H, out1, out2, part, m, n, k, mode == 1,
                                 static_cast<cudaStream_t>(stream));
}

// Number of per-block partial sums cost_terms needs (per output): one per
// CM x CN tile of V.
long long nmf_cost_partials(int m, int n) {
  return (long long)cdiv(n, CN) * cdiv(m, CM);
}

// out[0] = s1 and, for is, out[1] = s2.  part: 2 * nmf_cost_partials(m, n)
// doubles of scratch.
int nmf_cost_terms(const float* V, const float* W, const float* H,
                   double* part, float* out, int m, int n, int k, int mode,
                   void* stream) {
  const dim3 grid(cdiv(n, CN), cdiv(m, CM));
  const size_t count = (size_t)grid.x * grid.y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(V), b = reinterpret_cast<uintptr_t>(W),
                  c = reinterpret_cast<uintptr_t>(H);
  const bool vec = n % 4 == 0 && k % 4 == 0 && (b | c) % 16 == 0;
  const bool vecv = n % 4 == 0 && a % 16 == 0;
  const auto kernel = mode == 1 ? cost_kernel<true> : cost_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cost_smem());
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, CNT, cost_smem(), s>>>(V, W, H, part, part + count, m, n, k, vec, vecv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<1, RED_NT, 0, s>>>(part, count, out);
  if (mode == 1) reduce_partials_kernel<<<1, RED_NT, 0, s>>>(part + count, count, out + 1);
  return (int)cudaGetLastError();
}

}  // extern "C"
