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
// cost (cost_tile_kernel): V_hat tiles from 4x4 register tiles of f32
// FMAs on the CUDA cores; each block writes its tile's sum to a partial
// buffer and a one-block kernel adds the partials in a fixed order, so
// repeated runs give identical bits (no atomics).
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per cost block, viewed as a 16 x 16 grid
constexpr int TM = 64;    // V rows per cost tile (4 per thread row)
constexpr int TN = 64;    // V columns per cost tile (4 per thread column)
constexpr int KB = 16;    // k-depth of one V_hat step
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

// dst[r * dstr + c] = src[(r0 + r) * sstr + c0 + c] for r < rows, c < cols,
// zero where r0 + r >= rlim or c0 + c >= clim.  vec: 16-byte copies (cols,
// c0, clim and sstr multiples of 4, src 16-byte aligned).
__device__ __forceinline__ void copy_tile(float* dst, int dstr, const float* src,
                                          size_t sstr, int r0, int c0, int rows,
                                          int cols, int rlim, int clim, bool vec) {
  // Copies of w floats, cq per row; thread e takes copies e, e + PNT, ...,
  // stepping (r, c) without a division per copy.
  const int w = vec ? 4 : 1, cq = cols / w, dr = PNT / cq, dc = PNT % cq;
  int r = threadIdx.x / cq, c = threadIdx.x % cq;
  while (r < rows) {
    const int gr = r0 + r, gc = c0 + c * w;
    const bool ok = gr < rlim && gc < clim;
    const float* s = ok ? src + (size_t)gr * sstr + gc : src;
    if (vec)
      cp_async16(dst + r * dstr + c * w, s, ok);
    else
      cp_async4(dst + r * dstr + c, s, ok);
    r += dr;
    c += dc;
    if (c >= cq) {
      c -= cq;
      ++r;
    }
  }
}

// tf32(x) rounded to nearest, ties away from zero, as cvt.rna.tf32.f32
// gives it for finite x, but in integer operations: conversions issue at
// an eighth of the rate of integer and f32 arithmetic on sm_90.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// hi = tf32(x), lo = tf32(x - hi); x - hi is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b for a 16x8 (row) times 8x8 (col) TF32 tile, f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
      if (S > 1 || q == 0) copy_tile(As, HA_STR, H, n, c0, r0, kcw, PR, k, n, vec);
      copy_tile(Bs, kstr, W, k, l0, c0, PL, kcw, m, k, vec);
      if (u == S - 1) copy_tile(Vs, HV_STR, V, n, l0, r0, PL, PR, m, n, vec);
    } else {
      if (S > 1 || q == 0) copy_tile(As, kstr, W, k, r0, c0, PR, kcw, m, k, vec);
      copy_tile(Bs, CSTR, H, n, c0, l0, kcw, PL, k, n, vec);
      if (u == S - 1) copy_tile(Vs, CSTR, V, n, r0, l0, PR, PL, m, n, vec);
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
    for (int e = 4 * threadIdx.x; e < lay.b; e += 4 * PNT) {
      const float4 x = *reinterpret_cast<const float4*>(&Bs[e]);
      uint32_t h[4], l[4];
      split(x.x, h[0], l[0]);
      split(x.y, h[1], l[1]);
      split(x.z, h[2], l[2]);
      split(x.w, h[3], l[3]);
      *reinterpret_cast<float4*>(&Bs[e]) = make_float4(
          __uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
      *reinterpret_cast<float4*>(&Bl[e]) = make_float4(
          __uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
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
  const int blocks = (int)((count + NT - 1) / NT < 65535 ? (count + NT - 1) / NT : 65535);
  sum_spans_kernel<<<blocks, NT, 0, s>>>(part, p.grid.z, count, out1);
  if (is) sum_spans_kernel<<<blocks, NT, 0, s>>>(part2, p.grid.z, count, out2);
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
