// The naive KL step's elementwise passes for Hopper (sm_90a), f32: the
// gradient field and the cost over the m x n reconstruction V_hat = W H.
//
// Replaces no pallas_call.  In the JAX package the naive step runs inside
// one jitted lax.while_loop, where XLA fuses the KL field and cost of
// nmf_toolbox_tpu/ops/divergence.py (fields, cost, _weighted,
// _weighted_sum) into one pass over the fields each.  The port's eager
// step ran them as chains of torch ops, each reading or writing a whole
// m x n tensor: four passes a weighted field and nine a weighted cost.
// These two kernels give that fusion back; the products around them stay
// cuBLAS's.
//
//   kl_field:  phi = M > 0 ? M * (V / V_hat) : 0 (weighted only: the
//              unweighted field V / V_hat is one torch pass already).
//   kl_cost:   sum(M > 0 ? M * (V log(V / V_hat) - V + V_hat) : 0), or
//              the same sum with no M.
//
// Bound on the H100: bytes.  The field reads V, V_hat and M once and
// writes phi once: 16 bytes an entry, 1.91 ms at 40 000 x 10 000 and
// 3.35 TB/s.  The cost reads 12 (8) bytes an entry, 1.43 (0.96) ms; its
// logs (~20 instructions each) run under the reads.
//
// Design: the flat index of the contiguous operands, 16-byte (float4)
// loads and stores where every pointer is 16-byte aligned (the flat index
// needs nothing of the row length) and scalar ones at the tail, or
// throughout where a pointer is not.  The field gives each thread one
// float4 of each operand, one block to every NT of them: 94 % of the
// bound at 40 000 x 10 000 weighted, against 90 % for a grid-stride loop
// over one wave of resident blocks.  The cost keeps that loop (the
// card's SMs times the blocks each keeps resident, so every block
// streams an equal share) to have one partial sum a block, ~1 000 in all.
//
// Rounding: every entry equals torch's chain bit for bit.  Each step is
// an intrinsic rounded to nearest (__fdiv_rn, __fmul_rn, __fsub_rn,
// __fadd_rn), which nvcc never contracts into an FMA (its default
// --fmad=true would fuse V log(.) - V), and the log is the accurate
// logf, as torch's log is, not __logf.  The W and H the step builds from
// the field are so torch's own.  The cost sums each thread's terms in
// f64, the warp by a fixed butterfly and the block in warp order into one
// partial per block; a one-block kernel adds the partials in a fixed
// order and rounds once to f32, so repeated runs give identical bits (no
// atomics), closer to the exact sum than torch's f32 reduction.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it
// cannot take (a field with no M).

#include <cuda_runtime.h>
#include <cstdint>

#ifndef NMF_NAIVE_KL_THREADS
#define NMF_NAIVE_KL_THREADS 256
#endif

namespace {

constexpr int NT = NMF_NAIVE_KL_THREADS;  // threads a block, a power of two
static_assert(NT >= 32 && (NT & (NT - 1)) == 0, "NT must be a power of two >= 32");

__device__ __forceinline__ float field(float v, float vh, float m) {
  return m > 0.f ? __fmul_rn(m, __fdiv_rn(v, vh)) : 0.f;
}

// V log(V / V_hat) - V + V_hat, each step rounded as torch's passes round it.
template <bool WEIGHTED>
__device__ __forceinline__ float term(float v, float vh, float m) {
  const float t = __fadd_rn(__fsub_rn(__fmul_rn(v, logf(__fdiv_rn(v, vh))), v), vh);
  return WEIGHTED ? (m > 0.f ? __fmul_rn(m, t) : 0.f) : t;
}

__device__ __forceinline__ float4 load4(const float* p, long long i) {
  return reinterpret_cast<const float4*>(p)[i];
}

// phi[i] = field(V[i], Vh[i], M[i]) for i < n: each thread the four
// entries from 4 (blockIdx.x NT + threadIdx.x), as one float4 where vec
// (every pointer 16-byte aligned) and all four lie inside, else one by one.
__global__ void __launch_bounds__(NT)
kl_field_kernel(const float* __restrict__ V, const float* __restrict__ Vh,
                const float* __restrict__ M, float* __restrict__ phi, long long n,
                bool vec) {
  const long long g = (long long)blockIdx.x * NT + threadIdx.x;
  if (vec && 4 * g + 4 <= n) {
    const float4 v = load4(V, g), h = load4(Vh, g), m = load4(M, g);
    reinterpret_cast<float4*>(phi)[g] =
        make_float4(field(v.x, h.x, m.x), field(v.y, h.y, m.y),
                    field(v.z, h.z, m.z), field(v.w, h.w, m.w));
    return;
  }
  for (long long i = 4 * g; i < n && i < 4 * g + 4; ++i) phi[i] = field(V[i], Vh[i], M[i]);
}

// Fixed-order butterfly sum over the warp; every lane gets the total.
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// part[b] = the sum of block b's terms, each thread's in f64 in index
// order, then the warp and the block in a fixed order.
template <bool WEIGHTED>
__global__ void __launch_bounds__(NT)
kl_cost_kernel(const float* __restrict__ V, const float* __restrict__ Vh,
               const float* __restrict__ M, double* __restrict__ part, long long n,
               bool vec) {
  __shared__ double red[NT / 32];
  const long long tid = (long long)blockIdx.x * NT + threadIdx.x;
  const long long stride = (long long)gridDim.x * NT;
  long long head = 0;
  double s = 0.0;
  if (vec) {
    head = n / 4 * 4;
    for (long long i = tid; i < n / 4; i += stride) {
      const float4 v = load4(V, i), h = load4(Vh, i);
      const float4 m = WEIGHTED ? load4(M, i) : make_float4(0.f, 0.f, 0.f, 0.f);
      s += (double)term<WEIGHTED>(v.x, h.x, m.x);
      s += (double)term<WEIGHTED>(v.y, h.y, m.y);
      s += (double)term<WEIGHTED>(v.z, h.z, m.z);
      s += (double)term<WEIGHTED>(v.w, h.w, m.w);
    }
  }
  for (long long i = head + tid; i < n; i += stride)
    s += (double)term<WEIGHTED>(V[i], Vh[i], WEIGHTED ? M[i] : 0.f);
  s = warp_sum(s);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double b = red[0];
    for (int w = 1; w < NT / 32; ++w) b += red[w];
    part[blockIdx.x] = b;
  }
}

// out[0] = (float) sum(part[0..count)): each thread's stride in order,
// then a fixed tree over the block.
__global__ void __launch_bounds__(NT)
kl_reduce_partials_kernel(const double* __restrict__ part, long long count,
                          float* __restrict__ out) {
  __shared__ double red[NT];
  double s = 0.0;
  for (long long i = threadIdx.x; i < count; i += NT) s += part[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = NT / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)red[0];
}

// Blocks of the cost `kernel` for n entries: one wave of the blocks the
// current card keeps resident, fewer where n gives each thread less than
// one float4, at least one.
template <class K>
cudaError_t one_wave(K kernel, long long n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
  if (err != cudaSuccess) return err;
  const long long need = ((n + 3) / 4 + NT - 1) / NT;
  const long long wave = (long long)sms * per_sm;
  *blocks = (int)(need < wave ? (need > 0 ? need : 1) : (wave > 0 ? wave : 1));
  return cudaSuccess;
}

bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) % 16) == 0;
}

auto cost_kernel_for(bool weighted) {
  return weighted ? kl_cost_kernel<true> : kl_cost_kernel<false>;
}

}  // namespace

extern "C" {

// phi = the KL field of (V, Vh) weighted by M (not NULL); all n entries,
// contiguous.
int nmf_kl_field(const float* V, const float* Vh, const float* M, float* phi,
                 long long n, void* stream) {
  if (!M) return (int)cudaErrorInvalidValue;
  if (n < 1) return (int)cudaSuccess;
  const long long blocks = ((n + 3) / 4 + NT - 1) / NT;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kl_field_kernel<<<(unsigned)blocks, NT, 0, s>>>(V, Vh, M, phi, n, aligned16(V, Vh, M, phi));
  return (int)cudaGetLastError();
}

// Doubles of scratch nmf_kl_cost needs for n entries (one per block), on
// the current card; 0 if the card cannot be asked.
long long nmf_kl_cost_partials(long long n, int weighted) {
  int blocks = 0;
  return one_wave(cost_kernel_for(weighted != 0), n, &blocks) == cudaSuccess ? blocks : 0;
}

// out[0] = the KL cost of (V, Vh), weighted by M (NULL: unweighted), over
// n contiguous entries.  part: nmf_kl_cost_partials(n, M != NULL) doubles.
int nmf_kl_cost(const float* V, const float* Vh, const float* M, double* part,
                float* out, long long n, void* stream) {
  const auto kernel = cost_kernel_for(M != nullptr);
  int blocks = 0;
  cudaError_t err = one_wave(kernel, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, NT, 0, s>>>(V, Vh, M, part, n, aligned16(V, Vh, M, nullptr));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kl_reduce_partials_kernel<<<1, NT, 0, s>>>(part, blocks, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
