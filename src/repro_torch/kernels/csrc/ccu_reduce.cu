// CCU in-line reduce — CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ccu_kernel` / `ccu_reduce` of
// src/repro/kernels/ccu_reduce.py.  It computes the same function,
//     out[n] = (...((0 + bufs[0, n] * scale[0]) + bufs[1, n] * scale[1]) ...)
//              + bufs[P-1, n] * scale[P-1]
// in fp32: each peer's element widened to fp32, multiplied by its peer's
// dequant scale (1 when none is given) and added to the accumulator, each
// product and each sum rounded once, the peers in the fixed order
// p = 0 .. P-1.  The order is the contract: two runs give the same bits, and
// so does the plain version (a Python loop over p of the same two
// operations).
//
// What differs from the TPU kernel, because the machine does:
//  * The TPU grid walks (chunk of block_n elements, peer) with the peer axis
//    sequential and the chunk's fp32 accumulator in VMEM.  Here each thread
//    owns one run of contiguous elements, 16 bytes of one peer's row (16
//    int8, 8 bf16 or fp16, 4 fp32 elements), and LOOPS over the peers in
//    order with its accumulators in registers; there is no block grid over
//    peers, no atomics and no split of P into a tree.  A block's sums go out
//    through shared memory, so that a warp's stores are contiguous: a run of
//    16 int8 is 64 bytes of fp32 sums.
//  * Products and sums are written __fmul_rn / __fadd_rn, so nvcc cannot
//    contract them into one fused multiply-add: the reference rounds twice
//    per peer, and so does this kernel.
//  * Any N: the ragged last block (N not a multiple of its THREADS runs) is
//    read element by element; the reference asserts N % block_n == 0.
//    Rows are read through a row stride (elements), so a view of a larger
//    buffer is read in place; where a row's start is not 16-byte aligned the
//    whole call reads element by element.  Offsets are 64-bit: a leaf of
//    granite-8b's 8-layer training state has 469,762,048 elements and P * N
//    passes 2^31.
//  * Peers may be fp32, bf16, fp16 or int8; the output is always fp32.
//
// Bound on this card: bytes.  P * N input elements read once and N fp32
// written once; two operations an element and peer never bind.  On the
// training path (P = 1, int8) four fifths of the bytes are the fp32 writes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Params {
  const void* bufs;       // (P, N), row stride `stride` elements, innermost 1
  const float* scales;    // (P,) or null
  float* out;             // (N,)
  int P;
  long long N, stride;
  int vec_ok;             // every row starts 16-byte aligned
};

__device__ inline float widen(float v) { return v; }
__device__ inline float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline float widen(__half v) { return __half2float(v); }
__device__ inline float widen(int8_t v) { return static_cast<float>(v); }

// 16 bytes of a row as fp32 elements.
template <typename T>
__device__ inline void load16(const T* p, float* v) {
  constexpr int N = 16 / sizeof(T);
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&a);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = widen(e[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ccu_kernel(Params p) {
  constexpr int RUN = 16 / sizeof(T);
  const T* bufs = static_cast<const T*>(p.bufs);
  const long long base = static_cast<long long>(blockIdx.x) * THREADS * RUN;   // the block's first element
  const long long n0 = base + static_cast<long long>(threadIdx.x) * RUN;        // this thread's run

  if (p.vec_ok && base + THREADS * RUN <= p.N) {   // the same branch for the whole block
    float acc[RUN];
#pragma unroll
    for (int i = 0; i < RUN; ++i) acc[i] = 0.0f;
    for (int q = 0; q < p.P; ++q) {
      const float s = p.scales ? p.scales[q] : 1.0f;
      float x[RUN];
      load16(bufs + q * p.stride + n0, x);
#pragma unroll
      for (int i = 0; i < RUN; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(x[i], s));
    }
    // Each thread holds RUN contiguous sums, 4 * RUN bytes: written straight
    // out, a warp's float4 stores would land 4 * RUN bytes apart.  Through
    // shared memory, consecutive threads write consecutive 16-byte pieces.
    __shared__ float4 stage[THREADS * RUN / 4];
#pragma unroll
    for (int i = 0; i < RUN / 4; ++i)
      stage[threadIdx.x * (RUN / 4) + i] =
          make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    __syncthreads();
    float4* o = reinterpret_cast<float4*>(p.out + base);
#pragma unroll
    for (int i = 0; i < RUN / 4; ++i) o[i * THREADS + threadIdx.x] = stage[i * THREADS + threadIdx.x];
    return;
  }
  // the ragged last block, or rows that are not 16-byte aligned: one element at a time
  const long long n1 = n0 + RUN < p.N ? n0 + RUN : p.N;
  for (long long n = n0; n < n1; ++n) {
    float acc = 0.0f;
    for (int q = 0; q < p.P; ++q) {
      const float s = p.scales ? p.scales[q] : 1.0f;
      acc = __fadd_rn(acc, __fmul_rn(widen(bufs[q * p.stride + n]), s));
    }
    p.out[n] = acc;
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int RUN = 16 / sizeof(T);
  const long long threads = (p.N + RUN - 1) / RUN;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ccu_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16, 3 int8.  scales may be null.
extern "C" int ccu_reduce_fwd(
    const void* bufs, const float* scales, float* out,
    int P, long long N, long long stride, int dtype, int vec_ok, void* stream) {
  Params p;
  p.bufs = bufs; p.scales = scales; p.out = out;
  p.P = P; p.N = N; p.stride = stride; p.vec_ok = vec_ok;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch<float>(p, s);
  else if (dtype == 1) err = launch<__nv_bfloat16>(p, s);
  else if (dtype == 2) err = launch<__half>(p, s);
  else if (dtype == 3) err = launch<int8_t>(p, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* ccu_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
