// Flash attention (GQA), backward — CUDA C++ for Hopper (sm_90a), bf16 at
// head_dim 64 and 128.
//
// Replaces no TPU kernel: the Pallas kernel of src/repro/kernels/
// flash_attention.py has no backward (no custom_vjp), and JAX differentiates
// the plain attention there.  This is the gradient of the forward kernel of
// flash_attention.cu, for training: given q, k, v, the output o, each row's
// log-sum-exp `lse` of its scaled, filled scores (the forward writes it under
// autograd) and the output's gradient dO, it computes
//     P  = exp(S * scale - lse),   S = Q K^T, masked keys P = 0
//     dV = P^T dO
//     dP = dO V^T,  delta = rowsum(dO o O)
//     dS = P o (dP - delta)
//     dQ = scale * dS K,  dK = scale * dS^T Q
// with the forward's masks (causal, window, prefix, q_start, Sq != Sk and
// ragged edges), dK and dV summed over the G query heads of their kv head.
// Nothing of size Sq x Sk reaches device memory: the probabilities are
// recomputed tile by tile from lse.
//
// What bounds it: operations.  Every visible (query, key) pair takes seven
// products of 2 D flops (S and dP twice, dV, dK, dQ) against two in the
// forward (nine on the tensor cores: dS goes in as two bf16 parts, below);
// granite-8b's training layer (2 x 4,096 tokens, 32 heads of 128, causal)
// needs about 0.96 TFLOP of the seven, about 1 ms at the bf16 peak, against
// 0.15 GB of operands (0.05 ms at the memory rate).  So the products run on
// the tensor cores (wgmma, bf16 operands, fp32 sums) and the element-wise
// work between them is kept short.  Three launches, no atomics, every sum in
// a fixed order (two launches give the same bits):
//
//  (a) `flash_bwd_delta_kernel`: one warp a row, delta = rowsum(dO o O) in
//      fp32 (a butterfly of fixed order; O as the forward kernel had it
//      before rounding to bf16, which it writes under autograd: from the
//      bf16 O, dQ and dK lay up to 1.13 bf16 ulps of their largest element
//      from the float64 oracle at 100 rows) and lse in units of log2 (the
//      kernels below use ex2), both into rows padded to whole 64-row tiles
//      (zeros past Sq), so the tiles read them with 16-byte copies and no
//      edge.  Bound by bytes.
//  (b) `flash_bwd_dkdv_kernel`: one warpgroup a block of 64 keys of one
//      (batch, kv head), K and V resident in shared memory; the block walks
//      the G query heads of its kv head and, within each, the query tiles
//      that see its keys, in order; Q, dO and their rows' lse and delta
//      stream through a two-stage cp.async ring.  Per query tile:
//      S^T = K Q^T and dP^T = V dO^T (wgmma, both operands from shared
//      memory, keys as the 64 rows, so that P^T and dS^T land in the
//      accumulator layout that is the A fragment of the next products);
//      P^T from S^T and lse on the accumulator fragments (fp32, ex2);
//      dV += P^T dO issued while dP^T finishes; dS^T = P^T o (dP^T - delta)
//      in fp32; dK += dS^T Q.  P enters the product rounded to bf16 (the
//      forward's own precision for P V); dS as two bf16 parts, dS_hi =
//      bf16(dS) and dS_lo = bf16(dS - dS_hi), each through the tensor cores
//      into the same fp32 sum: a row's dS sums to zero, so dQ and dK are
//      differences of large terms (emulated on the CPU, one bf16 dS left
//      them up to 0.64 of one bf16 ulp of their largest element from the
//      float64 oracle, two parts 0.44).  The sums stay in fp32 registers,
//      and dK and dV are written once, in bf16.
//  (c) `flash_bwd_dq_kernel`: one warpgroup a block of 64 query rows of one
//      (batch, kv head, query head), Q, dO, lse and delta resident; the
//      visible key tiles stream through a two-stage K/V ring; S and dP are
//      recomputed, dS as in (b), and dQ += dS K (dS in two parts).
//  Atomics for dQ inside (b) would save S and dP's second products (five
//  instead of seven), but their order changes from run to run; the port's
//  kernels sum in a fixed order.
//  Grids put the tile index in y, heaviest first: under a causal mask the
//  first keys are seen by the most rows, the last rows see the most keys.
//  A tile pair that no row sees is never visited; a tile pair that every row
//  sees whole skips the mask.  Two blocks an SM (97 KB of shared memory each
//  at head_dim 128; dK and dV take 128 fp32 registers a thread).
//
// Left for later: a producer warp with TMA, two consumer warpgroups sharing
// each Q / dO tile, and a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;       // query rows in a tile
constexpr int BN = 64;       // keys in a tile
constexpr int NT = 128;      // threads a block of (b), (c): one warpgroup
constexpr int STAGES = 2;    // the rings
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const bf16 *q, *k, *v, *dout;
  const float* o;              // the forward's output before its rounding to bf16
  const float* lse;            // (B, K, G, Sq), natural log
  float *lse2, *delta;         // (B, K, G, Sq_pad): lse * log2(e), rowsum(dO o O)
  bf16 *dq, *dk, *dv;
  int B, K, G, Sq, Sk, Sq_pad;
  long long q_sb, q_sk, q_sg, q_ss;
  long long k_sb, k_sk, k_ss;
  long long v_sb, v_sk, v_ss;
  long long o_sb, o_sk, o_sg, o_ss;
  long long do_sb, do_sk, do_sg, do_ss;
  long long dq_sb, dq_sk, dq_sg, dq_ss;
  long long dk_sb, dk_sk, dk_ss;
  long long dv_sb, dv_sk, dv_ss;
  int causal, window, prefix_len, q_start;   // window < 0: none
  float sm_scale;
};

// the forward's mask for one pair (positions), and the ragged edges
__device__ inline bool visible_pair(const Params& p, int qrow, int qpos, int kpos) {
  if (qrow >= p.Sq || kpos >= p.Sk) return false;
  if (kpos < p.prefix_len) return true;
  return (!p.causal || qpos >= kpos) && (p.window < 0 || qpos - kpos < p.window);
}

// Does some row of query positions [qa, qz] see some key of [ka, kz]?
__device__ inline bool tiles_meet(const Params& p, int qa, int qz, int ka, int kz) {
  if (p.prefix_len > 0 && ka < p.prefix_len) return true;
  if (p.causal && ka > qz) return false;
  if (p.window >= 0 && qa - kz >= p.window) return false;
  return true;
}

// Does every row of [qa, qa + BM) see every key of [ka, ka + BN), with no edge?
__device__ inline bool tiles_full(const Params& p, int qrow0, int qa, int ka) {
  if (qrow0 + BM > p.Sq || ka + BN > p.Sk) return false;
  if (ka + BN <= p.prefix_len) return true;
  return (!p.causal || ka + BN - 1 <= qa) && (p.window < 0 || qa + BM - 1 - ka < p.window);
}

__device__ inline void cp_async16(void* smem, const void* gmem, bool valid) {
  // src-size 0 fills the 16 bytes with zeros: rows past the edge are zero
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// Tiles are 64 rows of D bf16 in 128-byte swizzled column blocks (the wgmma
// canonical layout, as the forward's): chunk c (16 bytes) of row r lies at
// byte (c / 8) * 64 * 128 + r * 128 + ((c % 8) ^ (r % 8)) * 16.
template <int D>
__device__ inline void load_tile_async(unsigned char* dst, const bf16* base, long long row_stride, int row0,
                                       int rows, int tid) {
  constexpr int CH = D / 8;
  static_assert(64 * CH % NT == 0, "whole rounds of 16-byte chunks");
#pragma unroll
  for (int c0 = 0; c0 < 64 * CH; c0 += NT) {
    const int c = c0 + tid;
    const int r = c / CH;
    const int ch = c % CH;
    const bool in = row0 + r < rows;
    const bf16* src = base + (in ? (long long)(row0 + r) * row_stride + ch * 8 : 0);
    cp_async16(dst + (ch >> 3) * 64 * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4), src, in);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ inline uint64_t descriptor(const void* p, unsigned lbo, unsigned sbo) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// the k-step ks (16 columns of D) of a 64-row K-major tile
__device__ inline uint64_t kmajor(const unsigned char* tile, int ks) {
  return descriptor(tile + (ks >> 2) * 64 * 128 + (ks & 3) * 32, 16, 1024);
}

// the k-step kk (16 rows) of a 64-row tile read as an MN-major B operand
__device__ inline uint64_t mnmajor(const unsigned char* tile, int kk) {
  return descriptor(tile + kk * 2048, 64 * 128, 1024);
}

__device__ inline float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ inline void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory"); }

// d (m64 x n64, fp32) (+)= A (smem, K-major) . B (smem, K-major); scale_d 0 overwrites d
__device__ inline void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (m64 x n64, fp32) += A (registers) . B (smem, MN-major: transposed)
__device__ inline void wgmma_rs_n64(float (&d)[32], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64 x n128, fp32) += A (registers) . B (smem, MN-major: transposed)
__device__ inline void wgmma_rs_n128(float (&d)[64], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ inline void wgmma_rs(float (&d)[N / 2], const unsigned (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

__device__ inline unsigned pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<const unsigned*>(&h);
}

// Accumulator layout of wgmma m64nN (lane = 4 g + t of warp w): d[4 n + e]
// holds row 16 w + g (e < 2) or 16 w + g + 8 (e >= 2), column 8 n + 2 t + (e & 1).
// The A fragment of k-step kk (columns 16 kk ..) is n tiles 2 kk and 2 kk + 1.
__device__ inline void to_fragments(const float (&x)[32], unsigned (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// x = hi + lo as two bf16 A fragments: hi = bf16(x), lo = bf16(x - hi)
__device__ inline void to_split_fragments(const float (&x)[32], unsigned (&hi)[4][4], unsigned (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = x[8 * kk + 2 * e], x1 = x[8 * kk + 2 * e + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][e] = *reinterpret_cast<const unsigned*>(&h);
      lo[kk][e] = pack(x0 - hf.x, x1 - hf.y);
    }
}

// 64 x D accumulator (rows row0 + 16 w + g (+ 8), columns 8 n + 2 t) times
// `scale` into bf16 rows of `dst` below `rows`
template <int D>
__device__ inline void store_rows(bf16* dst, long long row_stride, int row0, int rows, const float (&acc)[D / 2],
                                  float scale, int warp, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + warp * 16 + g + 8 * h;
    if (r < rows) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<unsigned*>(dst + (long long)r * row_stride + 8 * n + 2 * t) =
            pack(acc[4 * n + 2 * h] * scale, acc[4 * n + 2 * h + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// (a) delta = rowsum(dO o O) and lse in log2 units, padded rows
// ---------------------------------------------------------------------------

constexpr int DELTA_WARPS = 8;

__device__ inline float2 load2(const bf16* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}
__device__ inline float2 load2(const float* x) { return *reinterpret_cast<const float2*>(x); }

template <int D>
__global__ void flash_bwd_delta_kernel(const Params p) {
  const long long row = (long long)blockIdx.x * DELTA_WARPS + threadIdx.x / 32;
  if (row >= (long long)p.B * p.K * p.G * p.Sq_pad) return;
  const int lane = threadIdx.x % 32;
  const int s = static_cast<int>(row % p.Sq_pad);
  const long long bkg = row / p.Sq_pad;       // (b * K + kh) * G + g
  const int g = static_cast<int>(bkg % p.G);
  const int kh = static_cast<int>(bkg / p.G % p.K);
  const int b = static_cast<int>(bkg / p.G / p.K);
  float d = 0.f, l2 = 0.f;
  if (s < p.Sq) {                              // the same for the whole warp
    constexpr int PER = D / 32;
    const float* o = p.o + b * p.o_sb + kh * p.o_sk + g * p.o_sg + s * p.o_ss + lane * PER;
    const bf16* dout = p.dout + b * p.do_sb + kh * p.do_sk + g * p.do_sg + s * p.do_ss + lane * PER;
#pragma unroll
    for (int e = 0; e < PER; e += 2) {
      const float2 of = load2(o + e);
      const float2 df = load2(dout + e);
      d = fmaf(of.x, df.x, d);
      d = fmaf(of.y, df.y, d);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    l2 = p.lse[bkg * p.Sq + s] * LOG2E;
  }
  if (lane == 0) {
    p.delta[row] = d;
    p.lse2[row] = l2;
  }
}

// ---------------------------------------------------------------------------
// (b) dK and dV: a block of 64 keys walks the query tiles that see them
// ---------------------------------------------------------------------------

template <int D>
struct Layout {
  static constexpr int TILE = 64 * D * 2;      // 64 rows of D bf16
  static constexpr int STATS = 2 * BM * 4;     // a query tile's lse2 and delta
  // K, V, then the ring of (Q, dO), then the ring's stats
  static constexpr int DKDV_SMEM = 2 * TILE + STAGES * (2 * TILE + STATS);
  // Q, dO, then the ring of (K, V)
  static constexpr int DQ_SMEM = 2 * TILE + STAGES * 2 * TILE;
  static_assert(2 * (DKDV_SMEM + 1024) <= 233472 && 2 * (DQ_SMEM + 1024) <= 233472, "two blocks an SM");
};

template <int D>
__global__ void __launch_bounds__(NT, 2) flash_bwd_dkdv_kernel(const Params p) {
  using L = Layout<D>;
  constexpr int NO = D / 8;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + L::TILE;
  unsigned char* ring = Vs + L::TILE;                          // stage s: Q, then dO
  float* stats = reinterpret_cast<float*>(ring + STAGES * 2 * L::TILE);   // stage s: lse2, then delta

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bk = blockIdx.x;                   // b * K + kh
  const int b = bk / p.K;
  const int kh = bk % p.K;
  const int k_lo = blockIdx.y * BN;            // the first keys (the most rows see them) first
  const int k_hi = min(k_lo + BN, p.Sk) - 1;

  const bf16* kb = p.k + b * p.k_sb + kh * p.k_sk;
  const bf16* vb = p.v + b * p.v_sb + kh * p.v_sk;
  const bf16* qb = p.q + b * p.q_sb + kh * p.q_sk;
  const bf16* dob = p.dout + b * p.do_sb + kh * p.do_sk;
  const float* lse2b = p.lse2 + (long long)bk * p.G * p.Sq_pad;
  const float* deltab = p.delta + (long long)bk * p.G * p.Sq_pad;

  // the query tiles that see these keys: one run [i0, i1) (a causal mask
  // cuts it below, a window above; a prefix key is seen by all)
  const int n_qt = (p.Sq + BM - 1) / BM;
  int i0 = 0;
  while (i0 < n_qt && !tiles_meet(p, p.q_start + i0 * BM, p.q_start + min(i0 * BM + BM, p.Sq) - 1, k_lo, k_hi))
    ++i0;
  int i1 = i0;
  while (i1 < n_qt && tiles_meet(p, p.q_start + i1 * BM, p.q_start + min(i1 * BM + BM, p.Sq) - 1, k_lo, k_hi))
    ++i1;
  const int nv = i1 - i0;
  const int n_items = p.G * nv;               // item it: query head it / nv, tile i0 + it % nv

  load_tile_async<D>(Ks, kb, p.k_ss, k_lo, p.Sk, tid);
  load_tile_async<D>(Vs, vb, p.v_ss, k_lo, p.Sk, tid);
  auto load_item = [&](int stage, int it) {
    const int gh = it / nv;
    const int i = i0 + it % nv;
    unsigned char* Qd = ring + stage * 2 * L::TILE;
    load_tile_async<D>(Qd, qb + gh * p.q_sg, p.q_ss, i * BM, p.Sq, tid);
    load_tile_async<D>(Qd + L::TILE, dob + gh * p.do_sg, p.do_ss, i * BM, p.Sq, tid);
    if (tid < 32) {
      const float* src = (tid < 16 ? lse2b : deltab) + (long long)gh * p.Sq_pad + i * BM + (tid % 16) * 4;
      cp_async16(stats + stage * 2 * BM + (tid / 16) * BM + (tid % 16) * 4, src, true);
    }
  };
  if (n_items > 0) load_item(0, 0);
  cp_async_commit();                           // K, V and the first item
  if (n_items > 1) load_item(1, 1);
  cp_async_commit();

  float dv[NO * 4], dk[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) dv[i] = dk[i] = 0.f;
  const float scale2 = p.sm_scale * LOG2E;
  const int krow = k_lo + warp * 16 + g;       // this thread's keys: krow, krow + 8

  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    cp_async_wait<1>();                        // this item has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const unsigned char* Qs = ring + st * 2 * L::TILE;
    const unsigned char* dOs = Qs + L::TILE;
    const float* lse_s = stats + st * 2 * BM;
    const float* delta_s = lse_s + BM;

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) wgmma_ss_n64(s, kmajor(Ks, ks), kmajor(Qs, ks), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) wgmma_ss_n64(dp, kmajor(Vs, ks), kmajor(dOs, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();                           // S^T (keys x queries)

    const int qrow0 = (i0 + it % nv) * BM;
    const int qpos0 = p.q_start + qrow0;
    const bool full = tiles_full(p, qrow0, qpos0, k_lo);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        float x = exp2_approx(fmaf(s[4 * n + e], scale2, -((e & 1) ? ls.y : ls.x)));
        if (!full && !visible_pair(p, qrow0 + c, qpos0 + c, krow + 8 * (e >> 1))) x = 0.f;
        s[4 * n + e] = x;
      }
    }
    unsigned pf[4][4], dh[4][4], dl[4][4];
    to_fragments(s, pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dv, pf[kk], mnmajor(dOs, kk));
    wgmma_commit();
    wgmma_wait<1>();                           // dP^T; dV's product runs on
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * n + e] = s[4 * n + e] * (dp[4 * n + e] - ((e & 1) ? dl.y : dl.x));
    }
    to_split_fragments(dp, dh, dl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(dk, dh[kk], mnmajor(Qs, kk));
      wgmma_rs<D>(dk, dl[kk], mnmajor(Qs, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();                           // every warp is done with this stage
    if (it + 2 < n_items) load_item(st, it + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

  store_rows<D>(p.dk + b * p.dk_sb + kh * p.dk_sk, p.dk_ss, k_lo, p.Sk, dk, p.sm_scale, warp, g, t);
  store_rows<D>(p.dv + b * p.dv_sb + kh * p.dv_sk, p.dv_ss, k_lo, p.Sk, dv, 1.f, warp, g, t);
}

// ---------------------------------------------------------------------------
// (c) dQ: a block of 64 query rows walks the key tiles they see
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NT, 2) flash_bwd_dq_kernel(const Params p) {
  using L = Layout<D>;
  constexpr int NO = D / 8;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* dOs = Qs + L::TILE;
  unsigned char* ring = dOs + L::TILE;         // stage s: K, then V

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bkg = blockIdx.x;                  // (b * K + kh) * G + gh
  const int gh = bkg % p.G;
  const int kh = bkg / p.G % p.K;
  const int b = bkg / p.G / p.K;
  const int n_qt = (p.Sq + BM - 1) / BM;
  const int qrow0 = (n_qt - 1 - blockIdx.y) * BM;   // the last rows (the most keys) first
  const int qpos0 = p.q_start + qrow0;
  const int qpos_hi = p.q_start + min(qrow0 + BM, p.Sq) - 1;

  const bf16* kb = p.k + b * p.k_sb + kh * p.k_sk;
  const bf16* vb = p.v + b * p.v_sb + kh * p.v_sk;
  load_tile_async<D>(Qs, p.q + b * p.q_sb + kh * p.q_sk + gh * p.q_sg, p.q_ss, qrow0, p.Sq, tid);
  load_tile_async<D>(dOs, p.dout + b * p.do_sb + kh * p.do_sk + gh * p.do_sg, p.do_ss, qrow0, p.Sq, tid);

  // the visible key tiles, in order; under a causal mask none past the last
  // row's diagonal and the prefix
  const int n_kt = (p.Sk + BN - 1) / BN;
  const int stop = p.causal ? min(n_kt, max(qpos_hi, p.prefix_len - 1) / BN + 1) : n_kt;
  auto next = [&](int j) {
    while (j < stop && !tiles_meet(p, qpos0, qpos_hi, j * BN, min(j * BN + BN, p.Sk) - 1)) ++j;
    return j < stop ? j : n_kt;
  };
  auto load_kv = [&](int stage, int j) {
    unsigned char* Kd = ring + stage * 2 * L::TILE;
    load_tile_async<D>(Kd, kb, p.k_ss, j * BN, p.Sk, tid);
    load_tile_async<D>(Kd + L::TILE, vb, p.v_ss, j * BN, p.Sk, tid);
  };
  int j = next(0);
  int jl = j;                                  // the next tile to load
#pragma unroll
  for (int st = 0; st < STAGES; ++st) {
    if (jl < n_kt) {
      load_kv(st, jl);
      jl = next(jl + 1);
    }
    cp_async_commit();                         // the first group holds Q and dO too
  }

  // this thread's rows qrow0 + 16 warp + g (+ 8): their lse2 and delta (padded rows)
  const long long srow = (long long)bkg * p.Sq_pad + qrow0 + warp * 16 + g;
  const float lse2[2] = {p.lse2[srow], p.lse2[srow + 8]};
  const float delta[2] = {p.delta[srow], p.delta[srow + 8]};
  const int rrow = warp * 16 + g;

  float dq[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) dq[i] = 0.f;
  const float scale2 = p.sm_scale * LOG2E;
  int st = 0;
  while (j < n_kt) {
    cp_async_wait<1>();                        // tile j has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const unsigned char* Ks = ring + st * 2 * L::TILE;
    const unsigned char* Vs = Ks + L::TILE;

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) wgmma_ss_n64(s, kmajor(Qs, ks), kmajor(Ks, ks), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) wgmma_ss_n64(dp, kmajor(dOs, ks), kmajor(Vs, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();                           // S (rows x keys)

    const int k_lo = j * BN;
    const bool full = tiles_full(p, qrow0, qpos0, k_lo);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int c = (i >> 2) * 8 + 2 * t + (i & 1);
      float x = exp2_approx(fmaf(s[i], scale2, -lse2[h]));
      if (!full && !visible_pair(p, qrow0 + rrow + 8 * h, qpos0 + rrow + 8 * h, k_lo + c)) x = 0.f;
      s[i] = x;
    }
    wgmma_wait<0>();                           // dP
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - delta[(i >> 1) & 1]);
    unsigned dh[4][4], dl[4][4];
    to_split_fragments(dp, dh, dl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(dq, dh[kk], mnmajor(Ks, kk));
      wgmma_rs<D>(dq, dl[kk], mnmajor(Ks, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();                           // every warp is done with this stage
    if (jl < n_kt) {
      load_kv(st, jl);
      jl = next(jl + 1);
    }
    cp_async_commit();
    st ^= 1;
    j = next(j + 1);
  }
  cp_async_wait<0>();

  store_rows<D>(p.dq + b * p.dq_sb + kh * p.dq_sk + gh * p.dq_sg, p.dq_ss, qrow0, p.Sq, dq, p.sm_scale,
                warp, g, t);
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Layout<D>;
  const long long rows = (long long)p.B * p.K * p.G * p.Sq_pad;
  const unsigned blocks = static_cast<unsigned>((rows + DELTA_WARPS - 1) / DELTA_WARPS);
  flash_bwd_delta_kernel<D><<<blocks, 32 * DELTA_WARPS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DKDV_SMEM);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<D><<<dim3(p.B * p.K, (p.Sk + BN - 1) / BN), NT, L::DKDV_SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DQ_SMEM);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<dim3(p.B * p.K * p.G, p.Sq_pad / BM), NT, L::DQ_SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// bf16 only, but `o`: fp32, the forward's output before its rounding.
// strides: 28 element strides in the order q(b,k,g,s)
// k(b,k,s) v(b,k,s) o(b,k,g,s) dout(b,k,g,s) dq(b,k,g,s) dk(b,k,s)
// dv(b,k,s); every innermost stride is 1 and every row 16-byte aligned.
// `lse`: the forward's (B, K, G, Sq) fp32.  `work`: fp32 workspace of
// 2 * B*K*G*ceil(Sq/64)*64 floats (16-byte aligned).  window < 0 means none.
// Returns the cudaError_t of the launches (0 = ok); it does not synchronise.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const float* o, const void* dout, const void* lse,
    void* dq, void* dk, void* dv, void* work,
    int B, int K, int G, int Sq, int Sk, int D, const long long* strides,
    int causal, int window, int prefix_len, int q_start, float sm_scale, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q); p.k = static_cast<const bf16*>(k); p.v = static_cast<const bf16*>(v);
  p.o = o; p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dq = static_cast<bf16*>(dq); p.dk = static_cast<bf16*>(dk); p.dv = static_cast<bf16*>(dv);
  p.B = B; p.K = K; p.G = G; p.Sq = Sq; p.Sk = Sk;
  p.Sq_pad = (Sq + BM - 1) / BM * BM;
  p.lse2 = static_cast<float*>(work);
  p.delta = p.lse2 + (long long)B * K * G * p.Sq_pad;
  const long long* s = strides;
  p.q_sb = s[0]; p.q_sk = s[1]; p.q_sg = s[2]; p.q_ss = s[3];
  p.k_sb = s[4]; p.k_sk = s[5]; p.k_ss = s[6];
  p.v_sb = s[7]; p.v_sk = s[8]; p.v_ss = s[9];
  p.o_sb = s[10]; p.o_sk = s[11]; p.o_sg = s[12]; p.o_ss = s[13];
  p.do_sb = s[14]; p.do_sk = s[15]; p.do_sg = s[16]; p.do_ss = s[17];
  p.dq_sb = s[18]; p.dq_sk = s[19]; p.dq_sg = s[20]; p.dq_ss = s[21];
  p.dk_sb = s[22]; p.dk_sk = s[23]; p.dk_ss = s[24];
  p.dv_sb = s[25]; p.dv_sk = s[26]; p.dv_ss = s[27];
  p.causal = causal; p.window = window; p.prefix_len = prefix_len; p.q_start = q_start;
  p.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64: err = launch<64>(p, st); break;
    case 128: err = launch<128>(p, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
