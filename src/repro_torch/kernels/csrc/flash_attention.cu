// Flash attention (GQA), forward — CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py.  It computes the same function:
// online-softmax blocked attention over grouped query heads with the mask
//     ok = [causal: q_pos >= k_pos] & [window: q_pos - k_pos < window]
//     ok = ok | (k_pos < prefix_len)
// masked scores filled with the FINITE constant -1e30, fp32 running max /
// sum / accumulator, out = acc / max(l, 1e-20).
//
// Common to all three kernels below, and different from the TPU kernel
// because the machine is:
//  * The G query heads of a group are folded into rows (row r = position * G
//    + head), so a K/V tile is read once for all heads of the group.
//  * A block loops over its kv tiles (the TPU grid's sequential third axis);
//    tiles that the causal / window test rules out for all of the block's
//    rows are skipped, never one that starts below `prefix_len`.
//  * Any Sq, Sk >= 1: the ragged edge is masked here, nothing is padded.
//    `q_start` is the global position of query row 0, so the same function
//    serves prefill (q_start = 0) and a decode step over a cache.
//  * q, k, v, o come with element strides (innermost stride 1, 16-byte
//    rows), so the model's (B, S, heads, Dh) layout and KV-cache slices are
//    read in place.
//
// What bounds it: at every main-path shape (granite-8b, mixtral-8x22b,
// zamba2-1.2b, paligemma-3b and whisper-base prefill and decode, granite-8b's
// training step) the function is bound by bytes (q, k, v read once, o written once) on this card.  At
// prefill the operations are level with them: with P split in two (below)
// the granite-8b prompt's visible (query, key) pairs need about 12.9 GFLOP,
// about as long at the published bf16 peak as its bytes take at the memory
// rate; so the products must run on the tensor cores and overlap the softmax
// and the loads.  Three kernels, by the caller's rows:
//
//  1. bf16, folded rows G*Sq > 16 (prefill, training): `flash_fwd_tc_kernel`.
//     One warpgroup (4 warps) a block of 64 folded rows; wgmma m64n64k16 for
//     S = Q.K^T with both operands in shared memory, wgmma m64nDk16 for
//     O += P.V with P from registers.  Q, K and V stay bf16 in shared memory,
//     in the 128-byte swizzled layout wgmma reads without bank conflicts, and
//     arrive by cp.async, 16 bytes a thread, into a three-stage K/V ring.
//     S accumulates in fp32 (bf16 products are exact in fp32; only the order
//     of the sum changes).  Scale, mask and the online softmax work on the
//     accumulator fragments in registers, the row max and sum shuffled within
//     the quad that owns the row; the scores are kept times log2(e) and
//     exponentiated with ex2.approx.  P goes from the S accumulators straight
//     into A fragments, split as P_hi = bf16(P) and P_lo = bf16(P - P_hi);
//     both go through the tensor cores into the same fp32 accumulator.  One
//     bf16 P would lie up to ~140 bf16 ulps from the fp32-P result on a few %
//     of the elements; the split keeps the kernel within one ulp of its plain
//     version.  Per tile: start S of the next tile and O += P.V of this one,
//     then the next tile's softmax runs while O's product is on the tensor
//     cores.  The output is staged through shared memory and written as
//     16-byte rows.  Rows that see more than FLUSH_TILES tiles (a model
//     rank's rows far down a long sequence) add O into an fp32 copy in global
//     memory every FLUSH_TILES tiles and restart it from zero: the tensor
//     cores' fp32 accumulation rounds each addition against the
//     accumulator's size, which over 32,768 keys moved outputs near zero past
//     the one-ulp-plus-1e-5 limit; a sum of 2,048 keys stays within it, and
//     the copies are added with fp32 FMAs.  Shorter rows never flush.  At head_dim 256 (paligemma-3b) a block has two
//     warpgroups, each owning 128 of the output's columns: O alone would be
//     128 fp32 registers a thread in one warpgroup.  Each warpgroup computes
//     the same S and softmax of the block's rows itself (a third more
//     tensor-core work than sharing P through shared memory, and no barrier
//     between them beyond the ring's); the ring's three stages of 64 x 256
//     K and V take 192 KB, so one block runs on an SM.
//  2. Folded rows G*Sq <= 16 (a decode step), bf16 and fp32:
//     `flash_decode_kernel` + `flash_combine_kernel`.  The keys are split
//     across blocks, grid (B*K, splits), the split count chosen by the caller
//     so that about two blocks run on each SM.  Each split walks its own
//     range of 64-key tiles (a cp.async ring; K and V in their own type in
//     shared memory, not widened) with fp32 SIMT arithmetic (16 rows would
//     leave an m64 tile mostly empty, and the work is bound by bytes) and
//     writes fp32 partials (acc, m, l) to a workspace from the caller (fp32
//     at head_dim 256 has room for one stage of the ring only).  The
//     combine kernel sums the splits in a fixed order with no atomics, so two
//     calls give the same bits.  Where the caller asks, it also writes each
//     row's log-sum-exp of its scaled scores, M + log(sum_s l_s e^(m_s - M)),
//     in fp32: a model rank attending over its block of the cache returns it
//     beside its output, and the ranks' outputs are combined as the splits
//     are (train_step / layers.attention on the "model" axis).
//  3. fp32, folded rows > 16 (smoke sizes and tests, on no full-width path):
//     `flash_fwd_simt_kernel`, the first design: plain fp32 FMA from shared
//     memory, 16 x 16 threads with a 4 x 4 register tile of the scores.
//
// The caller counts one launch per call of the wrapper, also when a decode
// step runs the combine kernel after the split kernel.
//
// Under autograd the tensor-core kernel's second instantiation (LSE = true)
// also writes each row's log-sum-exp of its scaled, filled scores, fp32
// (B, K, G, Sq), the quantity the combine kernel writes, and the output
// before its rounding to bf16, fp32 (B, K, G, Sq, D): the backward kernels
// of csrc/flash_attention_bwd.cu recompute the probabilities from the first
// and take rowsum(dO o O) from the second (with the bf16 output that sum
// moved dQ and dK past one bf16 ulp of their largest element from the
// float64 oracle).  The instantiation without them (prefill, serving) is the
// same code as before.
//
// Left for later: TMA loads from a producer warp and two consumer
// warpgroups of 64 rows each sharing every K/V tile (half the K/V traffic of
// 64-row blocks), a persistent schedule over the tiles, the decode step in
// one kernel.
//
// Every query row must see at least one key (true of every causal row whose
// own position is among the keys); a row that sees none has no defined value
// in the reference either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;   // finite on purpose: see the softmax below
constexpr int BN = 64;              // keys in a tile (all kernels)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, K, G, Sq, Sk;
  long long q_sb, q_sk, q_sg, q_ss;   // q[b, k, g, s, :]
  long long k_sb, k_sk, k_ss;         // k[b, k, s, :]
  long long v_sb, v_sk, v_ss;
  long long o_sb, o_sk, o_sg, o_ss;
  int causal, window, prefix_len, q_start;   // window < 0: none
  float sm_scale;
  float* acc;   // tensor-core kernel: fp32 copies of O flushed every FLUSH_TILES tiles (null: no flush)
  float* lse;   // each row's log-sum-exp of its scores, (B, K, G, Sq) fp32 (null: not written)
  float* o32;   // tensor-core kernel under autograd: O unrounded, (B, K, G, Sq, D) fp32 (null: not written)
};

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

// Which kv tiles a block visits: every tile that starts below the prefix, and
// otherwise those that the causal / window test leaves some key of for some
// row in [q_lo, q_hi].
struct TileFilter {
  int Sk, causal, window, prefix_len, q_lo, q_hi;
  __device__ bool visible(int j) const {
    const int k_lo = j * BN;
    const int k_hi = min(k_lo + BN, Sk) - 1;
    if (prefix_len > 0 && k_lo < prefix_len) return true;
    if (causal && k_lo > q_hi) return false;
    if (window >= 0 && q_lo - k_hi >= window) return false;
    return true;
  }
  // the first visible tile in [j, end), or end.  Under a causal mask no tile
  // past both the last row's diagonal and the prefix is visible, so the scan
  // stops there: rows near the start of a long key range (a model rank's
  // share at q_start 0 against 32,768 keys) would otherwise step through
  // every tile after their last, a few times a block.
  __device__ int next(int j, int end) const {
    const int stop = causal ? min(end, max(q_hi, prefix_len - 1) / BN + 1) : end;
    while (j < stop && !visible(j)) ++j;
    return j < stop ? j : end;
  }
  // every key of tile j visible to every row in [q_lo, q_hi]: no mask needed
  __device__ bool full(int j) const {
    const int k_lo = j * BN;
    const int k_hi = k_lo + BN - 1;
    if (k_hi >= Sk) return false;
    if (prefix_len > 0 && k_hi < prefix_len) return true;
    return (!causal || k_hi <= q_lo) && (window < 0 || q_hi - k_lo < window);
  }
  __device__ bool ok(int qpos, int kpos) const {
    bool ok = true;
    if (causal) ok = ok && (qpos >= kpos);
    if (window >= 0) ok = ok && (qpos - kpos < window);
    if (prefix_len > 0) ok = ok || (kpos < prefix_len);
    return ok && (kpos < Sk);
  }
};

__device__ inline void cp_async16(void* smem, const void* gmem, bool valid) {
  // src-size 0 fills the 16 bytes with zeros: rows past the edge are zero,
  // never stale shared memory (0 * NaN would poison the P.V sum)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// Copy BN rows of K and V (key rows k_lo, k_lo + 1, ...) into shared memory
// with row stride LD elements, 16 bytes a thread; rows past Sk become zeros.
template <typename T, int D, int LD, int NTHREADS>
__device__ inline void load_kv_async(T* Ks, T* Vs, const T* kb, const T* vb, const Params& p,
                                     int k_lo, int tid) {
  constexpr int N8 = 16 / sizeof(T);
  constexpr int CH = D / N8;                 // 16-byte chunks in a row
#pragma unroll
  for (int c0 = 0; c0 < BN * CH; c0 += NTHREADS) {
    const int c = c0 + tid;
    if (c < BN * CH) {
      const int r = c / CH;
      const int d = (c % CH) * N8;
      const bool in = k_lo + r < p.Sk;
      const long long row = in ? k_lo + r : 0;
      cp_async16(Ks + r * LD + d, kb + row * p.k_ss + d, in);
      cp_async16(Vs + r * LD + d, vb + row * p.v_ss + d, in);
    }
  }
}

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(bf16 x) { return __bfloat162float(x); }
__device__ inline void from_float(float* p, float x) { *p = x; }
__device__ inline void from_float(bf16* p, float x) { *p = __float2bfloat16(x); }

// N elements of T at p (aligned to N * sizeof(T) bytes), widened to fp32.
template <typename T, int N>
__device__ inline void load_wide(const T* p, float* out) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  alignas(16) T buf[N];
  if constexpr (BYTES == 16) *reinterpret_cast<uint4*>(buf) = *reinterpret_cast<const uint4*>(p);
  else if constexpr (BYTES == 8) *reinterpret_cast<uint2*>(buf) = *reinterpret_cast<const uint2*>(p);
  else if constexpr (BYTES == 4) *reinterpret_cast<unsigned*>(buf) = *reinterpret_cast<const unsigned*>(p);
  else {
#pragma unroll
    for (int i = 0; i < N; ++i) buf[i] = p[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(buf[i]);
}

// ---------------------------------------------------------------------------
// 1. bf16 prefill / training: tensor cores over a cp.async K/V ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 64;                 // folded rows in a block (wgmma m64)
constexpr int KN = BN;                 // keys in a tile
constexpr int STAGES = 3;              // the K/V ring
constexpr int FLUSH_TILES = 32;        // O is flushed to the fp32 copy every 32 tiles (2,048 keys)

template <int D>
struct Layout {
  // Tiles are rows of DP bf16 in 128-byte swizzled column blocks (the wgmma
  // canonical layout): chunk c (16 bytes) of row r of an R-row tile lies at
  // byte (c / 8) * R * 128 + r * 128 + ((c % 8) ^ (r % 8)) * 16.  D = 32 is
  // padded with zeros to one whole 128-byte block.
  static constexpr int DP = D < 64 ? 64 : D;
  // Warpgroups a block: each owns DW of the output's columns and computes
  // the scores and the softmax of the block's 64 rows itself (the same
  // values in each).  One up to D = 128; at D = 256 two, so that a thread
  // keeps 64 fp32 accumulators of O (one warpgroup would need 128 beside
  // the scores and both P fragments, past the 255 registers a thread has).
  static constexpr int NWG = DP > 128 ? 2 : 1;
  static constexpr int NTHREADS = 128 * NWG;
  static constexpr int DW = DP / NWG;
  static constexpr int QBYTES = BM * DP * 2;
  static constexpr int KVBYTES = KN * DP * 2;          // a K or a V tile
  static constexpr int LDO = D + 8;                    // the output's staging rows
  // Q, the ring of (K, V) tiles, each row's bounds; the tiles start 1024-aligned
  static constexpr int SMEM_BYTES = QBYTES + STAGES * 2 * KVBYTES + BM * 8;
  // two blocks an SM up to D = 128; at D = 256 the ring alone is 192 KB: one
  static constexpr int MIN_BLOCKS = DP > 128 ? 1 : 2;
  static_assert(MIN_BLOCKS * (SMEM_BYTES + 1024) <= 233472, "blocks an SM");
  static_assert(BM * LDO * 2 <= STAGES * 2 * KVBYTES, "the output is staged in the K/V ring");
};

__device__ inline int swizzled(int r, int c, int rows) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// ROWS x DP tile from the rows at row_ptr(r) (nullptr: past the edge, zeros);
// chunks past D are zeros too.  `any` is a valid address for the zero fills.
template <int D, int ROWS, typename RowPtr>
__device__ inline void load_tile_async(unsigned char* dst, RowPtr row_ptr, const bf16* any, int tid) {
  constexpr int CH = Layout<D>::DP / 8;
  constexpr int NT = Layout<D>::NTHREADS;
  static_assert(ROWS * CH % NT == 0, "whole rounds of 16-byte chunks");
#pragma unroll
  for (int c0 = 0; c0 < ROWS * CH; c0 += NT) {
    const int c = c0 + tid;
    const int r = c / CH;
    const int ch = c % CH;
    const bf16* src = row_ptr(r);
    const bool in = src != nullptr && ch < D / 8;
    cp_async16(dst + swizzled(r, ch, ROWS), in ? src + ch * 8 : any, in);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ inline uint64_t descriptor(const void* p, unsigned lbo, unsigned sbo) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// 2^x on the special-function unit (relative error about 2^-22, subnormal
// results flushed to 0): tried against expf and exp2f, it keeps the kernel
// within the unchanged one-ulp check and shortens the softmax
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

// p = hi + lo as two bf16 pairs: hi = bf16(p), lo = bf16(p - hi)
__device__ inline void split(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack(x0 - hf.x, x1 - hf.y);
}

// Accumulator layout of wgmma m64nN (lane = 4 g + t of warp w): d[4 n + e]
// holds row 16 w + g (e < 2) or 16 w + g + 8 (e >= 2), column 8 n + 2 t + (e & 1).
// The A fragment from registers of a k16 step is the mma.m16n8k16 one, so the
// probabilities go from the score accumulators to A fragments in place.
template <int D, bool LSE>
__global__ void __launch_bounds__(Layout<D>::NTHREADS, Layout<D>::MIN_BLOCKS) flash_fwd_tc_kernel(const Params p) {
  using L = Layout<D>;
  constexpr int DP = L::DP;
  constexpr int DW = L::DW;             // the warpgroup's output columns
  constexpr int NO = DW / 8;            // ... in n tiles of 8
  constexpr int NT = L::NTHREADS;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Qs = smem_raw;
  unsigned char* KV = Qs + L::QBYTES;   // stage s: K at KV + 2 s KVBYTES, V after it
  int2* bounds = reinterpret_cast<int2*>(KV + STAGES * 2 * L::KVBYTES);

  const int tid = threadIdx.x;
  const int wg = tid / 128;             // warpgroup: output columns wg * DW ..
  const int warp = tid / 32 % 4;        // warp of the warpgroup: rows 16 warp ..
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.y / p.K;
  const int kh = blockIdx.y % p.K;
  const int tile = gridDim.x - 1 - blockIdx.x;   // heaviest (latest) causal tiles first
  const int R = p.G * p.Sq;                       // folded rows: r = position * G + head
  const int r0 = tile * BM;
  const int rows_here = min(BM, R - r0);
  const TileFilter f{p.Sk, p.causal, p.window, p.prefix_len,
                     p.q_start + r0 / p.G, p.q_start + (r0 + rows_here - 1) / p.G};

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + kh * p.q_sk;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kh * p.k_sk;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kh * p.v_sk;
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + kh * p.o_sk;

  auto load_kv = [&](int stage, int k_lo) {
    unsigned char* Kd = KV + stage * 2 * L::KVBYTES;
    load_tile_async<D, KN>(Kd, [&](int r) -> const bf16* {
      return k_lo + r < p.Sk ? kb + (long long)(k_lo + r) * p.k_ss : nullptr;
    }, kb, tid);
    load_tile_async<D, KN>(Kd + L::KVBYTES, [&](int r) -> const bf16* {
      return k_lo + r < p.Sk ? vb + (long long)(k_lo + r) * p.v_ss : nullptr;
    }, vb, tid);
  };

  // Q tile, in the first commit group with the first K/V tile
  load_tile_async<D, BM>(Qs, [&](int r) -> const bf16* {
    const int rg = r0 + r;
    return rg < R ? qb + (long long)(rg / p.G) * p.q_ss + (long long)(rg % p.G) * p.q_sg : nullptr;
  }, qb, tid);
  // The ring of three stages holds, at tile j: j, the next visible tile jn
  // (landed), and the stage of the tile before, refilled with the tile after jn.
  const int n_tiles = (p.Sk + KN - 1) / KN;
  int j = f.next(0, n_tiles);
  int jl = j;                            // the next tile to load
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    if (jl < n_tiles) {
      load_kv(st, jl * KN);
      jl = f.next(jl + 1, n_tiles);
    }
    cp_async_commit();
  }

  // each row's visible keys, [lo, hi] (besides the prefix): the mask of a
  // tile the causal / window test cuts is then two compares an element
  const int prefix = min(p.prefix_len, p.Sk);
  for (int r = tid; r < BM; r += NT) {
    const int qpos = p.q_start + (r0 + r) / p.G;
    bounds[r] = make_int2(p.window >= 0 ? qpos - p.window + 1 : 0,
                          p.causal ? min(qpos, p.Sk - 1) : p.Sk - 1);
  }

  float o[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  // the flushed copy of this thread's O (element i at acc_t[i * NT]), kept at
  // the running max m_acc; `since`: tiles added to o since the last flush
  float* acc_t = p.acc == nullptr ? nullptr
                 : p.acc + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * (NO * 4) * NT + tid;
  float m_acc[2] = {NEG_INF, NEG_INF};
  int since = 0;
  bool flushed = false;
  // scores are kept times log2(e), for exp2
  const float scale = p.sm_scale * 1.4426950408889634f;

  // S = Q.K^T of the tile at stage st (64 x 64, fp32) on the tensor cores, started, not waited for
  auto start_scores = [&](float (&sc)[32], int st) {
    const unsigned char* Ks = KV + st * 2 * L::KVBYTES;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      // k step ks: 128-byte column block ks / 4 (rows * 128 bytes apart), 32 bytes into its rows
      const int blk = ks >> 2, off = (ks & 3) * 32;
      wgmma_ss_n64(sc, descriptor(Qs + blk * BM * 128 + off, 16, 1024),
                   descriptor(Ks + blk * KN * 128 + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
  };

  // The online softmax of tile jt's scores sc, on the accumulator fragments:
  // updates m and l, returns each row's alpha (O's rescale) and the
  // probabilities as bf16 A fragments P_hi, P_lo.  The fill is finite: a row
  // whose every score in this tile is masked gets p = 2^0 = 1 while its max
  // is still -1e30; the first tile with a live score then has alpha =
  // 2^(-1e30 - m) = 0 and wipes that.  With -inf the same row would be NaN.
  auto softmax = [&](float (&sc)[32], int jt, float (&alpha)[2], unsigned (&hi)[4][4], unsigned (&lo)[4][4]) {
    const int k_lo = jt * KN;
    const bool full = f.full(jt);
    int2 bnd[2];
    if (!full) {
      bnd[0] = bounds[warp * 16 + g];
      bnd[1] = bounds[warp * 16 + g + 8];
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale;
      if (!full) {
        const int kpos = k_lo + (i >> 2) * 8 + 2 * t + (i & 1);
        const int2 bd = bnd[(i >> 1) & 1];
        x = (kpos < prefix || (kpos >= bd.x && kpos <= bd.y)) ? x : NEG_INF;
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the four lanes of a quad share a row
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2_approx(m[h] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        sc[4 * n + 2 * h] = exp2_approx(sc[4 * n + 2 * h] - m_new);
        sc[4 * n + 2 * h + 1] = exp2_approx(sc[4 * n + 2 * h + 1] - m_new);
        rs += sc[4 * n + 2 * h] + sc[4 * n + 2 * h + 1];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[h] = l[h] * alpha[h] + rs;
      m[h] = m_new;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A fragment of keys 16kk..16kk+15: accumulator n tiles 2kk, 2kk+1
      split(sc[8 * kk + 0], sc[8 * kk + 1], hi[kk][0], lo[kk][0]);
      split(sc[8 * kk + 2], sc[8 * kk + 3], hi[kk][1], lo[kk][1]);
      split(sc[8 * kk + 4], sc[8 * kk + 5], hi[kk][2], lo[kk][2]);
      split(sc[8 * kk + 6], sc[8 * kk + 7], hi[kk][3], lo[kk][3]);
    }
  };

  // Per tile j, with P(j) from the last step: start S(jn) and O += P(j).V(j) on
  // the tensor cores, then the softmax of S(jn) while O's product runs, then
  // rescale O.  Registers a wgmma reads or writes are left alone until it is
  // waited for, so ptxas keeps the products asynchronous.
  float s[32];
  unsigned hi[4][4], lo[4][4], hi_n[4][4], lo_n[4][4];
  float alpha[2];
  if (j < n_tiles) {
    cp_async_wait<1>();                  // Q and the first tile have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
    __syncthreads();
    wgmma_fence();
    start_scores(s, 0);
    wgmma_wait<0>();
    softmax(s, j, alpha, hi, lo);
  }
  int stage = 0;
  while (j < n_tiles) {
    const int jn = f.next(j + 1, n_tiles);
    cp_async_wait<0>();                  // tile jn has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                     // ... for all, and all are done with the tile before j
    if (jl < n_tiles) {
      load_kv((stage + 2) % 3, jl * KN);
      jl = f.next(jl + 1, n_tiles);
    }
    cp_async_commit();

    wgmma_fence();
    // started at the last tile too (on a stage no load is writing, its scores
    // unused): a wgmma under a branch makes ptxas serialise every wgmma
    start_scores(s, (stage + 1) % 3);
    // the warpgroup's columns start at 128-byte column block wg * DW / 64
    const unsigned char* Vs = KV + stage * 2 * L::KVBYTES + L::KVBYTES + wg * (DW / 64) * KN * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // keys 16kk..: two groups of 8 rows, 1024 bytes each; 128-byte column blocks KN * 128 apart
      const uint64_t vd = descriptor(Vs + kk * 2048, KN * 128, 1024);
      wgmma_rs<DW>(o, hi[kk], vd);
      wgmma_rs<DW>(o, lo[kk], vd);
    }
    wgmma_commit();
    wgmma_wait<1>();                     // S(jn)
    if (jn < n_tiles) softmax(s, jn, alpha, hi_n, lo_n);
    wgmma_wait<0>();                     // O += P(j).V(j)
    if (jn < n_tiles) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) hi[kk][e] = hi_n[kk][e], lo[kk][e] = lo_n[kk][e];
      if (acc_t != nullptr && ++since == FLUSH_TILES) {
        // o is at the running max m: the copy, at m_acc, is brought to m and o added
        since = 0;
        const float f0 = exp2_approx(m_acc[0] - m[0]), f1 = exp2_approx(m_acc[1] - m[1]);
#pragma unroll
        for (int i = 0; i < NO * 4; ++i) {
          float* a = acc_t + i * NT;
          *a = flushed ? fmaf(*a, (i & 2) ? f1 : f0, o[i]) : o[i];
          o[i] = 0.f;
        }
        m_acc[0] = m[0];
        m_acc[1] = m[1];
        flushed = true;
      }
    }
    stage = (stage + 1) % 3;
    j = jn;
  }
  if (flushed) {
    const float f0 = exp2_approx(m_acc[0] - m[0]), f1 = exp2_approx(m_acc[1] - m[1]);
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) o[i] = fmaf(acc_t[i * NT], (i & 2) ? f1 : f0, o[i]);
  }
  cp_async_wait<0>();
  __syncthreads();                       // the K/V ring is reused for the output

  // ---- out = acc / max(l, 1e-20), staged through shared memory ----------------
  bf16* Os = reinterpret_cast<bf16*>(KV) + warp * 16 * L::LDO + wg * DW;
  // one division a row: o * (1 / l) lies within an fp32 ulp of o / l
  const float inv0 = 1.f / fmaxf(l[0], 1e-20f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-20f);
  if constexpr (LSE) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rg = r0 + warp * 16 + g + 8 * h;
      if (rg < R) {
        const long long row = ((long long)blockIdx.y * p.G + rg % p.G) * p.Sq + rg / p.G;
        // m is kept times log2(e): lse = ln 2 (m + log2 l); one lane of the quad a row
        if (wg == 0 && t == 0) p.lse[row] = (m[h] + log2f(l[h])) * 0.6931471805599453f;
        const float inv = h ? inv1 : inv0;
#pragma unroll
        for (int n = 0; n < (D < DW ? D : DW) / 8; ++n)
          *reinterpret_cast<float2*>(p.o32 + row * D + wg * DW + n * 8 + 2 * t) =
              make_float2(o[4 * n + 2 * h] * inv, o[4 * n + 2 * h + 1] * inv);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < (D < DW ? D : DW) / 8; ++n) {
    *reinterpret_cast<unsigned*>(Os + g * L::LDO + n * 8 + 2 * t) = pack(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    *reinterpret_cast<unsigned*>(Os + (g + 8) * L::LDO + n * 8 + 2 * t) =
        pack(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
  __syncthreads();                       // a row's columns come from every warpgroup
  const bf16* Ob = reinterpret_cast<const bf16*>(KV);
#pragma unroll
  for (int c0 = 0; c0 < BM * (D / 8); c0 += NT) {
    const int c = c0 + tid;
    const int r = c / (D / 8);
    const int d = (c % (D / 8)) * 8;
    const int rg = r0 + r;
    if (rg < R)
      *reinterpret_cast<uint4*>(ob + (long long)(rg / p.G) * p.o_ss + (long long)(rg % p.G) * p.o_sg + d) =
          *reinterpret_cast<const uint4*>(Ob + r * L::LDO + d);
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Layout<D>;
  auto kernel = p.o32 != nullptr ? flash_fwd_tc_kernel<D, true> : flash_fwd_tc_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.G * p.Sq + BM - 1) / BM, p.B * p.K);
  kernel<<<grid, L::NTHREADS, L::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// 2. decode (folded rows <= 16): keys split across blocks, then a combine
// ---------------------------------------------------------------------------

namespace dec {

constexpr int MAX_ROWS = 16;
constexpr int NWARPS = 4;              // warp w owns rows w, w + 4, w + 8, w + 12
constexpr int NTHREADS = 32 * NWARPS;
constexpr int RPW = MAX_ROWS / NWARPS;

template <typename T, int D>
struct Layout {
  static constexpr int N8 = 16 / static_cast<int>(sizeof(T));
  static constexpr int LD = D + N8;            // rows padded by 16 bytes
  static constexpr int TILE = BN * LD;
  // Q (fp32), P, and `stages` of (K, V): one where a split is one tile (more
  // blocks fit an SM), else two
  static constexpr int smem_bytes(int stages) {
    return (MAX_ROWS * D + NWARPS * RPW * BN) * 4 + stages * 2 * TILE * static_cast<int>(sizeof(T));
  }
  // the ring's stages when a split walks several tiles: two where they fit a
  // block's 227 KB (fp32 at D = 256 takes 280 KB with two), else one, and
  // then the next tile's load waits for this tile's products
  static constexpr int STAGES = smem_bytes(2) <= 232448 ? 2 : 1;
  static_assert(smem_bytes(STAGES) <= 232448, "one stage fits");
};

// Partials: part[((bk * splits + split) * R + r) * (D + 2) + {0..D-1: acc, D: m, D+1: l}]
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_decode_kernel(const Params p, float* part,
                                                                 int tiles_per_split) {
  using L = Layout<T, D>;
  constexpr int N8 = L::N8;
  constexpr int LD = L::LD;
  constexpr int DPL = D / 32;          // output columns a lane owns

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);        // [16][D]
  float* Ps = Qs + MAX_ROWS * D;                          // [warp][RPW][BN]
  T* KV = reinterpret_cast<T*>(Ps + NWARPS * RPW * BN);   // stage s: K at 2 s TILE, V after

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bk = blockIdx.x;
  const int split = blockIdx.y;
  const int b = bk / p.K;
  const int kh = bk % p.K;
  const int R = p.G * p.Sq;
  const TileFilter f{p.Sk, p.causal, p.window, p.prefix_len, p.q_start, p.q_start + (R - 1) / p.G};

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + kh * p.q_sk;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sk;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sk;

  const int n_tiles = (p.Sk + BN - 1) / BN;
  const int j_end = min(n_tiles, (split + 1) * tiles_per_split);
  int j = f.next(split * tiles_per_split, j_end);
  if (j < j_end) load_kv_async<T, D, LD, NTHREADS>(KV, KV + L::TILE, kb, vb, p, j * BN, tid);
  cp_async_commit();

  // q rows widened to fp32 (16 bytes a thread); the cp.async above is in flight
  for (int c = tid; c < R * (D / N8); c += NTHREADS) {
    const int r = c / (D / N8);
    const int d = (c % (D / N8)) * N8;
    load_wide<T, N8>(qb + (long long)(r / p.G) * p.q_ss + (long long)(r % p.G) * p.q_sg + d, Qs + r * D + d);
  }

  const int nr = max(0, min(RPW, (R - warp + NWARPS - 1) / NWARPS));   // live rows of this warp
  int qpos[RPW];
  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    qpos[i] = p.q_start + (warp + NWARPS * i) / p.G;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }
  float* Pw = Ps + warp * RPW * BN;

  int stage = 0;
  while (j < j_end) {
    const int jn = f.next(j + 1, j_end);
    if constexpr (L::STAGES == 2) {
      if (jn < j_end) {
        T* Kn = KV + (stage ^ 1) * 2 * L::TILE;
        load_kv_async<T, D, LD, NTHREADS>(Kn, Kn + L::TILE, kb, vb, p, jn * BN, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (nr > 0) {                        // uniform across the warp
      const T* Ks = KV + stage * 2 * L::TILE;
      const T* Vs = Ks + L::TILE;
      const int k_lo = j * BN;
      // scores of keys lane and lane + 32 for the warp's rows, each a sum of
      // two partial dot products (even and odd columns), four chains a row
      float s[RPW][2], s2[RPW][2][2];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) s2[i][c][0] = s2[i][c][1] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += N8) {
        float kf[2][N8];
#pragma unroll
        for (int c = 0; c < 2; ++c) load_wide<T, N8>(Ks + (lane + 32 * c) * LD + d, kf[c]);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          if (i < nr) {
            const float* qrow = Qs + (warp + NWARPS * i) * D + d;
#pragma unroll
            for (int e = 0; e < N8; ++e) {
              const float qe = qrow[e];
#pragma unroll
              for (int c = 0; c < 2; ++c) s2[i][c][e & 1] = fmaf(qe, kf[c][e], s2[i][c][e & 1]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) s[i][c] = s2[i][c][0] + s2[i][c][1];
      // mask, online softmax (the finite fill: see the tensor-core kernel)
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        if (i < nr) {
          float mx = NEG_INF;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kpos = k_lo + lane + 32 * c;
            s[i][c] = f.ok(qpos[i], kpos) ? s[i][c] * p.sm_scale : NEG_INF;
            mx = fmaxf(mx, s[i][c]);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[i], mx);
          const float alpha = expf(m[i] - m_new);
          const float p0 = expf(s[i][0] - m_new);
          const float p1 = expf(s[i][1] - m_new);
          float rs = p0 + p1;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
          l[i] = l[i] * alpha + rs;
          m[i] = m_new;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
          Pw[i * BN + lane] = p0;
          Pw[i * BN + lane + 32] = p1;
        }
      }
      __syncwarp();
      // acc[i][:] += p[row i][:] . V, the lane's DPL columns
#pragma unroll 4
      for (int key = 0; key < BN; ++key) {
        float vf[DPL];
        load_wide<T, DPL>(Vs + key * LD + lane * DPL, vf);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          if (i < nr) {
            const float pk = Pw[i * BN + key];
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[i][e] = fmaf(pk, vf[e], acc[i][e]);
          }
        }
      }
    }
    __syncthreads();                     // before the next load overwrites this stage
    if constexpr (L::STAGES == 2) {
      stage ^= 1;
    } else {
      if (jn < j_end) load_kv_async<T, D, LD, NTHREADS>(KV, KV + L::TILE, kb, vb, p, jn * BN, tid);
      cp_async_commit();
    }
    j = jn;
  }
  cp_async_wait<0>();

  // a split that visits no tile writes m = -1e30, l = 0, acc = 0: weight 0
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (i < nr) {
      const int r = warp + NWARPS * i;
      float* dst = part + ((long long)(bk * gridDim.y + split) * R + r) * (D + 2);
#pragma unroll
      for (int e = 0; e < DPL; ++e) dst[lane * DPL + e] = acc[i][e];
      if (lane == 0) {
        dst[D] = m[i];
        dst[D + 1] = l[i];
      }
    }
  }
}

// out[r, d] = sum_s acc_s[r, d] e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-20),
// M = max_s m_s; the splits in order 0, 1, ..., no atomics.  Where p.lse is
// set, lse[b, k, g, s] = M + log(sum_s l_s e^(m_s - M)) of row r = s G + g.  Every (m_s, l_s)
// is read at once into shared memory and each row's weights e^(m_s - M) are
// worked out there; then each (row, column) reads its splits' partials with
// independent loads.
constexpr int MAX_SPLITS = 128;
constexpr int COMBINE_THREADS = 256;

template <typename T, int D>
__global__ void __launch_bounds__(COMBINE_THREADS) flash_combine_kernel(const Params p, const float* part,
                                                                         int splits) {
  __shared__ float w[MAX_ROWS][MAX_SPLITS];
  __shared__ float lw[MAX_ROWS][MAX_SPLITS];
  __shared__ float inv[MAX_ROWS];
  const int bk = blockIdx.x;
  const int b = bk / p.K;
  const int kh = bk % p.K;
  const int R = p.G * p.Sq;
  const long long split_stride = (long long)R * (D + 2);
  const float* base = part + (long long)bk * splits * split_stride;
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + kh * p.o_sk;
  for (int idx = threadIdx.x; idx < R * splits; idx += COMBINE_THREADS) {
    const int r = idx / splits;
    const int sp = idx % splits;
    const float* ps = base + sp * split_stride + r * (D + 2) + D;
    w[r][sp] = ps[0];                    // m_s, for now
    lw[r][sp] = ps[1];
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float M = NEG_INF;
    for (int sp = 0; sp < splits; ++sp) M = fmaxf(M, w[r][sp]);
    float lsum = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      w[r][sp] = expf(w[r][sp] - M);
      lsum += lw[r][sp] * w[r][sp];
    }
    inv[r] = 1.f / fmaxf(lsum, 1e-20f);
    if (p.lse != nullptr) p.lse[((long long)bk * p.G + r % p.G) * p.Sq + r / p.G] = M + logf(lsum);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * D; idx += COMBINE_THREADS) {
    const int r = idx / D;
    const int d = idx % D;
    const float* acc = base + r * (D + 2) + d;
    float osum = 0.f;
    for (int sp0 = 0; sp0 < splits; sp0 += 8) {
      // eight loads in flight, then the sum in split order
      float a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) a[u] = sp0 + u < splits ? acc[(sp0 + u) * split_stride] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (sp0 + u < splits) osum += a[u] * w[r][sp0 + u];
    }
    from_float(ob + (long long)(r / p.G) * p.o_ss + (long long)(r % p.G) * p.o_sg + d, osum * inv[r]);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, float* part, int splits, cudaStream_t stream) {
  using L = Layout<T, D>;
  auto kernel = flash_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::smem_bytes(L::STAGES));
  if (err != cudaSuccess) return err;
  const int n_tiles = (p.Sk + BN - 1) / BN;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  kernel<<<dim3(p.B * p.K, splits), NTHREADS, L::smem_bytes(tiles_per_split > 1 ? L::STAGES : 1), stream>>>(
      p, part, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_combine_kernel<T, D><<<p.B * p.K, COMBINE_THREADS, 0, stream>>>(p, part, splits);
  return cudaGetLastError();
}

}  // namespace dec

// ---------------------------------------------------------------------------
// 3. fp32 prefill: plain fp32 FMA from shared memory (the first design)
// ---------------------------------------------------------------------------

namespace simt {

constexpr int NTHREADS = 256;       // 16 (ty: rows) x 16 (tx: columns)
constexpr int PAD = 4;              // floats; keeps float4 reads conflict-free
constexpr int RA = 4;               // rows a thread owns: ty + 16 a
constexpr int BM = 16 * RA;

// Stage ROWS x D floats into shared memory.  `row_ptr(r)` gives the address
// of row r's D contiguous elements, or nullptr for a row past the edge, which
// is filled with zeros.
template <int D, int ROWS, typename RowPtr>
__device__ inline void load_tile(float* dst, int dst_stride, RowPtr row_ptr, int tid) {
  constexpr int CH = D / 4;   // 16-byte chunks in a row
#pragma unroll
  for (int c0 = 0; c0 < BN * CH; c0 += NTHREADS) {
    const int c = c0 + tid;
    if (c < BN * CH) {
      const int r = c / CH;
      const int d = (c % CH) * 4;
      const float* src = row_ptr(r);
      const float4 x = src != nullptr ? *reinterpret_cast<const float4*>(src + d) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + r * dst_stride + d) = x;
    }
  }
}

template <int D>
struct Layout {
  static constexpr int QS = D + PAD;        // row strides in shared memory
  static constexpr int KS = D + PAD;
  static constexpr int VS = D;
  static constexpr int PS = BN + PAD;
  // the K tile's room is reused for the probabilities once the scores are done
  static constexpr int KREGION = (BN * KS > BM * PS) ? BN * KS : BM * PS;
  static constexpr int SMEM_FLOATS = BM * QS + KREGION + BN * VS;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_simt_kernel(const Params p) {
  using L = Layout<D>;
  constexpr int VEC = (D >= 64) ? 4 : 2;    // output columns a thread owns side by side
  constexpr int NC = D / (16 * VEC);        // ... times this many groups
  constexpr int DV = NC * VEC;

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * L::QS;
  float* Vs = Ks + L::KREGION;
  float* Ps = Ks;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int b = blockIdx.y / p.K;
  const int kh = blockIdx.y % p.K;
  const int tile = gridDim.x - 1 - blockIdx.x;   // heaviest (latest) causal tiles first
  const int R = p.G * p.Sq;
  const int r0 = tile * BM;
  const int rows_here = min(BM, R - r0);
  const TileFilter f{p.Sk, p.causal, p.window, p.prefix_len,
                     p.q_start + r0 / p.G, p.q_start + (r0 + rows_here - 1) / p.G};

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + kh * p.q_sk;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sk;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sk;
  float* ob = static_cast<float*>(p.o) + b * p.o_sb + kh * p.o_sk;

  load_tile<D, BM>(Qs, L::QS, [&](int r) -> const float* {
    const int rg = r0 + r;
    if (rg >= R) return nullptr;
    return qb + (long long)(rg / p.G) * p.q_ss + (long long)(rg % p.G) * p.q_sg;
  }, tid);

  // A thread owns rows ty + 16 a.  A warp holds two values of ty, so "this
  // warp has a live row at index a" is uniform across the warp: the two heavy
  // loops are skipped for a ragged tile's dead rows.
  const int warp_row0 = 2 * (tid / 32);
  int na = 0;
#pragma unroll
  for (int a = 0; a < RA; ++a) na += (warp_row0 + 16 * a < rows_here) ? 1 : 0;

  int qpos[RA];
  float m[RA], l[RA], acc[RA][DV];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    qpos[a] = p.q_start + (r0 + ty + 16 * a) / p.G;
    m[a] = NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DV; ++c) acc[a][c] = 0.f;
  }

  const int n_tiles = (p.Sk + BN - 1) / BN;
  for (int j = f.next(0, n_tiles); j < n_tiles; j = f.next(j + 1, n_tiles)) {
    const int k_lo = j * BN;
    load_tile<D, BN>(Ks, L::KS, [&](int r) -> const float* {
      return (k_lo + r < p.Sk) ? kb + (long long)(k_lo + r) * p.k_ss : nullptr;
    }, tid);
    load_tile<D, BN>(Vs, L::VS, [&](int r) -> const float* {
      return (k_lo + r < p.Sk) ? vb + (long long)(k_lo + r) * p.v_ss : nullptr;
    }, tid);
    __syncthreads();

    // ---- scores: s[a][c] = q[row a] . k[col tx + 16 c] ----------------------
    float s[RA][4];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;

#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kf[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kf[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * L::KS + d);
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        if (a < na) {
          const float4 qf = *reinterpret_cast<const float4*>(Qs + (ty + 16 * a) * L::QS + d);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[a][c] = fmaf(qf.x, kf[c].x, s[a][c]);
            s[a][c] = fmaf(qf.y, kf[c].y, s[a][c]);
            s[a][c] = fmaf(qf.z, kf[c].z, s[a][c]);
            s[a][c] = fmaf(qf.w, kf[c].w, s[a][c]);
          }
        }
      }
    }

    // ---- mask, online softmax (the finite fill: see the tensor-core kernel) ---
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k_lo + tx + 16 * c;
        s[a][c] = f.ok(qpos[a], kpos) ? s[a][c] * p.sm_scale : NEG_INF;
        mx = fmaxf(mx, s[a][c]);
      }
      // the 16 threads of a row are 16 neighbouring lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = expf(s[a][c] - m_new);
        rs += s[a][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = l[a] * alpha + rs;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DV; ++c) acc[a][c] *= alpha;
    }

    __syncthreads();            // every thread is done reading Ks
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(ty + 16 * a) * L::PS + tx + 16 * c] = s[a][c];
    __syncthreads();

    // ---- acc[a][:] += p[row a][:] . V ---------------------------------------
#pragma unroll 2
    for (int n = 0; n < BN; n += 4) {
      float pf[RA][4];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        if (a < na) {
          const float4 t = *reinterpret_cast<const float4*>(Ps + (ty + 16 * a) * L::PS + n);
          pf[a][0] = t.x; pf[a][1] = t.y; pf[a][2] = t.z; pf[a][3] = t.w;
        }
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        float vf[DV];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float* src = Vs + (n + nn) * L::VS + c * 16 * VEC + tx * VEC;
          if (VEC == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vf[c * VEC + 0] = t.x; vf[c * VEC + 1] = t.y;
            vf[c * VEC + 2] = t.z; vf[c * VEC + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vf[c * VEC + 0] = t.x; vf[c * VEC + 1] = t.y;
          }
        }
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          if (a < na) {
#pragma unroll
            for (int c = 0; c < DV; ++c) acc[a][c] = fmaf(pf[a][nn], vf[c], acc[a][c]);
          }
        }
      }
    }
    __syncthreads();            // before the next tile overwrites Ks / Vs
  }

  // ---- out = acc / max(l, 1e-20) ----------------------------------------------
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int rg = r0 + ty + 16 * a;
    if (rg < R) {
      const float denom = fmaxf(l[a], 1e-20f);
      float* dst = ob + (long long)(rg / p.G) * p.o_ss + (long long)(rg % p.G) * p.o_sg;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          dst[c * 16 * VEC + tx * VEC + e] = acc[a][c * VEC + e] / denom;
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem_bytes = Layout<D>::SMEM_FLOATS * (int)sizeof(float);
  auto kernel = flash_fwd_simt_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.G * p.Sq + BM - 1) / BM, p.B * p.K);
  kernel<<<grid, NTHREADS, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace simt

// Which kernel takes the call: folded rows <= 16 -> decode (split keys +
// combine, either type); else bf16 -> tensor cores; else fp32 -> SIMT.
template <int D>
cudaError_t launch_dim(Params p, int dtype, float* part, int splits, cudaStream_t stream) {
  if (p.G * p.Sq <= dec::MAX_ROWS) {
    if (part == nullptr || splits < 1 || splits > dec::MAX_SPLITS || p.o32 != nullptr)
      return cudaErrorInvalidValue;
    return dtype == 1 ? dec::launch<bf16, D>(p, part, splits, stream)
                      : dec::launch<float, D>(p, part, splits, stream);
  }
  // above 16 rows the log-sum-exp comes with the unrounded output: a bf16 call's under autograd
  if ((p.lse == nullptr) != (p.o32 == nullptr) || (p.lse != nullptr && dtype != 1))
    return cudaErrorInvalidValue;
  p.acc = part;    // the tensor-core kernel's flushed copies of O, where the rows are long
  return dtype == 1 ? tc::launch<D>(p, stream) : simt::launch<D>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 14 element strides in the order
// q(b,k,g,s) k(b,k,s) v(b,k,s) o(b,k,g,s); every innermost stride is 1.
// window < 0 means no window.  `part` and `splits`: for G*Sq <= 16, fp32
// workspace of B*K*splits*G*Sq*(D+2) floats and the number of key splits;
// for bf16 with G*Sq > 16, null or (where Sk > 2,048) fp32 workspace of
// ceil(G*Sq/64)*B*K*64*max(D,64) floats for O's flushed copies (`splits`
// unused).  `lse`: null, or for G*Sq <= 16 an fp32 output of B*K*G*Sq
// floats for each row's log-sum-exp.  For bf16 with G*Sq > 16, `lse` and
// `o32` both null, or both given: the log-sum-exp and an fp32 output of
// B*K*G*Sq*D floats (contiguous) for the output before its rounding.
// Returns the cudaError_t of the launches (0 = ok); it does not synchronise.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int K, int G, int Sq, int Sk, int D, int dtype,
    const long long* strides,
    int causal, int window, int prefix_len, int q_start, float sm_scale,
    void* part, int splits, void* lse, void* o32, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.K = K; p.G = G; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = strides[0]; p.q_sk = strides[1]; p.q_sg = strides[2]; p.q_ss = strides[3];
  p.k_sb = strides[4]; p.k_sk = strides[5]; p.k_ss = strides[6];
  p.v_sb = strides[7]; p.v_sk = strides[8]; p.v_ss = strides[9];
  p.o_sb = strides[10]; p.o_sk = strides[11]; p.o_sg = strides[12]; p.o_ss = strides[13];
  p.causal = causal; p.window = window; p.prefix_len = prefix_len; p.q_start = q_start;
  p.sm_scale = sm_scale;
  p.acc = nullptr;
  p.lse = static_cast<float*>(lse);
  p.o32 = static_cast<float*>(o32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* work = static_cast<float*>(part);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (D) {
    case 32: err = launch_dim<32>(p, dtype, work, splits, s); break;
    case 64: err = launch_dim<64>(p, dtype, work, splits, s); break;
    case 128: err = launch_dim<128>(p, dtype, work, splits, s); break;
    case 256: err = launch_dim<256>(p, dtype, work, splits, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
