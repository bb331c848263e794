// Mamba2 chunked SSD scan — CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan` of
// src/repro/kernels/ssd_scan.py.  It computes the same function, chunk by
// chunk of Q rows, in fp32 inside:
//     cum_i  = sum_{t <= i} log_l_t                      (within the chunk)
//     y[i,p] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) x[j,p]
//            + exp(cum_i) sum_n C_i[n] h[p,n]
//     h[p,n] <- h[p,n] exp(cum_last) + sum_j x[j,p] B_j[n] exp(cum_last - cum_j)
// with y rounded once to x's type and the final h written in fp32.
//
// Bound on this card.  Bytes: x, log_l, B, C read once, y and h written
// once (38.8 MB at the zamba2-1.2b prefill shape, 0.0116 ms at 3.35 TB/s).
// Operations: the causal pairs' scores (once per batch row, shared by the
// heads), att x, C h^T and the state update, 3.2 GFLOP there, 0.003 ms at
// the bf16 tensor-core peak.  The TPU kernel keeps all H heads' (P, N) state
// in VMEM over a sequential chunk axis and feeds the three products to its
// matrix unit.  The first port (kept below as `fma::`, now for fp32 inputs
// only, which no served path uses) took one block per (batch row, head):
// 256 blocks of 186 KB shared memory, so one an SM and two waves; every
// product as fp32 FMA on the CUDA cores (4.31 GFLOP there, >= 0.0644 ms at
// 67 TFLOP/s); C B^T recomputed in each of the 64 heads' blocks; 0.5264 ms.
//
// The bf16 design (`tc::`), what every served path runs:
//  * Tensor cores.  Scores S = C B^T take the bf16 inputs as they are, in
//    mma.sync m16n8k16 bf16 with fp32 sums (the products are exact).  The
//    other three products have one operand that the kernel holds in fp32:
//    att = S * exp(cum_i - cum_j), the state h, and B * tail.  Each is cut
//    into two TF32 parts, big = v with its low 13 bits cleared and small =
//    v - big likewise (|v - big - small| < 2^-20 |v|), and runs as two
//    mma.sync m16n8k8 TF32 products beside the other operand, which is bf16
//    and so exact in TF32: the 3xTF32 scheme, whose third product (small x
//    small) is zero here.  Chosen from the CPU emulation of this arithmetic
//    (tests/_torch_parity.py `ssd_emulated`, held by
//    tests/test_torch_kernels.py): two bf16 parts (residual 2^-16) hold h
//    within 5e-5 but put elements of y past their one-ulp limit from the
//    plain version at the main path's widths (P = N = 64, 512 rows, h0); two
//    TF32 parts do not; one bf16 part misses by more than 10 limits.  The
//    parts are cut by masks, not cvt.rna, which runs at the conversion rate:
//    rounding to nearest gains nothing the check can see.
//  * Scores once per pair of heads.  A block owns HG = 2 heads (one head
//    where 64 < N <= 128, granite-4.0-h's state size) and all P <=
//    PB = 64 columns (a split of P would cost the scores and the
//    exponentials again).  S is computed once for the block's heads and kept
//    in registers (a warp's 16 rows of the causal tiles) while each head
//    applies its own decay.  At zamba2's shape (H = P = 64) the grid is 32
//    pairs of heads x 4 batch rows = 128 blocks of 256 threads, one wave on
//    132 SMs; S is computed 32 times per (batch row, chunk) where the first
//    design computed it 64 times.
//  * Warp w owns the outputs of row tile rt (16 rows); warps w and w + 4
//    share a scheduler, so they take tiles k and 7 - k: 9 causal 16-column
//    blocks on each scheduler.  Every warp first computes its tiles of the
//    state products (x^T (B tail), 16 rows of P by 16 columns of N a tile,
//    for the group's heads at once) into registers, then its outputs; the
//    state is updated after a barrier, once every warp has read it.
//  * The k index of each TF32 product is permuted (slot t <-> 2t, slot t + 4
//    <-> 2t + 1 of each group of 8), the same in both operands, so a score
//    accumulator of the m16n8k16 product is an m16n8k8 A fragment without
//    moving, and every operand is one 32-bit read: pairs along the row from
//    C and h, `ldmatrix.trans` pairs down the column from x and B, which
//    stay in shared memory as staged (bf16, rows padded by 16 bytes so no
//    bank is read twice).
//  * Chunks are staged by cp.async into two buffers: the next chunk's C, B
//    and x land while this one is computed.  Tiles have fixed sizes (128
//    rows, 64 or 128 columns of N, zero past the chunk and past N), so every
//    shared-memory address is a constant offset.  188,480 bytes of shared
//    memory (213,056 at N > 64), one block an SM; three barriers a chunk.
//  * What bounds it now: not bytes (6x the byte bound) and not the tensor
//    pipe's rate, but issue and latency with two warps a scheduler, which
//    the registers (a warp's scores and accumulators) leave no room to
//    raise: the fp32 operands' splits, the bf16-to-TF32 unpacking and the
//    fp64 decays interleave with the products (PERF.md, §6).
//  * Numerics that stay: the cumulative log decay in fp64 (a warp's scan,
//    kept times log2(e)); each difference cum_i - cum_j taken there before it
//    is narrowed, and masked to -inf above the diagonal BEFORE its
//    exponential (ex2.approx: relative error about 2^-22, subnormals to 0),
//    so only exp of a non-positive number is ever taken and exp(cum_i) *
//    exp(-cum_j) is never used; any S, a ragged last chunk staged as zero
//    rows (x = 0, B = 0, log_l = 0), which add nothing to the state and do
//    not decay it; any P and N that are multiples of 4, P up to 64 and N up
//    to 128 (64 in the fp32 design); an initial
//    state h0; x, B and C read through element strides (innermost 1), so
//    the model's slices of its conv output are read in place; h written in
//    fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

struct Params {
  const void* x;        // (B, S, H, P), element strides x_sb, x_ss, x_sh, innermost 1
  const float* l;       // (B, S, H) log decay, fp32, strides l_sb, l_ss, l_sh
  const void* bm;       // (B, S, N), strides b_sb, b_ss, innermost 1
  const void* cm;       // (B, S, N), strides c_sb, c_ss, innermost 1
  const float* h0;      // (B, H, P, N) contiguous fp32, or null for zeros
  void* y;              // (B, S, H, P) contiguous, x's type
  float* h_out;         // (B, H, P, N) contiguous fp32
  int B, S, H, P, N, Q;
  long long x_sb, x_ss, x_sh, l_sb, l_ss, l_sh, b_sb, b_ss, c_sb, c_ss;
  int x_vec;            // rows of x are 16-byte aligned runs
  int bc_vec;           // rows of B and C are 16-byte aligned runs
};

__device__ inline float to_float(float v) { return v; }
__device__ inline void from_float(float* p, float v) { *p = v; }

__device__ inline void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ inline void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// ---------------------------------------------------------------------------
// fma: the first design, fp32 FMA on the CUDA cores; fp32 inputs only
// ---------------------------------------------------------------------------

namespace fma {

// Shared memory, in floats; QP = Q rounded up to 8, LD = QP + 4 (rows of
// 16-byte multiples):
//   bt[N][LD]    B of the chunk, transposed: bt[n][j] = B[j, n]
//   ct[N][LD]    C, transposed
//   att[QP][LD]  att transposed: att[j][i] = (C_i . B_j) exp(cum_i - cum_j), j <= i
//   xs[QP][P]    x of the block's head
//   ht[N][P]     the state, transposed: ht[n][p] = h[p, n]
//   cum[QP] (fp64, 2 floats each)   cumulative log decay
//   tail[QP]     exp(cum_last - cum_j)
__host__ __device__ inline size_t smem_floats(int Q, int P, int N) {
  const int QP = (Q + 7) & ~7, LD = QP + 4;
  return (size_t)2 * N * LD + (size_t)QP * LD + (size_t)QP * P + (size_t)N * P + 3 * QP;
}

// grid: (H, B), THREADS threads.
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int P = p.P, N = p.N;
  const int QP = (p.Q + 7) & ~7, LD = QP + 4;
  float* bt = smem;
  float* ct = bt + N * LD;
  float* att = ct + N * LD;
  float* xs = att + QP * LD;
  float* ht = xs + QP * P;
  double* cum = reinterpret_cast<double*>(ht + N * P);
  float* tail = reinterpret_cast<float*>(cum + QP);

  const int tid = threadIdx.x;
  const int hd = blockIdx.x, b = blockIdx.y;
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + hd * p.x_sh;
  const float* l = p.l + b * p.l_sb + hd * p.l_sh;
  const T* bm = static_cast<const T*>(p.bm) + b * p.b_sb;
  const T* cm = static_cast<const T*>(p.cm) + b * p.c_sb;
  T* y = static_cast<T*>(p.y) + ((long long)b * p.S * p.H + hd) * P;   // + s * H * P
  const long long y_ss = (long long)p.H * P;
  const long long h_off = ((long long)b * p.H + hd) * P * N;

  for (int e = tid; e < P * N; e += THREADS)
    ht[(e % N) * P + e / N] = p.h0 ? p.h0[h_off + e] : 0.f;

  // roles in the y and state phases: 16 column groups of 4 (p0), and 16
  // row-group pairs (y) or state-column groups of 4 (n0)
  const int p0 = 4 * (tid % 16);
  const int tr = tid / 16;
  const int n0 = 4 * tr;

  for (int s0 = 0; s0 < p.S; s0 += p.Q) {
    const int q = min(p.Q, p.S - s0);
    __syncthreads();                      // the previous chunk is read
    // ---- stage the chunk as fp32; rows q .. QP-1 are zero
    for (int e = tid; e < QP * P; e += THREADS) {
      const int j = e / P;
      xs[e] = j < q ? to_float(x[(s0 + j) * p.x_ss + e % P]) : 0.f;
    }
    for (int e = tid; e < QP * N; e += THREADS) {
      const int j = e / N, n = e % N;
      bt[n * LD + j] = j < q ? to_float(bm[(s0 + j) * p.b_ss + n]) : 0.f;
      ct[n * LD + j] = j < q ? to_float(cm[(s0 + j) * p.c_ss + n]) : 0.f;
    }
    for (int j = tid; j < QP; j += THREADS) tail[j] = j < q ? l[(s0 + j) * p.l_ss] : 0.f;
    __syncthreads();
    if (tid == 0) {                       // in row order
      double run = 0.0;
      for (int j = 0; j < QP; ++j) cum[j] = run += tail[j];
    }
    __syncthreads();
    const double last = cum[q - 1];
    for (int j = tid; j < QP; j += THREADS) tail[j] = expf(static_cast<float>(last - cum[j]));

    // ---- att: one 8 x 8 tile on or below the diagonal a thread
    {
      const int nb = QP / 8;
      if (tid < nb * (nb + 1) / 2) {
        int bi = 0;
        while ((bi + 1) * (bi + 2) / 2 <= tid) ++bi;
        const int i0 = 8 * bi, j0 = 8 * (tid - bi * (bi + 1) / 2);
        if (i0 < q) {                     // tiles of padding rows are never read
          float acc[8][8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
          for (int n = 0; n < N; ++n) {
            float a[8], bb[8];
            load4(ct + n * LD + i0, a);
            load4(ct + n * LD + i0 + 4, a + 4);
            load4(bt + n * LD + j0, bb);
            load4(bt + n * LD + j0 + 4, bb + 4);
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], bb[c], acc[r][c]);
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int j = j0 + c;
            float v[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const int i = i0 + r;
              v[r] = j <= i ? acc[r][c] * expf(static_cast<float>(cum[i] - cum[j])) : 0.f;   // masked first
            }
            store4(att + j * LD + i0, v);
            store4(att + j * LD + i0 + 4, v + 4);
          }
        }
      }
    }
    __syncthreads();

    // ---- y = att x + exp(cum) C h^T: row groups tr and QP/4 - 1 - tr, columns p0..p0+3
    {
      const int ng = QP / 4;
      if (tr < ng / 2 && p0 < P) {
        for (int half = 0; half < 2; ++half) {
          const int i0 = 4 * (half == 0 ? tr : ng - 1 - tr);
          if (i0 >= q) continue;
          float acc[4][4], inter[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = inter[r][c] = 0.f;
          const int jmax = min(i0 + 3, q - 1);
          for (int j = 0; j <= jmax; ++j) {
            float a[4], xv[4];
            load4(att + j * LD + i0, a);
            load4(xs + j * P + p0, xv);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], xv[c], acc[r][c]);
          }
          for (int n = 0; n < N; ++n) {
            float cv[4], hv[4];
            load4(ct + n * LD + i0, cv);
            load4(ht + n * P + p0, hv);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) inter[r][c] = fmaf(cv[r], hv[c], inter[r][c]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + r;
            if (i >= q) break;
            const float e = expf(static_cast<float>(cum[i]));
            T* dst = y + (s0 + i) * y_ss + p0;
#pragma unroll
            for (int c = 0; c < 4; ++c) from_float(dst + c, acc[r][c] + inter[r][c] * e);
          }
        }
      }
    }
    __syncthreads();                      // y has read the state

    // ---- state: h[p0..p0+3][n0..n0+3] <- h exp(cum_last) + sum_j x_j tail_j B_j
    if (p0 < P && n0 < N) {
      float acc[4][4];                    // [p][n]
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      const int jend = (q + 3) & ~3;      // rows past q are zero
      for (int j = 0; j < jend; j += 4) {
        float w[4], xw[4][4], bv[4][4];   // xw[row][p], bv[n][row]
        load4(tail + j, w);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          load4(xs + (j + jj) * P + p0, xw[jj]);
#pragma unroll
          for (int c = 0; c < 4; ++c) xw[jj][c] *= w[jj];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) load4(bt + (n0 + c) * LD + j, bv[c]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xw[jj][r], bv[c][jj], acc[r][c]);
      }
      const float decay = expf(static_cast<float>(last));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float hv[4];
        load4(ht + (n0 + c) * P + p0, hv);
#pragma unroll
        for (int r = 0; r < 4; ++r) hv[r] = hv[r] * decay + acc[r][c];
        store4(ht + (n0 + c) * P + p0, hv);
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < P * N; e += THREADS) p.h_out[h_off + e] = ht[(e % N) * P + e / N];
}


}  // namespace fma

// ---------------------------------------------------------------------------
// tc: the bf16 design on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WARPS = THREADS / 32;
constexpr double LOG2E = 1.4426950408889634;

// Shared memory of a block, in tiles of fixed size so that every address is
// a constant offset: QP = 128 rows (a chunk's rows past q are zero), NP = 64
// or 128 columns of C, B and the state (columns past N are zero), LDN = LDH =
// NP + 8 (row strides padded by 16 and 32 bytes, so no bank is read twice):
//   two staging buffers, each   cc[QP][LDN], bc[QP][LDN]  C and B of a chunk, bf16
//                               xs[HG][QP][LDX]           x of the group's heads, the block's columns
//   hs[HG][PB][LDH]            the state h[p][n], fp32
//   cl[HG][QP]                 cumulative log decay times log2(e), fp64
//   tail[HG][QP], ecum[HG][QP] exp(cum_last - cum_j), exp(cum_j), fp32
//   decay[HG]                  exp(cum_last)
// The next chunk is copied into one buffer (cp.async) while the other is read.
// Two instantiations: N <= 64 takes NP = 64 and HG = 2 heads a block (188,480
// bytes); 64 < N <= 128 takes NP = 128 and HG = 1 (213,056 bytes; two heads'
// state and x would not fit beside the wider C and B).  A warp owns the same
// number of state tiles in both (NPW * HG = 4), so the registers do not grow.
constexpr int QP = 128;
constexpr int PB = 64;                 // columns of P a block owns
constexpr int LDX = PB + 8;            // row stride of a head's x tile, bf16 (144 bytes)

template <int NP, int HG>
struct Layout {
  static constexpr int LDN = NP + 8, LDH = NP + 8;
  static constexpr int NT = NP / 16;                 // 16-column tiles of the state
  static constexpr int NPW = (PB / 16) * NT / WARPS;  // (16-row, 16-column) state tiles a warp owns, per head
  static constexpr size_t cc = 0;
  static constexpr size_t bc = cc + (size_t)QP * LDN * 2;
  static constexpr size_t xs = bc + (size_t)QP * LDN * 2;
  static constexpr size_t stage = xs + (size_t)HG * QP * LDX * 2;    // one buffer; buffer k at k * stage
  static constexpr size_t hs = 2 * stage;
  static constexpr size_t cl = hs + (size_t)HG * PB * LDH * 4;
  static constexpr size_t tail = cl + (size_t)HG * QP * 8;
  static constexpr size_t ecum = tail + (size_t)HG * QP * 4;
  static constexpr size_t decay = ecum + (size_t)HG * QP * 4;
  static constexpr size_t bytes = decay + 16 * 4;
};

__device__ inline unsigned ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const unsigned*>(p); }
__device__ inline unsigned lo_bf16(unsigned v) { return v << 16; }           // bf16 -> fp32 bits, exact
__device__ inline unsigned hi_bf16(unsigned v) { return v & 0xffff0000u; }

// v = big + small + r, both parts TF32 (10 explicit mantissa bits), each cut
// toward zero: |r| < 2^-20 |v|.  One subtraction and two masks; cvt.rna
// runs at the conversion rate, a quarter of the integer units', and rounding
// to nearest gains nothing the one-ulp check can see (tests/_torch_parity.py)
__device__ inline void split(float v, unsigned& big, unsigned& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

__device__ inline float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ inline void mma_bf16(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ inline void mma_tf32(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four (two) 8 x 8 bf16 matrices, lane 8m + r giving row r of matrix m;
// transposed: lane 4g + t gets (row 2t, column g) in its low half and (row
// 2t + 1, column g) in its high half of each.
__device__ inline void ldmatrix_x4_trans(unsigned (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ inline void ldmatrix_x2_trans(unsigned (&r)[2], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// 16 bytes global -> shared, of which the first `bytes` are read and the rest zero
__device__ inline void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// 8 bf16 of a row from column c (columns past n zero), element by element
__device__ inline uint4 load8(const __nv_bfloat16* row, int c, int n) {
  unsigned short v[8];
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = c + i < n ? r[c + i] : 0;
  uint4 out;
  out.x = v[0] | (unsigned)v[1] << 16;
  out.y = v[2] | (unsigned)v[3] << 16;
  out.z = v[4] | (unsigned)v[5] << 16;
  out.w = v[6] | (unsigned)v[7] << 16;
  return out;
}

// 16 bytes of a staged row: zeros past the valid rows and columns; by
// cp.async where the source rows are aligned runs, element by element where not
__device__ inline void stage16(__nv_bfloat16* dst, const __nv_bfloat16* row, int c, int n, bool valid, bool vec) {
  if (!valid || c >= n) *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  else if (vec) cp_async16(dst, row + c, 2 * min(8, n - c));
  else *reinterpret_cast<uint4*>(dst) = load8(row, c, n);
}

// grid: (ceil(H / HG), B), THREADS threads; a block owns HG heads, all of P.
template <int NP, int HG>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using lay = Layout<NP, HG>;
  constexpr int LDN = lay::LDN, LDH = lay::LDH, NT = lay::NT, NPW = lay::NPW;
  float* hs = reinterpret_cast<float*>(smem + lay::hs);
  double* cl = reinterpret_cast<double*>(smem + lay::cl);
  float* tail = reinterpret_cast<float*>(smem + lay::tail);
  float* ecum = reinterpret_cast<float*>(smem + lay::ecum);
  float* decay = reinterpret_cast<float*>(smem + lay::decay);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int hd0 = blockIdx.x * HG;
  const int b = blockIdx.y;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x) + b * p.x_sb;
  const __nv_bfloat16* bm = static_cast<const __nv_bfloat16*>(p.bm) + b * p.b_sb;
  const __nv_bfloat16* cm = static_cast<const __nv_bfloat16*>(p.cm) + b * p.c_sb;
  const float* l = p.l + b * p.l_sb;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y) + (long long)b * p.S * p.H * p.P;

  // Copies rows s0 .. s0 + q - 1 of C, B and the group's x into buffer k.
  auto stage = [&](int k, int s0, int q) {
    __nv_bfloat16* cc = reinterpret_cast<__nv_bfloat16*>(smem + k * lay::stage + lay::cc);
    __nv_bfloat16* bc = reinterpret_cast<__nv_bfloat16*>(smem + k * lay::stage + lay::bc);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + k * lay::stage + lay::xs);
    for (int e = tid; e < QP * (NP / 8); e += THREADS) {
      const int r = e / (NP / 8), c = (e % (NP / 8)) * 8;
      stage16(cc + r * LDN + c, cm + (s0 + r) * p.c_ss, c, p.N, r < q, p.bc_vec);
      stage16(bc + r * LDN + c, bm + (s0 + r) * p.b_ss, c, p.N, r < q, p.bc_vec);
    }
    for (int e = tid; e < HG * QP * (PB / 8); e += THREADS) {
      const int gh = e / (QP * (PB / 8)), r = (e / (PB / 8)) % QP, c = (e % (PB / 8)) * 8;
      stage16(xs + (gh * QP + r) * LDX + c, x + (s0 + r) * p.x_ss + (hd0 + gh) * p.x_sh, c, p.P,
              r < q && hd0 + gh < p.H, p.x_vec);
    }
    cp_async_commit();
  };
  // log_l of rows 4 lane .. 4 lane + 3 of a chunk, head hd0 + warp (warps < HG)
  float lv[4];
  auto load_l = [&](int s0, int q) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = 4 * lane + k;
      lv[k] = warp < HG && r < q && hd0 + warp < p.H ? l[(s0 + r) * p.l_ss + (hd0 + warp) * p.l_sh] : 0.f;
    }
  };

  stage(0, 0, min(p.Q, p.S));
  load_l(0, min(p.Q, p.S));
  // the state: h0 or zeros; rows past P and columns past N stay zero
  for (int e = tid; e < HG * PB * NP; e += THREADS) {
    const int gh = e / (PB * NP), r = (e / NP) % PB, n = e % NP;
    const int hd = hd0 + gh;
    float v = 0.f;
    if (p.h0 && hd < p.H && r < p.P && n < p.N) v = p.h0[(((long long)b * p.H + hd) * p.P + r) * p.N + n];
    hs[(gh * PB + r) * LDH + n] = v;
  }

  for (int s0 = 0, it = 0; s0 < p.S; s0 += p.Q, ++it) {
    const int q = min(p.Q, p.S - s0);
    const int qp = (q + 15) & ~15;          // rows worked on; rows q .. qp - 1 are zero
    const __nv_bfloat16* cc = reinterpret_cast<const __nv_bfloat16*>(smem + (it & 1) * lay::stage + lay::cc);
    const __nv_bfloat16* bc = reinterpret_cast<const __nv_bfloat16*>(smem + (it & 1) * lay::stage + lay::bc);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(smem + (it & 1) * lay::stage + lay::xs);
    cp_async_wait_all();
    __syncthreads();                        // this chunk is staged, the previous one is read
    if (s0 + p.Q < p.S) stage((it + 1) & 1, s0 + p.Q, min(p.Q, p.S - s0 - p.Q));

    // ---- cumulative log decay of each head in fp64: warp gh, four rows a lane
    if (warp < HG) {
      double run = 0.0, v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = run += static_cast<double>(lv[k]);
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const double before = incl - run;
      const double last = __shfl_sync(0xffffffffu, incl, 31) * LOG2E;   // padded rows add 0
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * lane + k;
        if (r < QP) {
          const double c = (v[k] + before) * LOG2E;
          cl[warp * QP + r] = c;
          tail[warp * QP + r] = exp2_approx(static_cast<float>(last - c));
          ecum[warp * QP + r] = exp2_approx(static_cast<float>(c));
        }
      }
      if (lane == 0) decay[warp] = exp2_approx(static_cast<float>(last));
      if (s0 + p.Q < p.S) load_l(s0 + p.Q, min(p.Q, p.S - s0 - p.Q));   // lands during this chunk
    }
    __syncthreads();

    // ---- state products: dh[p][n] = sum_j x[j][p] (B[j][n] tail[j]) into registers;
    // warp w owns NPW tiles of 16 rows of the block's P by the same 16 columns of N
    // (tile w + 8 k: rows 16 ((w + 8 k) / NT) .., columns 16 (w % NT) ..), for every
    // head of the group at once (independent accumulators).  B tail is cut into its
    // two TF32 parts once a head and step for all the warp's tiles.  The products
    // are added to the state after the outputs have read it.
    float dh[NPW][HG][2][4];
#pragma unroll
    for (int k = 0; k < NPW; ++k)
#pragma unroll
      for (int gh = 0; gh < HG; ++gh)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[k][gh][nn][e] = 0.f;
    {
      const int r8 = lane & 7, m2 = (lane >> 3) & 1, nq = warp % NT;
#pragma unroll 2
      for (int j0 = 0; j0 < qp; j0 += 8) {
        unsigned bv[2];           // B[j .. j + 1][16 nq + 8 nn + g], j = j0 + 2t
        ldmatrix_x2_trans(bv, bc + (j0 + r8) * LDN + 16 * nq + 8 * m2);
#pragma unroll
        for (int gh = 0; gh < HG; ++gh) {
          if (hd0 + gh < p.H) {
            const float2 tl = *reinterpret_cast<const float2*>(tail + gh * QP + j0 + 2 * t);
            // B slot order: (j, n), (j + 1, n)
            unsigned bbig[2][2], bsmall[2][2];
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
              split(__uint_as_float(lo_bf16(bv[nn])) * tl.x, bbig[nn][0], bsmall[nn][0]);
              split(__uint_as_float(hi_bf16(bv[nn])) * tl.y, bbig[nn][1], bsmall[nn][1]);
            }
#pragma unroll
            for (int k = 0; k < NPW; ++k) {
              const int mt = (warp + 8 * k) / NT;
              unsigned xv[2];     // x[j .. j + 1][16 mt + 8 m + g], m = 0, 1
              ldmatrix_x2_trans(xv, xs + (gh * QP + j0 + r8) * LDX + 16 * mt + 8 * m2);
              // A slot order: (p, j), (p + 8, j), (p, j + 1), (p + 8, j + 1), p = 16 mt + g
              const unsigned xa[4] = {lo_bf16(xv[0]), lo_bf16(xv[1]), hi_bf16(xv[0]), hi_bf16(xv[1])};
#pragma unroll
              for (int nn = 0; nn < 2; ++nn) {
                mma_tf32(dh[k][gh][nn], xa, bbig[nn]);
                mma_tf32(dh[k][gh][nn], xa, bsmall[nn]);
              }
            }
          }
        }
      }
    }

    // ---- y: warp w owns row tile rt (rows 16 rt .. 16 rt + 15 of the chunk); warps w
    // and w + 4 share a scheduler, so they take tiles k and 7 - k: 9 causal
    // 16-column blocks on each scheduler, where tiles w and w + 4 would give 6 to 12
    const int rt = warp < 4 ? warp : 11 - warp;
    const int i0 = 16 * rt;
    if (i0 < qp) {
      // S = C B^T on the causal tiles (n8 tiles jt <= 2 rt + 1), bf16 products exact
      float s[16][4];
#pragma unroll
      for (int jt = 0; jt < 16; ++jt)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[jt][k] = 0.f;
#pragma unroll
      for (int n0 = 0; n0 < NP; n0 += 16) {
        const unsigned a[4] = {ld32(cc + (i0 + g) * LDN + n0 + 2 * t), ld32(cc + (i0 + g + 8) * LDN + n0 + 2 * t),
                               ld32(cc + (i0 + g) * LDN + n0 + 2 * t + 8),
                               ld32(cc + (i0 + g + 8) * LDN + n0 + 2 * t + 8)};
#pragma unroll
        for (int jt = 0; jt < 16; ++jt) {
          if (jt <= 2 * rt + 1) {
            const unsigned bb[2] = {ld32(bc + (8 * jt + g) * LDN + n0 + 2 * t),
                                    ld32(bc + (8 * jt + g) * LDN + n0 + 2 * t + 8)};
            mma_bf16(s[jt], a, bb);
          }
        }
      }
      for (int gh = 0; gh < HG; ++gh) {
        const int hd = hd0 + gh;
        if (hd >= p.H) break;
        const double* clg = cl + gh * QP;
        const float* hsg = hs + gh * PB * LDH;
        const __nv_bfloat16* xsg = xs + gh * QP * LDX;
        float acc[PB / 8][4];
#pragma unroll
        for (int pt = 0; pt < PB / 8; ++pt)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[pt][k] = 0.f;
        // inter: (C h^T) exp(cum_i), h in two TF32 parts
#pragma unroll
        for (int n0 = 0; n0 < NP; n0 += 8) {
          const unsigned c0 = ld32(cc + (i0 + g) * LDN + n0 + 2 * t);
          const unsigned c1 = ld32(cc + (i0 + g + 8) * LDN + n0 + 2 * t);
          const unsigned a[4] = {lo_bf16(c0), lo_bf16(c1), hi_bf16(c0), hi_bf16(c1)};
#pragma unroll
          for (int pt = 0; pt < PB / 8; ++pt) {
            const float2 hv = *reinterpret_cast<const float2*>(hsg + (8 * pt + g) * LDH + n0 + 2 * t);
            unsigned big[2], small[2];
            split(hv.x, big[0], small[0]);
            split(hv.y, big[1], small[1]);
            mma_tf32(acc[pt], a, big);
            mma_tf32(acc[pt], a, small);
          }
        }
        {
          const float e0 = ecum[gh * QP + i0 + g], e1 = ecum[gh * QP + i0 + g + 8];
#pragma unroll
          for (int pt = 0; pt < PB / 8; ++pt) {
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[pt][k] *= k < 2 ? e0 : e1;
          }
        }
        // intra: att x, att = S exp(cum_i - cum_j) masked to j <= i before the
        // exponential, in two TF32 parts
        const double ci0 = clg[i0 + g], ci1 = clg[i0 + g + 8];
#pragma unroll
        for (int jt = 0; jt < 16; ++jt) {
          if (jt <= 2 * rt + 1) {
            const int j = 8 * jt + 2 * t;
            const double2 cj = *reinterpret_cast<const double2*>(clg + j);
            const double cj0 = cj.x, cj1 = cj.y;
            const float d00 = j <= i0 + g ? static_cast<float>(ci0 - cj0) : -INFINITY;
            const float d01 = j + 1 <= i0 + g ? static_cast<float>(ci0 - cj1) : -INFINITY;
            const float d10 = j <= i0 + g + 8 ? static_cast<float>(ci1 - cj0) : -INFINITY;
            const float d11 = j + 1 <= i0 + g + 8 ? static_cast<float>(ci1 - cj1) : -INFINITY;
            // A slot order: (g, j), (g + 8, j), (g, j + 1), (g + 8, j + 1)
            const float att[4] = {s[jt][0] * exp2_approx(d00), s[jt][2] * exp2_approx(d10),
                                  s[jt][1] * exp2_approx(d01), s[jt][3] * exp2_approx(d11)};
            unsigned big[4], small[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) split(att[k], big[k], small[k]);
            unsigned xr[PB / 32][4];   // x[j .. j + 1][8 pt + g]
#pragma unroll
            for (int k = 0; k < PB / 32; ++k)
              ldmatrix_x4_trans(xr[k], xsg + (8 * jt + (lane & 7)) * LDX + 32 * k + 8 * (lane >> 3));
#pragma unroll
            for (int pt = 0; pt < PB / 8; ++pt) {
              const unsigned bb[2] = {lo_bf16(xr[pt / 4][pt % 4]), hi_bf16(xr[pt / 4][pt % 4])};
              mma_tf32(acc[pt], big, bb);
              mma_tf32(acc[pt], small, bb);
            }
          }
        }
        // y rows i0 + g, i0 + g + 8, columns 8 pt + 2t, + 1
#pragma unroll
        for (int pt = 0; pt < PB / 8; ++pt) {
          const int pp = 8 * pt + 2 * t;
          if (pp >= p.P) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = i0 + g + 8 * half;
            if (i >= q) continue;
            *reinterpret_cast<__nv_bfloat162*>(y + ((long long)(s0 + i) * p.H + hd) * p.P + pp) =
                __floats2bfloat162_rn(acc[pt][2 * half], acc[pt][2 * half + 1]);
          }
        }
      }
    }
    __syncthreads();                        // y has read the state

    // ---- state: h <- h exp(cum_last) + dh
#pragma unroll
    for (int k = 0; k < NPW; ++k) {
      const int mt = (warp + 8 * k) / NT, nq = warp % NT;
#pragma unroll
      for (int gh = 0; gh < HG; ++gh) {
        if (hd0 + gh >= p.H) break;
        const float dec = decay[gh];
        float* hsg = hs + gh * PB * LDH;
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float2* hp = reinterpret_cast<float2*>(hsg + (16 * mt + g + 8 * half) * LDH + 16 * nq + 8 * nn + 2 * t);
            float2 h = *hp;
            h.x = h.x * dec + dh[k][gh][nn][2 * half];
            h.y = h.y * dec + dh[k][gh][nn][2 * half + 1];
            *hp = h;
          }
        }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < HG * PB * NP; e += THREADS) {
    const int gh = e / (PB * NP), r = (e / NP) % PB, n = e % NP;
    const int hd = hd0 + gh;
    if (hd < p.H && r < p.P && n < p.N)
      p.h_out[(((long long)b * p.H + hd) * p.P + r) * p.N + n] = hs[(gh * PB + r) * LDH + n];
  }
}

template <int NP, int HG>
cudaError_t launch_with(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = Layout<NP, HG>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_tc_kernel<NP, HG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int groups = (p.H + HG - 1) / HG;
  ssd_scan_tc_kernel<NP, HG><<<dim3(groups, p.B), THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch(const Params& p, cudaStream_t stream) {
  return p.N <= 64 ? launch_with<64, 2>(p, stream) : launch_with<128, 1>(p, stream);
}

}  // namespace tc

cudaError_t launch_fma(const Params& p, cudaStream_t stream) {
  const size_t bytes = fma::smem_floats(p.Q, p.P, p.N) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fma::ssd_scan_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  fma::ssd_scan_kernel<float><<<dim3(p.H, p.B), THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core kernel)
// (x, B, C and y alike; log_l, h0 and h are fp32).  strides: 10 element
// strides in the order x(b,s,h) l(b,s,h) B(b,s) C(b,s).  h0 may be null.
// x_vec / bc_vec: rows of x / of B and C are 16-byte aligned runs.
// Returns the cudaError_t of the launch (0 = ok); it does not synchronise.
extern "C" int ssd_scan_fwd(
    const void* x, const void* log_l, const void* bm, const void* cm, const void* h0,
    void* y, void* h_out, int B, int S, int H, int P, int N, int Q, int dtype,
    const long long* strides, int x_vec, int bc_vec, void* stream) {
  Params p;
  p.x = x; p.l = static_cast<const float*>(log_l); p.bm = bm; p.cm = cm;
  p.h0 = static_cast<const float*>(h0); p.y = y; p.h_out = static_cast<float*>(h_out);
  p.B = B; p.S = S; p.H = H; p.P = P; p.N = N; p.Q = Q;
  p.x_sb = strides[0]; p.x_ss = strides[1]; p.x_sh = strides[2];
  p.l_sb = strides[3]; p.l_ss = strides[4]; p.l_sh = strides[5];
  p.b_sb = strides[6]; p.b_ss = strides[7];
  p.c_sb = strides[8]; p.c_ss = strides[9];
  p.x_vec = x_vec; p.bc_vec = bc_vec;
  if (B > 65535 || Q < 1 || Q > 128 || P > 64 || N > (dtype == 1 ? 128 : 64) || P % 4 || N % 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch_fma(p, s);
  else if (dtype == 1) err = tc::launch(p, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
