// Flash attention (GQA), forward — CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py.  It computes the same function:
// online-softmax blocked attention over grouped query heads with the mask
//     ok = [causal: q_pos >= k_pos] & [window: q_pos - k_pos < window]
//     ok = ok | (k_pos < prefix_len)
// masked scores filled with the FINITE constant -1e30, fp32 running max /
// sum / accumulator, out = acc / max(l, 1e-20).  Inputs are cast to fp32 and
// both products accumulate in fp32, probabilities included.
//
// What differs from the TPU kernel, because the machine does:
//  * One thread block owns one (batch, kv head, tile of query rows) and LOOPS
//    over the kv tiles; the TPU grid's sequential third axis is that loop.
//    Running max, sum and accumulator stay in registers for the whole loop.
//  * The G query heads of a group are folded into the tile's rows
//    (row r = position * G + head), so a K/V tile staged in shared memory is
//    read once for all heads of the group.
//  * kv tiles that the causal / window test rules out for the whole q tile
//    are skipped, not visited and masked.  A tile that starts below
//    `prefix_len` is never skipped.
//  * Any Sq, Sk >= 1: the ragged edge is masked here, nothing is padded.
//  * `q_start` is the global position of query row 0 (q_pos = q_start + row).
//    With q_start = 0 this is the TPU kernel's function; with Sq = 1 and
//    q_start = pos it is a decode step's attention over the cache.
//  * q, k, v, o come with element strides (innermost stride 1), so the
//    caller's layout — the model's (B, S, heads, Dh), a slice of a KV cache —
//    is read in place.
//
// Bound on this card: counted as bytes (q, k, v read once, o written once)
// against operations on the tensor cores, the function is bound by bytes at
// the serving shapes.  This first version is far from that bound: it does the
// two products with plain fp32 FMA from shared memory (16 x 16 threads, each
// with a 4 x 4 register tile of the scores and a 4 x D/16 tile of the output),
// and loads each K/V tile before it computes on it.  Tensor cores (wgmma), TMA
// and a pipelined K/V ring are the next step; a decode step, which has only
// B*K blocks, also wants its keys split across blocks.
//
// Every query row must see at least one key (true of every causal row whose
// own position is among the keys); a row that sees none has no defined value
// in the reference either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;   // finite on purpose: see the softmax below
constexpr int BN = 64;              // keys in a tile
constexpr int NTHREADS = 256;       // 16 (ty: rows) x 16 (tx: columns)
constexpr int PAD = 4;              // floats; keeps float4 reads conflict-free

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
};

// 16-byte global loads, widened to fp32.
template <typename T> struct Load16;

template <> struct Load16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};

template <> struct Load16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ inline void from_float(float* p, float x) { *p = x; }
__device__ inline void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stage ROWS x D elements into shared memory as fp32.  `row_ptr(r)` gives the
// address of row r's D contiguous elements, or nullptr for a row past the
// edge, which is filled with zeros.
template <typename T, int D, int ROWS, typename RowPtr>
__device__ inline void load_tile(float* dst, int dst_stride, RowPtr row_ptr, int tid) {
  constexpr int N = Load16<T>::N;
  constexpr int CH = D / N;   // 16-byte chunks in a row
#pragma unroll
  for (int c0 = 0; c0 < ROWS * CH; c0 += NTHREADS) {
    const int c = c0 + tid;
    if (c < ROWS * CH) {
      const int r = c / CH;
      const int d = (c % CH) * N;
      float x[N];
      const T* src = row_ptr(r);
      if (src != nullptr) {
        Load16<T>::load(src + d, x);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) x[i] = 0.f;
      }
      float* out = dst + r * dst_stride + d;
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        *reinterpret_cast<float4*>(out + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
      }
    }
  }
}

template <int D, int RA>
struct Layout {
  static constexpr int BM = 16 * RA;        // query rows in a tile
  static constexpr int QS = D + PAD;        // row strides in shared memory
  static constexpr int KS = D + PAD;
  static constexpr int VS = D;
  static constexpr int PS = BN + PAD;
  // the K tile's room is reused for the probabilities once the scores are done
  static constexpr int KREGION = (BN * KS > BM * PS) ? BN * KS : BM * PS;
  static constexpr int SMEM_FLOATS = BM * QS + KREGION + BN * VS;
};

template <typename T, int D, int RA>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const Params p) {
  using L = Layout<D, RA>;
  constexpr int BM = L::BM;
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
  // heaviest (latest) causal tiles first
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int R = p.G * p.Sq;                 // folded rows: r = position * G + head
  const int r0 = tile * BM;
  const int rows_here = min(BM, R - r0);
  const int q_lo = p.q_start + r0 / p.G;
  const int q_hi = p.q_start + (r0 + rows_here - 1) / p.G;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + kh * p.q_sk;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sk;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sk;
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + kh * p.o_sk;

  load_tile<T, D, BM>(Qs, L::QS, [&](int r) -> const T* {
    const int rg = r0 + r;
    if (rg >= R) return nullptr;
    return qb + (long long)(rg / p.G) * p.q_ss + (long long)(rg % p.G) * p.q_sg;
  }, tid);

  // A thread owns rows ty + 16 a.  A warp holds two values of ty, so "this
  // warp has a live row at index a" is uniform across the warp: the two heavy
  // loops are skipped for tiles' dead rows (a decode step has only G rows).
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

  const int n_kv_tiles = (p.Sk + BN - 1) / BN;
  for (int j = 0; j < n_kv_tiles; ++j) {
    const int k_lo = j * BN;
    const int k_hi = min(k_lo + BN, p.Sk) - 1;
    const bool in_prefix = p.prefix_len > 0 && k_lo < p.prefix_len;
    if (!in_prefix) {
      if (p.causal && k_lo > q_hi) continue;
      if (p.window >= 0 && q_lo - k_hi >= p.window) continue;
    }

    load_tile<T, D, BN>(Ks, L::KS, [&](int r) -> const T* {
      return (k_lo + r < p.Sk) ? kb + (long long)(k_lo + r) * p.k_ss : nullptr;
    }, tid);
    load_tile<T, D, BN>(Vs, L::VS, [&](int r) -> const T* {
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

    // ---- mask, online softmax ------------------------------------------------
    // The fill is finite.  A row whose every score in this tile is masked gets
    // p = exp(0) = 1 while its max is still -1e30; the first tile with a live
    // score then has alpha = exp(-1e30 - m) = 0 and wipes that.  With -inf the
    // same row would be NaN.
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k_lo + tx + 16 * c;
        bool ok = true;
        if (p.causal) ok = ok && (qpos[a] >= kpos);
        if (p.window >= 0) ok = ok && (qpos[a] - kpos < p.window);
        if (p.prefix_len > 0) ok = ok || (kpos < p.prefix_len);
        ok = ok && (kpos < p.Sk);
        s[a][c] = ok ? s[a][c] * p.sm_scale : NEG_INF;
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
      T* dst = ob + (long long)(rg / p.G) * p.o_ss + (long long)(rg % p.G) * p.o_sg;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          from_float(dst + c * 16 * VEC + tx * VEC + e, acc[a][c * VEC + e] / denom);
    }
  }
}

template <typename T, int D, int RA>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Layout<D, RA>;
  constexpr int smem_bytes = L::SMEM_FLOATS * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<T, D, RA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const int R = p.G * p.Sq;
  const dim3 grid((R + L::BM - 1) / L::BM, p.B * p.K);
  kernel<<<grid, NTHREADS, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  // few rows (a decode step: G of them): a 16-row tile; else 64 rows
  if (p.G * p.Sq <= 16) return launch<T, D, 1>(p, stream);
  return launch<T, D, 4>(p, stream);
}

template <typename T>
cudaError_t launch_dim(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_rows<T, 32>(p, stream);
    case 64: return launch_rows<T, 64>(p, stream);
    case 128: return launch_rows<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 14 element strides in the order
// q(b,k,g,s) k(b,k,s) v(b,k,s) o(b,k,g,s); every innermost stride is 1.
// window < 0 means no window.  Returns the cudaError_t of the launch (0 = ok);
// it does not synchronise.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int K, int G, int Sq, int Sk, int D, int dtype,
    const long long* strides,
    int causal, int window, int prefix_len, int q_start, float sm_scale,
    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.K = K; p.G = G; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = strides[0]; p.q_sk = strides[1]; p.q_sg = strides[2]; p.q_ss = strides[3];
  p.k_sb = strides[4]; p.k_sk = strides[5]; p.k_ss = strides[6];
  p.v_sb = strides[7]; p.v_sk = strides[8]; p.v_ss = strides[9];
  p.o_sb = strides[10]; p.o_sk = strides[11]; p.o_sg = strides[12]; p.o_ss = strides[13];
  p.causal = causal; p.window = window; p.prefix_len = prefix_len; p.q_start = q_start;
  p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch_dim<float>(p, D, s);
  else if (dtype == 1) err = launch_dim<__nv_bfloat16>(p, D, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
