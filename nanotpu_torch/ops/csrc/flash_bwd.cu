// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes:
// three kernels in one library.
//
// Replaces, in nanotpu/ops/attention.py (launched by _flash_backward through
// pl.pallas_call):
//   * bwd_kv<.., true>   the fused single pass, _flash_bwd_fused_kernel
//                        (:384-446): dq, dk and dv, 5 products per pair;
//   * bwd_dq             the two-pass dq half, _flash_bwd_dq_kernel (:300-336);
//   * bwd_kv<.., false>  the two-pass dk/dv half, _flash_bwd_dkv_kernel
//                        (:339-381).
// All three rebuild p = exp(q.k scale - lse) from the forward's lse and go
// through one routine for each (query, key) pair, bwd_pair below: the
// counterpart of _bwd_pair/_rebuild_p (:271-297). ds = p (dO.v - D), with
// D = rowsum(dO * O) - g_lse computed by the wrapper as a torch reduction,
// as the JAX code computes it outside its kernels. dq = scale * ds k,
// dk = scale * ds^T q, dv = p^T dO.
//
// Layouts are nanotpu's: q, dO, dq [B, S, H, D]; k, v, dk, dv [B, S, KV, D];
// lse and D [B, H, S] f32. q, k, v are read through strides (the head-dim
// stride must be 1); nothing is padded: a ragged S is masked by bounds, and
// a row whose lse is NEG_INF gives zero gradients. GQA by indexing: q head h
// reads kv head h / (H / KV).
//
// Design for the card rather than the TPU's sequential grid:
//   * bwd_kv: a block owns one 64-key tile of one (batch, kv head) and loops
//     over the H / KV query heads of that kv head and, for each, over the
//     64-row query tiles from the causal diagonal on. dk and dv stay in
//     registers and are written once at kv-head granularity, so there is no
//     group sum and no race. In the fused variant dq is added in f32 with
//     atomicAdd into a zeroed [B, S, H, D] buffer (the wrapper casts it);
//     the order of those additions varies from run to run.
//   * bwd_dq: a block owns 64 query rows of one (batch, head) and loops over
//     the causally relevant key tiles; no atomics.
//   * bf16: mma.sync m16n8k16 tiles (bf16 in, f32 accumulate), p and ds
//     rounded to bf16 for their products as the TPU kernels do; the next
//     tile streams in with cp.async while the current one is multiplied.
//     f32: FMA tiles on the CUDA cores, so f32 stays f32 end to end.
//
// What bounds it on an H100 SXM: at the training flagship's shape (B=8,
// S=2048, H=16, KV=4, D=64, causal) one product over the causal half is
// ~3.4e10 FLOP; the fused pass does 5 (~1.7e11, ~0.17 ms at the 989 TFLOP/s
// bf16 peak), the two-pass pair 7 (~2.4e11). Its inputs and outputs are
// ~40 MB (~0.012 ms at 3.35 TB/s), so it is compute-bound. This first
// design is simple and correct rather than fast: no wgmma, no TMA, no
// producer/consumer warps.

#include "flash_common.cuh"

namespace {

constexpr int kTile = 64;  // query rows and keys per tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;   // [B, H, S]
  const float* dvec;  // [B, H, S]: rowsum(dO * O) - g_lse
  void* dq;   // fused: f32 accumulator, zeroed; dq kernel: the input type
  void* dk;
  void* dv;
  int S, H, KV;
  // b, s, h strides in elements
  long long q_stride[3], k_stride[3], v_stride[3], do_stride[3];
  long long dq_stride[3], dk_stride[3], dv_stride[3];
  int causal;
  float scale;
};

// The pair math of every kernel here: for one (query row, key) with raw
// score s = q.k and dp = dO.v, p = exp(s * scale - lse) where the pair is
// valid (both in range, causal order, a finite lse), else 0; ds = p (dp - D).
struct Pair {
  float p, ds;
};
__device__ __forceinline__ Pair bwd_pair(float s, float dp, float lse,
                                         float dvec, int qpos, int kpos,
                                         const Args& a) {
  const bool valid = qpos < a.S && kpos < a.S && (!a.causal || kpos <= qpos) &&
                     lse != kNegInf;
  const float p = valid ? expf(s * a.scale - lse) : 0.f;
  return {p, p * (dp - dvec)};
}

// The rows of one (batch, head) of a strided [B, S, heads, D] tensor.
template <typename T>
__device__ __forceinline__ const T* rows_of(const void* base,
                                            const long long (&st)[3], int b,
                                            int h) {
  return static_cast<const T*>(base) + b * st[0] + h * st[2];
}
template <typename T>
__device__ __forceinline__ T* rows_of(void* base, const long long (&st)[3],
                                      int b, int h) {
  return static_cast<T*>(base) + b * st[0] + h * st[2];
}

// 64 entries of a [B, H, S] f32 vector from row0 on (0 past S).
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int S) {
  for (int i = threadIdx.x; i < kTile; i += blockDim.x)
    dst[i] = row0 + i < S ? src[row0 + i] : 0.f;
}

// ---- bf16: tensor cores --------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows

template <int D> struct Pitch {
  static constexpr int P = D + 8;             // bf16 per [64, D] row
  static constexpr int tile = kTile * P;      // bf16 per [64, D] tile
  static constexpr int dsP = kTile + 8;       // bf16 per dS row
};

// Issue the copies of 64 rows of a strided bf16 [S, D] matrix, from row0
// on, into a [64, D] shared tile (rows past S zero).
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int row0,
                                           int S) {
  constexpr int P = Pitch<D>::P;
  for (int i = threadIdx.x; i < kTile * D / 8; i += kMmaThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8, s = row0 + r;
    const bool valid = s < S;
    const long long row = valid ? s : 0;
    cp_async_16(dst + r * P + c, src + row * row_stride + c, valid);
  }
}

// A fragments of 16 rows of a [64, D] shared tile, starting at `rows`.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4],
                                       const __nv_bfloat16* rows, int g,
                                       int t) {
  constexpr int P = Pitch<D>::P;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* r0 = rows + g * P + kk * 16 + 2 * t;
    f[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * P);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * P + 8);
  }
}

// c[nt] = a . B^T for 8 column tiles of 8 rows of a [64, D] shared tile:
// the 16 x 64 product of 16 rows (as A fragments) with all 64 rows of `B`.
template <int D>
__device__ __forceinline__ void rows_dot_tile(float (&c)[kTile / 8][4],
                                              const uint32_t (&f)[D / 16][4],
                                              const __nv_bfloat16* B, int g,
                                              int t) {
  constexpr int P = Pitch<D>::P;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
    const __nv_bfloat16* row = B + (nt * 8 + g) * P + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row + kk * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + kk * 16 + 8);
      mma_bf16(c[nt], f[kk], b0, b1);
    }
  }
}

// acc[16 rows, D] += X . T where X [16, 64] is given by its C fragments x
// (column tiles 2j, 2j+1 of x form the A fragment of columns 16j..16j+15)
// and T is a [64, D] shared tile, read through ldmatrix.trans.
template <int D>
__device__ __forceinline__ void c_times_tile(float (&acc)[D / 8][4],
                                             const float (&x)[kTile / 8][4],
                                             const __nv_bfloat16* T,
                                             int lane) {
  constexpr int P = Pitch<D>::P;
  const int mi = lane >> 3;  // which 8x8 matrix this lane addresses
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) {
    const uint32_t xa[4] = {pack_bf16(x[2 * j][0], x[2 * j][1]),
                            pack_bf16(x[2 * j][2], x[2 * j][3]),
                            pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]),
                            pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3])};
    const __nv_bfloat16* trow =
        T + (j * 16 + (mi & 1) * 8 + (lane & 7)) * P + (mi >> 1) * 8;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t tb[4];
      ldmatrix_x4_trans(tb, trow + dp * 16);
      mma_bf16(acc[2 * dp], xa, tb[0], tb[1]);
      mma_bf16(acc[2 * dp + 1], xa, tb[2], tb[3]);
    }
  }
}

template <int D> struct KvSmem {
  using Pt = Pitch<D>;
  // sK, sV, two stages of (sQ, sdO), sdS; then two stages of (lse, D)
  static constexpr int bf16s = 2 * Pt::tile + 4 * Pt::tile + kTile * Pt::dsP;
  static constexpr size_t bytes =
      bf16s * sizeof(__nv_bfloat16) + 4 * kTile * sizeof(float);
};

// One 64-key tile of one (batch, kv head): dk and dv, and with kDq dq too.
template <int D, bool kDq>
__global__ void __launch_bounds__(kMmaThreads) bwd_kv_bf16(const Args a) {
  using Pt = Pitch<D>;
  constexpr int P = Pt::P, DSP = Pt::dsP, TILE = Pt::tile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + TILE;
  __nv_bfloat16* stages = sV + TILE;  // stage s: sQ, then sdO
  __nv_bfloat16* sdS = stages + 4 * TILE;  // [key][query]
  float* vecs = reinterpret_cast<float*>(sdS + kTile * DSP);  // lse, D

  const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
  const int rep = a.H / a.KV;
  const int k0 = blockIdx.y * kTile;  // under causal, tile 0 is the heaviest
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (a.S + kTile - 1) / kTile;
  const int q_first = a.causal ? blockIdx.y : 0;
  const int per_head = nq - q_first;
  const int n_iter = rep * per_head;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  stage_rows<D>(sK, rows_of<__nv_bfloat16>(a.k, a.k_stride, b, kvh),
                a.k_stride[1], k0, a.S);
  stage_rows<D>(sV, rows_of<__nv_bfloat16>(a.v, a.v_stride, b, kvh),
                a.v_stride[1], k0, a.S);
  // iteration it visits query head kvh * rep + it / per_head and the query
  // tile q_first + it % per_head
  auto issue = [&](int it) {
    const int h = kvh * rep + it / per_head;
    const int q0 = (q_first + it % per_head) * kTile;
    __nv_bfloat16* st = stages + (it & 1) * 2 * TILE;
    stage_rows<D>(st, rows_of<__nv_bfloat16>(a.q, a.q_stride, b, h),
                  a.q_stride[1], q0, a.S);
    stage_rows<D>(st + TILE, rows_of<__nv_bfloat16>(a.dout, a.do_stride, b, h),
                  a.do_stride[1], q0, a.S);
    const long long bh = static_cast<long long>(b * a.H + h) * a.S;
    float* vec = vecs + (it & 1) * 2 * kTile;
    load_vec(vec, a.lse + bh, q0, a.S);
    load_vec(vec + kTile, a.dvec + bh, q0, a.S);
  };

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  if (n_iter > 0) issue(0);
  cp_async_commit();  // K, V and the first stage
  for (int it = 0; it < n_iter; ++it) {
    const int h = kvh * rep + it / per_head;
    const int q0 = (q_first + it % per_head) * kTile;
    // prefetch the next stage, whose reads ended at the barrier closing the
    // previous iteration
    if (it + 1 < n_iter) issue(it + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* sQ = stages + (it & 1) * 2 * TILE;
    const __nv_bfloat16* sdO = sQ + TILE;
    const float* sL = vecs + (it & 1) * 2 * kTile;
    const float* sD = sL + kTile;

    // this warp's 16 keys against the tile's 64 query rows:
    // s^T = K Q^T and dp^T = V dO^T
    float s[kTile / 8][4], dp[kTile / 8][4];
    {
      uint32_t f[D / 16][4];
      load_a<D>(f, sK + warp * 16 * P, g, t);
      rows_dot_tile<D>(s, f, sQ, g, t);
      load_a<D>(f, sV + warp * 16 * P, g, t);
      rows_dot_tile<D>(dp, f, sdO, g, t);
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);
        const Pair pr = bwd_pair(s[nt][e], dp[nt][e], sL[ql], sD[ql], q0 + ql,
                                 keys[e >> 1], a);
        s[nt][e] = pr.p;
        dp[nt][e] = pr.ds;
      }
    // dv += p^T dO, dk += ds^T Q
    c_times_tile<D>(dv, s, sdO, lane);
    c_times_tile<D>(dk, dp, sQ, lane);

    if constexpr (kDq) {
      // ds^T to shared memory, then dq[16 query rows of this warp] =
      // scale * ds K, added to the f32 accumulator
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(sdS + (warp * 16 + g + 8 * i) * DSP +
                                       nt * 8 + 2 * t) =
              pack_bf16(dp[nt][2 * i], dp[nt][2 * i + 1]);
      __syncthreads();
      float acc[D / 8][4];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        // A = ds [query, key] from the stored ds^T [key, query]
        uint32_t af[4];
        ldmatrix_x4_trans(af, sdS + (kk * 16 + (mi >> 1) * 8 + (lane & 7)) * DSP +
                                  warp * 16 + (mi & 1) * 8);
        const __nv_bfloat16* krow =
            sK + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * P + (mi >> 1) * 8;
#pragma unroll
        for (int dpi = 0; dpi < D / 16; ++dpi) {
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, krow + dpi * 16);
          mma_bf16(acc[2 * dpi], af, kb[0], kb[1]);
          mma_bf16(acc[2 * dpi + 1], af, kb[2], kb[3]);
        }
      }
      float* dq = rows_of<float>(a.dq, a.dq_stride, b, h);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = q0 + warp * 16 + g + 8 * i;
        if (q >= a.S) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          atomicAdd(dq + q * a.dq_stride[1] + j * 8 + 2 * t,
                    acc[j][2 * i] * a.scale);
          atomicAdd(dq + q * a.dq_stride[1] + j * 8 + 2 * t + 1,
                    acc[j][2 * i + 1] * a.scale);
        }
      }
    }
    __syncthreads();  // this stage's (and sdS's) reads are done
  }

  __nv_bfloat16* dK = rows_of<__nv_bfloat16>(a.dk, a.dk_stride, b, kvh);
  __nv_bfloat16* dV = rows_of<__nv_bfloat16>(a.dv, a.dv_stride, b, kvh);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= a.S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dK + keys[i] * a.dk_stride[1] + j * 8 + 2 * t) =
          pack_bf16(dk[j][2 * i] * a.scale, dk[j][2 * i + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dV + keys[i] * a.dv_stride[1] + j * 8 + 2 * t) =
          pack_bf16(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

template <int D> struct DqSmem {
  // two stages of (sK, sV)
  static constexpr size_t bytes = 4 * Pitch<D>::tile * sizeof(__nv_bfloat16);
};

// 64 query rows of one (batch, head): dq over the causally relevant keys.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) bwd_dq_bf16(const Args a) {
  constexpr int TILE = Pitch<D>::tile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.KV);
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qb * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int n_tiles = (a.S + kTile - 1) / kTile;
  if (a.causal) n_tiles = min(n_tiles, qb + 1);

  const __nv_bfloat16* Q = rows_of<__nv_bfloat16>(a.q, a.q_stride, b, h);
  const __nv_bfloat16* dO = rows_of<__nv_bfloat16>(a.dout, a.do_stride, b, h);
  const __nv_bfloat16* K = rows_of<__nv_bfloat16>(a.k, a.k_stride, b, kvh);
  const __nv_bfloat16* V = rows_of<__nv_bfloat16>(a.v, a.v_stride, b, kvh);

  // this warp's 16 query rows of q and dO as A fragments, read once
  uint32_t qf[D / 16][4], of[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = load_pair(Q, a.q_stride[1], rows[0], c, a.S);
    qf[kk][1] = load_pair(Q, a.q_stride[1], rows[1], c, a.S);
    qf[kk][2] = load_pair(Q, a.q_stride[1], rows[0], c + 8, a.S);
    qf[kk][3] = load_pair(Q, a.q_stride[1], rows[1], c + 8, a.S);
    of[kk][0] = load_pair(dO, a.do_stride[1], rows[0], c, a.S);
    of[kk][1] = load_pair(dO, a.do_stride[1], rows[1], c, a.S);
    of[kk][2] = load_pair(dO, a.do_stride[1], rows[0], c + 8, a.S);
    of[kk][3] = load_pair(dO, a.do_stride[1], rows[1], c + 8, a.S);
  }
  const long long bh = static_cast<long long>(blockIdx.x) * a.S;
  float lse[2], dvec[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = rows[i] < a.S ? a.lse[bh + rows[i]] : 0.f;
    dvec[i] = rows[i] < a.S ? a.dvec[bh + rows[i]] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  auto issue = [&](int kt) {
    __nv_bfloat16* st = stages + (kt & 1) * 2 * TILE;
    stage_rows<D>(st, K, a.k_stride[1], kt * kTile, a.S);
    stage_rows<D>(st + TILE, V, a.v_stride[1], kt * kTile, a.S);
  };
  issue(0);
  cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) issue(kt + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* sK = stages + (kt & 1) * 2 * TILE;
    const __nv_bfloat16* sV = sK + TILE;

    float s[kTile / 8][4], dp[kTile / 8][4];
    rows_dot_tile<D>(s, qf, sK, g, t);
    rows_dot_tile<D>(dp, of, sV, g, t);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const Pair pr = bwd_pair(s[nt][e], dp[nt][e], lse[i], dvec[i], rows[i],
                                 kt * kTile + nt * 8 + 2 * t + (e & 1), a);
        dp[nt][e] = pr.ds;
      }
    c_times_tile<D>(acc, dp, sK, lane);  // dq += ds K
    __syncthreads();  // this stage's reads are done before it is refilled
  }

  __nv_bfloat16* dQ = rows_of<__nv_bfloat16>(a.dq, a.dq_stride, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= a.S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dQ + rows[i] * a.dq_stride[1] + j * 8 + 2 * t) =
          pack_bf16(acc[j][2 * i] * a.scale, acc[j][2 * i + 1] * a.scale);
  }
}

// ---- f32: CUDA-core FMA tiles --------------------------------------------
//
// 256 threads as 16 row groups (ty) of 16 lanes (tx): a thread owns rows
// ty*4 .. ty*4+3 of a 64 x 64 score tile at columns tx + 16c, and the same
// rows of a [64, D] accumulator at columns tx + 16j.

constexpr int kFmaThreads = 256;

template <int D> struct FmaPitch {
  static constexpr int P = D + 1;      // floats per [64, D] row
  static constexpr int T = kTile + 1;  // floats per [64, 64] row
};

// 64 rows of a strided f32 [S, D] matrix from row0 on (0 past S).
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long row_stride, int row0,
                                              int S) {
  constexpr int P = FmaPitch<D>::P;
  for (int i = threadIdx.x; i < kTile * D; i += kFmaThreads) {
    const int r = i / D, d = i % D, s = row0 + r;
    dst[r * P + d] = s < S ? src[s * row_stride + d] : 0.f;
  }
}

// s[r][c] = X[ty*4+r] . Y[tx+16c] and dp[r][c] = U[ty*4+r] . W[tx+16c]
// over D, for [64, D] shared tiles X, Y, U, W.
template <int D>
__device__ __forceinline__ void score_tiles(float (&s)[4][4], float (&dp)[4][4],
                                            const float* X, const float* Y,
                                            const float* U, const float* W,
                                            int ty, int tx) {
  constexpr int P = FmaPitch<D>::P;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], u[4], y[4], w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x[r] = X[(ty * 4 + r) * P + d];
      u[r] = U[(ty * 4 + r) * P + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      y[c] = Y[(tx + 16 * c) * P + d];
      w[c] = W[(tx + 16 * c) * P + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(x[r], y[c], s[r][c]);
        dp[r][c] = fmaf(u[r], w[c], dp[r][c]);
      }
  }
}

// acc[r][j] += sum over 64 n of A[ty*4+r][n] * Tl[n][tx+16j], where A is a
// [64, 64] shared tile read by row (at = 1) or by column (at = 0).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][D / 16],
                                           const float* A, bool by_row,
                                           const float* Tl, int ty, int tx) {
  constexpr int P = FmaPitch<D>::P, T = FmaPitch<D>::T;
#pragma unroll 4
  for (int n = 0; n < kTile; ++n) {
    float av[4], tv[D / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = by_row ? A[(ty * 4 + r) * T + n] : A[n * T + ty * 4 + r];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) tv[j] = Tl[n * P + tx + 16 * j];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[r][j] = fmaf(av[r], tv[j], acc[r][j]);
  }
}

template <int D> struct FmaKvSmem {
  // sK, sV, sQ, sdO, then sP and sdS [key][query], then lse and D
  static constexpr size_t bytes =
      sizeof(float) * (4 * kTile * FmaPitch<D>::P + 2 * kTile * FmaPitch<D>::T +
                       2 * kTile);
};

template <int D, bool kDq>
__global__ void __launch_bounds__(kFmaThreads) bwd_kv_f32(const Args a) {
  constexpr int P = FmaPitch<D>::P, T = FmaPitch<D>::T;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * P;
  float* sQ = sV + kTile * P;
  float* sdO = sQ + kTile * P;
  float* sP = sdO + kTile * P;
  float* sdS = sP + kTile * T;
  float* sL = sdS + kTile * T;
  float* sD = sL + kTile;

  const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
  const int rep = a.H / a.KV;
  const int k0 = blockIdx.y * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int nq = (a.S + kTile - 1) / kTile;
  const int q_first = a.causal ? blockIdx.y : 0;

  load_rows_f32<D>(sK, rows_of<float>(a.k, a.k_stride, b, kvh), a.k_stride[1],
                   k0, a.S);
  load_rows_f32<D>(sV, rows_of<float>(a.v, a.v_stride, b, kvh), a.v_stride[1],
                   k0, a.S);
  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk[r][j] = dv[r][j] = 0.f;

  for (int h = kvh * rep; h < (kvh + 1) * rep; ++h) {
    const long long bh = static_cast<long long>(b * a.H + h) * a.S;
    for (int qb = q_first; qb < nq; ++qb) {
      const int q0 = qb * kTile;
      __syncthreads();  // the previous tiles' reads are done
      load_rows_f32<D>(sQ, rows_of<float>(a.q, a.q_stride, b, h),
                       a.q_stride[1], q0, a.S);
      load_rows_f32<D>(sdO, rows_of<float>(a.dout, a.do_stride, b, h),
                       a.do_stride[1], q0, a.S);
      load_vec(sL, a.lse + bh, q0, a.S);
      load_vec(sD, a.dvec + bh, q0, a.S);
      __syncthreads();

      // keys ty*4+r against query rows tx+16c
      float s[4][4], dp[4][4];
      score_tiles<D>(s, dp, sK, sQ, sV, sdO, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ql = tx + 16 * c;
          const Pair pr = bwd_pair(s[r][c], dp[r][c], sL[ql], sD[ql], q0 + ql,
                                   k0 + ty * 4 + r, a);
          sP[(ty * 4 + r) * T + ql] = pr.p;
          sdS[(ty * 4 + r) * T + ql] = pr.ds;
        }
      __syncthreads();
      accumulate<D>(dv, sP, true, sdO, ty, tx);   // dv += p^T dO
      accumulate<D>(dk, sdS, true, sQ, ty, tx);   // dk += ds^T Q
      if constexpr (kDq) {
        // dq[query rows ty*4+r] = scale * ds K, into the f32 accumulator
        float acc[4][D / 16];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < D / 16; ++j) acc[r][j] = 0.f;
        accumulate<D>(acc, sdS, false, sK, ty, tx);
        float* dq = rows_of<float>(a.dq, a.dq_stride, b, h);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int q = q0 + ty * 4 + r;
          if (q >= a.S) continue;
#pragma unroll
          for (int j = 0; j < D / 16; ++j)
            atomicAdd(dq + q * a.dq_stride[1] + tx + 16 * j, acc[r][j] * a.scale);
        }
      }
    }
  }

  float* dK = rows_of<float>(a.dk, a.dk_stride, b, kvh);
  float* dV = rows_of<float>(a.dv, a.dv_stride, b, kvh);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty * 4 + r;
    if (key >= a.S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dK[key * a.dk_stride[1] + tx + 16 * j] = dk[r][j] * a.scale;
      dV[key * a.dv_stride[1] + tx + 16 * j] = dv[r][j];
    }
  }
}

template <int D> struct FmaDqSmem {
  // sQ, sdO, sK, sV, then sdS [query][key], then lse and D
  static constexpr size_t bytes =
      sizeof(float) * (4 * kTile * FmaPitch<D>::P + kTile * FmaPitch<D>::T +
                       2 * kTile);
};

template <int D>
__global__ void __launch_bounds__(kFmaThreads) bwd_dq_f32(const Args a) {
  constexpr int T = FmaPitch<D>::T;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * FmaPitch<D>::P;
  float* sK = sdO + kTile * FmaPitch<D>::P;
  float* sV = sK + kTile * FmaPitch<D>::P;
  float* sdS = sV + kTile * FmaPitch<D>::P;
  float* sL = sdS + kTile * T;
  float* sD = sL + kTile;

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.KV);
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int q0 = qb * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  int n_tiles = (a.S + kTile - 1) / kTile;
  if (a.causal) n_tiles = min(n_tiles, qb + 1);

  const long long bh = static_cast<long long>(blockIdx.x) * a.S;
  load_rows_f32<D>(sQ, rows_of<float>(a.q, a.q_stride, b, h), a.q_stride[1],
                   q0, a.S);
  load_rows_f32<D>(sdO, rows_of<float>(a.dout, a.do_stride, b, h),
                   a.do_stride[1], q0, a.S);
  load_vec(sL, a.lse + bh, q0, a.S);
  load_vec(sD, a.dvec + bh, q0, a.S);
  float acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[r][j] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_rows_f32<D>(sK, rows_of<float>(a.k, a.k_stride, b, kvh),
                     a.k_stride[1], k0, a.S);
    load_rows_f32<D>(sV, rows_of<float>(a.v, a.v_stride, b, kvh),
                     a.v_stride[1], k0, a.S);
    __syncthreads();
    // query rows ty*4+r against keys tx+16c
    float s[4][4], dp[4][4];
    score_tiles<D>(s, dp, sQ, sK, sdO, sV, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ql = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const Pair pr = bwd_pair(s[r][c], dp[r][c], sL[ql], sD[ql], q0 + ql,
                                 k0 + tx + 16 * c, a);
        sdS[ql * T + tx + 16 * c] = pr.ds;
      }
    }
    __syncthreads();
    accumulate<D>(acc, sdS, true, sK, ty, tx);  // dq += ds K
  }

  float* dQ = rows_of<float>(a.dq, a.dq_stride, b, h);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = q0 + ty * 4 + r;
    if (q >= a.S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dQ[q * a.dq_stride[1] + tx + 16 * j] = acc[r][j] * a.scale;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, dim3 grid,
                   const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

enum Which { kFused = 0, kDqOnly = 1, kDkv = 2 };

template <int D>
cudaError_t run(int which, int dtype, const Args& a, int B, cudaStream_t st) {
  const int tiles = (a.S + kTile - 1) / kTile;
  const dim3 kv_grid(B * a.KV, tiles), q_grid(B * a.H, tiles);
  if (dtype == 1) {
    if (which == kFused)
      return launch(bwd_kv_bf16<D, true>, kMmaThreads, KvSmem<D>::bytes,
                    kv_grid, a, st);
    if (which == kDkv)
      return launch(bwd_kv_bf16<D, false>, kMmaThreads, KvSmem<D>::bytes,
                    kv_grid, a, st);
    if (which == kDqOnly)
      return launch(bwd_dq_bf16<D>, kMmaThreads, DqSmem<D>::bytes, q_grid, a,
                    st);
  } else if (dtype == 0) {
    if (which == kFused)
      return launch(bwd_kv_f32<D, true>, kFmaThreads, FmaKvSmem<D>::bytes,
                    kv_grid, a, st);
    if (which == kDkv)
      return launch(bwd_kv_f32<D, false>, kFmaThreads, FmaKvSmem<D>::bytes,
                    kv_grid, a, st);
    if (which == kDqOnly)
      return launch(bwd_dq_f32<D>, kFmaThreads, FmaDqSmem<D>::bytes, q_grid, a,
                    st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// which: 0 = fused (dq into a zeroed f32 accumulator, dk, dv), 1 = dq (in the
// input type), 2 = dk and dv. dtype: 0 = float32, 1 = bfloat16. Strides are
// in elements, ordered (batch, sequence, head); every head-dim stride is 1,
// and for bfloat16 every stride is a multiple of 8 and every pointer 16-byte
// aligned (the wrapper checks). lse and dvec are contiguous [B, H, S] f32.
// Returns the CUDA error code of the launch (0 on success). Launches on
// `stream` and allocates nothing.
extern "C" int nanotpu_flash_bwd(
    int which, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dvec, void* dq, void* dk, void* dv,
    int dtype, int B, int S, int H, int KV, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, dout, lse, dvec, dq, dk, dv, S, H, KV,
         {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
         {do_sb, do_ss, do_sh}, {dq_sb, dq_ss, dq_sh},
         {dk_sb, dk_ss, dk_sh}, {dv_sb, dv_ss, dv_sh},
         causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return static_cast<int>(run<64>(which, dtype, a, B, st));
  if (D == 128) return static_cast<int>(run<128>(which, dtype, a, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
