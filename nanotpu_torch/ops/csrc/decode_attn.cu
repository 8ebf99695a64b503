// Decode attention over the serving engine's slot cache, for Hopper
// (sm_90a), bound to Python with ctypes.
//
// Replaces no TPU kernel. nanotpu's decode attend
// (nanotpu/serving/engine.py:_attend_rows) is a jnp einsum that XLA fuses;
// the port's einsum of the same (ops/decode_attention.py:attend_rows_ref)
// cannot merge the batch and kv-head axes of the [B, T, KV, D] cache into
// one batch axis of a strided product, so PyTorch copies every layer's
// whole K and V, all T positions, on every step, and then runs a masked
// f32 softmax over all T. This kernel computes the same function:
//   * q [B, S, H, D], the caches k, v [B, T, KV, D] and the output
//     [B, S, H, D], all contiguous; base [B] int32 (>= 0) read from device
//     memory, so a captured graph stays valid whatever the lengths;
//   * query s of row b, head h, attends positions t < min(base[b] + s + 1,
//     T) of kv head h / (H / KV), at scale 1 / sqrt(D) (given);
//   * the logits stay f32 (the einsum rounds them to the input type
//     first); the probabilities are rounded to the input type for the
//     product with V, as the einsum rounds them.
//
// What bounds it on an H100 SXM: bytes. A position of one kv head costs
// 4 D bytes of K and V (bf16) and 4 D S (H / KV) operations, S (H / KV)
// operations a byte: 4 at a Mistral decode step, far under the ~295 at
// which the tensor cores would bind. The least time is the rows' valid K
// and V bytes at 3.35 TB/s. The design reads those and little else:
//   * split-KV (flash-decoding): a row's positions are cut into spans of
//     `span` (a multiple of 64, from the shapes alone); a work unit is one
//     span of one (row, kv head, group of up to 64 query rows), one block
//     each, on a grid from the shapes alone (span, kv head x group, row), so
//     a captured graph stays valid whatever the lengths. A block whose span
//     starts at or past its row's frontier returns at once: bytes read
//     follow the rows' real lengths, not T;
//   * each cache byte read once a layer: a unit serves every query row
//     (S x H / KV) of its kv head;
//   * loads: 16-byte cp.async of the [position, D] rows (each 2D bytes
//     contiguous, coalesced), swizzled into a 3-stage ring of 64-position
//     (K, V) tiles; the unit's query rows ride in with its first tile;
//     positions past a row's frontier are zero-filled, not read;
//   * products on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out):
//     the query rows are the 16 rows of an A fragment (a Mistral decode
//     step fills 4 of them; the tensor cores have room to spare), K and V
//     come from the ring by ldmatrix (V transposed); up to 16 query rows
//     the four warps split a tile's 64 positions, 16 each;
//   * online softmax in base 2 in f32; each unit ends by combining its
//     warps' (max, sum, accumulator) through the ring, and writes the
//     partial to scratch, or the output itself where the row has only one
//     span;
//   * a second small kernel merges each row's partials by log-sum-exp.
// f32 (the card tests' engines) runs units of 16 query rows on a grid of
// the same form, on the CUDA cores in full f32 (the tensor cores would
// round to TF32).

#include "flash_common.cuh"  // smem_u32, exp2_approx, pack_bf16

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kTile = 64;      // positions a (K, V) tile
constexpr int kStages = 3;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* base;
  void* out;
  float* part_o;   // [B, KV, n_split, M, D] f32, unnormalised
  float* part_ml;  // [B, KV, n_split, M, 2] f32: max (base 2), sum
  int B, S, H, KV, D, T, span, n_split;
  int r;     // H / KV
  int M;     // S * r query rows a kv head; row m is query m / r, head m % r
  int n_mg;  // groups of query rows a kv head
  float scale2;  // scale * log2(e)
};

// 16 bytes from global into shared memory; zeros and no read where !ok
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the last position (exclusive) query row m of a row at `base` attends
__device__ __forceinline__ int frontier(const Args& a, int base, int m) {
  return min(base + m / a.r + 1, a.T);
}

template <typename OutT>
__device__ __forceinline__ void store_out(const Args& a, int b, int g, int m,
                                          int d, float x) {
  const long long i =
      ((static_cast<long long>(b) * a.S + m / a.r) * a.H + g * a.r +
       m % a.r) * a.D + d;
  if constexpr (sizeof(OutT) == 2)
    static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(a.out)[i] = x;
}

// Element d of query row m's result over span `split`: (max mx, sum l,
// accumulator o). A row with one span is done: its output is o / l. A row
// with more leaves a partial for the merge. A span at or past the row's
// frontier holds nothing of it (the merge does not read it).
template <typename OutT>
__device__ __forceinline__ void emit(const Args& a, int b, int base, int g,
                                     int split, int m, int d, float mx,
                                     float l, float o) {
  const int nv = (frontier(a, base, m) + a.span - 1) / a.span;
  if (split >= nv) return;
  if (nv == 1) {
    store_out<OutT>(a, b, g, m, d, o / l);
    return;
  }
  const long long row =
      (static_cast<long long>(b * a.KV + g) * a.n_split + split) * a.M + m;
  a.part_o[row * a.D + d] = o;
  if (d == 0) {
    a.part_ml[2 * row] = mx;
    a.part_ml[2 * row + 1] = l;
  }
}

// ---- bf16: tensor cores on a cp.async ring ---------------------------------

// Shared memory: the ring of stages, each a K and a V tile [64
// positions][2D bytes]; the unit's NW query rows [NW][2D bytes]; every
// row's 16-byte chunks XORed by row % 8 (ldmatrix reads eight rows of one
// chunk without a bank conflict); then the warps' (max, sum) of the unit's
// end. The end stages the warps' accumulators [4][16][D] f32 through the
// ring's first stage: 256 D bytes exactly.
template <int D, int NW> struct Smem {
  static constexpr int row = 2 * D;
  static constexpr int tile = kTile * row;
  static constexpr int stage = 2 * tile;
  static constexpr int q = kStages * stage;
  static constexpr int ml = q + NW * row;
  static constexpr int bytes = ml + 4 * 16 * 2 * 4;
  static_assert(4 * 16 * D * 4 == stage, "staging fills a stage");
};

// The unit's NW query rows (zeros past M) into shared address `sq`.
template <int D, int NW>
__device__ __forceinline__ void load_q(const Args& a, int b, int g, int mg,
                                       uint32_t sq) {
  constexpr int kChunks = D / 8;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  for (int i = threadIdx.x; i < NW * kChunks; i += kThreads) {
    const int p = i / kChunks, ch = i % kChunks;
    const int m = mg * NW + p;
    const bool ok = m < a.M;
    const long long off =
        ok ? ((static_cast<long long>(b) * a.S + m / a.r) * a.H + g * a.r +
              m % a.r) * D + ch * 8
           : 0;
    cp_async_16(sq + p * Smem<D, NW>::row + ((ch ^ (p & 7)) << 4), q + off,
                ok);
  }
}

// The 64 positions from t0 (zeros from t_end) of K and V, from the heads
// at kb and vb, into the stage at shared address `st`.
template <int D, int NW>
__device__ __forceinline__ void load_tile(const Args& a,
                                          const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb, int t0,
                                          int t_end, uint32_t st) {
  using L = Smem<D, NW>;
  constexpr int kChunks = D / 8;
  const int n = min(kTile, t_end - t0);
  static_assert(kTile * kChunks % kThreads == 0, "whole rounds of chunks");
#pragma unroll
  for (int r = 0; r < kTile * kChunks / kThreads; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const int p = i / kChunks, ch = i % kChunks;
    const bool ok = p < n;
    const long long off =
        ok ? static_cast<long long>(t0 + p) * a.KV * D + ch * 8 : 0;
    const uint32_t dst = st + p * L::row + ((ch ^ (p & 7)) << 4);
    cp_async_16(dst, kb + off, ok);
    cp_async_16(dst + L::tile, vb + off, ok);
  }
}

// One unit a block (grid: span, kv head x group, row). NW: positions of a
// tile a warp takes, and query rows a group: 16 (four warps on one m16
// tile of rows, 16 positions each), 32 (two tiles of rows, two warps each)
// or 64 (four tiles of rows, one warp each).
template <int D, int NW>
__global__ void __launch_bounds__(kThreads)
decode_split_bf16(const Args a) {
  constexpr int P = 64 / NW;  // warps on one tile of rows
  using L = Smem<D, NW>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int split = blockIdx.x, g = blockIdx.y / a.n_mg;
  const int mg = blockIdx.y % a.n_mg, b = blockIdx.z;
  const int base = a.base[b];
  const int t0 = split * a.span;
  const int t_end = min(t0 + a.span, min(base + a.S, a.T));
  if (t0 >= t_end) return;  // the span lies past the row's frontier
  const int n_tiles = (t_end - t0 + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int mt = warp / P, pi = warp % P;
  const long long head = (static_cast<long long>(b) * a.T * a.KV + g) * D;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + head;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + head;

  const uint32_t ring = smem_u32(smem);
  load_q<D, NW>(a, b, g, mg, ring + L::q);  // in the first tile's group
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      load_tile<D, NW>(a, kb, vb, t0 + s * kTile, t_end, ring + s * L::stage);
    cp_async_commit();
  }

  const int row0 = mg * NW + mt * 16;  // this warp's first query row
  const bool rows_here = row0 < a.M;
  uint32_t qa[D / 16][4];
  float o[D / 8][4];
  float m_run[2], l_run[2];
  int f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + gq + 8 * h;
    f[h] = m < a.M ? frontier(a, base, m) : 0;
    m_run[h] = -INFINITY;
    l_run[h] = 0.f;
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j landed; stage j - 1 is free
    if (j + kStages - 1 < n_tiles)
      load_tile<D, NW>(a, kb, vb, t0 + (j + kStages - 1) * kTile, t_end,
                       ring + ((j + kStages - 1) % kStages) * L::stage);
    cp_async_commit();
    if (j == 0) {  // the A fragments of the warp's 16 query rows
      const int p = mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ch = 2 * kk + (lane >> 4);
        ldsm_x4(ring + L::q + p * L::row + ((ch ^ (p & 7)) << 4), qa[kk]);
      }
    }
    if (!rows_here) continue;

    const uint32_t sk = ring + (j % kStages) * L::stage;
    const uint32_t sv = sk + L::tile;
    // scores: the warp's 16 rows x its NW positions of the tile
    float s[NW / 8][4];
#pragma unroll
    for (int nt = 0; nt < NW / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const int mi = lane / 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int nt = 0; nt < NW / 8; nt += 2) {
        const int p = pi * NW + (nt + (mi >> 1)) * 8 + (lane & 7);
        const int ch = 2 * kk + (mi & 1);
        uint32_t bk[4];
        ldsm_x4(sk + p * L::row + ((ch ^ (p & 7)) << 4), bk);
        mma_16816(s[nt], qa[kk], bk[0], bk[1]);
        mma_16816(s[nt + 1], qa[kk], bk[2], bk[3]);
      }
    // online softmax in base 2; positions at or past a row's frontier
    // (and rows past M, frontier 0) are masked
    const int pos0 = t0 + j * kTile + pi * NW + 2 * tq;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NW / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = pos0 + nt * 8 + (e & 1);
        s[nt][e] = pos < f[e >> 1] ? s[nt][e] * a.scale2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2], sub[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      sub[h] = m_new == -INFINITY ? 0.f : m_new;
      corr[h] = exp2_approx(m_run[h] - sub[h]);
      m_run[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NW / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2_approx(s[nt][e] - sub[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + sum[h];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= corr[0];
      o[dn][1] *= corr[0];
      o[dn][2] *= corr[1];
      o[dn][3] *= corr[1];
    }
    // O += P V: P from the score registers, V transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < NW / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int p = pi * NW + kk * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        const int ch = dn + (mi >> 1);
        uint32_t bv[4];
        ldsm_x4_t(sv + p * L::row + ((ch ^ (p & 7)) << 4), bv);
        mma_16816(o[dn], pa, bv[0], bv[1]);
        mma_16816(o[dn + 1], pa, bv[2], bv[3]);
      }
    }
  }

  // the unit's end: the warps' states through the ring's first stage,
  // combined (every load has landed; the barrier waits for every read)
  __syncthreads();
  float* st = reinterpret_cast<float*>(smem);
  float* sml = reinterpret_cast<float*>(smem + L::ml);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    float* srow = st + (warp * 16 + gq + 8 * h) * D + 2 * tq;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(srow + dn * 8) =
          make_float2(o[dn][2 * h], o[dn][2 * h + 1]);
    if (tq == 0) {
      sml[(warp * 16 + gq + 8 * h) * 2] = m_run[h];
      sml[(warp * 16 + gq + 8 * h) * 2 + 1] = l_run[h];
    }
  }
  __syncthreads();
  for (int i = tid; i < NW * D; i += kThreads) {
    const int rl = i / D, d = i % D;
    const int m = mg * NW + rl;
    if (m >= a.M) break;
    const int w0 = (rl / 16) * P, rr = rl % 16;
    float mmax = -INFINITY;
#pragma unroll
    for (int k = 0; k < P; ++k)
      mmax = fmaxf(mmax, sml[((w0 + k) * 16 + rr) * 2]);
    const float sub = mmax == -INFINITY ? 0.f : mmax;
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float c = exp2_approx(sml[((w0 + k) * 16 + rr) * 2] - sub);
      l += c * sml[((w0 + k) * 16 + rr) * 2 + 1];
      acc += c * st[((w0 + k) * 16 + rr) * D + d];
    }
    emit<__nv_bfloat16>(a, b, base, g, split, m, d, mmax, l, acc);
  }
}

// ---- f32: the CUDA cores ----------------------------------------------------

// One block a unit (grid: span, kv head x group of 16 query rows, row);
// units past a row's frontier return at once. Warp w owns query rows w,
// w + 4, w + 8, w + 12 of the group; lane j takes position j of each
// 32-position tile for the scores and dimensions j, j + 32, ... for the
// accumulator.
template <int D>
__global__ void __launch_bounds__(kThreads) decode_split_f32(const Args a) {
  constexpr int R = 16, N = 32;
  __shared__ float sq[R][D];
  __shared__ float sk[N][D + 1];  // padded: lanes read one column
  __shared__ float sv[N][D];
  __shared__ float sp[R][N];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, g = blockIdx.y / a.n_mg;
  const int mg = blockIdx.y % a.n_mg, b = blockIdx.z;
  const int base = a.base[b];
  const int t0 = split * a.span;
  const int t_end = min(t0 + a.span, min(base + a.S, a.T));
  if (t0 >= t_end) return;
  const float* Q = static_cast<const float*>(a.q);
  const long long head = (static_cast<long long>(b) * a.T * a.KV + g) * D;
  const float* K = static_cast<const float*>(a.k) + head;
  const float* V = static_cast<const float*>(a.v) + head;
  for (int i = tid; i < R * D; i += kThreads) {
    const int rr = i / D, d = i % D, m = mg * R + rr;
    sq[rr][d] = m < a.M ? Q[((static_cast<long long>(b) * a.S + m / a.r) *
                                 a.H + g * a.r + m % a.r) * D + d]
                        : 0.f;
  }
  float m_run[4], l_run[4], acc[4][D / 32];
  int f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = mg * R + warp + 4 * k;
    f[k] = m < a.M ? frontier(a, base, m) : 0;
    m_run[k] = -INFINITY;
    l_run[k] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[k][i] = 0.f;
  }
  for (int tt = t0; tt < t_end; tt += N) {
    __syncthreads();  // the last tile's reads are done
    for (int i = tid; i < N * D; i += kThreads) {
      const int p = i / D, d = i % D;
      const bool ok = tt + p < t_end;
      const long long off = static_cast<long long>(tt + p) * a.KV * D + d;
      sk[p][d] = ok ? K[off] : 0.f;
      sv[p][d] = ok ? V[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int rr = warp + 4 * k;
      float x = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) x = fmaf(sq[rr][d], sk[lane][d], x);
      x = tt + lane < f[k] ? x * a.scale2 : -INFINITY;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[k], mx);
      const float sub = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2_approx(m_run[k] - sub);
      const float p = exp2_approx(x - sub);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      m_run[k] = m_new;
      l_run[k] = l_run[k] * corr + sum;
      sp[rr][lane] = p;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        float y = acc[k][i] * corr;
#pragma unroll 8
        for (int c = 0; c < N; ++c) y = fmaf(sp[rr][c], sv[c][lane + 32 * i], y);
        acc[k][i] = y;
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = mg * R + warp + 4 * k;
    if (m >= a.M) continue;
#pragma unroll
    for (int i = 0; i < D / 32; ++i)
      emit<float>(a, b, base, g, split, m, lane + 32 * i, m_run[k], l_run[k],
                  acc[k][i]);
  }
}

// ---- the merge -------------------------------------------------------------

// One block a query row (b, g, m), a thread a dimension: the row's partials
// over its spans, by log-sum-exp. Rows of one span were written whole. The
// partials' (max, sum) are loaded in parallel, each warp reduces them, and
// a thread's accumulator loads are independent, several in flight.
template <typename OutT>
__global__ void decode_merge(const Args a) {
  extern __shared__ float sml[];  // [n_split][2]
  const int row = blockIdx.x;
  const int m = row % a.M, g = (row / a.M) % a.KV, b = row / (a.M * a.KV);
  const int nv = (frontier(a, a.base[b], m) + a.span - 1) / a.span;
  if (nv == 1) return;
  const long long r0 =
      static_cast<long long>(b * a.KV + g) * a.n_split * a.M + m;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const long long ri = r0 + static_cast<long long>(i) * a.M;
    sml[2 * i] = a.part_ml[2 * ri];
    sml[2 * i + 1] = a.part_ml[2 * ri + 1];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  float mx = -INFINITY;
  for (int i = lane; i < nv; i += 32) mx = fmaxf(mx, sml[2 * i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float l = 0.f;
  for (int i = lane; i < nv; i += 32)
    l += exp2_approx(sml[2 * i] - mx) * sml[2 * i + 1];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  const float* po = a.part_o + r0 * a.D + threadIdx.x;
  const long long step = static_cast<long long>(a.M) * a.D;
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < nv; ++i)
    acc += exp2_approx(sml[2 * i] - mx) * po[i * step];
  store_out<OutT>(a, b, g, m, threadIdx.x, acc / l);
}

template <int D, int NW>
cudaError_t launch_bf16(Args& a, cudaStream_t st) {
  a.n_mg = (a.M + NW - 1) / NW;
  constexpr int smem = Smem<D, NW>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_split_bf16<D, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  decode_split_bf16<D, NW>
      <<<dim3(a.n_split, a.KV * a.n_mg, a.B), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(Args& a, int dtype, cudaStream_t st) {
  cudaError_t err;
  if (dtype == 1) {
    err = a.M <= 16   ? launch_bf16<D, 16>(a, st)
          : a.M <= 32 ? launch_bf16<D, 32>(a, st)
                      : launch_bf16<D, 64>(a, st);
  } else {
    a.n_mg = (a.M + 15) / 16;
    decode_split_f32<D><<<dim3(a.n_split, a.KV * a.n_mg, a.B), kThreads, 0,
                          st>>>(a);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const int rows = a.B * a.KV * a.M;
  const size_t smem = 2 * sizeof(float) * a.n_split;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  if (dtype == 1) decode_merge<__nv_bfloat16><<<rows, D, smem, st>>>(a);
  else decode_merge<float><<<rows, D, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the caches and out alike). Every
// tensor is contiguous; base is [B] int32 on the device, each >= 0. span
// is a multiple of 64; part_o and part_ml hold B * KV * ceil(T / span) *
// S * (H / KV) rows of D and of 2 floats. Returns the CUDA error code of
// the launches (0 on success). Launches on `stream` and allocates nothing.
extern "C" int nanotpu_decode_attn(const void* q, const void* k,
                                   const void* v, const int* base, void* out,
                                   float* part_o, float* part_ml, int dtype,
                                   int B, int S, int H, int KV, int D, int T,
                                   int span, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || T <= 0 || H % KV != 0 ||
      span <= 0 || span % kTile != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, base, out, part_o, part_ml, B, S, H, KV, D, T, span,
         (T + span - 1) / span, H / KV, S * (H / KV), 0, scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return static_cast<int>(launch<64>(a, dtype, st));
  if (D == 128) return static_cast<int>(launch<128>(a, dtype, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
