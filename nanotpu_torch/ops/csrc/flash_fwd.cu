// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces nanotpu/ops/attention.py:_flash_kernel (launched there by
// _flash_forward through pl.pallas_call). Same semantics:
//   * causal or full attention with an online softmax over key tiles:
//     running max m, running denominator l, f32 accumulator;
//   * causal mode stops at the diagonal tile;
//   * GQA by indexing: q head h reads kv head h / (H / KV), never a copy;
//   * a ragged S is masked by bounds here (the inputs are not padded);
//   * fully masked rows output 0, and their lse is NEG_INF (-1e30);
//   * optional lse = m + log(l), written [B, H, S] f32.
// Inputs are read in nanotpu's [B, S, H, D] layout through the strides the
// wrapper passes (the head-dim stride must be 1), so no transpose copy
// exists. bf16 or f32 in, f32 accumulation, output in the input type.
//
// What bounds it on an H100 SXM: at the training flagship's shape (B=8,
// S=2048, H=16, KV=4, D=64, causal) the two products over the causal half
// are ~6.9e10 FLOP, ~0.07 ms at the 989 TFLOP/s bf16 tensor-core peak;
// q, k, v and o are ~42 MB, ~0.013 ms at 3.35 TB/s. So the kernel is
// bound by the tensor cores' rate, reached only through wgmma, and at
// D = 64 nearly as much by the exponentials: a 128-key tile costs the
// special-function units about as many cycles as its two products cost the
// tensor cores.
//
// bf16 (serving and training), built for that on the persistent
// Q-stationary skeleton of flash_common.cuh: a work item is 64 query rows
// a consumer warpgroup of one (batch, head); a producer thread loads the
// item's q and streams (K, V) tiles of 128 keys by TMA into a 3-stage ring.
// Per tile a warpgroup runs
//   * S = Q K^T: wgmma with both operands K-major in shared memory;
//   * the online softmax in base 2 (ex2.approx.ftz, scale log2(e) folded
//     into one FMA), masks only in the steps of an item's last key tiles,
//     which alone can cross the diagonal or hold keys past S;
//   * O += P V: P rounded to bf16, as the TPU kernel does, straight from
//     the score accumulator into the A fragment (register for register),
//     V read MN-major (transposed) from the same stage; O is rescaled
//     only after the previous product has retired.
// Tile j's scores are issued together with tile j-1's P V (ptxas waits for
// both before the softmax, whatever the source order), and the warpgroups
// take the tensor cores in turn (ping-pong on named barriers), so one's
// softmax runs under the others' products. At D = 64 an item has
// three warpgroups (192 rows) when there are items enough for two rounds
// of the grid, else two; at D = 128 always two (registers). The output
// goes out through the warpgroup's own q rows and a TMA store; lse by
// plain stores.
//
// f32 keeps FMA tiles on the CUDA cores (16 scores and 4*D/16 output
// elements per thread), a block of 64 query rows, one 64-key tile at a
// time, so f32 stays f32 end to end (TF32 would not meet f32's 1e-4
// tolerance).

#include <type_traits>

#include "flash_common.cuh"

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // nullptr when the caller needs no lse
  int S, H, KV;
  long long q_stride[3], k_stride[3], v_stride[3], o_stride[3];  // b, s, h
  int causal;
  float scale;
};

// ---- bf16: wgmma on TMA-fed tiles ---------------------------------------

constexpr int kFwdKeys = 128;  // keys a tile
// 3 stages; q double-buffered at D = 64, single at D = 128 (shared memory)
template <int D, int kWgs>
using FwdLayout = QLayout<D, kFwdKeys, 3, 1, kWgs, D == 64 ? 2 : 1>;

struct FwdTma {
  Args a;
  int B;
  // q, o [B, S, H, D] (64-row boxes), k, v [B, S, KV, D] (128-row boxes),
  // all 64 columns a box
  CUtensorMap q, k, v, o;
};

// One tile's online softmax in place, in base 2: the scores s (64 rows x N
// keys, element i of row 16 warp + g + 8 (i / 2 % 2) and key k0 + 8 (i / 4)
// + 2 tq + i % 2) become p = exp2(s scale log2(e) - m); the rows' running
// max m and this thread's share of their denominators l move on, and corr
// is the factor the accumulator takes before this tile's P V is added.
// kMask: the tile may hold keys past S or past a row's causal diagonal.
template <int N, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int row0, const Args& a,
                                             float scale2) {
  const int wt = threadIdx.x % 128, warp = wt / 32, g = (wt % 32) / 4;
  const int tq = wt % 4;
  if constexpr (kMask) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
      const int row = row0 + 16 * warp + g + 8 * ((i >> 1) & 1);
      if (key >= a.S || (a.causal && key > row)) s[i] = -INFINITY;
    }
  }
  // Row r's elements are 4 q + 2 r + {0, 1}; its max and sum run in four
  // independent chains (q % 4), so that a warp is not held by one long
  // dependent chain of 32.
  float mx[2][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    mx[0][q] = fmaxf(s[4 * q], s[4 * q + 1]);
    mx[1][q] = fmaxf(s[4 * q + 2], s[4 * q + 3]);
  }
#pragma unroll
  for (int q = 4; q < N / 8; ++q)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r][q & 3] = fmaxf(mx[r][q & 3],
                           fmaxf(s[4 * q + 2 * r], s[4 * q + 2 * r + 1]));
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
    float row_max = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    const float m_new = fmaxf(m[r], row_max * scale2);
    // a row with no valid key yet keeps m = -inf and takes p against 0
    base[r] = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = exp2_approx(m[r] - base[r]);
    m[r] = m_new;
  }
  float sum[2][4];
#pragma unroll
  for (int q = 0; q < N / 8; ++q)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 4 * q + 2 * r;
      s[i] = exp2_approx(fmaf(s[i], scale2, -base[r]));
      s[i + 1] = exp2_approx(fmaf(s[i + 1], scale2, -base[r]));
      const float pair = s[i] + s[i + 1];
      sum[r][q & 3] = q < 4 ? pair : sum[r][q & 3] + pair;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * corr[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

template <int D, int kWgs>
__global__ void __launch_bounds__(128 * (kWgs + 1), 1)
    flash_fwd_bf16(const __grid_constant__ FwdTma t) {
  using L = FwdLayout<D, kWgs>;
  constexpr int N = kFwdKeys;
  const Args& a = t.a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::off_bar);
  uint64_t* full = bars;
  uint64_t* empty = bars + L::NS;
  uint64_t* rows_full = bars + 2 * L::NS;
  uint64_t* rows_empty = rows_full + 2;
  init_ring<L>(bars);

  // registers: 65536 >= 2 x 128 x 240 + 128 x 24 = 3 x 128 x 160 + 128 x 24
  if (threadIdx.x >= 128 * kWgs) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * kWgs) {
      const CUtensorMap* rows[1] = {&t.q};
      produce<L>(smem, bars, t.B, a.H, a.KV, a.S, a.causal, rows, &t.k, &t.v);
    }
    return;
  }
  setmaxnreg_inc<kWgs == 2 ? 240 : 160>();

  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128;
  const int warp = wt / 32, g = (wt % 32) / 4, tq = wt % 4;
  const uint32_t stages = smem_u32(smem + L::off_stage);
  const float scale2 = a.scale * kLog2e;

  // Ping-pong: each warpgroup issues its products between a wait on its own
  // named barrier (kTurnBar + wg) and an arrive on the next one's, so the
  // warpgroups take the tensor cores in turn and one's softmax runs under
  // the others' products. The last lets warpgroup 0 go first.
  auto my_turn = [&] { named_sync(kTurnBar + wg, 256); };
  auto your_turn = [&] { named_arrive(kTurnBar + (wg + 1) % kWgs, 256); };
  if (wg == kWgs - 1) named_arrive(kTurnBar, 256);

  int done = 0;  // key tiles of the block's earlier items: the ring's count
  for (int it = 0; QWork::exists(it, t.B, a.H, a.S, L::rows); ++it) {
    const QWork w(it, t.B, a.H, a.KV, a.S, a.causal, N, L::rows);
    const int buf = it % L::row_bufs;
    const int row0 = w.q0 + 64 * wg;  // this warpgroup's first row
    unsigned char* q_rows = smem + buf * L::rows_buf + wg * L::rows_tile;
    const uint32_t sq = smem_u32(q_rows);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // per row (i / 2 % 2 of an accumulator element): the running max in
    // base-2 units, this thread's share of the denominator, the rescale
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
    float s[N / 2];
    uint32_t pa[N / 16][4];

    // Tile j's scores are issued with tile j-1's P V, which takes tile
    // j-1's rescale first; stage j-1 goes back to the producer once its V
    // has been read. The first step has no P V, the last no scores. Only
    // the item's last kEdge key tiles can cross the causal diagonal or hold
    // keys past S, so only their steps mask: no test in the steady loop.
    auto step = [&](int j, auto with_scores, auto with_pv, auto with_mask) {
      constexpr bool kScores = decltype(with_scores)::value;
      constexpr bool kPv = decltype(with_pv)::value;
      const int gj = done + j;  // the tile's place in the ring
      if constexpr (kScores) mbar_wait(&full[gj % L::NS], (gj / L::NS) & 1);
      my_turn();
      if constexpr (kScores) {
        wgmma_fence();
        issue_scores<L>(s, sq, stages + (gj % L::NS) * 2 * L::kv_tile);
        wgmma_commit();
      }
      if constexpr (kPv) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        wgmma_fence();
        issue_pv<L, D>(o, pa, stages + ((gj - 1) % L::NS) * 2 * L::kv_tile +
                                  L::kv_tile);
        wgmma_commit();
      }
      your_turn();
      if constexpr (kScores) {
        wgmma_wait<kPv ? 1 : 0>();
        fence_regs(s);
        softmax_tile<N, decltype(with_mask)::value>(s, m, l, corr, j * N,
                                                   row0, a, scale2);
      }
      if constexpr (kPv) {
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) fence_regs(pa[kk]);
        mbar_arrive(&empty[(gj - 1) % L::NS]);  // done with tile j-1
      }
      if constexpr (kScores) {
        // P as bf16 A fragments: k16 step kk is accumulator columns 16 kk ..
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
          for (int mm = 0; mm < 4; ++mm)
            pa[kk][mm] = pack_bf16(s[8 * kk + 2 * mm], s[8 * kk + 2 * mm + 1]);
      }
    };
    using T = std::true_type;
    using F = std::false_type;
    constexpr int kEdge = (L::rows + N - 1) / N;
    const int n = w.n_tiles, first_masked = max(n - kEdge, 0);
    mbar_wait(&rows_full[buf], (it / L::row_bufs) & 1);
    if (first_masked == 0) step(0, T{}, F{}, T{});
    else step(0, T{}, F{}, F{});
    for (int j = 1; j < first_masked; ++j) step(j, T{}, T{}, F{});
    for (int j = max(first_masked, 1); j < n; ++j) step(j, T{}, T{}, T{});
    step(n, F{}, T{}, F{});
    done += n;

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    store_rows<D>(o, inv, q_rows, &t.o, w.h, row0, w.b, a.S, &rows_empty[buf]);
    if (a.lse != nullptr && tq == 0) {
      float* lse = a.lse + static_cast<long long>(w.b * a.H + w.h) * a.S;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * warp + g + 8 * r;
        if (row < a.S)  // natural log: m ln(2) + log(l)
          lse[row] = l[r] > 0.f ? m[r] * 0.6931471805599453f + logf(l[r])
                                : kNegInf;
      }
    }
  }
  // the last warpgroup's last arrive
  if (wg == 0) named_sync(kTurnBar, 256);
}

template <int D, int kWgs>
cudaError_t launch_bf16(const Args& a, int B, cudaStream_t stream) {
  using L = FwdLayout<D, kWgs>;
  FwdTma t;
  t.a = a;
  t.B = B;
  const bool ok =
      encode_rows_map(&t.q, a.q, true, B, a.S, a.H, D, a.q_stride[0],
                      a.q_stride[1], a.q_stride[2], 64, 64) &&
      encode_rows_map(&t.k, a.k, true, B, a.S, a.KV, D, a.k_stride[0],
                      a.k_stride[1], a.k_stride[2], 64, kFwdKeys) &&
      encode_rows_map(&t.v, a.v, true, B, a.S, a.KV, D, a.v_stride[0],
                      a.v_stride[1], a.v_stride[2], 64, kFwdKeys) &&
      encode_rows_map(&t.o, a.o, true, B, a.S, a.H, D, a.o_stride[0],
                      a.o_stride[1], a.o_stride[2], 64, 64);
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_bf16<D, kWgs>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::alloc));
  if (err != cudaSuccess) return err;
  const int items = B * a.H * ((a.S + L::rows - 1) / L::rows);
  kernel<<<persistent_blocks(items), L::threads, L::alloc, stream>>>(t);
  return cudaGetLastError();
}

// ---- f32: CUDA-core FMA tiles --------------------------------------------

constexpr int kBlockM = 64;  // query rows per block (f32)
constexpr int kBlockN = 64;  // keys per tile

// Where a block's (batch, head, first query row) lie, and how many key tiles
// it visits. The heaviest causal tiles go first: they start while the light
// ones fill in behind them.
struct Tile {
  int bh, b, h, kvh, q0, n_tiles;
  __device__ Tile(const Args& a) {
    bh = blockIdx.x;
    b = bh / a.H;
    h = bh % a.H;
    kvh = h / (a.H / a.KV);
    q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
    n_tiles = (a.S + kBlockN - 1) / kBlockN;
    if (a.causal) n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kBlockN + 1);
  }
};

// One online-softmax update of a row's running max m and the rescale its
// old sum and accumulator take: NEG_INF marks masked scores, and a fully
// masked row keeps m = NEG_INF (exp(NEG_INF - NEG_INF) would be 1).
struct Rescale {
  float m_safe, corr;
  __device__ Rescale(float& m, float tile_max) {
    const float m_new = fmaxf(m, tile_max);
    m_safe = m_new == kNegInf ? 0.f : m_new;
    corr = m == kNegInf ? 0.f : __expf(m - m_safe);
    m = m_new;
  }
  __device__ float p(float s) const {
    return s == kNegInf ? 0.f : __expf(s - m_safe);
  }
};

__device__ __forceinline__ float lse_of(float m, float l) {
  return l > 0.f ? m + logf(fmaxf(l, 1e-30f)) : kNegInf;
}

constexpr int kFmaThreads = 256;  // 16 row groups of 16 lanes (half a warp)
constexpr int kRows = kBlockM / 16;  // query rows per thread
constexpr int kCols = kBlockN / 16;  // keys per thread per tile

// Shared-memory row pitches (in floats), padded so that the 16 lanes of a
// row group hit distinct banks.
template <int D> struct FmaSmem {
  static constexpr int q = D + 4;
  static constexpr int k = D + 1;
  static constexpr int v = D;
  static constexpr int p = kBlockN + 1;
  static constexpr size_t bytes =
      sizeof(float) * (kBlockM * q + kBlockN * k + kBlockN * v + kBlockM * p);
};

template <int D>
__global__ void __launch_bounds__(kFmaThreads) flash_fwd_f32(const Args a) {
  using P = FmaSmem<D>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockM * P::q;
  float* sV = sK + kBlockN * P::k;
  float* sP = sV + kBlockN * P::v;

  const Tile tile(a);
  const int q0 = tile.q0;
  const int tid = threadIdx.x;
  const int row0 = (tid >> 4) * kRows;  // this thread's first tile row
  const int lane = tid & 15;

  const float* Q = static_cast<const float*>(a.q) + tile.b * a.q_stride[0] +
                   tile.h * a.q_stride[2];
  const float* K = static_cast<const float*>(a.k) + tile.b * a.k_stride[0] +
                   tile.kvh * a.k_stride[2];
  const float* V = static_cast<const float*>(a.v) + tile.b * a.v_stride[0] +
                   tile.kvh * a.v_stride[2];

  for (int i = tid; i < kBlockM * D; i += kFmaThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    sQ[r * P::q + d] = s < a.S ? Q[s * a.q_stride[1] + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][D / 16];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[r][j] = 0.f;
  }

  for (int kt = 0; kt < tile.n_tiles; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int i = tid; i < kBlockN * D; i += kFmaThreads) {
      const int r = i / D, d = i % D, s = k0 + r;
      sK[r * P::k + d] = s < a.S ? K[s * a.k_stride[1] + d] : 0.f;
      sV[r * P::v + d] = s < a.S ? V[s * a.v_stride[1] + d] : 0.f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) sc[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = sQ[(row0 + r) * P::q + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = sK[(lane + 16 * c) * P::k + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + row0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kpos = k0 + lane + 16 * c;
        const bool valid = kpos < a.S && (!a.causal || kpos <= qpos);
        sc[r][c] = valid ? sc[r][c] * a.scale : kNegInf;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const Rescale rs(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = rs.p(sc[r][c]);
        sP[(row0 + r) * P::p + lane + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * rs.corr + sum;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[r][j] *= rs.corr;
    }
    __syncwarp();  // a row group's sP rows are written and read in one warp

#pragma unroll 4
    for (int c = 0; c < kBlockN; ++c) {
      float vv[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) vv[j] = sV[c * P::v + lane + 16 * j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = sP[(row0 + r) * P::p + c];
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
  }

  float* O = static_cast<float*>(a.o) + tile.b * a.o_stride[0] +
             tile.h * a.o_stride[2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= a.S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      O[qpos * a.o_stride[1] + lane + 16 * j] = acc[r][j] / denom;
    if (a.lse != nullptr && lane == 0)
      a.lse[static_cast<long long>(tile.bh) * a.S + qpos] = lse_of(m[r], l[r]);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const Args& a,
                   int BH, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (a.S + kBlockM - 1) / kBlockM);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, ordered
// (batch, sequence, head); the head-dim stride is 1, and for bfloat16 every
// stride is a multiple of 8 and every pointer 16-byte aligned (the wrapper
// checks). Returns the CUDA error code of the launch (0 on success).
// Launches on `stream` and allocates nothing.
extern "C" int nanotpu_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int B, int S, int H, int KV, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, lse, S, H, KV,
         {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
         {v_sb, v_ss, v_sh}, {o_sb, o_ss, o_sh},
         causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (dtype == 1 && D == 64) {
    // 192-row items (three consumer warpgroups) where they fill at least
    // two rounds of the persistent grid, else 128-row items
    const int items3 = B * H * ((S + 191) / 192);
    return items3 >= 2 * sm_count() ? launch_bf16<64, 3>(a, B, st)
                                    : launch_bf16<64, 2>(a, B, st);
  }
  if (dtype == 1 && D == 128) return launch_bf16<128, 2>(a, B, st);
  if (dtype == 0 && D == 64)
    return launch(flash_fwd_f32<64>, kFmaThreads, FmaSmem<64>::bytes, a, BH, st);
  if (dtype == 0 && D == 128)
    return launch(flash_fwd_f32<128>, kFmaThreads, FmaSmem<128>::bytes, a, BH, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
