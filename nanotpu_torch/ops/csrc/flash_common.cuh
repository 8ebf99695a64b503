// What the attention kernels (flash_fwd.cu, flash_bwd.cu and, for its
// helpers, decode_attn.cu) share: the NEG_INF sentinel, bf16 packing, the
// card's SM count, and the skeleton of the two
// Q-stationary bf16 kernels, the forward and the two-pass dq. Each .cu
// builds into its own library, so the anonymous namespace gives every
// library its own copy.
//
// The Q-stationary skeleton. A work item is 64 kWgs query rows of one
// (batch, head); consumer warpgroup wg owns rows 64 wg .. 64 wg + 63. The
// grid is persistent, one block an SM, and a block walks its items
// (QWork), heaviest causal rows first. The first thread of the last
// warpgroup is the producer, and the rest of that warpgroup only gives its
// registers away. For each item the producer loads the resident row tiles
// (q, and dO for dq) into one of two buffers, so that the next item's rows
// arrive while this one is computed, and streams (K, V) tiles of N keys of
// the item's kv head by TMA into a ring of stages with full/empty
// mbarriers that runs on from item to item; rows past S arrive as zeros.
// Each consumer ends an item by writing its 64 x D accumulator as bf16
// through its own rows of the item's buffer and one TMA store, which drops
// the rows past S, and then hands the buffer back.
#pragma once

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// named barriers: 1 + wg for a warpgroup's epilogue, kTurnBar + wg for
// the ping-pong of the warpgroups' products
constexpr int kTurnBar = 8;

// Byte offsets of the shared tiles, each 1024-byte aligned: two buffers of
// kResident row tensors ([buffer][tensor][warpgroup][64-column panel][64
// rows][128 bytes]), the ring of (K, V) stages ([K | V][panel][N rows][128
// bytes]), then the mbarriers: full and empty per stage, then full and
// empty per row buffer.
template <int D, int N, int kStages, int kResident, int kWgs,
          int kRowBufs = 2>
struct QLayout {
  static constexpr int NS = kStages;
  static constexpr int row_bufs = kRowBufs;
  static constexpr int wgs = kWgs;
  static constexpr int rows = 64 * kWgs;             // query rows a block
  static constexpr int threads = 128 * (kWgs + 1);   // + the producer's
  static constexpr int kPanels = D / 64;
  static constexpr int row_panel = 64 * 128;
  static constexpr int rows_tile = kPanels * row_panel;  // one warpgroup's
  static constexpr int kv_panel = N * 128;
  static constexpr int kv_tile = kPanels * kv_panel;
  static constexpr int rows_buf = kResident * kWgs * rows_tile;
  static constexpr int off_stage = kRowBufs * rows_buf;
  static constexpr int off_bar = off_stage + kStages * 2 * kv_tile;
  static constexpr int bytes = off_bar + (2 * kStages + 4) * 8;
  static constexpr size_t alloc = bytes + 1024;  // room to align the base
  static constexpr int resident = kResident;
  static constexpr int keys = N;
};

// A block's k-th work item: where its rows lie, and how many key tiles of
// N it visits. Items are numbered heaviest first (the last query block of
// every (batch, head), then the one before, ...), and dealt to the blocks
// in rounds, each round in the opposite direction to the last, so that a
// block that drew a heavy item draws a light one next.
struct QWork {
  int b, h, kvh, q0, n_tiles;
  __device__ QWork(int k, int B, int H, int KV, int S, int causal, int N,
                   int rows) {
    const int G = gridDim.x, c = blockIdx.x;
    const int w = k * G + (k & 1 ? G - 1 - c : c);
    const int n_qb = (S + rows - 1) / rows;
    b = (w % (B * H)) / H;
    h = w % H;
    kvh = h / (H / KV);
    q0 = (n_qb - 1 - w / (B * H)) * rows;
    n_tiles = (S + N - 1) / N;
    if (causal) n_tiles = min(n_tiles, (q0 + rows - 1) / N + 1);
  }
  // whether the block has a k-th item
  static __device__ bool exists(int k, int B, int H, int S, int rows) {
    const int G = gridDim.x, c = blockIdx.x;
    const int w = k * G + (k & 1 ? G - 1 - c : c);
    return w < B * H * ((S + rows - 1) / rows);
  }
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

template <class L>
__device__ __forceinline__ void init_ring(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::NS; ++s) {
      mbar_init(&bars[s], 1);             // the producer's expect_tx
      mbar_init(&bars[L::NS + s], 128 * L::wgs);  // every consumer thread
    }
    for (int r = 0; r < 2; ++r) {
      mbar_init(&bars[2 * L::NS + r], 1);           // the producer's
      mbar_init(&bars[2 * L::NS + 2 + r], L::wgs);  // each warpgroup's store
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer thread: for each of the block's items, its resident rows
// (maps `rows`, 64-row boxes) into buffer k % 2 once the consumers have
// handed it back, then its (K, V) tiles into the ring, the block's g-th
// tile into stage g % NS once every consumer has released it.
template <class L>
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* bars,
                                        int B, int H, int KV, int S,
                                        int causal,
                                        const CUtensorMap* const* rows,
                                        const CUtensorMap* k,
                                        const CUtensorMap* v) {
  uint64_t* full = bars;
  uint64_t* empty = bars + L::NS;
  uint64_t* rows_full = bars + 2 * L::NS;
  uint64_t* rows_empty = rows_full + 2;
  int g = 0;
  for (int it = 0; QWork::exists(it, B, H, S, L::rows); ++it) {
    const QWork w(it, B, H, KV, S, causal, L::keys, L::rows);
    const int buf = it % L::row_bufs;
    mbar_wait(&rows_empty[buf], ((it / L::row_bufs) & 1) ^ 1);
    mbar_arrive_expect_tx(&rows_full[buf], L::rows_buf);
    for (int r = 0; r < L::resident; ++r)
      for (int wg = 0; wg < L::wgs; ++wg)
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_4d(smem + buf * L::rows_buf +
                          (L::wgs * r + wg) * L::rows_tile + p * L::row_panel,
                      rows[r], &rows_full[buf], p * 64, w.h, w.q0 + 64 * wg,
                      w.b);
    for (int j = 0; j < w.n_tiles; ++j, ++g) {
      const int st = g % L::NS;
      unsigned char* sk = smem + L::off_stage + st * 2 * L::kv_tile;
      mbar_wait(&empty[st], ((g / L::NS) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[st], 2 * L::kv_tile);
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load_4d(sk + p * L::kv_panel, k, &full[st], p * 64, w.kvh,
                    j * L::keys, w.b);
        tma_load_4d(sk + L::kv_tile + p * L::kv_panel, v, &full[st], p * 64,
                    w.kvh, j * L::keys, w.b);
      }
    }
  }
}

// The card's SMs; the persistent grid is one block an SM, or fewer where
// there are fewer items.
inline int sm_count() {
  static int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return sms;
}
inline int persistent_blocks(int items) {
  return items < sm_count() ? items : sm_count();
}

// The two products of a tile, issued by one consumer warpgroup.
// Rows x keys (S = Q K^T, and dP = dO V^T in dq): 64 rows of `sq` against
// the N keys of `sk`, both K-major, k16 step kc at byte 32 (kc % 4) of
// panel kc / 4 (the first step overwrites s).
template <class L>
__device__ __forceinline__ void issue_scores(float (&s)[L::keys / 2],
                                             uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int kc = 0; kc < L::kPanels * 4; ++kc)
    wgmma_ss<0, 0, L::keys>(
        s, wgmma_desc(sq + (kc / 4) * L::row_panel + (kc % 4) * 32, 16, 1024),
        wgmma_desc(sk + (kc / 4) * L::kv_panel + (kc % 4) * 32, 16, 1024),
        kc > 0);
}
// Keys into the accumulator (O += P V, and dQ += dS K in dq): bf16 A
// fragments of 64 rows x N keys times the key tile at `sv`, read MN-major,
// k16 step kk at 16 keys (2048 bytes), 64-column panels kv_panel apart.
template <class L, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[L::keys / 16][4],
                                         uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < L::keys / 16; ++kk)
    wgmma_rs<1, D>(o, pa[kk], wgmma_desc(sv + kk * 2048, L::kv_panel, 1024));
}

// A consumer warpgroup's 64 x D f32 accumulator (the m64nNk16 layout of
// hopper.cuh: element i of thread t is row 16 (t / 32) + (t % 32) / 4 +
// 8 ((i / 2) % 2)), each row times f[(i / 2) % 2], as bf16 through `tile`
// (its own swizzled 64-row panels, free once its last product has read
// them) and one TMA store per panel at (h, row0, b); then hands the rows'
// buffer back to the producer on `rows_empty` once the store has read it.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           const float (&f)[2],
                                           unsigned char* tile,
                                           const CUtensorMap* map, int h,
                                           int row0, int b, int S,
                                           uint64_t* rows_empty) {
  const int wt = threadIdx.x % 128, warp = wt / 32, g = (wt % 32) / 4;
  const int tq = wt % 4;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * tq;
    const int cc = c & 63;
    // 128-byte rows, 16-byte chunks XORed by the row: no two lanes of a
    // store share a bank
    *reinterpret_cast<uint32_t*>(tile + (c >> 6) * 8192 + r * 128 +
                                 (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2) =
        pack_bf16(acc[i] * f[(i >> 1) & 1], acc[i + 1] * f[(i >> 1) & 1]);
  }
  fence_proxy_async();
  named_sync(1 + threadIdx.x / 128, 128);
  if (wt == 0) {
    if (row0 < S) {
      for (int p = 0; p < D / 64; ++p)
        tma_store_4d(map, tile + p * 8192, p * 64, h, row0, b);
      bulk_commit();
      bulk_wait_read<0>();  // the tile stays until the store has read it
    }
    mbar_arrive(rows_empty);
  }
}

}  // namespace
