// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes:
// three kernels in one library.
//
// Replaces, in nanotpu/ops/attention.py (launched by _flash_backward through
// pl.pallas_call):
//   * bwd_kv_*<.., true>   the fused single pass, _flash_bwd_fused_kernel
//                          (:384-446): dq, dk and dv, 5 products per pair;
//   * bwd_dq_*             the two-pass dq half, _flash_bwd_dq_kernel
//                          (:300-336);
//   * bwd_kv_*<.., false>  the two-pass dk/dv half, _flash_bwd_dkv_kernel
//                          (:339-381).
// All rebuild p = exp(q.k scale - lse) from the forward's lse, the
// counterpart of _bwd_pair/_rebuild_p (:271-297): ds = p (dO.v - D), with
// D = rowsum(dO * O) - g_lse computed by the wrapper as a torch reduction,
// as the JAX code computes it outside its kernels; dq = scale * ds k,
// dk = scale * ds^T q, dv = p^T dO; p and ds are rounded to bf16 for their
// products in bf16, as the TPU kernels do. The f32 kernels go through one
// routine per pair, bwd_pair; the bf16 kernels apply the same arithmetic to
// whole accumulator tiles (in base 2: exp2(s scale log2(e) - lse
// log2(e))).
//
// Layouts are nanotpu's: q, dO, dq [B, S, H, D]; k, v, dk, dv [B, S, KV, D];
// lse and D [B, H, S] f32. q, k, v are read through strides (the head-dim
// stride must be 1); nothing is padded: a ragged S is masked by bounds, and
// a row whose lse is NEG_INF gives zero gradients. GQA by indexing: q head h
// reads kv head h / (H / KV).
//
// What bounds it on an H100 SXM: at the training flagship's shape (B=8,
// S=2048, H=16, KV=4, D=64, causal) one product over the causal half is
// ~3.44e10 FLOP; the fused pass does 5 (~1.7e11, ~0.17 ms at the 989
// TFLOP/s bf16 peak), dk/dv 4 (~0.14 ms), dq 3. Inputs and outputs are
// ~40 MB (~0.012 ms at 3.35 TB/s), so all three are compute-bound: the
// tensor cores' rate, reached only through wgmma, is what bounds them.
//
// bwd_kv_bf16 (dk/dv, and dq in the fused pass), built for that:
//   * Work unit. A block owns one 128-key tile of one (batch, kv head) and
//     loops over the H / KV query heads of that kv head and, for each, over
//     the 64-row query tiles from the causal diagonal on; launched key tile
//     0 first, the heaviest under causal. Two key warpgroups hold 64 keys
//     each, so every (Q, dO) stage feeds 128 keys; dk and dv stay in their
//     registers and are written once at kv-head granularity: no group sum,
//     no race, the same bits on every run.
//   * Loads. One producer warp issues TMA loads of the Q and dO tiles (4-D
//     tensor maps over the strided [B, S, heads, D] tensors, 128-byte
//     swizzle) into a ring of 3 stages (2 in the fused pass at D = 128, for
//     shared memory) with full/empty mbarriers; K and V arrive once. Rows
//     past S come back as zeros. lse and D go through plain loads of the
//     same warp (a ragged S leaves their rows without the 16-byte alignment
//     a bulk copy needs), with lse turned into base 2 and into +inf where p
//     must be 0. setmaxnreg moves the producer's registers to the others.
//   * Products. S^T = K Q^T and dP^T = V dO^T: wgmma with both operands
//     K-major in shared memory. dV += P^T dO and dK += dS^T Q: P^T and dS^T
//     straight from the accumulators as bf16 register fragments, dO and Q
//     read MN-major (transposed) from the same stage. Every descriptor and
//     tensor map describes the same 128-byte swizzle.
//   * dq by tile. The key warpgroups write dS^T to shared memory (a fence
//     to the async proxy, then an mbarrier); a third warpgroup computes
//     dQ = dS K over all 128 keys with wgmma, stages it in a swizzled f32
//     tile and adds it to the zeroed f32 accumulator (the wrapper casts it)
//     with one bulk tensor reduce per 32-column box: no scalar atomics. The
//     order of those sums varies from run to run. dS^T buffers and dq
//     tiles used in turn (four at D = 64, two at D = 128, for shared
//     memory), with their own mbarriers, let the key warpgroups run on
//     while the dq of earlier tiles is computed and reduced.
//   * Masks only where needed: the causal test on tiles that cross the
//     diagonal, the keys' bound on the ragged last key tile, and NEG_INF
//     rows through their lse once a column. exp2 on the special-function
//     unit (ex2.approx.ftz).
//
// bwd_dq_bf16 (dq of the two-pass backward) is the forward's shape, the
// persistent Q-stationary skeleton of flash_common.cuh: a work item is 128
// query rows of one (batch, head) in two consumer warpgroups; a producer
// thread loads the item's q and dO and streams (K, V) tiles (128 keys at
// D = 64, 64 at D = 128) by TMA into a 3-stage ring. Per tile a warpgroup
// runs S = Q K^T and dP = dO V^T (wgmma, both operands K-major in shared
// memory), p = exp2(s scale log2(e) - lse log2(e)) masked only on diagonal
// and ragged tiles, dS = p (dP - D) rounded to bf16 straight into the A
// fragment of dQ += dS K (K read MN-major from the same stage); the two
// warpgroups issue S and dP in turn (ping-pong). lse and D load once a row
// by plain loads. dq stays in registers and is scaled and written once: no
// atomics, the same bits on every run.
//
// The f32 kernels keep FMA tiles on the CUDA cores, so that f32 stays f32
// end to end: a block of bwd_dq_f32 owns 64 query rows of one (batch, head)
// and loops over the causally relevant key tiles; bwd_kv_f32 owns 64 keys
// and adds dq with atomicAdd.

#include "flash_common.cuh"
#include "hopper.cuh"

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

// ---- bf16 dk/dv, and dq in the fused pass: wgmma on TMA-fed tiles --------

constexpr int kKeyTile = 128;    // keys a block
constexpr int kConsumers = 256;  // two key warpgroups, 64 keys each
// + the dq warpgroup (fused only) + the producer warpgroup
__host__ __device__ constexpr int kv_threads(bool dq) {
  return kConsumers + (dq ? 256 : 128);
}

struct KvTma {
  Args a;
  // bf16 q, dO [B, S, H, D] (64-row boxes), k, v [B, S, KV, D] (128-row
  // boxes), all 64 columns a box; the fused pass's f32 dq accumulator
  // [B, S, H, D] (64 rows x 32 columns a box)
  CUtensorMap q, k, v, dout, dq;
};

// Byte offsets of the shared tiles (each 1024-byte aligned): K and V, the
// ring of (Q, dO) stages, kBufs dS^T buffers and f32 dq tiles (fused
// only), the ring's (lse, D) vectors, and the mbarriers.
template <int D, bool kDq> struct KvLayout {
  static constexpr int kStages = (D == 64 || !kDq) ? 3 : 2;
  // dS^T buffers and dq tiles, used in turn (fused only)
  static constexpr int kBufs = D == 64 ? 4 : 2;
  static constexpr int kPanels = D / 64;
  static constexpr int kv_panel = kKeyTile * 128;
  static constexpr int kv_tile = kPanels * kv_panel;
  static constexpr int q_panel = kTile * 128;
  static constexpr int q_tile = kPanels * q_panel;
  static constexpr int ds_tile = kKeyTile * 128;  // [128 keys][64 queries]
  static constexpr int dq_tile = kTile * D * 4;   // f32, D / 32 panels
  static constexpr int off_k = 0, off_v = kv_tile, off_stage = 2 * kv_tile;
  static constexpr int off_ds = off_stage + kStages * 2 * q_tile;
  static constexpr int off_dq = off_ds + (kDq ? kBufs * ds_tile : 0);
  static constexpr int off_vec = off_dq + (kDq ? kBufs * dq_tile : 0);
  static constexpr int off_bar = off_vec + kStages * 2 * kTile * 4;
  // full and empty per stage, K/V's, and full and empty per dS^T buffer
  static constexpr int bytes = off_bar + (2 * kStages + 1 + 2 * kBufs) * 8;
  static constexpr size_t alloc = bytes + 1024;  // room to align the base
};

// One 128-key tile of one (batch, kv head): dk and dv, and with kDq the
// tile's share of dq. Warpgroups 0 and 1 own keys 0-63 and 64-127 of the
// tile; with kDq warpgroup 2 computes dq; the last warpgroup's first warp
// is the producer, its other three only give their registers away.
template <int D, bool kDq>
__global__ void __launch_bounds__(kv_threads(kDq), 1)
    bwd_kv_bf16(const __grid_constant__ KvTma t) {
  using L = KvLayout<D, kDq>;
  constexpr int NS = L::kStages;
  const Args& a = t.a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::off_bar);
  uint64_t* empty = full + NS;
  uint64_t* kv_bar = empty + NS;
  uint64_t* ds_full = kv_bar + 1;  // [kBufs]: both halves of dS^T written
  uint64_t* ds_empty = ds_full + L::kBufs;  // [kBufs]: its dQ has read it
  float* vecs = reinterpret_cast<float*>(smem + L::off_vec);

  const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
  const int rep = a.H / a.KV;
  const int k0 = blockIdx.y * kKeyTile;  // under causal, tile 0 is the heaviest
  const int nq = (a.S + kTile - 1) / kTile;
  const int q_first = a.causal ? k0 / kTile : 0;
  const int per_head = nq - q_first;
  // iteration it visits query head kvh * rep + it / per_head and the query
  // tile q_first + it % per_head, from stage it % NS
  const int n_iter = rep * per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);           // the producer warp's lanes
      mbar_init(&empty[s], kConsumers);  // every key warpgroup thread
    }
    mbar_init(kv_bar, 1);
    for (int s = 0; s < L::kBufs; ++s) {
      mbar_init(&ds_full[s], kConsumers);
      mbar_init(&ds_empty[s], 128);  // the dq warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  // registers: 65536 = 2 x 128 x 240 + 128 x 24 without the dq warpgroup,
  // 2 x 128 x 208 + 128 x 72 + 128 x 24 with it
  constexpr int kProducer = kv_threads(kDq) - 128;
  if (threadIdx.x >= kProducer) {
    setmaxnreg_dec<24>();
    if (threadIdx.x / 32 != kProducer / 32) return;  // warp 0 of it loads
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_bar, 2 * L::kv_tile);
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load_4d(smem + L::off_k + p * L::kv_panel, &t.k, kv_bar, p * 64,
                    kvh, k0, b);
        tma_load_4d(smem + L::off_v + p * L::kv_panel, &t.v, kv_bar, p * 64,
                    kvh, k0, b);
      }
    }
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % NS;
      const int h = kvh * rep + it / per_head;
      const int q0 = (q_first + it % per_head) * kTile;
      mbar_wait(&empty[st], ((it / NS) & 1) ^ 1);
      unsigned char* sq = smem + L::off_stage + st * 2 * L::q_tile;
      if (lane == 0) {
        mbar_expect_tx(&full[st], 2 * L::q_tile);
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_4d(sq + p * L::q_panel, &t.q, &full[st], p * 64, h, q0, b);
          tma_load_4d(sq + L::q_tile + p * L::q_panel, &t.dout, &full[st],
                      p * 64, h, q0, b);
        }
      }
      // lse in log2 units, +inf where p must be 0 (a NEG_INF row, a row
      // past S), and D. Plain loads: a ragged S leaves these rows without
      // the 16-byte alignment a bulk copy needs.
      const long long bh = static_cast<long long>(b * a.H + h) * a.S;
      float* vec = vecs + st * 2 * kTile;
      for (int j = lane; j < kTile; j += 32) {
        const int row = q0 + j;
        const float lse = row < a.S ? a.lse[bh + row] : kNegInf;
        vec[j] = lse == kNegInf ? __int_as_float(0x7f800000) : lse * kLog2e;
        vec[kTile + j] = row < a.S ? a.dvec[bh + row] : 0.f;
      }
      mbar_arrive(&full[st]);
    }
    return;
  }

  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128;
  const int warp = wt / 32, lane = wt % 32, g = lane / 4, tq = lane % 4;
  const uint32_t sk = smem_u32(smem + L::off_k), sv = smem_u32(smem + L::off_v);

  if constexpr (kDq) {
    if (wg == 2) {
      // The dq warpgroup: dQ = dS K for each (query tile, key tile), over
      // the tile's 128 keys, from the dS^T buffer the two key warpgroups
      // filled (dS and K both MN-major, k16 step kc at 16 keys, 2048
      // bytes), 64 columns at a time (32 accumulator registers), through a
      // swizzled f32 tile and one bulk tensor reduce a 32-column box.
      // Tiles are used in turn, so reduces may still read the others while
      // one is written.
      setmaxnreg_dec<72>();
      mbar_wait(kv_bar, 0);
      for (int it = 0; it < n_iter; ++it) {
        const int h = kvh * rep + it / per_head;
        const int q0 = (q_first + it % per_head) * kTile;
        const int buf = it % L::kBufs, use = it / L::kBufs;
        unsigned char* sdq = smem + L::off_dq + buf * L::dq_tile;
        const uint32_t ads = smem_u32(smem + L::off_ds + buf * L::ds_tile);
        mbar_wait(&ds_full[buf], use & 1);
        if (wt == 0) bulk_wait_read<L::kBufs - 1>();  // this tile's last reduce
        named_sync(2, 128);
#pragma unroll
        for (int n = 0; n < D / 64; ++n) {
          float acc[32];
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < kKeyTile / 16; ++kc)
            wgmma_ss<1, 1, 64>(
                acc, wgmma_desc(ads + kc * 2048, L::q_panel, 1024),
                wgmma_desc(sk + n * L::kv_panel + kc * 2048, L::kv_panel, 1024),
                kc > 0);
          wgmma_commit();
          wgmma_wait();
          fence_regs(acc);
          if (n == D / 64 - 1) mbar_arrive(&ds_empty[buf]);
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            // 32-column panels of 128-byte rows, swizzled as the map reads
            // them: no two lanes of a store share a bank
            const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
            const int c = 64 * n + 8 * (i >> 2) + 2 * tq;
            *reinterpret_cast<float2*>(
                sdq + (c >> 5) * 8192 + r * 128 +
                ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4) =
                make_float2(acc[i] * a.scale, acc[i + 1] * a.scale);
          }
        }
        fence_proxy_async();
        named_sync(2, 128);
        if (wt == 0) {  // rows past S are dropped by the tensor map
          for (int p = 0; p < D / 32; ++p)
            tma_reduce_add_4d(&t.dq, sdq + p * 8192, p * 32, h, q0, b);
          bulk_commit();
        }
      }
      if (wt == 0) bulk_wait();
      return;
    }
  }

  setmaxnreg_inc<kDq ? 208 : 240>();
  // the query tile in kHalves passes of NQ: two of 32 in the fused pass at
  // D = 128, so that S^T and dP^T fit beside dk and dv in 208 registers
  constexpr int kHalves = kDq && D == 128 ? 2 : 1, NQ = kTile / kHalves;
  const int kb = k0 + 64 * wg;  // this warpgroup's first key
  const float scale_log2 = a.scale * kLog2e;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int st = it % NS;
    const int q0 = (q_first + it % per_head) * kTile;
    const uint32_t sq = smem_u32(smem + L::off_stage + st * 2 * L::q_tile);
    const uint32_t sdo = sq + L::q_tile;
    const float* vec = vecs + st * 2 * kTile;
    mbar_wait(&full[st], (it / NS) & 1);

    unsigned char* sds = nullptr;
    int buf = 0;
    if constexpr (kDq) {
      // dS^T goes to buffer it % kBufs ([128 keys][64 queries], swizzled)
      // once the dq warpgroup has read its last contents
      buf = it % L::kBufs;
      sds = smem + L::off_ds + buf * L::ds_tile;
      mbar_wait(&ds_empty[buf], ((it / L::kBufs) & 1) ^ 1);
    }
    // not unrolled: the two passes' registers would overlap, and spill
#pragma unroll 1
    for (int hf = 0; hf < kHalves; ++hf) {
      // S^T = K Q^T and dP^T = V dO^T, 64 keys x NQ queries; both operands
      // K-major, k16 step kc at byte 32 (kc % 4) of panel kc / 4 (the first
      // step overwrites: zeroing would be moved past the fence by the
      // compiler and make ptxas serialize the wgmmas)
      float s[NQ / 2], dp[NQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t kvo = (kc / 4) * L::kv_panel + wg * 64 * 128 + (kc % 4) * 32;
        const uint32_t qo = (kc / 4) * L::q_panel + hf * NQ * 128 + (kc % 4) * 32;
        wgmma_ss<0, 0, NQ>(s, wgmma_desc(sk + kvo, 16, 1024),
                           wgmma_desc(sq + qo, 16, 1024), kc > 0);
      }
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t kvo = (kc / 4) * L::kv_panel + wg * 64 * 128 + (kc % 4) * 32;
        const uint32_t qo = (kc / 4) * L::q_panel + hf * NQ * 128 + (kc % 4) * 32;
        wgmma_ss<0, 0, NQ>(dp, wgmma_desc(sv + kvo, 16, 1024),
                           wgmma_desc(sdo + qo, 16, 1024), kc > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      // p = exp2(s scale log2(e) - lse log2(e)), ds = p (dp - D). Element
      // i is key 16 warp + g + 8 ((i / 2) % 2) of this warpgroup's 64,
      // query column NQ hf + 8 (i / 4) + 2 tq + i % 2. Only a tile that
      // crosses the causal diagonal tests the causal order, only the
      // ragged last tile the keys' bound; rows are settled by their lse.
      const bool masked = (a.causal && q0 < kb + 63) || kb + 64 > a.S;
#pragma unroll
      for (int c = 0; c < NQ / 4; ++c) {  // column 8 (c / 2) + 2 tq + c % 2
        const int col = NQ * hf + 8 * (c >> 1) + 2 * tq + (c & 1);
        const float lse2 = vec[col], dcol = vec[kTile + col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * (c >> 1) + (c & 1) + 2 * r;
          float p;
          if (masked) {
            const int key = kb + 16 * warp + g + 8 * r;
            const bool ok = key < a.S && (!a.causal || key <= q0 + col);
            p = ok ? exp2_approx(s[i] * scale_log2 - lse2) : 0.f;
          } else {
            p = exp2_approx(s[i] * scale_log2 - lse2);
          }
          s[i] = p;
          dp[i] = p * (dp[i] - dcol);
        }
      }
      // P^T and dS^T as bf16 A fragments (keys x queries)
      uint32_t pa[NQ / 16][4], da[NQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          pa[kk][m] = pack_bf16(s[8 * kk + 2 * m], s[8 * kk + 2 * m + 1]);
          da[kk][m] = pack_bf16(dp[8 * kk + 2 * m], dp[8 * kk + 2 * m + 1]);
        }

      // dV += P^T dO and dK += dS^T Q: dO and Q MN-major, k16 step kk at
      // 16 query rows (2048 bytes), 64-column panels q_panel apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk)
        wgmma_rs<1, D>(dv, pa[kk], wgmma_desc(sdo + (hf * NQ / 16 + kk) * 2048,
                                              L::q_panel, 1024));
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk)
        wgmma_rs<1, D>(dk, da[kk], wgmma_desc(sq + (hf * NQ / 16 + kk) * 2048,
                                              L::q_panel, 1024));
      wgmma_commit();
      if constexpr (kDq) {
        // this pass's columns of dS^T, while dV and dK run
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int r = 64 * wg + 16 * warp + g + 8 * (m & 1);
            const int c = NQ * hf + 16 * kk + 8 * (m >> 1) + 2 * tq;
            *reinterpret_cast<uint32_t*>(sds + r * 128 +
                                         (((c >> 3) ^ (r & 7)) << 4) +
                                         (c & 7) * 2) = da[kk][m];
          }
      }
      wgmma_wait();
      fence_regs(dk);
      fence_regs(dv);
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
    }
    mbar_arrive(&empty[st]);  // this thread is done with the stage
    if constexpr (kDq) {
      fence_proxy_async();
      mbar_arrive(&ds_full[buf]);
    }
  }

  __nv_bfloat16* dK = rows_of<__nv_bfloat16>(a.dk, a.dk_stride, b, kvh);
  __nv_bfloat16* dV = rows_of<__nv_bfloat16>(a.dv, a.dv_stride, b, kvh);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int key = kb + 16 * warp + g + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * tq;
    if (key >= a.S) continue;
    *reinterpret_cast<uint32_t*>(dK + key * a.dk_stride[1] + c) =
        pack_bf16(dk[i] * a.scale, dk[i + 1] * a.scale);
    *reinterpret_cast<uint32_t*>(dV + key * a.dv_stride[1] + c) =
        pack_bf16(dv[i], dv[i + 1]);
  }
}

template <int D, bool kDq>
cudaError_t launch_kv_bf16(const Args& a, int B, cudaStream_t stream) {
  using L = KvLayout<D, kDq>;
  KvTma t;
  t.a = a;
  bool ok =
      encode_rows_map(&t.q, a.q, true, B, a.S, a.H, D, a.q_stride[0],
                      a.q_stride[1], a.q_stride[2], 64, kTile) &&
      encode_rows_map(&t.dout, a.dout, true, B, a.S, a.H, D, a.do_stride[0],
                      a.do_stride[1], a.do_stride[2], 64, kTile) &&
      encode_rows_map(&t.k, a.k, true, B, a.S, a.KV, D, a.k_stride[0],
                      a.k_stride[1], a.k_stride[2], 64, kKeyTile) &&
      encode_rows_map(&t.v, a.v, true, B, a.S, a.KV, D, a.v_stride[0],
                      a.v_stride[1], a.v_stride[2], 64, kKeyTile);
  if (kDq)
    ok = ok && encode_rows_map(&t.dq, a.dq, false, B, a.S, a.H, D,
                               a.dq_stride[0], a.dq_stride[1], a.dq_stride[2],
                               32, kTile);
  else
    t.dq = t.q;  // not read
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = bwd_kv_bf16<D, kDq>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::alloc));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.KV, (a.S + kKeyTile - 1) / kKeyTile);
  kernel<<<grid, kv_threads(kDq), L::alloc, stream>>>(t);
  return cudaGetLastError();
}

// ---- bf16 dq of the two-pass backward: wgmma on TMA-fed tiles ----------

// tiles of 128 keys at D = 64, 64 at D = 128 (registers); 3 stages
template <int D>
using DqLayout = QLayout<D, D == 64 ? 128 : 64, 3, 2, 2>;

struct DqTma {
  Args a;
  int B;
  // q, dO, dq [B, S, H, D] (64-row boxes), k, v [B, S, KV, D] (a key
  // tile's rows a box), all 64 columns a box
  CUtensorMap q, dout, k, v, dq;
};

template <int D>
__global__ void __launch_bounds__(DqLayout<D>::threads, 1)
    bwd_dq_bf16(const __grid_constant__ DqTma t) {
  using L = DqLayout<D>;
  constexpr int N = L::keys;
  const Args& a = t.a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::off_bar);
  uint64_t* full = bars;
  uint64_t* empty = bars + L::NS;
  uint64_t* rows_full = bars + 2 * L::NS;
  uint64_t* rows_empty = rows_full + 2;
  init_ring<L>(bars);

  // registers: 65536 >= 2 x 128 x 240 + 128 x 24
  if (threadIdx.x >= 128 * L::wgs) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * L::wgs) {
      const CUtensorMap* rows[2] = {&t.q, &t.dout};
      produce<L>(smem, bars, t.B, a.H, a.KV, a.S, a.causal, rows, &t.k, &t.v);
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128;
  const int warp = wt / 32, g = (wt % 32) / 4, tq = wt % 4;
  const uint32_t stages = smem_u32(smem + L::off_stage);
  const float scale2 = a.scale * kLog2e;

  // Ping-pong, as in the forward: a warpgroup issues S and dP between a
  // wait on its own named barrier and an arrive on the other's (on every
  // tile, also one it skips), so the two take the tensor cores in turn.
  // Warpgroup 1 lets warpgroup 0 go first.
  if (wg == 1) named_arrive(kTurnBar, 256);
  int done = 0;  // key tiles of the block's earlier items: the ring's count
  for (int it = 0; QWork::exists(it, t.B, a.H, a.S, L::rows); ++it) {
    const QWork w(it, t.B, a.H, a.KV, a.S, a.causal, N, L::rows);
    const int buf = it % L::row_bufs;
    const int row0 = w.q0 + 64 * wg;  // this warpgroup's first row
    unsigned char* q_rows = smem + buf * L::rows_buf + wg * L::rows_tile;
    const uint32_t sq = smem_u32(q_rows);
    const uint32_t sdo = sq + L::wgs * L::rows_tile;

    // this thread's two rows (i / 2 % 2 of an accumulator element): lse in
    // base-2 units, +inf where p must be 0 (a NEG_INF row, a row past S),
    // and D. Plain loads: a ragged S leaves these rows without the 16-byte
    // alignment a bulk copy needs.
    const long long bh = static_cast<long long>(w.b * a.H + w.h) * a.S;
    float lse2[2], dvec[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * warp + g + 8 * r;
      const float lse = row < a.S ? a.lse[bh + row] : kNegInf;
      lse2[r] = lse == kNegInf ? INFINITY : lse * kLog2e;
      dvec[r] = row < a.S ? a.dvec[bh + row] : 0.f;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    mbar_wait(&rows_full[buf], (it / L::row_bufs) & 1);
    for (int j = 0; j < w.n_tiles; ++j) {
      const int gj = done + j, st = gj % L::NS, k0 = j * N;
      const uint32_t sk = stages + st * 2 * L::kv_tile;
      const uint32_t sv = sk + L::kv_tile;
      mbar_wait(&full[st], (gj / L::NS) & 1);
      named_sync(kTurnBar + wg, 256);
      // a tile wholly past this warpgroup's causal diagonal adds nothing
      const bool skip = a.causal && k0 > row0 + 63;
      if (skip) named_arrive(kTurnBar + 1 - wg, 256);
      if (!skip) {
        // S = Q K^T and dP = dO V^T, 64 rows x N keys
        float s[N / 2], dp[N / 2];
        wgmma_fence();
        issue_scores<L>(s, sq, sk);
        issue_scores<L>(dp, sdo, sv);
        wgmma_commit();
        named_arrive(kTurnBar + 1 - wg, 256);
        wgmma_wait();
        fence_regs(s);
        fence_regs(dp);

        // p = exp2(s scale log2(e) - lse log2(e)), ds = p (dp - D). Element
        // i: row 16 warp + g + 8 (i / 2 % 2), key 8 (i / 4) + 2 tq + i % 2
        // of the tile. Only a tile that crosses the causal diagonal tests
        // the causal order, only the ragged last tile the keys' bound.
        const bool masked = (a.causal && k0 + N - 1 > row0) || k0 + N > a.S;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          const int r = (i >> 1) & 1;
          float p = exp2_approx(fmaf(s[i], scale2, -lse2[r]));
          if (masked) {
            const int key = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
            const int row = row0 + 16 * warp + g + 8 * r;
            if (key >= a.S || (a.causal && key > row)) p = 0.f;
          }
          dp[i] = p * (dp[i] - dvec[r]);
        }
        // dS as bf16 A fragments: k16 step kk is accumulator columns 16 kk ..
        uint32_t da[N / 16][4];
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
          for (int mm = 0; mm < 4; ++mm)
            da[kk][mm] =
                pack_bf16(dp[8 * kk + 2 * mm], dp[8 * kk + 2 * mm + 1]);

        // dQ += dS K, K read MN-major from the stage
        wgmma_fence();
        issue_pv<L, D>(dq, da, sk);
        wgmma_commit();
        wgmma_wait();
        fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) fence_regs(da[kk]);
      }
      mbar_arrive(&empty[st]);  // this thread is done with the stage
    }
    done += w.n_tiles;
    const float f[2] = {a.scale, a.scale};
    store_rows<D>(dq, f, q_rows, &t.dq, w.h, row0, w.b, a.S,
                  &rows_empty[buf]);
  }
  if (wg == 0) named_sync(kTurnBar, 256);  // warpgroup 1's last arrive
}

template <int D>
cudaError_t launch_dq_bf16(const Args& a, int B, cudaStream_t stream) {
  using L = DqLayout<D>;
  DqTma t;
  t.a = a;
  t.B = B;
  const bool ok =
      encode_rows_map(&t.q, a.q, true, B, a.S, a.H, D, a.q_stride[0],
                      a.q_stride[1], a.q_stride[2], 64, 64) &&
      encode_rows_map(&t.dout, a.dout, true, B, a.S, a.H, D, a.do_stride[0],
                      a.do_stride[1], a.do_stride[2], 64, 64) &&
      encode_rows_map(&t.k, a.k, true, B, a.S, a.KV, D, a.k_stride[0],
                      a.k_stride[1], a.k_stride[2], 64, L::keys) &&
      encode_rows_map(&t.v, a.v, true, B, a.S, a.KV, D, a.v_stride[0],
                      a.v_stride[1], a.v_stride[2], 64, L::keys) &&
      encode_rows_map(&t.dq, a.dq, true, B, a.S, a.H, D, a.dq_stride[0],
                      a.dq_stride[1], a.dq_stride[2], 64, 64);
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = bwd_dq_bf16<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::alloc));
  if (err != cudaSuccess) return err;
  const int items = B * a.H * ((a.S + L::rows - 1) / L::rows);
  kernel<<<persistent_blocks(items), L::threads, L::alloc, stream>>>(t);
  return cudaGetLastError();
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
    if (which == kFused) return launch_kv_bf16<D, true>(a, B, st);
    if (which == kDkv) return launch_kv_bf16<D, false>(a, B, st);
    if (which == kDqOnly) return launch_dq_bf16<D>(a, B, st);
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
