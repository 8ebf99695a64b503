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
// What bounds it on an H100 SXM: at the flagship's longest prefill bucket
// (S=2048, H=16, KV=8, D=64, causal) the work is 2*S^2*D*H ~ 8.6 GFLOP,
// ~8.7 us at the 989 TFLOP/s bf16 tensor-core peak; q, k, v and o are
// ~12.6 MB, ~3.8 us at 3.35 TB/s. So the kernel is compute-bound at long
// buckets and launch-bound at short ones.
//
// This first design is simple and correct rather than fast. Both kernels
// give a block 64 query rows of one (batch, head) and loop over 64-key tiles
// staged in shared memory:
//   * bf16 (the serving path): four warps of 16 query rows each run both
//     products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//     accumulate); q stays in registers, p is rounded to bf16 for the second
//     product as the TPU kernel does, v reaches the tensor cores through
//     ldmatrix.trans, and the next K/V tile streams in with cp.async while
//     the current one is multiplied (two stages);
//   * f32: FMA tiles on the CUDA cores (16 scores and 4*D/16 output
//     elements per thread), one tile at a time, so f32 stays f32 end to end.
// wgmma, TMA and a producer/consumer pipeline are left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockM = 64;  // query rows per block
constexpr int kBlockN = 64;  // keys per tile

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

// ---- bf16: tensor cores --------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

// Two stages of (K tile, V tile): the next tile's copy is in flight while
// the current one is multiplied.
template <int D> struct MmaSmem {
  static constexpr int pitch = D + 8;  // bf16 per row: conflict-free, 16B rows
  static constexpr int stage = 2 * kBlockN * pitch;  // bf16 per stage
  static constexpr size_t bytes = 2 * stage * sizeof(__nv_bfloat16);
};

// 16 bytes global -> shared without a register round trip; zero-fills when
// !valid (src is then not read).
__device__ __forceinline__ void cp_async_16(void* smem, const void* src,
                                            bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Issue the copies of key tile kt (K and V, rows past S zero) into `stage`.
template <int D>
__device__ __forceinline__ void stage_kv(__nv_bfloat16* stage,
                                         const __nv_bfloat16* K,
                                         const __nv_bfloat16* V, const Args& a,
                                         int kt) {
  constexpr int P = MmaSmem<D>::pitch;
  for (int i = threadIdx.x; i < kBlockN * D / 8; i += kMmaThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8, s = kt * kBlockN + r;
    const bool valid = s < a.S;
    const long long row = valid ? s : 0;
    cp_async_16(stage + r * P + c, K + row * a.k_stride[1] + c, valid);
    cp_async_16(stage + (kBlockN + r) * P + c, V + row * a.v_stride[1] + c,
                valid);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two adjacent bf16 of row `row` (0 past the sequence's end).
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base,
                                              long long row_stride, int row,
                                              int col, int S) {
  return row < S ? *reinterpret_cast<const uint32_t*>(base + row * row_stride + col)
                 : 0u;
}

// Fragment layouts follow PTX's mma.m16n8k16: with g = lane / 4 and
// t = lane % 4, an A fragment holds rows g and g+8 at columns 2t, 2t+1
// (+8), a B fragment column g at rows 2t, 2t+1 (+8), and an f32 C fragment
// rows g and g+8 at columns 2t, 2t+1.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_bf16(const Args a) {
  using Smem = MmaSmem<D>;
  constexpr int P = Smem::pitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const Tile tile(a);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {tile.q0 + warp * 16 + g, tile.q0 + warp * 16 + g + 8};

  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(a.q) +
                           tile.b * a.q_stride[0] + tile.h * a.q_stride[2];
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(a.k) +
                           tile.b * a.k_stride[0] + tile.kvh * a.k_stride[2];
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(a.v) +
                           tile.b * a.v_stride[0] + tile.kvh * a.v_stride[2];

  // this warp's 16 query rows as A fragments, read once from global memory
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = load_pair(Q, a.q_stride[1], rows[0], c, a.S);
    qf[kk][1] = load_pair(Q, a.q_stride[1], rows[1], c, a.S);
    qf[kk][2] = load_pair(Q, a.q_stride[1], rows[0], c + 8, a.S);
    qf[kk][3] = load_pair(Q, a.q_stride[1], rows[1], c + 8, a.S);
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  stage_kv<D>(stages, K, V, a, 0);
  cp_async_commit();
  for (int kt = 0; kt < tile.n_tiles; ++kt) {
    const int k0 = kt * kBlockN;
    // prefetch tile kt+1 into the other stage, whose reads (tile kt-1)
    // ended at the barrier closing the previous iteration
    if (kt + 1 < tile.n_tiles)
      stage_kv<D>(stages + ((kt + 1) & 1) * Smem::stage, K, V, a, kt + 1);
    cp_async_commit();  // possibly empty: keeps one group per iteration
    cp_async_wait_one();  // this thread's copies of tile kt have landed
    __syncthreads();      // ... and everyone else's
    const __nv_bfloat16* sK = stages + (kt & 1) * Smem::stage;
    const __nv_bfloat16* sV = sK + kBlockN * P;

    // scores: 8 column tiles of 8 keys each
    float sc[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const __nv_bfloat16* krow = sK + (nt * 8 + g) * P + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(sc[nt], qf[kk], b0, b1);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const bool valid = key < a.S && (!a.causal || key <= rows[e >> 1]);
        sc[nt][e] = valid ? sc[nt][e] * a.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 4 lanes of a quad share a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const Rescale rs[2] = {Rescale(m[0], mx[0]), Rescale(m[1], mx[1])};
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] *= rs[i].corr;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = rs[e >> 1].p(sc[nt][e]);
        l[e >> 1] += sc[nt][e];  // this lane's share; quads sum at the end
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= rs[0].corr;
      o[j][1] *= rs[0].corr;
      o[j][2] *= rs[1].corr;
      o[j][3] *= rs[1].corr;
    }

    // o += p v: the score C fragments of key tiles 2j, 2j+1 are exactly the
    // A fragment of keys 16j..16j+15
#pragma unroll
    for (int j = 0; j < kBlockN / 16; ++j) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * j][0], sc[2 * j][1]),
          pack_bf16(sc[2 * j][2], sc[2 * j][3]),
          pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
          pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
      const int mi = lane >> 3;  // which 8x8 matrix this lane addresses
      const __nv_bfloat16* vrow =
          sV + (j * 16 + (mi & 1) * 8 + (lane & 7)) * P + (mi >> 1) * 8;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + dp * 16);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.o) +
                     tile.b * a.o_stride[0] + tile.h * a.o_stride[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (rows[i] >= a.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(O + rows[i] * a.o_stride[1] + j * 8 + 2 * t) =
          pack_bf16(o[j][2 * i] / denom, o[j][2 * i + 1] / denom);
    if (a.lse != nullptr && t == 0)
      a.lse[static_cast<long long>(tile.bh) * a.S + rows[i]] = lse_of(m[i], l[i]);
  }
}

// ---- f32: CUDA-core FMA tiles --------------------------------------------

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
  if (dtype == 1 && D == 64)
    return launch(flash_fwd_bf16<64>, kMmaThreads, MmaSmem<64>::bytes, a, BH, st);
  if (dtype == 1 && D == 128)
    return launch(flash_fwd_bf16<128>, kMmaThreads, MmaSmem<128>::bytes, a, BH, st);
  if (dtype == 0 && D == 64)
    return launch(flash_fwd_f32<64>, kFmaThreads, FmaSmem<64>::bytes, a, BH, st);
  if (dtype == 0 && D == 128)
    return launch(flash_fwd_f32<128>, kFmaThreads, FmaSmem<128>::bytes, a, BH, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
