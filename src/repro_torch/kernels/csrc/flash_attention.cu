// Flash attention, forward only, on the CUDA cores: softmax(q k^T * scale) v
// with an online softmax, so the (Sq, Sk) scores never reach device memory.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (launched by flash_attention_bhsd, wrapped by
// kernels/ops.py::flash_attention) for float32 inputs, and for bf16 at a
// head_dim that is not a multiple of 16 (flash_attention_sm90.cu takes the
// rest).  It computes the same function:
//   - scores in fp32, times `scale`, then gemma2's softcap
//     cap * tanh(s / cap) when cap > 0;
//   - causal masking top-left aligned (k_pos <= q_pos, both from 0), a
//     sliding window keeping k_pos > q_pos - window when window > 0, and
//     positions at or past Sq / Sk masked;
//   - GQA: query head h reads kv head h / (H / KV);
//   - a running max, denominator and accumulator in fp32, the output
//     rounded to q's type once; a fully masked row gives 0, not NaN.
// The TPU walked the kv blocks as a sequential grid dimension carrying
// scratch between steps; here one thread block owns a (batch*head, q tile)
// pair and walks the kv tiles in a loop.  q, k and v are read in the
// (B, S, heads, D) layout by strides, with no transposed copies; D may be
// anything up to 256.
//
// Bound on this card (H100 SXM): 4*D FLOPs per visible (q, k) pair (two
// products of D multiply-adds).  In float32 they run on the CUDA cores, at
// 67 TFLOP/s: 128 FFMA a clock an SM.  Shared memory gives an SM 32 words
// a clock, so a product that reads one shared word per FMA runs at a
// quarter of that rate at best.  The design keeps that ratio high:
//
// - Register-blocked products.  A block has 256 threads: 16 row groups of
//   kRows q rows (8; 4 in the 192- and 256-wide instances) by 16 column
//   groups, one half-warp per row group.  For S = Q K^T over a 64-row kv
//   tile the thread (rg, cg) owns kRows rows x 4 kv columns (cg, cg+16,
//   cg+32, cg+48); each step of 4 along D reads kRows float4s of Q and 4 of
//   K from row-major tiles for 16*kRows FMAs: 2.7 FMAs a word at kRows = 8.
//   For O += P V the same thread owns its rows x the float4 columns 4cg,
//   4cg+64, ...: each kv row reads kRows/4 float4s of P (stored
//   transposed, [kv][q]) and one float4 of V per 64 columns, 4 FMAs a word
//   at D = 128.  The tiles' row stride is DMAX + 4 floats (4 mod 8 words:
//   8 consecutive rows on distinct banks).  P V runs over every column up
//   to DMAX, V's columns past D held at 0: a test of the column in that
//   loop splits it into branches the compiler cannot schedule across, and
//   cost more on the card than the products it saves.
// - Loads in flight.  K and V each have one buffer; K of the next tile is
//   loaded while P V of this one is computed, and V of this tile while
//   Q K^T is (two barriers a tile, each wait covering half a tile of
//   compute; two K/V buffers do not fit beside the 128-row q tile at
//   D = 128).  float32 rows that are 16-byte aligned go by cp.async.cg, 16
//   bytes a copy, zero-filled past Sk; bf16 and unaligned rows are loaded
//   into registers before the product and converted into shared memory
//   after it.
// - Masks only on edge tiles.  A tile wholly inside the visible region
//   (below the diagonal, inside the window, before Sk) skips the
//   per-element mask; only tiles that straddle an edge test each score.
//   Kv tiles wholly above the causal diagonal or wholly before the window
//   are never visited.
// - Row statistics by shuffles.  A row's max reduces over its half-warp by
//   four xor shuffles once a tile; the denominator stays a per-thread
//   partial sum, reduced once at the end; the accumulator is rescaled once
//   a 64-column tile.  Exponentials are exp2 of scores pre-scaled by
//   log2(e).
// - Heavy tiles first.  Blocks take the q tiles from the last to the
//   first, so the causal rows that see most keys start in the first wave.
//
// Instances by DMAX, D rounded up: 64 (128 q rows a block, 103,424 bytes
// of shared memory, two blocks an SM), 128 (128 q rows, 168,960 bytes, one
// block an SM), 192 and 256 (64 q rows, 167,936 and 217,088 bytes, one
// block an SM).  Tensor cores (TF32) would change the rounding the float32
// tolerance holds, so both products stay in full fp32.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 16;             // row groups a block, a half-warp each
constexpr int kThreads = 16 * kGroups;  // by 16 column groups
constexpr int kBK = 64;                 // kv rows per tile
constexpr int kCols = 4;       // kv columns of S per thread: cg + 16j
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx.ftz: relative error about 2^-22; p below
// 2^-126 flushes to 0, far under the float32 tolerance of the sums).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Launches that reached the card, counted by the kernel itself (block 0,
// thread 0 adds one): a count that a host-side trace cannot lose.
__device__ unsigned long long g_device_launches;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;  // element strides (batch, seq, head); d is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int H, KV, Sq, Sk, D;
  int causal, window;
  float scale, cap;
  int n_q_tiles;
  int bh;  // B * H
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The tiles of an instance.  kLd, the row stride of the q, k and v tiles
// in floats, is DMAX plus 4: a stride of 4 mod 8 words puts 8 consecutive
// rows on distinct banks.
template <int DMAX>
struct Tile {
  static constexpr int kRows = DMAX > 128 ? 4 : 8;  // q rows a thread
  static constexpr int kBQ = kGroups * kRows;       // q rows a block
  static constexpr int kChunks = DMAX / 64;  // float4 columns of O a thread
  static constexpr int kMinBlocks = DMAX <= 64 ? 2 : 1;
  static constexpr int kLd = DMAX + 4;
  static constexpr int kLdP = kBQ + 4;  // the P tile's row stride
  // steps of Q K^T unrolled: 4 hides the shared loads better; at 64 the
  // two blocks an SM leave 128 registers, and 2 spills less
  static constexpr int kUnrollQK = DMAX <= 64 ? 2 : 4;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kBQ * kLd + 2 * kBK * kLd + kBK * kLdP);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies rows [pos0, pos0 + kRowsT) of a (S, D) matrix (row stride ss) into
// a shared tile with stride ld by cp.async, 16 bytes a copy; rows at or past
// S are zero-filled.  Needs D % 4 == 0 and 16-byte aligned rows.
template <int kRowsT, int ld>
__device__ __forceinline__ void tile_async(float* dst, const float* src,
                                           long long ss, int pos0, int S,
                                           int D, int rg, int cg) {
  const int nv = D / 4;
#pragma unroll
  for (int r = rg; r < kRowsT; r += kGroups) {
    const int pos = pos0 + r;
    const bool in = pos < S;
    const float* row = src + (in ? static_cast<long long>(pos) * ss : 0);
    for (int c = cg; c < nv; c += 16)
      cp_async16(dst + r * ld + 4 * c, row + 4 * c, in);
  }
}

// The same, element by element and converted to float, for bf16 or rows
// that are not 16-byte aligned: columns D..dp-1 of the tile are zeroed.
template <typename T, int kRowsT, int ld>
__device__ __forceinline__ void tile_sync(float* dst, const T* src,
                                          long long ss, int pos0, int S,
                                          int D, int dp, int rg, int cg) {
  for (int r = rg; r < kRowsT; r += kGroups) {
    const int pos = pos0 + r;
    for (int d = cg; d < dp; d += 16)
      dst[r * ld + d] =
          (pos < S && d < D)
              ? to_float(src[static_cast<long long>(pos) * ss + d])
              : 0.f;
  }
}

// A kv tile held in registers between its load (before a product) and its
// store into shared memory (after it), so the loads' latency hides behind
// the product: element (rg + 16a, cg + 16b) at v[a][b].
template <typename T, int DMAX>
struct KvRegs {
  static constexpr int kA = kBK / kGroups;
  static constexpr int kB = DMAX / 16;
  T v[kA][kB];

  __device__ __forceinline__ void load(const T* src, long long ss, int pos0,
                                       int S, int D, int rg, int cg) {
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      const int pos = pos0 + rg + kGroups * a;
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int d = cg + 16 * b;
        v[a][b] = (pos < S && d < D)
                      ? src[static_cast<long long>(pos) * ss + d]
                      : from_float<T>(0.f);
      }
    }
  }

  template <int ld>
  __device__ __forceinline__ void store(float* dst, int dp, int rg,
                                        int cg) const {
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int d = cg + 16 * b;
        if (d < dp) dst[(rg + kGroups * a) * ld + d] = to_float(v[a][b]);
      }
  }
};

// kAsync: float32 with 16-byte aligned rows, tiles by cp.async; else tiles
// through registers (KvRegs).  DMAX: D rounded up to 64, 128, 192 or 256.
template <typename T, int DMAX, bool kAsync>
__global__ void __launch_bounds__(kThreads, Tile<DMAX>::kMinBlocks)
    flash_fwd_kernel(const Params p) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_device_launches, 1ull);
  constexpr int kRows = Tile<DMAX>::kRows;
  constexpr int kBQ = Tile<DMAX>::kBQ;
  constexpr int kChunks = Tile<DMAX>::kChunks;
  constexpr int ld = Tile<DMAX>::kLd;
  constexpr int kLdP = Tile<DMAX>::kLdP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dp = (p.D + 3) & ~3;  // D rounded up to a float4
  float* qs = smem;               // [kBQ][ld]
  float* ks = qs + kBQ * ld;      // [kBK][ld]
  float* vs = ks + kBK * ld;      // [kBK][ld], columns dp.. zero
  float* ps = vs + kBK * ld;      // [kBK][kLdP] probabilities, transposed

  // the last q tile first: under a causal mask it sees the most keys
  const int bh = blockIdx.x % p.bh;
  const int tile = p.n_q_tiles - 1 - blockIdx.x / p.bh;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = tile * kBQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // row group: rows rg*kRows .. + kRows-1
  const int cg = tid & 15;  // column group
  const int qrow0 = q0 + rg * kRows;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // kv positions any row of this tile can see
  int k_lo = 0;
  int k_hi = p.Sk;
  if (p.causal) k_hi = min(k_hi, min(q0 + kBQ, p.Sq));
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int k_start = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > k_start ? (k_hi - k_start + kBK - 1) / kBK : 0;

  // scores go to log2 units: p = exp2(x - m) with x = s * scale * log2(e)
  const bool capped = p.cap > 0.f;
  const float scale_log2 = p.scale * kLog2e;
  const float scale_over_cap = capped ? p.scale / p.cap : 0.f;
  const float cap_log2 = p.cap * kLog2e;

  // P V reads every column of V up to DMAX: the ones past dp stay 0
  for (int r = rg; r < kBK; r += kGroups)
    for (int d = dp + cg; d < DMAX; d += 16) vs[r * ld + d] = 0.f;
  KvRegs<T, DMAX> kreg, vreg;
  if constexpr (kAsync) {
    tile_async<kBQ, ld>(qs, reinterpret_cast<const float*>(qg), p.q_ss, q0,
                        p.Sq, p.D, rg, cg);
    cp_async_commit();
    if (n_tiles > 0) {
      tile_async<kBK, ld>(ks, reinterpret_cast<const float*>(kg), p.k_ss,
                          k_start, p.Sk, p.D, rg, cg);
      cp_async_commit();
    }
  } else {
    tile_sync<T, kBQ, ld>(qs, qg, p.q_ss, q0, p.Sq, p.D, dp, rg, cg);
    if (n_tiles > 0) kreg.load(kg, p.k_ss, k_start, p.Sk, p.D, rg, cg);
  }

  float4 acc[kRows][kChunks];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m[kRows], l[kRows];  // l: this thread's share of the row's sum
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_start + t * kBK;
    // K of this tile lands; V's buffer is free (the last P V is done)
    if constexpr (kAsync) {
      cp_async_wait_all();
    } else {
      kreg.template store<ld>(ks, dp, rg, cg);
    }
    __syncthreads();
    if constexpr (kAsync) {
      tile_async<kBK, ld>(vs, reinterpret_cast<const float*>(vg), p.v_ss,
                          k0, p.Sk, p.D, rg, cg);
      cp_async_commit();
    } else {
      vreg.load(vg, p.v_ss, k0, p.Sk, p.D, rg, cg);
    }

    // S = Q K^T: kRows x 4 scores a thread
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    {
      const float* qb = qs + rg * kRows * ld;
      const float* kb = ks + cg * ld;
#pragma unroll(Tile<DMAX>::kUnrollQK)
      for (int d = 0; d < dp; d += 4) {
        float4 kf[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          kf[j] = *reinterpret_cast<const float4*>(kb + 16 * j * ld + d);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(qb + i * ld + d);
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[i][j] = fmaf(a.x, kf[j].x, s[i][j]);
            s[i][j] = fmaf(a.y, kf[j].y, s[i][j]);
            s[i][j] = fmaf(a.z, kf[j].z, s[i][j]);
            s[i][j] = fmaf(a.w, kf[j].w, s[i][j]);
          }
        }
      }
    }

    // scale, softcap; the mask only where the tile straddles an edge
    const bool edge = k0 + kBK > p.Sk || (p.causal && k0 + kBK - 1 > q0) ||
                      (p.window > 0 && k0 <= q0 + kBQ - 1 - p.window);
    unsigned ok_bits = 0xffffffffu;
    if (capped) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          s[i][j] = cap_log2 * tanhf(s[i][j] * scale_over_cap);
    } else {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] *= scale_log2;
    }
    if (edge) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int qpos = qrow0 + i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int kpos = k0 + cg + 16 * j;
          bool ok = kpos < p.Sk;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          if (!ok) {
            s[i][j] = kNegInf;
            ok_bits &= ~(1u << (i * kCols + j));
          }
        }
      }
    }

    // online softmax: the row max over the half-warp, P into shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < kCols; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      const float m_new = fmaxf(m[i], mx);
      const float corr = fast_exp2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const bool ok = (ok_bits >> (i * kCols + j)) & 1u;
        s[i][j] = ok ? fast_exp2(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        acc[i][c].x *= corr;
        acc[i][c].y *= corr;
        acc[i][c].z *= corr;
        acc[i][c].w *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float* prow = ps + (cg + 16 * j) * kLdP + rg * kRows;
#pragma unroll
      for (int i = 0; i < kRows; i += 4)
        *reinterpret_cast<float4*>(prow + i) =
            make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
    }

    // V of this tile lands and P is written; K's buffer is free
    if constexpr (kAsync) {
      cp_async_wait_all();
    } else {
      vreg.template store<ld>(vs, dp, rg, cg);
    }
    __syncthreads();
    if (t + 1 < n_tiles) {
      if constexpr (kAsync) {
        tile_async<kBK, ld>(ks, reinterpret_cast<const float*>(kg),
                            p.k_ss, k0 + kBK, p.Sk, p.D, rg, cg);
        cp_async_commit();
      } else {
        kreg.load(kg, p.k_ss, k0 + kBK, p.Sk, p.D, rg, cg);
      }
    }

    // O += P V: kRows rows x kChunks float4 columns a thread (every
    // column up to DMAX: a test of d < dp here would cost more than the
    // products on the zero columns past it)
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; i += 4) {
        const float4 x =
            *reinterpret_cast<const float4*>(ps + c * kLdP + rg * kRows + i);
        pr[i] = x.x;
        pr[i + 1] = x.y;
        pr[i + 2] = x.z;
        pr[i + 3] = x.w;
      }
      const float* vrow = vs + c * ld;
#pragma unroll
      for (int cc = 0; cc < kChunks; ++cc) {
        const float4 w =
            *reinterpret_cast<const float4*>(vrow + 4 * cg + 64 * cc);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][cc].x = fmaf(pr[i], w.x, acc[i][cc].x);
          acc[i][cc].y = fmaf(pr[i], w.y, acc[i][cc].y);
          acc[i][cc].z = fmaf(pr[i], w.z, acc[i][cc].z);
          acc[i][cc].w = fmaf(pr[i], w.w, acc[i][cc].w);
        }
      }
    }
  }

  // out = acc / l (l == 0 on a fully masked row: out = 0), staged through
  // the q tile's shared memory so the store is coalesced
  if constexpr (kAsync) cp_async_wait_all();  // no kv tile: q still landing
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    const float inv = sum == 0.f ? 0.f : 1.f / sum;
    float* orow = qs + (rg * kRows + i) * ld;
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      const int d = 4 * cg + 64 * cc;
      if (d < dp)
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[i][cc].x * inv, acc[i][cc].y * inv,
                        acc[i][cc].z * inv, acc[i][cc].w * inv);
    }
  }
  __syncthreads();
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int r = rg; r < kBQ; r += kGroups) {
    const int pos = q0 + r;
    if (pos >= p.Sq) break;
    T* orow = og + static_cast<long long>(pos) * p.o_ss;
    if constexpr (kAsync) {
      for (int c = cg; c < p.D / 4; c += 16)
        reinterpret_cast<float4*>(orow)[c] =
            *reinterpret_cast<const float4*>(qs + r * ld + 4 * c);
    } else {
      for (int d = cg; d < p.D; d += 16)
        orow[d] = from_float<T>(qs[r * ld + d]);
    }
  }
}

template <typename T, int DMAX, bool kAsync>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr int kBQ = Tile<DMAX>::kBQ;
  p.n_q_tiles = (p.Sq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(p.bh) * p.n_q_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  constexpr size_t smem = Tile<DMAX>::kSmemBytes;
  const cudaError_t set = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX, kAsync>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return set;
  flash_fwd_kernel<T, DMAX, kAsync>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kAsync>
cudaError_t launch_for_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64, kAsync>(p, stream);
  if (p.D <= 128) return launch<T, 128, kAsync>(p, stream);
  if (p.D <= 192) return launch<T, 192, kAsync>(p, stream);
  return launch<T, 256, kAsync>(p, stream);
}

// Whether every row of q, k, v and o starts on 16 bytes, so float32 tiles
// can go by 16-byte cp.async and the output by float4 stores.
bool rows_aligned(const Params& p) {
  if (p.D % 4) return false;
  const long long strides[12] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb,
                                 p.k_ss, p.k_sh, p.v_sb, p.v_ss,
                                 p.v_sh, p.o_sb, p.o_ss, p.o_sh};
  for (long long s : strides)
    if (s % 4) return false;
  const void* ptrs[4] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  return true;
}

}  // namespace

// C entry point, loaded through ctypes.
//   q: (B, Sq, H, D), k and v: (B, Sk, KV, D), o: (B, Sq, H, D), all on
//   card `device`, of one type (dtype 0 = float32, 1 = bfloat16), each with
//   unit stride along D; strides[12] holds the (batch, seq, head) element
//   strides of q, k, v and o in that order.  causal is 0 or 1; window >= 0
//   (0 = none); cap >= 0 (0 = none).  stream is a cudaStream_t of that card.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int lcap_flash_attention(const void* q, const void* k,
                                    const void* v, void* o,
                                    const long long* strides, int B, int H,
                                    int KV, int Sq, int Sk, int D, int causal,
                                    int window, float scale, float cap,
                                    int dtype, int device, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > 256 || window < 0 || cap < 0.f || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.causal = causal ? 1 : 0;
  p.window = window;
  p.scale = scale;
  p.cap = cap;
  p.n_q_tiles = 0;  // set by launch() for the instance's tile
  if (static_cast<long long>(B) * H > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  p.bh = B * H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = launch_for_d<__nv_bfloat16, false>(p, s);
  else if (rows_aligned(p))
    err = launch_for_d<float, true>(p, s);
  else
    err = launch_for_d<float, false>(p, s);
  return static_cast<int>(err);
}

// Launches of flash_fwd_kernel on card `device` since this library was
// loaded or the count last reset, as the kernel counted them on the card;
// with reset != 0 the count restarts from 0.  Synchronises with the card's
// work.  Returns the count, or minus the cudaError_t of reading it.
extern "C" long long lcap_flash_attention_device_launches(int reset,
                                                           int device) {
  cudaError_t err = cudaSetDevice(device);
  unsigned long long n = 0;
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(&n, g_device_launches, sizeof n);
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(g_device_launches, &zero, sizeof zero);
  }
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return static_cast<long long>(n);
}
