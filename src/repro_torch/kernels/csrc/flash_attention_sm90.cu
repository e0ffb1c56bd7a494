// Flash attention, forward only, for Hopper: both products on the tensor
// cores by wgmma (bf16 in, fp32 accumulate), fed by TMA tile loads through
// a two-stage ring of shared-memory buffers.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (launched by flash_attention_bhsd, wrapped by
// kernels/ops.py::flash_attention) for bf16 q, k, v with D % 16 == 0 and
// D <= 256; the wrapper (kernels/flash_attention.py) sends float32, and
// bf16 at any other D, to csrc/flash_attention.cu.  It computes the same
// function:
//   - scores in fp32, times `scale`, then gemma2's softcap
//     cap * tanh(s / cap) when cap > 0;
//   - causal masking top-left aligned (k_pos <= q_pos, both from 0), a
//     sliding window keeping k_pos > q_pos - window when window > 0, and
//     positions at or past Sq / Sk masked;
//   - GQA: query head h reads kv head h / (H / KV);
//   - a running max, denominator and accumulator in fp32, the output
//     rounded to bf16 once; a fully masked row gives 0, not NaN.
// One deliberate difference: the probabilities P are rounded to bf16 before
// the P.V product (the tensor cores take bf16 operands), where the
// reference multiplies an fp32 P.
//
// Bound on this card (H100 SXM): 4*D FLOPs per visible (q, k) pair, at
// 989 TFLOP/s bf16 on the tensor cores, or q, k, v and o moved once at
// 3.35 TB/s, whichever is larger.  At the serving path's shape (B 4,
// S 2048, H 32, KV 8, D 128, causal) that is 137.5 GFLOP -> 0.139 ms
// against 167.8 MB -> 0.050 ms: bound by the tensor cores.  So:
//   - Both products are wgmma.mma_async.  S = Q.K^T reads Q and K from
//     shared memory by descriptor (K-major, 128-byte swizzle).  O += P.V
//     takes P from registers: the S accumulator fragment is converted to
//     bf16 pairs in place, since its layout is the A-register layout of
//     the next wgmma; V is B from shared memory with the transpose flag.
//   - Loads are TMA (cp.async.bulk.tensor over a 4-d tensor map of the
//     (B, S, heads, D) layout), completing on mbarriers: Q once, then K
//     and V tiles into a ring of 2 stages, so the next tile's loads overlap
//     this tile's products.  One producer thread issues them; its
//     warpgroup gives its registers up (setmaxnreg).  The tensor map's
//     out-of-bounds zero fill takes the place of ragged-edge code: rows
//     past Sq / Sk and columns past D arrive as zeros.
//   - Two consumer warpgroups of 64 q rows each (128 q rows a block),
//     which interleave on the SM: one's softmax runs beside the other's
//     products.  The online softmax runs on the accumulator fragment in
//     registers: a row lives on the 4 lanes of a quad (two shuffles
//     reduce it), exp2f with log2(e) folded into the scale.
//   - kv tiles of 64 rows.  ptxas gives a thread at most 168 registers
//     here (three warps share each quarter of the register file) whatever
//     setmaxnreg asks at run time; 64-row tiles keep the consumer's live
//     state (O, 32 scores, 16 registers of P) within that with no spills
//     at DP <= 128, where 128-row tiles spilled and serialised the wgmmas.
//     ptxas -v (CUDA 12.8): DP = 192 spills 16 bytes, DP = 256 456 bytes.
//   - Only the tiles that need it are masked (the causal diagonal, the
//     window's edge, the Sk edge); tiles wholly above the diagonal or
//     before the window are never loaded.
//   - Blocks are numbered so that the q tiles with the most kv tiles (the
//     last ones, under a causal mask) start first.
//
// Shared memory: D is padded to DP = 64, 128, 192 or 256 (TMA zero-fills
// the padding); each tile is DP / 64 column groups of rows x 128 bytes in
// the 128-byte swizzle: 97 KB at DP = 128, 193 KB at DP = 256.

#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 128;        // q rows per block: 64 per consumer warpgroup
constexpr int kBK = 64;         // kv rows per tile
constexpr int kStages = 2;      // depth of the K/V ring
constexpr int kThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int kGroupCols = 64;  // bf16 columns in one 128-byte swizzle row
constexpr int kRowBytes = 128;
constexpr int kS = kBK / 2;     // score registers per consumer thread
constexpr int kP = kBK / 16;    // k16 steps of P.V
constexpr float kLog2e = 1.4426950408889634f;

// Launches that reached the card, counted by the kernel itself (block 0,
// thread 0 adds one): a count that a host-side trace cannot lose.
__device__ unsigned long long g_device_launches;

struct Params {
  void* o;
  int H, KV, Sq, Sk, D;
  int BH, n_q_tiles;
  int causal, window;
  int has_cap;
  float scale_log2;  // scale * log2(e), when cap == 0
  float cap_pre;     // scale / cap
  float cap_post;    // cap * log2(e)
};

// Byte offsets in the (1024-byte aligned) dynamic shared memory.
template <int DP>
struct Smem {
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kKVBytes = kBK * DP * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  // mbarriers (q full; k full, v full and empty per stage) and the slack
  // to align the base to 1024 bytes
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait of some 10 s (2^34 clocks) can only be a fault: it traps, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) break;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One TMA box of the 4-d map into shared memory at `dst`; completes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle: start
// address, both byte offsets 1024 (one 8-row x 128-byte swizzle atom; with
// k16 steps and 64-column B pieces only the stride between 8-row groups is
// read), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kAtom = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kAtom << 16) |
         (kAtom << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D(64 x 64) (+)= A(64 x 16) * B(64 x 16)^T, A and B read from shared
// memory by descriptor, both K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x 64) (+)= A(64 x 16) * B(16 x 64), A from registers in the
// accumulator's row layout, B from shared memory, MN-major (the transpose
// flag set).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S = Q.K^T of one kv tile: the warpgroup's 64 q rows against the tile's
// 64 rows, one k16 step per wgmma (issued, not waited for).  Steps past D
// multiply the zeros TMA filled in.
template <int DP>
__device__ __forceinline__ void issue_qk(float (&sc)[kS], uint32_t q_rows,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    // column group kk / 4, 32 bytes into its swizzled rows per step
    const uint32_t at = (kk % 4) * 32;
    wgmma_ss_m64n64k16(sc,
                       smem_desc(q_rows + (kk / 4) * kBQ * kRowBytes + at),
                       smem_desc(k_tile + (kk / 4) * kBK * kRowBytes + at),
                       kk > 0);
  }
}

// O += P.V of one kv tile, P from registers, one product per k16 step and
// 64-column group of V (issued, not waited for).
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 64][32],
                                         const uint32_t (&pa)[kP][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kP; ++kk)
#pragma unroll
    for (int n = 0; n < DP / 64; ++n)
      wgmma_rs_m64n64k16(
          o[n], pa[kk],
          smem_desc(v_tile + n * kBK * kRowBytes + kk * 16 * kRowBytes), 1);
}

// The running softmax state of a thread's two rows (qpos0, qpos0 + 8).
struct RowState {
  float m0, m1;  // running max, log2 units
  float l0, l1;  // this thread's share of the denominators
};

// Scores of the kv tile starting at k0 -> probabilities, in place: scale
// (and softcap) into log2 units, the mask where the tile needs one, the
// new row max, exp2.  Updates the row state and returns the factors c0, c1
// by which the output rows must be rescaled.  Element j of the fragment
// lies in row qpos0 (j & 2 == 0) or qpos0 + 8, column k0 + 8 (j / 4) +
// col + (j & 1); a row's values span the 4 lanes of a quad.
__device__ __forceinline__ void softmax_tile(float (&sc)[kS], const Params& p,
                                             int k0, int wq, int qpos0,
                                             int col, RowState& st,
                                             float& c0, float& c1) {
  if (p.has_cap) {
#pragma unroll
    for (int j = 0; j < kS; ++j) sc[j] = p.cap_post * tanhf(sc[j] * p.cap_pre);
  } else {
#pragma unroll
    for (int j = 0; j < kS; ++j) sc[j] *= p.scale_log2;
  }
  // only a tile that crosses the diagonal, the window's edge or Sk
  const bool edge = k0 + kBK > p.Sk || (p.causal && k0 + kBK - 1 > wq) ||
                    (p.window > 0 && k0 <= wq + 63 - p.window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const int kpos = k0 + 8 * (j / 4) + col + (j & 1);
      const int qpos = qpos0 + ((j & 2) ? 8 : 0);
      bool ok = kpos < p.Sk;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && kpos > qpos - p.window;
      if (!ok) sc[j] = -INFINITY;
    }
  }
  float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    if (j & 2) {
      t1 = fmaxf(t1, sc[j]);
    } else {
      t0 = fmaxf(t0, sc[j]);
    }
  }
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
  const float n0 = fmaxf(st.m0, t0);
  const float n1 = fmaxf(st.m1, t1);
  // a row with nothing visible yet subtracts 0, so exp2 gives 0, not NaN
  const float u0 = n0 == -INFINITY ? 0.f : n0;
  const float u1 = n1 == -INFINITY ? 0.f : n1;
  c0 = exp2f(st.m0 - u0);
  c1 = exp2f(st.m1 - u1);
  st.m0 = n0;
  st.m1 = n1;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const float e = exp2f(sc[j] - ((j & 2) ? u1 : u0));
    sc[j] = e;
    if (j & 2) {
      r1 += e;
    } else {
      r0 += e;
    }
  }
  st.l0 = st.l0 * c0 + r0;
  st.l1 = st.l1 * c1 + r1;
}

// P as the A operand of P.V: the accumulator's columns 16 kk .. 16 kk + 15
// are its 8-column chunks 2 kk and 2 kk + 1, and that is the A-register
// layout of a k16 step.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kP][4],
                                       const float (&sc)[kS]) {
#pragma unroll
  for (int kk = 0; kk < kP; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// DP: D padded to a multiple of 64.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const Params p) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_device_launches, 1ull);
  using L = Smem<DP>;
  constexpr int kGroups = DP / kGroupCols;
  constexpr int kN = DP / 64;  // 64-column pieces of the output
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base + L::kQ;
  const uint32_t s_k = base + L::kK;
  const uint32_t s_v = base + L::kV;
  // mbarriers, 8 bytes each: q full; k full, v full, empty per stage
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_k = bar_q + 8;
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_empty = bar_v + 8 * kStages;

  // the q tiles with the most kv tiles (the last ones) start first
  const int tile = p.n_q_tiles - 1 - static_cast<int>(blockIdx.x / p.BH);
  const int bh = static_cast<int>(blockIdx.x % p.BH);
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = tile * kBQ;

  // kv positions any row of this block can see, as whole tiles
  int k_lo = 0;
  int k_hi = p.Sk;
  if (p.causal) k_hi = min(k_hi, min(q0 + kBQ, p.Sq));
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / kBK;
  const int n_tiles = k_hi > k_lo ? (k_hi + kBK - 1) / kBK - t_lo : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        tma_load_4d(s_q + g * kBQ * kRowBytes, &tm_q, bar_q, g * kGroupCols,
                    h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int k0 = (t_lo + i) * kBK;
        // the consumers have released this stage's previous tile
        mbar_wait(bar_empty + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t off = s * L::kKVBytes;
        mbar_expect_tx(bar_k + 8 * s, L::kKVBytes);
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          tma_load_4d(s_k + off + g * kBK * kRowBytes, &tm_k, bar_k + 8 * s,
                      g * kGroupCols, kvh, k0, b);
        mbar_expect_tx(bar_v + 8 * s, L::kKVBytes);
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          tma_load_4d(s_v + off + g * kBK * kRowBytes, &tm_v, bar_v + 8 * s,
                      g * kGroupCols, kvh, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;
    const int warp = (ct % 128) / 32;
    const int lane = ct % 32;
    const int wq = q0 + 64 * cw;                  // first row of this group
    const int qpos0 = wq + 16 * warp + lane / 4;  // rows of this thread:
    const int qpos1 = qpos0 + 8;                  // qpos0 and qpos0 + 8
    const int col = 2 * (lane % 4);  // its first column in each 8 columns

    float o[kN][32];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
    float sc[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) sc[j] = 0.f;
    uint32_t pa[kP][4];
    RowState st = {-INFINITY, -INFINITY, 0.f, 0.f};
    const uint32_t q_rows = s_q + cw * 64 * kRowBytes;

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t phase = (i / kStages) & 1;
      mbar_wait(bar_k + 8 * s, phase);
      fence_regs(sc);
      wgmma_fence();
      issue_qk<DP>(sc, q_rows, s_k + s * L::kKVBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      float c0, c1;
      softmax_tile(sc, p, (t_lo + i) * kBK, wq, qpos0, col, st, c0, c1);
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[n][j] *= (j & 2) ? c1 : c0;
      pack_p(pa, sc);

      mbar_wait(bar_v + 8 * s, phase);
#pragma unroll
      for (int n = 0; n < kN; ++n) fence_regs(o[n]);
      wgmma_fence();
      issue_pv<DP>(o, pa, s_v + s * L::kKVBytes);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int n = 0; n < kN; ++n) fence_regs(o[n]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this stage is free
    }

    // out = o / l (l == 0 on a row with nothing visible: out = 0)
    float l0 = st.l0, l1 = st.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const long long row_stride = static_cast<long long>(p.H) * p.D;
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                        static_cast<long long>(b) * p.Sq * row_stride +
                        static_cast<long long>(h) * p.D;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * n + 8 * j + col;
        if (d < p.D) {
          if (qpos0 < p.Sq)
            *reinterpret_cast<uint32_t*>(og + qpos0 * row_stride + d) =
                pack_bf16(o[n][4 * j] * i0, o[n][4 * j + 1] * i0);
          if (qpos1 < p.Sq)
            *reinterpret_cast<uint32_t*>(og + qpos1 * row_stride + d) =
                pack_bf16(o[n][4 * j + 2] * i1, o[n][4 * j + 3] * i1);
        }
      }
  }
}

// cuTensorMapEncodeTiled, a driver-API function, reached through the
// runtime so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The tensor map of a contiguous bf16 (B, S, heads, D) tensor, read in
// boxes of 64 columns x 1 head x `rows` positions x 1 batch, 128-byte
// swizzle, zeros out of bounds.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                  int B, int S, int heads, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * D;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {kGroupCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, int B,
                   int KV, int Sk, const Params& p, unsigned int blocks,
                   cudaStream_t stream, CUresult* map_err) {
  constexpr int smem = Smem<DP>::kBytes;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) {
    *map_err = CUDA_ERROR_NOT_FOUND;
    return cudaErrorUnknown;
  }
  CUtensorMap mq, mk, mv;
  CUresult r = make_map(encode, &mq, q, B, p.Sq, p.H, p.D, kBQ);
  if (r == CUDA_SUCCESS) r = make_map(encode, &mk, k, B, Sk, KV, p.D, kBK);
  if (r == CUDA_SUCCESS) r = make_map(encode, &mv, v, B, Sk, KV, p.D, kBK);
  if (r != CUDA_SUCCESS) {
    *map_err = r;
    return cudaErrorUnknown;
  }
  const cudaError_t set = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (set != cudaSuccess) return set;
  flash_fwd_sm90_kernel<DP><<<blocks, kThreads, smem, stream>>>(mq, mk, mv,
                                                                p);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded through ctypes.
//   q: (B, Sq, H, D), k and v: (B, Sk, KV, D), o: (B, Sq, H, D), all
//   contiguous bf16 on card `device`, each 16-byte aligned; D % 16 == 0 and
//   16 <= D <= 256.  causal is 0 or 1; window >= 0 (0 = none); cap >= 0
//   (0 = none).  stream is a cudaStream_t of that card.
// Returns 0, the launch's cudaError_t (> 0), or minus the CUresult of
// building a tensor map (< 0).
extern "C" int lcap_flash_attention_sm90(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int H, int KV, int Sq, int Sk, int D,
                                         int causal, int window, float scale,
                                         float cap, int device,
                                         void* stream) {
  const auto misaligned = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15u) != 0;
  };
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 ||
      D < 16 || D > 256 || D % 16 != 0 || window < 0 || cap < 0.f ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(o))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p;
  p.o = o;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.BH = B * H;
  p.n_q_tiles = (Sq + kBQ - 1) / kBQ;
  p.causal = causal ? 1 : 0;
  p.window = window;
  p.has_cap = cap > 0.f ? 1 : 0;
  p.scale_log2 = scale * kLog2e;
  p.cap_pre = cap > 0.f ? scale / cap : 0.f;
  p.cap_post = cap * kLog2e;
  const long long blocks = static_cast<long long>(B) * H * p.n_q_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int n = static_cast<unsigned int>(blocks);
  CUresult map_err = CUDA_SUCCESS;
  cudaError_t err;
  const int dp = (D + 63) / 64 * 64;
  if (dp == 64) {
    err = launch<64>(q, k, v, B, KV, Sk, p, n, s, &map_err);
  } else if (dp == 128) {
    err = launch<128>(q, k, v, B, KV, Sk, p, n, s, &map_err);
  } else if (dp == 192) {
    err = launch<192>(q, k, v, B, KV, Sk, p, n, s, &map_err);
  } else {
    err = launch<256>(q, k, v, B, KV, Sk, p, n, s, &map_err);
  }
  if (map_err != CUDA_SUCCESS) return -static_cast<int>(map_err);
  return static_cast<int>(err);
}

// Launches of flash_fwd_sm90_kernel on card `device` since this library was
// loaded or the count last reset, as the kernel counted them on the card;
// with reset != 0 the count restarts from 0.  Synchronises with the card's
// work.  Returns the count, or minus the cudaError_t of reading it.
extern "C" long long lcap_flash_attention_sm90_device_launches(int reset,
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
