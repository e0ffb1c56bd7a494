// Flash attention, forward only, for Hopper: both products on the tensor
// cores by wgmma (bf16 in, fp32 accumulate), fed by TMA tile loads through
// a ring of shared-memory buffers.
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
//   - Both products are wgmma.mma_async, each as wide as the tile allows.
//     S = Q.K^T is one m64nBKk16 per k16 step of D, Q and K read from
//     shared memory by descriptor (K-major, 128-byte swizzle).  O += P.V
//     is one m64nWk16 per k16 step of the kv tile, across the whole head
//     dim W: P from registers (the S accumulator fragment converted to
//     bf16 pairs in place is the A-register layout of the next product),
//     V from shared memory MN-major with the transpose flag, its column
//     groups BK * 128 bytes apart (the descriptor's leading offset).
//   - Loads are TMA (cp.async.bulk.tensor over a 4-d tensor map of the
//     (B, S, heads, D) layout), completing on mbarriers: Q once, then K
//     and V tiles into a ring whose stages release K and V apart.  Thread
//     0 issues the loads of K, thread 128 those of V, each at the start of
//     a step: the ones that step needs, waiting for their stages if it
//     must, and then the ones ahead whose stages are free, without
//     waiting.  The tensor map's out-of-bounds zero fill takes the place
//     of ragged-edge code: rows past Sq / Sk and columns past D arrive as
//     zeros.
//   - No producer warp: every warp of the block is one of WG warpgroups
//     of 64 q rows (2 or 3, 128 or 192 q rows a block).  A separate warp
//     would put three warps on one of the SM's four register-file
//     quarters and hold every thread to 168 registers; setmaxnreg lifts
//     that at run time, but ptxas then still checks the wgmma pipeline
//     against 168 and, past it, spills and serialises every wgmma (its
//     C7512 warning).  Two warpgroups alone get 255 registers a thread
//     (O, a score tile and P in flight at once); three get 168, enough
//     for O and one score tile at D <= 160.
//   - Each warpgroup runs its tiles one of two ways (Tile<W>::kOverlap).
//     Overlapped: step i issues tile i's Q.K^T and then tile i - 1's P.V
//     as two commit groups, rescales O under the first, and runs tile i's
//     softmax while the P.V runs on (wait_group 1); with kPingPong, named
//     barriers make the warpgroups issue their products in turn.  In
//     order: Q.K^T, softmax, P.V, one tile at a time, with the other
//     warpgroups' products filling the tensor cores meanwhile.
//   - The online softmax runs on the accumulator fragment in registers: a
//     row lives on the 4 lanes of a quad (two shuffles reduce it), exp2 by
//     ex2.approx with the scale and log2(e) folded into its multiply-add;
//     the softcap's tanh as 1 - 2 / (2^(2x log2 e) + 1), by ex2.approx and
//     rcp.approx.
//   - Only the tiles that need it are masked (the causal diagonal, the
//     window's edge, the Sk edge); tiles wholly above the diagonal or
//     before the window are never loaded.
//   - Blocks are numbered so that the q tiles with the most kv tiles (the
//     last ones, under a causal mask) start first.
//
// Instances: W = 64, 128, 160, 192, 224 and 256, the smallest that holds
// D (D 160 and 224 run as themselves, not padded to 192 and 256).  Shared
// memory holds each tile as ceil(W / 64) column groups of rows x 128 bytes
// in the 128-byte swizzle (TMA zero-fills a partial group); the products
// run W / 16 k16 steps and W columns.  Tile<W> sets each instance's
// warpgroups, kv tile rows, ring depth and schedule: the fastest of those
// measured on an H100 at the shapes of the port's models (chip_smoke.py
// phase 3), within what its registers and shared memory allow.

#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGroupCols = 64;  // bf16 columns in one 128-byte swizzle row
constexpr int kRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxCards = 64;  // cards whose attribute setting is cached

// Each instance's warpgroups (WG; 64 q rows each), kv tile rows (a
// multiple of 16, at most 128), ring depth, whether a warpgroup overlaps
// its softmax with its own products, and whether the warpgroups take
// turns issuing them (overlapped only).
template <int W>
struct Tile;
#define LCAP_TILE(W, WG, BK, STAGES, OVERLAP, PINGPONG) \
  template <>                                           \
  struct Tile<W> {                                      \
    static constexpr int kWG = WG;                      \
    static constexpr int kBQ = 64 * WG;                 \
    static constexpr int kThreads = 128 * WG;           \
    static constexpr int kBK = BK;                      \
    static constexpr int kStages = STAGES;              \
    static constexpr bool kOverlap = OVERLAP;           \
    static constexpr bool kPingPong = PINGPONG;         \
  };
//        W  WG   BK STAGES OVERLAP PINGPONG
LCAP_TILE(64, 3, 128, 2, true, true)
LCAP_TILE(128, 3, 128, 2, false, false)
LCAP_TILE(160, 3, 96, 2, false, false)
LCAP_TILE(192, 2, 96, 2, true, false)
LCAP_TILE(224, 2, 80, 2, true, false)
LCAP_TILE(256, 2, 64, 2, true, false)
#undef LCAP_TILE

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
  float cap_pre;     // 2 * scale * log2(e) / cap
  float cap_post;    // cap * log2(e)
  float cap_neg2;    // -2 * cap * log2(e)
};

// Byte offsets in the (1024-byte aligned) dynamic shared memory.
template <int W>
struct Smem {
  static constexpr int kBK = Tile<W>::kBK;
  static constexpr int kStages = Tile<W>::kStages;
  static constexpr int kGroups = (W + kGroupCols - 1) / kGroupCols;
  static constexpr int kQBytes = Tile<W>::kBQ * kGroups * kRowBytes;
  static constexpr int kKVBytes = kBK * kGroups * kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  // mbarriers (q full; k full, v full, k empty and v empty per stage) and
  // the slack to align the base to 1024 bytes
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block gets");
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

// Whether the phase of parity `parity` of the barrier has completed, without
// waiting.
__device__ __forceinline__ bool mbar_ready(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Named barriers 1 .. WG order the warpgroups' products in a ring: a group
// waits on its own (bar.sync: its 128 threads and the previous group's 128
// arrivals) and then arrives on the next group's.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
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
// address, leading byte offset `lead`, stride byte offset 1024 (one 8-row
// x 128-byte swizzle atom to the next), layout type 1 (128-byte swizzle).
// K-major operands (Q, K) read one 64-column group per k16 step, where the
// leading offset is not read; V, MN-major, spans the head dim's column
// groups, and its leading offset is the stride from one group to the next.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr,
                                              uint32_t lead = 1024) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The wgmma products of one width N (64 rows x N columns, k16 steps, fp32
// accumulator d of N / 2 registers a thread):
//   ss: D (+)= A * B^T, A and B read from shared memory by descriptor,
//       both K-major; scale_d = 0 overwrites D;
//   rs: D += A * B, A from registers in the accumulator's row layout, B
//       from shared memory, MN-major (the transpose flag set).
#define LCAP_D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
template <int N>
struct Mma;
template <>
struct Mma<64> {
  __device__ static void ss(float (&d)[32], uint64_t da, uint64_t db,
                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, "
        "0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : LCAP_D8(0), LCAP_D8(8), LCAP_D8(16), LCAP_D8(24)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  __device__ static void rs(float (&d)[32], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, "
        "0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
        "1, 1, 1;\n}\n"
        : LCAP_D8(0), LCAP_D8(8), LCAP_D8(16), LCAP_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Mma<80> {
  __device__ static void ss(float (&d)[40], uint64_t da, uint64_t db,
                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, "
        "0;\nwgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : LCAP_D8(0), LCAP_D8(8), LCAP_D8(16), LCAP_D8(24), LCAP_D8(32)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma<96> {
  __device__ static void ss(float (&d)[48], uint64_t da, uint64_t db,
                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, "
        "0;\nwgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, "
        "p, 1, 1, 0, 0;\n}\n"
        : LCAP_D8(0), LCAP_D8(8), LCAP_D8(16), LCAP_D8(24), LCAP_D8(32),
          LCAP_D8(40)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  __device__ static void ss(float (&d)[64], uint64_t da, uint64_t db,
                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, "
        "0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : LCAP_D8(0), LCAP_D8(8), LCAP_D8(16), LCAP_D8(24), LCAP_D8(32),
          LCAP_D8(40), LCAP_D8(48), LCAP_D8(56)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  __device__ static void rs(float (&d)[64], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, "
        "0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : LCAP_D8(0), LCAP_D8(8), LCAP_D8(16), LCAP_D8(24), LCAP_D8(32),
          LCAP_D8(40), LCAP_D8(48), LCAP_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Mma<160> {
  __device__ static void rs(float (&d)[80], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, "
        "0;\nwgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79}, {%80, %81, %82, %83}, %84, p, "
        "1, 1, 1;\n}\n"
        : LCAP_D8(0), LCAP_D8(8), LCAP_D8(16), LCAP_D8(24), LCAP_D8(32),
          LCAP_D8(40), LCAP_D8(48), LCAP_D8(56), LCAP_D8(64), LCAP_D8(72)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Mma<192> {
  __device__ static void rs(float (&d)[96], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, "
        "0;\nwgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, "
        "%97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : LCAP_D8(0), LCAP_D8(8), LCAP_D8(16), LCAP_D8(24), LCAP_D8(32),
          LCAP_D8(40), LCAP_D8(48), LCAP_D8(56), LCAP_D8(64), LCAP_D8(72),
          LCAP_D8(80), LCAP_D8(88)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Mma<224> {
  __device__ static void rs(float (&d)[112], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %117, "
        "0;\nwgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111}, {%112, %113, %114, %115}, %116, p, "
        "1, 1, 1;\n}\n"
        : LCAP_D8(0), LCAP_D8(8), LCAP_D8(16), LCAP_D8(24), LCAP_D8(32),
          LCAP_D8(40), LCAP_D8(48), LCAP_D8(56), LCAP_D8(64), LCAP_D8(72),
          LCAP_D8(80), LCAP_D8(88), LCAP_D8(96), LCAP_D8(104)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Mma<256> {
  __device__ static void rs(float (&d)[128], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, "
        "0;\nwgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : LCAP_D8(0), LCAP_D8(8), LCAP_D8(16), LCAP_D8(24), LCAP_D8(32),
          LCAP_D8(40), LCAP_D8(48), LCAP_D8(56), LCAP_D8(64), LCAP_D8(72),
          LCAP_D8(80), LCAP_D8(88), LCAP_D8(96), LCAP_D8(104), LCAP_D8(112),
          LCAP_D8(120)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

#undef LCAP_D8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S = Q.K^T of one kv tile: the warpgroup's 64 q rows against the tile's
// BK rows, one m64nBKk16 product per k16 step of W (issued, not waited
// for).  Steps past D multiply the zeros TMA filled in.
template <int W, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2],
                                         uint32_t q_rows, uint32_t k_tile) {
  constexpr int kBQ = Tile<W>::kBQ;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    // column group kk / 4, 32 bytes into its swizzled rows per step
    const uint32_t at = (kk % 4) * 32;
    Mma<BK>::ss(sc, smem_desc(q_rows + (kk / 4) * kBQ * kRowBytes + at),
                smem_desc(k_tile + (kk / 4) * BK * kRowBytes + at), kk > 0);
  }
}

// O += P.V of one kv tile, P from registers: one m64nWk16 product per k16
// step of the tile, across every column group of V (issued, not waited
// for).
template <int W, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[W / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Mma<W>::rs(o, pa[kk],
               smem_desc(v_tile + kk * 16 * kRowBytes, BK * kRowBytes));
}

// The running softmax state of a thread's two rows (qpos0, qpos0 + 8).
struct RowState {
  float m0, m1;  // running max, log2 units
  float l0, l1;  // this thread's share of the denominators
};

// Scores of the kv tile starting at k0 -> probabilities, in place: scale
// (and softcap) into log2 units, the mask where the tile needs one, the
// new row max, exp2 (the scale folded into its multiply-add where it can
// be).  Updates the row state and returns the factors c0, c1
// by which the output rows must be rescaled.  Element j of the fragment
// lies in row qpos0 (j & 2 == 0) or qpos0 + 8, column k0 + 8 (j / 4) +
// col + (j & 1); a row's values span the 4 lanes of a quad.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             const Params& p, int k0, int wq,
                                             int qpos0, int col,
                                             RowState& st, float& c0,
                                             float& c1) {
  constexpr int kS = BK / 2;
  // the factor that takes a score to log2 units inside the exp2's fused
  // multiply-add: the scale, when it is positive and there is no cap (the
  // max of the raw scores times the scale is then the max of the scaled
  // ones), else 1 with the scores scaled first
  float mul = 1.f;
  if (p.has_cap) {
    // cap log2(e) tanh(x) = cap log2(e) (1 - 2 / (e^(2x) + 1)), x = s / cap
#pragma unroll
    for (int j = 0; j < kS; ++j)
      sc[j] = fmaf(p.cap_neg2, rcp(ex2(sc[j] * p.cap_pre) + 1.f),
                   p.cap_post);
  } else if (p.scale_log2 > 0.f) {
    mul = p.scale_log2;
  } else {
#pragma unroll
    for (int j = 0; j < kS; ++j) sc[j] *= p.scale_log2;
  }
  // only a tile that crosses the diagonal, the window's edge or Sk; 63 is
  // the last of the warpgroup's 64 rows
  const bool edge = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > wq) ||
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
  // row maxima and sums over two partials a row (element j into j & 3:
  // row j & 2, partial j & 1), so no chain of dependent adds runs the
  // whole row
  float tm[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kS; ++j) tm[j & 3] = fmaxf(tm[j & 3], sc[j]);
  float t0 = fmaxf(tm[0], tm[1]), t1 = fmaxf(tm[2], tm[3]);
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
  const float n0 = fmaxf(st.m0, t0 * mul);
  const float n1 = fmaxf(st.m1, t1 * mul);
  // a row with nothing visible yet subtracts 0, so exp2 gives 0, not NaN
  const float u0 = n0 == -INFINITY ? 0.f : n0;
  const float u1 = n1 == -INFINITY ? 0.f : n1;
  c0 = ex2(st.m0 - u0);
  c1 = ex2(st.m1 - u1);
  st.m0 = n0;
  st.m1 = n1;
  float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    sc[j] = ex2(fmaf(sc[j], mul, -((j & 2) ? u1 : u0)));
    r[j & 3] += sc[j];
  }
  st.l0 = st.l0 * c0 + (r[0] + r[1]);
  st.l1 = st.l1 * c1 + (r[2] + r[3]);
}

// P as the A operand of P.V: the accumulator's columns 16 kk .. 16 kk + 15
// are its 8-column chunks 2 kk and 2 kk + 1, and that is the A-register
// layout of a k16 step.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// W: D rounded up to an instance's width.
template <int W>
__global__ void __launch_bounds__(Tile<W>::kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const Params p) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_device_launches, 1ull);
  using L = Smem<W>;
  constexpr int kWG = Tile<W>::kWG;
  constexpr int kBQ = Tile<W>::kBQ;
  constexpr int BK = L::kBK;
  constexpr int kStages = L::kStages;
  constexpr bool kOverlap = Tile<W>::kOverlap;
  constexpr bool kPingPong = Tile<W>::kPingPong && kOverlap;
  // how many steps after its K a tile's V is read
  constexpr int kVLag = kOverlap ? 1 : 0;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base + L::kQ;
  const uint32_t s_k = base + L::kK;
  const uint32_t s_v = base + L::kV;
  // mbarriers, 8 bytes each: q full; then per stage k full, v full, k
  // empty, v empty
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_k = bar_q + 8;
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_ke = bar_v + 8 * kStages;
  const uint32_t bar_ve = bar_ke + 8 * kStages;

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
  const int t_lo = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi + BK - 1) / BK - t_lo : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ke + 8 * s, 4 * kWG);  // one arrival per warp
      mbar_init(bar_ve + 8 * s, 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues the loads of Q and K, thread 128 those of V, ahead of
  // the products that read them: Q once; at the start of step i (which
  // issues tile i's Q.K^T, and P.V of tile i - kVLag) K of tile i and V of
  // tile i - kVLag, waiting for their stages to be released if it must,
  // and then as many more (up to kStages tiles ahead) as have a released
  // stage: a warpgroup never waits here for another to release a stage
  // it does not need yet
  int next_k = 0, next_v = 0;
  const auto issue_loads = [&](int step) {
    if (threadIdx.x == 0) {
      for (; next_k < min(n_tiles, step + kStages); ++next_k) {
        const int s = next_k % kStages;
        const uint32_t parity = ((next_k / kStages) & 1) ^ 1;
        if (next_k > step && !mbar_ready(bar_ke + 8 * s, parity)) break;
        mbar_wait(bar_ke + 8 * s, parity);
        mbar_expect_tx(bar_k + 8 * s, L::kKVBytes);
#pragma unroll
        for (int g = 0; g < L::kGroups; ++g)
          tma_load_4d(s_k + s * L::kKVBytes + g * BK * kRowBytes, &tm_k,
                      bar_k + 8 * s, g * kGroupCols, kvh,
                      (t_lo + next_k) * BK, b);
      }
    } else if (threadIdx.x == 128) {
      for (; next_v < min(n_tiles, step + kStages - kVLag); ++next_v) {
        const int s = next_v % kStages;
        const uint32_t parity = ((next_v / kStages) & 1) ^ 1;
        if (next_v > step - kVLag && !mbar_ready(bar_ve + 8 * s, parity))
          break;
        mbar_wait(bar_ve + 8 * s, parity);
        mbar_expect_tx(bar_v + 8 * s, L::kKVBytes);
#pragma unroll
        for (int g = 0; g < L::kGroups; ++g)
          tma_load_4d(s_v + s * L::kKVBytes + g * BK * kRowBytes, &tm_v,
                      bar_v + 8 * s, g * kGroupCols, kvh,
                      (t_lo + next_v) * BK, b);
      }
    }
    __syncwarp();
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g)
      tma_load_4d(s_q + g * kBQ * kRowBytes, &tm_q, bar_q, g * kGroupCols, h,
                  q0, b);
  }

  // ---- WG warpgroups of 64 q rows each
  const int cw = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wq = q0 + 64 * cw;                  // first row of this group
  const int qpos0 = wq + 16 * warp + lane / 4;  // rows of this thread:
  const int qpos1 = qpos0 + 8;                  // qpos0 and qpos0 + 8
  const int col = 2 * (lane % 4);  // its first column in each 8 columns

  float o[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];
  RowState st = {-INFINITY, -INFINITY, 0.f, 0.f};
  const uint32_t q_rows = s_q + cw * 64 * kRowBytes;

  // a warp's lane 0 releases a stage's K or V once the products that
  // read it have completed
  const auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // with kPingPong the groups issue their products in turn: the last
  // group lets group 0 go first, and its own last issue arrives nowhere
  // (each group's barrier then sees as many arrivals as waits)
  int issues_left = n_tiles + 1;
  const auto turn_begin = [&]() {
    if (kPingPong) named_sync(1 + cw);
  };
  const auto turn_end = [&]() {
    if (kPingPong && (--issues_left > 0 || cw < kWG - 1))
      named_arrive(1 + (cw + 1) % kWG);
  };

  mbar_wait(bar_q, 0);
  if (!kOverlap) {
    // one tile at a time: Q.K^T, its softmax, its P.V; the warpgroups
    // interleave on the tensor cores by themselves
    float c0, c1;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      issue_loads(i);
      mbar_wait(bar_k + 8 * s, parity);
      wgmma_fence();
      issue_qk<W, BK>(sc, q_rows, s_k + s * L::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      release(bar_ke + 8 * s);
      softmax_tile<BK>(sc, p, (t_lo + i) * BK, wq, qpos0, col, st, c0, c1);
#pragma unroll
      for (int j = 0; j < W / 2; ++j) o[j] *= (j & 2) ? c1 : c0;
      pack_p<BK>(pa, sc);
      mbar_wait(bar_v + 8 * s, parity);
      fence_regs(o);
      wgmma_fence();
      issue_pv<W, BK>(o, pa, s_v + s * L::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release(bar_ve + 8 * s);
    }
  } else if (n_tiles > 0) {
    if (kPingPong && cw == kWG - 1) named_arrive(1);
    issue_loads(0);
    mbar_wait(bar_k, 0);
    turn_begin();
    wgmma_fence();
    issue_qk<W, BK>(sc, q_rows, s_k);
    wgmma_commit();
    turn_end();
    wgmma_wait<0>();
    fence_regs(sc);
    release(bar_ke);
    float c0, c1;
    softmax_tile<BK>(sc, p, t_lo * BK, wq, qpos0, col, st, c0, c1);
    pack_p<BK>(pa, sc);
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int sp = (i - 1) % kStages;
      issue_loads(i);
      mbar_wait(bar_k + 8 * s, (i / kStages) & 1);
      mbar_wait(bar_v + 8 * sp, ((i - 1) / kStages) & 1);
      turn_begin();
      wgmma_fence();
      issue_qk<W, BK>(sc, q_rows, s_k + s * L::kKVBytes);
      wgmma_commit();
      // O to tile i - 1's max, while tile i's Q.K^T runs
#pragma unroll
      for (int j = 0; j < W / 2; ++j) o[j] *= (j & 2) ? c1 : c0;
      fence_regs(o);
      wgmma_fence();
      issue_pv<W, BK>(o, pa, s_v + sp * L::kKVBytes);
      wgmma_commit();
      turn_end();
      // tile i's scores, while tile i - 1's P.V runs on
      wgmma_wait<1>();
      fence_regs(sc);
      release(bar_ke + 8 * s);
      softmax_tile<BK>(sc, p, (t_lo + i) * BK, wq, qpos0, col, st, c0, c1);
      wgmma_wait<0>();
      fence_regs(o);
      release(bar_ve + 8 * sp);
      pack_p<BK>(pa, sc);
    }
    const int sl = (n_tiles - 1) % kStages;
    issue_loads(n_tiles);
    mbar_wait(bar_v + 8 * sl, ((n_tiles - 1) / kStages) & 1);
    turn_begin();
#pragma unroll
    for (int j = 0; j < W / 2; ++j) o[j] *= (j & 2) ? c1 : c0;
    fence_regs(o);
    wgmma_fence();
    issue_pv<W, BK>(o, pa, s_v + sl * L::kKVBytes);
    wgmma_commit();
    turn_end();
    wgmma_wait<0>();
    fence_regs(o);
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
  for (int j = 0; j < W / 8; ++j) {
    const int d = 8 * j + col;
    if (d < p.D) {
      if (qpos0 < p.Sq)
        *reinterpret_cast<uint32_t*>(og + qpos0 * row_stride + d) =
            pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
      if (qpos1 < p.Sq)
        *reinterpret_cast<uint32_t*>(og + qpos1 * row_stride + d) =
            pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
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

template <int W>
cudaError_t launch(const void* q, const void* k, const void* v, int B,
                   int KV, int Sk, Params p, int device, cudaStream_t stream,
                   CUresult* map_err) {
  constexpr int smem = Smem<W>::kBytes;
  constexpr int kBQ = Tile<W>::kBQ;
  p.n_q_tiles = (p.Sq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(p.BH) * p.n_q_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) {
    *map_err = CUDA_ERROR_NOT_FOUND;
    return cudaErrorUnknown;
  }
  CUtensorMap mq, mk, mv;
  CUresult r = make_map(encode, &mq, q, B, p.Sq, p.H, p.D, Tile<W>::kBQ);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &mk, k, B, Sk, KV, p.D, Tile<W>::kBK);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &mv, v, B, Sk, KV, p.D, Tile<W>::kBK);
  if (r != CUDA_SUCCESS) {
    *map_err = r;
    return cudaErrorUnknown;
  }
  // the instance's shared memory, set once per card
  static bool ready[kMaxCards] = {};
  const bool known = device >= 0 && device < kMaxCards;
  if (!known || !ready[device]) {
    const cudaError_t set = cudaFuncSetAttribute(
        flash_fwd_sm90_kernel<W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return set;
    if (known) ready[device] = true;
  }
  flash_fwd_sm90_kernel<W>
      <<<static_cast<unsigned int>(blocks), Tile<W>::kThreads, smem,
         stream>>>(mq, mk, mv, p);
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
  p.causal = causal ? 1 : 0;
  p.window = window;
  p.has_cap = cap > 0.f ? 1 : 0;
  p.scale_log2 = scale * kLog2e;
  p.cap_pre = cap > 0.f ? 2.f * scale * kLog2e / cap : 0.f;
  p.cap_post = cap * kLog2e;
  p.cap_neg2 = -2.f * cap * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUresult map_err = CUDA_SUCCESS;
  cudaError_t err;
  if (D <= 64) {
    err = launch<64>(q, k, v, B, KV, Sk, p, device, s, &map_err);
  } else if (D <= 128) {
    err = launch<128>(q, k, v, B, KV, Sk, p, device, s, &map_err);
  } else if (D <= 160) {
    err = launch<160>(q, k, v, B, KV, Sk, p, device, s, &map_err);
  } else if (D <= 192) {
    err = launch<192>(q, k, v, B, KV, Sk, p, device, s, &map_err);
  } else if (D <= 224) {
    err = launch<224>(q, k, v, B, KV, Sk, p, device, s, &map_err);
  } else {
    err = launch<256>(q, k, v, B, KV, Sk, p, device, s, &map_err);
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
