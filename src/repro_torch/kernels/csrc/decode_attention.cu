// Decode attention split over the cache's slots ("flash-decoding"), on the
// CUDA cores: one query token a sequence against its KV cache,
// softmax(q k^T * scale) v over the slots that token can see.
//
// Replaces no TPU kernel.  The reference's decode attention is jnp einsums
// whose converts XLA fuses (src/repro/models/layers.py:104-112,
// `decode_attention`); the port ran the same einsums eagerly in float32
// (`attention_core_naive`), which copied the whole bf16 cache to float32
// and built a position tensor and an additive mask in every layer of every
// step.  This kernel computes that function in one pass over the cache:
//   - scores fp32(q) . fp32(k) * scale, then gemma2's softcap
//     cap * tanh(s / cap) when cap > 0, then the mask;
//   - an online softmax in fp32; P . V with P in fp32 (never rounded to
//     bf16); the output rounded once to q's type;
//   - the mask is computed here from `pos` with the rule of the model's
//     `_decode_k_pos` + `_mask_bias`: causal over a linear cache (slots
//     0..pos), a sliding window over a linear cache (pos - window + 1..pos),
//     a ring buffer of `window` slots (slots 0..min(pos, window - 1): every
//     slot once the ring has wrapped).  Slots no position can see are
//     never read.  A sequence with nothing visible gives 0.
//   - GQA: query head h reads kv head h / (H / KV).
//
// Bound on this card (H100 SXM, 3.35 TB/s): bytes.  A step reads each
// visible K and V row once; the arithmetic is 4 FLOP a bf16 cache byte
// at G = 4 query heads a kv head, against the card's float32 balance of
// about 20 (67 TFLOP/s over 3.35 TB/s), so CUDA-core FMAs suffice and the
// design's whole job is keeping enough bytes in flight:
//
// - One block per (split, kv head, sequence): the slots a sequence can see
//   are cut into `splits` equal ranges, so that B * KV * splits blocks fill
//   the card about twice over (the wrapper's choice, from the shapes).  A
//   block loads its kv head's G query rows once, pre-scaled (and times
//   log2(e), so exponentials are exp2), into registers: every K and V byte
//   it reads from device memory serves all G heads.  G above 8 takes
//   heads in chunks of at most 8, one chunk a block.
// - A ring of 4 shared-memory stages of 16 KB (K and V rows of one tile),
//   filled by cp.async 16 bytes a copy (rows past the range zero-filled):
//   up to four tiles in flight a block, three blocks an SM, some 190 KB an
//   SM.  Each thread copies exactly the 16-byte pieces it later reads, so
//   no barrier is needed inside the loop: warps stream independently.
// - A row group of LPR lanes (D / 8 for bf16 rounded up to 8, 16 or 32)
//   holds one cache row across its lanes, 16 bytes a lane; the partial
//   dot products reduce by xor shuffles inside the group, so every lane
//   has the row's G scores.  Each row group keeps its own running max,
//   denominator and accumulator (G x its lanes' columns), rescaled once a
//   tile; the groups merge through shared memory once at the end.
// - One split: the block writes the normalised output.  Several: each
//   block writes float32 partials (max, denominator, accumulator) and
//   `decode_attn_merge_kernel` combines them (two launches a layer).
// Unaligned rows (D % 8 != 0 in bf16, D % 4 != 0 in float32, or a base or
// stride off 16 bytes) are loaded element by element instead, the same
// arithmetic otherwise.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;  // the K and V rows of one tile
constexpr int kMaxHeads = 8;        // query heads a block
constexpr float kLog2e = 1.4426950408889634f;

// Launches of decode_attn_kernel that reached the card, counted by the
// kernel itself (block (0, 0, 0), thread 0 adds one).
__device__ unsigned long long g_device_launches;

struct Params {
  const void* q;    // (B, 1, H, D), float32 or bf16 (q_bf16)
  const void* k;    // (B, S, KV, D) of T, unit stride along D
  const void* v;
  const void* pos;  // (B,) int32 or int64 (pos64)
  void* o;          // (B, 1, H, D) contiguous, q's type
  float* part;      // splits > 1: accumulators, then (max, sum) pairs
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int B, H, KV, S, D;
  int G;    // query heads a kv head
  int GS;   // query heads a block (<= kMaxHeads)
  int HC;   // head chunks a kv head: ceil(G / GS)
  int NS;   // splits
  int window, ring, pos64, q_bf16, vec;
  float qscale;  // scale, times log2(e) when cap == 0
  float cap;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory as floats: 8 bf16 or 4 float32.
__device__ __forceinline__ void unpack(const __nv_bfloat16* src, float* f) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const float* src, float* f) {
  const float4 w = *reinterpret_cast<const float4*>(src);
  f[0] = w.x;
  f[1] = w.y;
  f[2] = w.z;
  f[3] = w.w;
}

// An instance: cache type T, LPR lanes a row (a power of 2), NV 16-byte
// pieces a lane, GM query heads a block at most.
template <typename T, int LPR, int NV, int GM>
struct Inst {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kDP = LPR * NV * kVec;   // row width in shared memory
  static constexpr int kGroups = kThreads / LPR;  // row groups a block
  static constexpr int kRowBytes = 2 * kDP * static_cast<int>(sizeof(T));
  static constexpr int kR =  // rows a group a tile
      kStageBytes / kRowBytes / kGroups > 0
          ? kStageBytes / kRowBytes / kGroups : 1;
  static constexpr int kRows = kGroups * kR;  // rows a tile
  static constexpr size_t kSmem =
      static_cast<size_t>(kStages) * kRows * kRowBytes;
  // the groups' merge reuses the ring
  static constexpr size_t kMergeBytes =
      sizeof(float) * (static_cast<size_t>(kGroups) * GM * kDP +
                       2 * kGroups * GM);
  static_assert(kMergeBytes <= kSmem, "merge space exceeds the ring");
  static_assert(32 % LPR == 0, "a row group lies inside one warp");
};

// Three blocks an SM fit the shared memory; at 8 heads a block the
// registers hold two.
template <typename T, int LPR, int NV, int GM>
__global__ void __launch_bounds__(kThreads, GM <= 4 ? 3 : 2)
    decode_attn_kernel(const Params p) {
  using I = Inst<T, LPR, NV, GM>;
  constexpr int kVec = I::kVec, kDP = I::kDP, kGroups = I::kGroups;
  constexpr int kR = I::kR, kRows = I::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [stage][K, V][row][kDP]

  const int split = blockIdx.x, y = blockIdx.y, b = blockIdx.z;
  if (split == 0 && y == 0 && b == 0 && threadIdx.x == 0)
    atomicAdd(&g_device_launches, 1ull);
  const int kvh = y / p.HC;
  const int g0 = (y % p.HC) * p.GS;       // first query head in the group
  const int ng = min(p.GS, p.G - g0);     // query heads of this block
  const int sub = threadIdx.x % LPR;      // lane in the row group
  const int grp = threadIdx.x / LPR;      // row group
  const int D = p.D;

  // the slots this sequence sees, and this split's share of them
  const long long pb = p.pos64 ? static_cast<const long long*>(p.pos)[b]
                               : static_cast<const int*>(p.pos)[b];
  const long long hi = pb < p.S - 1 ? pb : p.S - 1;
  long long lo = 0;
  if (p.window > 0 && !p.ring && pb - p.window + 1 > 0)
    lo = pb - p.window + 1;
  const long long len = hi >= lo ? hi - lo + 1 : 0;
  const long long chunk = (len + p.NS - 1) / p.NS;
  const long long start = lo + split * chunk;
  const long long stop = start + chunk < hi + 1 ? start + chunk : hi + 1;
  const int n = stop > start ? static_cast<int>(stop - start) : 0;

  // this lane's columns: piece c = sub + LPR * j holds columns
  // [c * kVec, c * kVec + kVec)
  bool has[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) has[j] = (sub + LPR * j) * kVec < D;

  float q[GM][NV][kVec];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    const long long qo =
        b * p.q_sb + static_cast<long long>(kvh * p.G + g0 + g) * p.q_sh;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int d = (sub + LPR * j) * kVec + e;
        float x = 0.f;
        if (g < ng && d < D)
          x = p.q_bf16 ? __bfloat162float(
                             static_cast<const __nv_bfloat16*>(p.q)[qo + d])
                       : static_cast<const float*>(p.q)[qo + d];
        q[g][j][e] = x * p.qscale;
      }
  }

  const T* gk = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* gv = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // copies this thread's pieces of tile t into stage st
  auto issue = [&](int t, int st) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = grp + kGroups * i;
      const int row = t * kRows + r;
      const bool in = row < n;
      const long long slot = start + (in ? row : 0);
      T* dk = ring + (static_cast<size_t>(2 * st) * kRows + r) * kDP;
      T* dv = dk + static_cast<size_t>(kRows) * kDP;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!has[j]) continue;
        const int c0 = (sub + LPR * j) * kVec;
        const T* sk = gk + slot * p.k_ss + c0;
        const T* sv = gv + slot * p.v_ss + c0;
        if (p.vec) {
          cp_async16(dk + c0, sk, in);
          cp_async16(dv + c0, sv, in);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const bool ok = in && c0 + e < D;
            dk[c0 + e] = ok ? sk[e] : T(0.f);
            dv[c0 + e] = ok ? sv[e] : T(0.f);
          }
        }
      }
    }
  };

  float acc[GM][NV][kVec];
  float m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][j][e] = 0.f;
  }

  const int n_tiles = (n + kRows - 1) / kRows;
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < n_tiles) issue(st, st);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    cp_async_wait<kStages - 1>();
    const T* tk = ring + static_cast<size_t>(2 * st) * kRows * kDP;
    const T* tv = tk + static_cast<size_t>(kRows) * kDP;

    float s[kR][GM];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = grp + kGroups * i;
      float part[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) part[g] = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!has[j]) continue;
        float kf[kVec];
        unpack(tk + r * kDP + (sub + LPR * j) * kVec, kf);
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < kVec; ++e) part[g] += q[g][j][e] * kf[e];
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off /= 2)
#pragma unroll
        for (int g = 0; g < GM; ++g)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      const bool valid = t * kRows + r < n;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float x = part[g];
        if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap) * kLog2e;
        s[i][g] = valid ? x : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mt = m[g];
#pragma unroll
      for (int i = 0; i < kR; ++i) mt = fmaxf(mt, s[i][g]);
      const float base = mt == -INFINITY ? 0.f : mt;
      const float alpha = fast_exp2(m[g] - base);
      m[g] = mt;
      l[g] *= alpha;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][j][e] *= alpha;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        s[i][g] = fast_exp2(s[i][g] - base);
        l[g] += s[i][g];
      }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = grp + kGroups * i;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!has[j]) continue;
        float vf[kVec];
        unpack(tv + r * kDP + (sub + LPR * j) * kVec, vf);
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[g][j][e] += s[i][g] * vf[e];
      }
    }
    // the stage is read: refill it with the tile kStages ahead
    if (t + kStages < n_tiles) issue(t + kStages, st);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the row groups: each rescaled to the block's max
  float* red = reinterpret_cast<float*>(smem);  // [group][GM][kDP]
  float* red_m = red + kGroups * GM * kDP;      // [group][GM]
  float* red_l = red_m + kGroups * GM;
  if (sub == 0)
#pragma unroll
    for (int g = 0; g < GM; ++g) red_m[grp * GM + g] = m[g];
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    float mb = -INFINITY;
    for (int i = 0; i < kGroups; ++i) mb = fmaxf(mb, red_m[i * GM + g]);
    const float f = fast_exp2(m[g] - (mb == -INFINITY ? 0.f : mb));
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        red[(grp * GM + g) * kDP + (sub + LPR * j) * kVec + e] =
            acc[g][j][e] * f;
    if (sub == 0) red_l[grp * GM + g] = l[g] * f;
  }
  __syncthreads();

  const long long unit =  // this block's (sequence, head group, split)
      (static_cast<long long>(b) * p.KV * p.HC + y) * p.NS + split;
  for (int idx = threadIdx.x; idx < ng * D; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    float a = 0.f, sum = 0.f, mb = -INFINITY;
    for (int i = 0; i < kGroups; ++i) {
      a += red[(i * GM + g) * kDP + d];
      sum += red_l[i * GM + g];
      mb = fmaxf(mb, red_m[i * GM + g]);
    }
    if (p.NS == 1) {
      const float x = sum > 0.f ? a / sum : 0.f;
      const long long oi =
          (static_cast<long long>(b) * p.H + kvh * p.G + g0 + g) * D + d;
      if (p.q_bf16)
        static_cast<__nv_bfloat16*>(p.o)[oi] = __float2bfloat16_rn(x);
      else
        static_cast<float*>(p.o)[oi] = x;
    } else {
      const long long pi = unit * p.GS + g;
      p.part[pi * D + d] = a;
      if (d == 0) {
        const long long mi =
            static_cast<long long>(p.B) * p.KV * p.HC * p.NS * p.GS * D;
        p.part[mi + 2 * pi] = mb;
        p.part[mi + 2 * pi + 1] = sum;
      }
    }
  }
}

// Combines the splits' partials: one thread per (sequence, head, column).
__global__ void __launch_bounds__(256) decode_attn_merge_kernel(
    const Params p) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(p.B) * p.H * p.D;
  if (idx >= total) return;
  const int d = static_cast<int>(idx % p.D);
  const long long bh = idx / p.D;
  const int h = static_cast<int>(bh % p.H);
  const long long b = bh / p.H;
  const int kvh = h / p.G, gg = h % p.G;
  const int y = kvh * p.HC + gg / p.GS, g = gg % p.GS;
  const long long first = ((b * p.KV * p.HC + y) * p.NS) * p.GS + g;
  const float* ml =
      p.part + static_cast<long long>(p.B) * p.KV * p.HC * p.NS * p.GS * p.D;
  float mb = -INFINITY;
  for (int s = 0; s < p.NS; ++s)
    mb = fmaxf(mb, ml[2 * (first + static_cast<long long>(s) * p.GS)]);
  const float base = mb == -INFINITY ? 0.f : mb;
  float num = 0.f, den = 0.f;
  for (int s = 0; s < p.NS; ++s) {
    const long long pi = first + static_cast<long long>(s) * p.GS;
    const float w = fast_exp2(ml[2 * pi] - base);
    num += w * p.part[pi * p.D + d];
    den += w * ml[2 * pi + 1];
  }
  const float x = den > 0.f ? num / den : 0.f;
  if (p.q_bf16)
    static_cast<__nv_bfloat16*>(p.o)[idx] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p.o)[idx] = x;
}

template <typename T, int LPR, int NV, int GM>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using I = Inst<T, LPR, NV, GM>;
  const cudaError_t set = cudaFuncSetAttribute(
      decode_attn_kernel<T, LPR, NV, GM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(I::kSmem));
  if (set != cudaSuccess) return set;
  const dim3 grid(p.NS, p.KV * p.HC, p.B);
  decode_attn_kernel<T, LPR, NV, GM><<<grid, kThreads, I::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// 4 heads a block or 8: fewer heads leave some registers and FMAs idle,
// which a kernel bound by bytes does not feel, and halve the instances
template <typename T, int LPR, int NV>
cudaError_t launch_for_g(const Params& p, cudaStream_t stream) {
  if (p.GS <= 4) return launch<T, LPR, NV, 4>(p, stream);
  return launch<T, LPR, NV, 8>(p, stream);
}

template <typename T>
cudaError_t launch_for_d(const Params& p, cudaStream_t stream);

// bf16: 8 columns a lane; D <= 64, 128, 256 on 8, 16, 32 lanes a row
template <>
cudaError_t launch_for_d<__nv_bfloat16>(const Params& p,
                                        cudaStream_t stream) {
  if (p.D <= 64) return launch_for_g<__nv_bfloat16, 8, 1>(p, stream);
  if (p.D <= 128) return launch_for_g<__nv_bfloat16, 16, 1>(p, stream);
  return launch_for_g<__nv_bfloat16, 32, 1>(p, stream);
}

// float32: 4 columns a piece; D <= 64, 128 on 16, 32 lanes, 256 on 32
// lanes of two pieces each
template <>
cudaError_t launch_for_d<float>(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch_for_g<float, 16, 1>(p, stream);
  if (p.D <= 128) return launch_for_g<float, 32, 1>(p, stream);
  return launch_for_g<float, 32, 2>(p, stream);
}

bool aligned16(const void* ptr, long long sb, long long ss, long long sh,
               int D, int esize) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (sb * esize) % 16 == 0 && (ss * esize) % 16 == 0 &&
         (sh * esize) % 16 == 0 && (static_cast<long long>(D) * esize) % 16 == 0;
}

}  // namespace

// C entry point, loaded through ctypes.
//   q: (B, 1, H, D) of q_dtype; k and v: (B, S, KV, D) of cache_dtype
//   (0 = float32, 1 = bfloat16), each with unit stride along D; strides[8]
//   holds the element strides q (batch, head), k (batch, slot, head) and v
//   (batch, slot, head); pos: (B,) int32 (pos64 = 0) or int64; o: (B, 1, H,
//   D) contiguous, of q_dtype; part: float32 scratch of
//   B * KV * ceil(H / KV / 8) * splits * min(H / KV, 8) * (D + 2) elements
//   when splits > 1 (else unused).  window >= 0 (0 = none); ring != 0 for
//   a ring buffer of window == S slots; cap >= 0 (0 = none).  stream is a
//   cudaStream_t of card `device`.  One launch, or two with splits > 1.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int lcap_decode_attention(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    float* part, const long long* strides, int B, int H, int KV, int S,
    int D, int splits, int window, int ring, float scale, float cap,
    int cache_dtype, int q_dtype, int pos64, int device, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || D < 1 ||
      D > 256 || splits < 1 || window < 0 || cap < 0.f ||
      (ring && window != S) || (cache_dtype != 0 && cache_dtype != 1) ||
      (q_dtype != 0 && q_dtype != 1) || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.pos = pos;
  p.o = o;
  p.part = part;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.k_sb = strides[2];
  p.k_ss = strides[3];
  p.k_sh = strides[4];
  p.v_sb = strides[5];
  p.v_ss = strides[6];
  p.v_sh = strides[7];
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.D = D;
  p.G = H / KV;
  p.HC = (p.G + kMaxHeads - 1) / kMaxHeads;
  p.GS = (p.G + p.HC - 1) / p.HC;
  p.NS = splits;
  p.window = window;
  p.ring = ring ? 1 : 0;
  p.pos64 = pos64 ? 1 : 0;
  p.q_bf16 = q_dtype;
  p.cap = cap;
  p.qscale = cap > 0.f ? scale : scale * kLog2e;
  if (static_cast<long long>(KV) * p.HC > 65535 || B > 65535 ||
      static_cast<long long>(B) * H * D > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = cache_dtype == 1 ? 2 : 4;
  p.vec = aligned16(k, p.k_sb, p.k_ss, p.k_sh, D, esize) &&
          aligned16(v, p.v_sb, p.v_ss, p.v_sh, D, esize);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cache_dtype == 1 ? launch_for_d<__nv_bfloat16>(p, s)
                                     : launch_for_d<float>(p, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * H * D;
  decode_attn_merge_kernel<<<static_cast<unsigned>((total + 255) / 256), 256,
                             0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launches of decode_attn_kernel on card `device` since this library was
// loaded or the count last reset, as the kernel counted them on the card;
// with reset != 0 the count restarts from 0.  Synchronises with the card's
// work.  Returns the count, or minus the cudaError_t of reading it.
extern "C" long long lcap_decode_attention_device_launches(int reset,
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
