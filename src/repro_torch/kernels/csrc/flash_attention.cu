// Flash attention, forward only: softmax(q k^T * scale) v with an online
// softmax, so the (Sq, Sk) scores never reach device memory.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (launched by flash_attention_bhsd, wrapped by
// kernels/ops.py::flash_attention).  It computes the same function:
//   - scores in fp32, times `scale`, then gemma2's softcap
//     cap * tanh(s / cap) when cap > 0;
//   - causal masking top-left aligned (k_pos <= q_pos, both from 0), a
//     sliding window keeping k_pos > q_pos - window when window > 0, and
//     positions at or past Sq / Sk masked;
//   - GQA: query head h reads kv head h / (H / KV);
//   - a running max, denominator and accumulator in fp32, the output
//     rounded to q's type once; a fully masked row gives 0, not NaN.
// The TPU walked the kv blocks as a sequential grid dimension carrying
// scratch between steps; here one thread block owns a (batch*head, 64-row
// q tile) pair and walks the kv tiles in a loop, staging each 32-row K and
// V tile through shared memory.  Kv tiles wholly above the causal diagonal
// or wholly before the window are never visited.  q, k and v are read in
// the (B, S, heads, D) layout by strides, with no transposed copies; D may
// be anything up to 256 (tiles are zero-padded past D in shared memory).
//
// Thread layout: 256 threads, 4 per q row.  Thread (r, g) computes scores
// for kv columns g, g+4, ..., g+28 from float4 reads of shared memory (row
// stride = a multiple of 32 floats + 4, so the 8 rows of a warp hit
// distinct banks), reduces the row's max and sum over its 4 lanes by warp
// shuffles, and owns the float4 accumulator chunks 4g, 4g+16, ... of its
// row's output.
//
// Bound on this card (H100 SXM): 4*D FLOPs per visible (q, k) pair (two
// products of D multiply-adds), at 989 TFLOP/s bf16 on the tensor cores,
// or q, k, v and o moved once at 3.35 TB/s, whichever is larger.  At the
// serving path's shape (bf16, B 4, S 2048, H 32, KV 8, D 128, causal) that
// is 4*32*2048*2049/2 pairs * 512 FLOP = 137.5 GFLOP -> 0.139 ms, against
// 167.8 MB -> 0.050 ms: bound by compute.  This kernel runs its products
// on the CUDA cores in fp32, whose 67 TFLOP/s put a ceiling of 2.05 ms on
// the same work.  Moving both products onto the tensor cores (mma.sync or
// wgmma, bf16 in, fp32 accumulate) with TMA or cp.async loads of pipelined
// kv tiles removes that ceiling; that is the next kernel's work.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // q rows per block
constexpr int kBK = 32;         // kv rows per tile
constexpr int kThreads = 256;   // 4 threads per q row
constexpr int kCols = kBK / 4;  // score columns per thread
constexpr float kNegInf = -1e30f;

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

// Row stride of the shared tiles, in floats: a multiple of 32 plus 4.
__host__ __device__ __forceinline__ int tile_ld(int d) {
  return ((d + 31) / 32) * 32 + 4;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int d) {
  const int ld = tile_ld(d);
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * ld + 2 * static_cast<size_t>(kBK) * ld +
          static_cast<size_t>(kBQ) * (kBK + 1));
}

// DMAX: D rounded up to 64, 128 or 256; it sizes the accumulator.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_device_launches, 1ull);
  constexpr int kChunks = DMAX / 16;  // float4 accumulator chunks per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = tile_ld(p.D);
  const int dp = (p.D + 3) & ~3;  // D rounded up to a float4
  float* qs = smem;               // [kBQ][ld]
  float* ks = qs + kBQ * ld;      // [kBK][ld]
  float* vs = ks + kBK * ld;      // [kBK][ld]
  float* ps = vs + kBK * ld;      // [kBQ][kBK + 1] probabilities

  const int tile = blockIdx.x % p.n_q_tiles;
  const int bh = blockIdx.x / p.n_q_tiles;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = tile * kBQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // q row of this thread within the tile
  const int g = tid & 3;   // its lane within the row's 4
  const int qpos = q0 + r;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < kBQ * dp; i += kThreads) {
    const int row = i / dp;
    const int d = i - row * dp;
    const int pos = q0 + row;
    qs[row * ld + d] =
        (pos < p.Sq && d < p.D) ? to_float(qg[pos * p.q_ss + d]) : 0.f;
  }

  // kv positions any row of this tile can see
  int k_lo = 0;
  int k_hi = p.Sk;
  if (p.causal) k_hi = min(k_hi, min(q0 + kBQ, p.Sq));
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);

  float4 acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf;
  float l = 0.f;

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = tid; i < kBK * dp; i += kThreads) {
      const int row = i / dp;
      const int d = i - row * dp;
      const int pos = k0 + row;
      const bool in = pos < p.Sk && d < p.D;
      ks[row * ld + d] = in ? to_float(kg[pos * p.k_ss + d]) : 0.f;
      vs[row * ld + d] = in ? to_float(vg[pos * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
    const float* qrow = qs + r * ld;
    for (int d = 0; d < dp; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float4 c =
            *reinterpret_cast<const float4*>(ks + (g + 4 * j) * ld + d);
        s[j] += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
      }
    }

    unsigned ok_bits = 0;
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kpos = k0 + g + 4 * j;
      bool ok = kpos < p.Sk && qpos < p.Sq;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && kpos > qpos - p.window;
      float x = s[j] * p.scale;
      if (p.cap > 0.f) x = tanhf(x / p.cap) * p.cap;
      s[j] = ok ? x : kNegInf;
      ok_bits |= static_cast<unsigned>(ok) << j;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    float* prow = ps + r * (kBK + 1);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float pj = ((ok_bits >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      prow[g + 4 * j] = pj;
      psum += pj;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
    __syncwarp();  // a row's 4 lanes share one warp: its p row is written

    for (int c = 0; c < kBK; ++c) {
      const float pc = prow[c];
      const float* vrow = vs + c * ld;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int d = 16 * i + 4 * g;
        if (d < dp) {
          const float4 w = *reinterpret_cast<const float4*>(vrow + d);
          acc[i].x += pc * w.x;
          acc[i].y += pc * w.y;
          acc[i].z += pc * w.z;
          acc[i].w += pc * w.w;
        }
      }
    }
  }

  // out = acc / l (l == 0 on a fully masked row: out = 0), staged through
  // the q tile's shared memory so the store is coalesced
  __syncthreads();
  const float denom = (l == 0.f) ? 1.f : l;
  float* orow = qs + r * ld;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int d = 16 * i + 4 * g;
    if (d < dp) {
      *reinterpret_cast<float4*>(orow + d) =
          make_float4(acc[i].x / denom, acc[i].y / denom, acc[i].z / denom,
                      acc[i].w / denom);
    }
  }
  __syncthreads();
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int i = tid; i < kBQ * p.D; i += kThreads) {
    const int row = i / p.D;
    const int d = i - row * p.D;
    const int pos = q0 + row;
    if (pos < p.Sq) og[pos * p.o_ss + d] = from_float<T>(qs[row * ld + d]);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const Params& p, long long blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  const cudaError_t set = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return set;
  flash_fwd_kernel<T, DMAX><<<static_cast<unsigned int>(blocks), kThreads,
                              smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_d(const Params& p, long long blocks,
                         cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64>(p, blocks, stream);
  if (p.D <= 128) return launch<T, 128>(p, blocks, stream);
  return launch<T, 256>(p, blocks, stream);
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
  p.n_q_tiles = (Sq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(B) * H * p.n_q_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_for_d<float>(p, blocks, s)
                              : launch_for_d<__nv_bfloat16>(p, blocks, s);
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
