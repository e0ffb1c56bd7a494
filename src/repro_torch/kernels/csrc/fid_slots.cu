// FID-slot routing: the shard slot of every changelog record's target FID.
//
// Replaces the Pallas kernel src/repro/kernels/stream_ops.py::_slots_kernel
// (launched by fid_slots_pallas).  The function is cluster.fid_slot:
//     z = seq*C1 ^ oid*C2 ^ ver*MIX
//     z = (z ^ z>>30) * C1;  z = (z ^ z>>27) * C2;  z ^= z>>31
//     slot = z % n_slots
// on wrapping unsigned 64-bit arithmetic.  The TPU kernel composed that
// from uint32 limbs (JAX runs with x64 off) and therefore capped
// n_slots below 2^16; here the mix runs on native unsigned long long
// and the modulus takes any 1 <= n_slots < 2^31.
//
// Input: the records' 64-byte fixed headers as one uint8 [N, 64] row
// table (records.HDR_DTYPE, little-endian).  tseq/toid/tver sit at byte
// offsets 32/40/44 of a row, so a row's FID is one aligned 16-byte load
// (rows are 64-byte aligned in a fresh allocation; the wrapper checks
// 16-byte alignment of the base).  Output: int64 slots, one per row.
//
// Bound: one 32-byte sector read per row plus the 8-byte slot written,
// 40 B a row at HBM's rate, against a few tens of INT32 instructions a
// row (the 64-bit multiplies split into 32-bit multiply-adds).  Bytes
// bound it at every N.  The design keeps to that bound:
// - The modulus by a divisor known only at run time goes through a
//   reciprocal the host computes once per launch, m = floor((2^64-1)/n):
//   q = umulhi(z, m) is floor(z/n) or one less (z/n - z*m/2^64 =
//   z*(2^64 - m*n)/(n*2^64) < 1 since 2^64 - m*n <= n), so r = z - q*n
//   lies in [0, 2n) and one conditional subtraction ends it.  The card
//   has no integer divide; `%` on 64 bits was a division subroutine.
// - Each thread issues the 16-byte loads of kRowsPerThread rows, a grid
//   stride apart, before any of their arithmetic, so an SM keeps several
//   loads in flight per thread.  Rows i, i + stride, ... of one pass go
//   to neighbouring threads, so loads and the int64 stores coalesce.
// - The grid is at most one full wave: the SM count times the blocks an
//   SM holds at once (both queried once per device), walking the rows in
//   a grid-stride loop; a small N takes one row a thread over
//   ceil(N / 256) blocks instead, to spread over the SMs.
// A routing round hashes up to 2^16 rows in one launch
// (core/cluster.py, SlotRouter.slots_many), so launches are few and the
// host's cost per launch matters as much as the body.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kC1 = 0xBF58476D1CE4E5B9ULL;
constexpr unsigned long long kC2 = 0x94D049BB133111EBULL;
constexpr unsigned long long kMix = 0x9E3779B97F4A7C15ULL;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kMaxDevices = 64;

// blocks of one full wave on each device (0 = not asked yet)
std::atomic<int> wave_blocks[kMaxDevices];

__device__ __forceinline__ long long slot_of(uint4 v,
                                             unsigned long long n_slots,
                                             unsigned long long recip) {
  // bytes 32..47 of the row: tseq (u64), toid (u32), tver (u32)
  const unsigned long long seq =
      static_cast<unsigned long long>(v.x)
      | (static_cast<unsigned long long>(v.y) << 32);
  const unsigned long long oid = v.z;
  const unsigned long long ver = v.w;
  unsigned long long z = seq * kC1 ^ oid * kC2 ^ ver * kMix;
  z = (z ^ (z >> 30)) * kC1;
  z = (z ^ (z >> 27)) * kC2;
  z ^= z >> 31;
  const unsigned long long q = __umul64hi(z, recip);
  unsigned long long r = z - q * n_slots;
  if (r >= n_slots) r -= n_slots;
  return static_cast<long long>(r);
}

__global__ void __launch_bounds__(kThreads)
fid_slots_kernel(const uint8_t* __restrict__ rows, long long* __restrict__ out,
                 long long n, unsigned long long n_slots,
                 unsigned long long recip) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < n; i += kRowsPerThread * stride) {
    uint4 v[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const long long j = i + k * stride;
      if (j < n) {
        v[k] = __ldg(reinterpret_cast<const uint4*>(rows + j * 64 + 32));
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const long long j = i + k * stride;
      if (j < n) out[j] = slot_of(v[k], n_slots, recip);
    }
  }
}

}  // namespace

// C entry point, loaded through ctypes.  rows: pointer to n * 64 bytes
// on card `device`, 16-byte aligned; out: pointer to n int64 on the same
// card; stream: a cudaStream_t of that card.  Returns the launch's
// cudaError_t (0 = ok).  Sets the runtime's current device only when it
// differs, and sizes the wave once per device.
extern "C" int lcap_fid_slots(const void* rows, void* out, long long n,
                              long long n_slots, int device, void* stream) {
  if (n < 0 || n_slots < 1 || n_slots >= (1LL << 31) || device < 0
      || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int wave = wave_blocks[device].load(std::memory_order_relaxed);
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fid_slots_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    wave = sms * (per_sm > 0 ? per_sm : 1);
    wave_blocks[device].store(wave, std::memory_order_relaxed);
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > wave) blocks = wave;
  const unsigned long long divisor = static_cast<unsigned long long>(n_slots);
  fid_slots_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), static_cast<long long*>(out), n,
      divisor, ~0ULL / divisor);
  return static_cast<int>(cudaGetLastError());
}
