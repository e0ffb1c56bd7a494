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
// offsets 32/40/44 of a row, so each thread reads them with a single
// aligned 16-byte load (rows are 64-byte aligned in a fresh allocation;
// the wrapper checks 16-byte alignment of the base).  Output: int64
// slots, one per row.
//
// Bound: memory traffic is one 32-byte sector per row read plus 8 bytes
// written.  At the main path's N = 1024 rows per journal read that is
// about 40 KB, which HBM moves in ~12 ns, so the kernel is bound by its
// launch latency and by the host<->device copies around it, not by HBM
// or by the few tens of INT32 instructions per row (64-bit multiplies,
// shifts and modulus split into 32-bit ones).  The design therefore keeps
// one launch per routing read and no shared memory, synchronisation or
// second pass: one thread per row, 256 threads per block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kC1 = 0xBF58476D1CE4E5B9ULL;
constexpr unsigned long long kC2 = 0x94D049BB133111EBULL;
constexpr unsigned long long kMix = 0x9E3779B97F4A7C15ULL;
constexpr int kThreads = 256;

__global__ void fid_slots_kernel(const uint8_t* __restrict__ rows,
                                 long long* __restrict__ out,
                                 long long n,
                                 unsigned long long n_slots) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= n) return;
  // bytes 32..47 of the row: tseq (u64), toid (u32), tver (u32)
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(rows + i * 64 + 32));
  const unsigned long long seq =
      static_cast<unsigned long long>(v.x)
      | (static_cast<unsigned long long>(v.y) << 32);
  const unsigned long long oid = v.z;
  const unsigned long long ver = v.w;
  unsigned long long z = seq * kC1 ^ oid * kC2 ^ ver * kMix;
  z = (z ^ (z >> 30)) * kC1;
  z = (z ^ (z >> 27)) * kC2;
  z ^= z >> 31;
  out[i] = static_cast<long long>(z % n_slots);
}

}  // namespace

// C entry point, loaded through ctypes.  rows: pointer to n * 64 bytes
// on card `device`, 16-byte aligned; out: pointer to n int64 on the same
// card; stream: a cudaStream_t of that card.  Returns the launch's
// cudaError_t (0 = ok).
extern "C" int lcap_fid_slots(const void* rows, void* out, long long n,
                              long long n_slots, int device, void* stream) {
  if (n < 0 || n_slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  fid_slots_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), static_cast<long long*>(out), n,
      static_cast<unsigned long long>(n_slots));
  return static_cast<int>(cudaGetLastError());
}
