// Kernel B14: one ring step of the block-sharded forest's halo transport.
//
// Replaces cup3d_tpu/parallel/ring.py::_ring_shift_pallas (kernel body
// :89, pallas_call :109): each shard's array lands on shard
// (s + shift) mod D.  On the TPU that is a send-sided remote DMA over ICI
// with send/recv semaphores; here it is the same function, not the DMA
// mechanics: one launch moves every shard's chunk, grid (chunks, D), block
// row y = source shard s, writing to the destination shard's address.
//
// The addresses come from a small table passed by value in the kernel's
// parameter memory (RingTable: one source and one destination address per
// shard), so a call needs no host-to-device copy.  On one card the
// addresses are slices of one allocation; a table of peer addresses would
// take the same kernel across cards (ROADMAP A7).
//
// Bound: bytes.  Every byte is read once and written once, so the least
// time is 2 x bytes over the card's memory rate.  The copy moves 16-byte
// vectors when both of a shard's addresses are 16-byte aligned, 4-byte
// words when they are 4-byte aligned, and single bytes otherwise, with a
// scalar tail for a byte count that is not a multiple of the vector: f32
// and int32 payloads take the same path.  Plain C interface, loaded with
// ctypes (ops/cuda_lib.py); the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define RING_MAX_SHARDS 64
#define RING_THREADS 256
#define RING_VEC_PER_THREAD 4
#define RING_MAX_CHUNKS 2048

struct RingTable {
  const unsigned char* src[RING_MAX_SHARDS];
  unsigned char* dst[RING_MAX_SHARDS];
};

__global__ void __launch_bounds__(RING_THREADS)
k_ring_shift(RingTable tab, int D, long long nbytes, int shift) {
  const int s = blockIdx.y;
  const int d = ((s + shift) % D + D) % D;
  const unsigned char* src = tab.src[s];
  unsigned char* dst = tab.dst[d];
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uintptr_t align = (uintptr_t)src | (uintptr_t)dst;
  long long done = 0;
  if ((align & 15) == 0) {
    const long long nv = nbytes >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = tid; i < nv; i += stride) d4[i] = s4[i];
    done = nv << 4;
  } else if ((align & 3) == 0) {
    const long long nw = nbytes >> 2;
    const uint32_t* s1 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d1 = reinterpret_cast<uint32_t*>(dst);
    for (long long i = tid; i < nw; i += stride) d1[i] = s1[i];
    done = nw << 2;
  }
  for (long long i = done + tid; i < nbytes; i += stride) dst[i] = src[i];
}

// src[s], dst[s]: shard s's source and destination addresses (device
// pointers as 64-bit integers, host arrays of D entries); nbytes: bytes of
// one shard's array; shard s's bytes land at dst[(s + shift) mod D].
extern "C" int cup3d_ring_shift(const unsigned long long* src,
                                const unsigned long long* dst, int D,
                                long long nbytes, int shift, void* stream) {
  if (D < 1 || D > RING_MAX_SHARDS || nbytes < 0)
    return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return 0;
  RingTable tab;
  for (int s = 0; s < D; ++s) {
    tab.src[s] = reinterpret_cast<const unsigned char*>(src[s]);
    tab.dst[s] = reinterpret_cast<unsigned char*>(dst[s]);
  }
  const long long per_block =
      (long long)RING_THREADS * 16 * RING_VEC_PER_THREAD;
  long long chunks = (nbytes + per_block - 1) / per_block;
  if (chunks > RING_MAX_CHUNKS) chunks = RING_MAX_CHUNKS;
  dim3 grid((unsigned)chunks, (unsigned)D);
  k_ring_shift<<<grid, RING_THREADS, 0, (cudaStream_t)stream>>>(
      tab, D, nbytes, shift % D);
  return (int)cudaGetLastError();
}
