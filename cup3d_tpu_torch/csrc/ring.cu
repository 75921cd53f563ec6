// Kernel B14: ring steps of the block-sharded forest's halo transport.
//
// Replaces cup3d_tpu/parallel/ring.py::_ring_shift_pallas (kernel body
// :89, pallas_call :109): at ring step k each shard's chunk lands on
// shard (s + k) mod D.  On the TPU one step is a send-sided remote DMA
// over ICI with send/recv semaphores; here it is the same function, not
// the DMA mechanics.  One launch carries steps k0 .. k0+nsteps-1 for
// every shard: grid (blocks, nsteps * D), block row y = (step, source
// shard s).
//
// Two forms of a step, by the chunk strides:
// - a ring shift (chunk strides 0): shard s's whole array lands on
//   shard (s + k) mod D;
// - a step of the all-to-all (ring.py::ring_all_to_all): shard s sends
//   its chunk (s + k) mod D, which lands in the receiver's chunk s, so
//   the caller's gather before a step and landing after it are the
//   kernel's own reads and writes, and steps 0 .. D-1 in one launch are
//   the whole exchange (step 0 the diagonal, which stays on its shard).
// A chunk is `rows` rows of `row_bytes` contiguous bytes, each side with
// its own row stride: the strided views of the slab padding and of the
// sharded lanes Laplacian are read in place, with no copy first.
//
// The shards' base addresses come from a small table passed by value in
// the kernel's parameter memory (RingTable), built here in C from a base
// address and a shard stride each, so a call needs no host-to-device
// copy and no loop in Python.  On one card they are slices of one
// allocation; a table of peer addresses would take the same kernel
// across cards (ROADMAP A7).
//
// Bound: bytes.  Every byte is read once and written once, so the least
// time is 2 x bytes over the card's memory rate.  The copy moves 16-byte
// vectors when every base address, stride and the row length are
// multiples of 16, else 8-, 4-, 2-byte words or single bytes; f32 and
// int32 payloads take the same path.  At the Krylov loop's exchange a
// step is ~1 MB a shard, a few microseconds of copying, so what a call
// costs is its launch and the host work around it: one ctypes call of
// two host arrays (the caller's cached layout and the call's addresses),
// one launch an exchange.  Plain C interface, loaded with ctypes
// (ops/cuda_lib.py); the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define RING_MAX_SHARDS 64
#define RING_THREADS 256
#define RING_VEC_PER_THREAD 4
#define RING_MAX_BLOCKS_X 2048

namespace {

struct RingTable {
  const unsigned char* src[RING_MAX_SHARDS];
  unsigned char* dst[RING_MAX_SHARDS];
};

// strides in bytes; a chunk is `rows` rows of `per_row` vectors of V
struct RingLayout {
  long long src_chunk, dst_chunk;  // between a shard's chunks (0: one)
  long long src_row, dst_row;      // between a chunk's rows
  unsigned per_row;                // vectors a row
  unsigned n;                      // vectors a chunk (rows * per_row)
};

// the table and layout are read in place in parameter memory, indexed by
// shard (__grid_constant__: no per-thread copy)
template <typename V>
__global__ void __launch_bounds__(RING_THREADS)
k_ring_shift(const __grid_constant__ RingTable tab,
             const __grid_constant__ RingLayout lay, int D, int k0) {
  const int s = blockIdx.y % D;
  const int d = (s + k0 + (int)(blockIdx.y / D)) % D;
  const unsigned char* src = tab.src[s] + d * lay.src_chunk;
  unsigned char* dst = tab.dst[d] + s * lay.dst_chunk;
  const unsigned stride = gridDim.x * RING_THREADS;
  if (lay.per_row == lay.n) {  // one contiguous row
    const V* sv = reinterpret_cast<const V*>(src);
    V* dv = reinterpret_cast<V*>(dst);
    for (unsigned i = blockIdx.x * RING_THREADS + threadIdx.x; i < lay.n;
         i += stride)
      dv[i] = sv[i];
    return;
  }
  for (unsigned i = blockIdx.x * RING_THREADS + threadIdx.x; i < lay.n;
       i += stride) {
    const unsigned r = i / lay.per_row, c = i - r * lay.per_row;
    *reinterpret_cast<V*>(dst + r * lay.dst_row + c * sizeof(V)) =
        *reinterpret_cast<const V*>(src + r * lay.src_row + c * sizeof(V));
  }
}

template <typename V>
int launch(const RingTable& tab, RingLayout lay, long long rows,
           long long row_bytes, int D, int k0, int nsteps,
           cudaStream_t stream) {
  const long long per_row = row_bytes / (long long)sizeof(V);
  const long long n = per_row * rows;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  lay.per_row = (unsigned)per_row;
  lay.n = (unsigned)n;
  long long bx = (n + RING_THREADS * RING_VEC_PER_THREAD - 1) /
                 (RING_THREADS * RING_VEC_PER_THREAD);
  if (bx > RING_MAX_BLOCKS_X) bx = RING_MAX_BLOCKS_X;
  dim3 grid((unsigned)bx, (unsigned)(D * nsteps));
  k_ring_shift<V><<<grid, RING_THREADS, 0, stream>>>(tab, lay, D, k0);
  return (int)cudaGetLastError();
}

}  // namespace

// A launch's layout (strides in bytes), cached by the caller per layout:
// nine int64s.  Shard s's source is at src + s * src_shard and its
// destination at dst + s * dst_shard; at step k shard s reads its chunk
// d = (s + k) mod D, src + s * src_shard + d * src_chunk, and writes it
// to shard d's chunk s, dst + d * dst_shard + s * dst_chunk.  A chunk is
// `rows` rows of `row_bytes` bytes at the row strides src_row and dst_row.
struct RingArgs {
  long long src_shard, src_chunk, src_row;
  long long dst_shard, dst_chunk, dst_row;
  long long rows, row_bytes, D;
};

// Steps k0 .. k0+nsteps-1 of the ring (k0 mod D).  `call` holds this
// call's five int64s: the first source and destination bytes (device
// addresses), k0, nsteps and the stream.  Both arguments are host arrays
// that ctypes passes by pointer.
extern "C" int cup3d_ring_steps(const RingArgs* a, const long long* call) {
  const unsigned long long src = (unsigned long long)call[0];
  const unsigned long long dst = (unsigned long long)call[1];
  const int nsteps = (int)call[3];
  void* stream = (void*)call[4];
  const int D = (int)a->D;
  if (D < 1 || D > RING_MAX_SHARDS || nsteps < 1 || nsteps > D ||
      a->rows < 0 || a->row_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const int k0 = (int)(((call[2] % D) + D) % D);
  if (a->rows == 0 || a->row_bytes == 0) return 0;
  RingTable tab;
  uintptr_t align = (uintptr_t)(a->src_chunk | a->dst_chunk | a->row_bytes);
  if (a->rows > 1) align |= (uintptr_t)(a->src_row | a->dst_row);
  for (int s = 0; s < D; ++s) {
    tab.src[s] =
        reinterpret_cast<const unsigned char*>(src + s * a->src_shard);
    tab.dst[s] = reinterpret_cast<unsigned char*>(dst + s * a->dst_shard);
    align |= (uintptr_t)tab.src[s] | (uintptr_t)tab.dst[s];
  }
  const RingLayout lay{a->src_chunk, a->dst_chunk, a->src_row, a->dst_row,
                       0u, 0u};
  const long long rows = a->rows, rb = a->row_bytes;
  cudaStream_t st = (cudaStream_t)stream;
  if ((align & 15) == 0)
    return launch<uint4>(tab, lay, rows, rb, D, k0, nsteps, st);
  if ((align & 7) == 0)
    return launch<uint2>(tab, lay, rows, rb, D, k0, nsteps, st);
  if ((align & 3) == 0)
    return launch<uint32_t>(tab, lay, rows, rb, D, k0, nsteps, st);
  if ((align & 1) == 0)
    return launch<uint16_t>(tab, lay, rows, rb, D, k0, nsteps, st);
  return launch<uint8_t>(tab, lay, rows, rb, D, k0, nsteps, st);
}
