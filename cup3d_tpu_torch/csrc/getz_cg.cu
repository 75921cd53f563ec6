// Hopper (sm_90a) kernel of the CG getZ (cup3d_tpu_torch/ops/getz_cg.py):
// `iters` sweeps of conjugate gradients on every 8^3 tile of
// (-lap_tile + shift) z = b, with the tile's zero-Dirichlet halo and a
// per-tile shift (0 for the Poisson getZ).
//
// Replaces _cg_kernel of cup3d_tpu/ops/getz_pallas.py (:42, call :96),
// which batches 256 tiles along the TPU's lanes.  The guards are the
// reference's (getz_pallas.py:70-76): alpha = 0 when |p.Ap| <= 1e-30,
// beta = 0 when r.r <= 1e-30.
//
// Layout: cell c = (a*8 + b)*8 + k of tile t lives at t*ts + c*cs, so the
// same kernel reads the lanes layout (8,8,8,T) of the uniform legacy solve
// (cs = T, ts = 1) and the block layout (nb,8,8,8) of the forest (cs = 1,
// ts = 512) without a transpose.
//
// What bounds it on an H100: operations, not bytes.  A sweep costs 19
// flops a cell (stencil 7, shifted apply 2, two dots 4, three axpys 6), so
// 24 sweeps are ~458 flops a cell against 8 B moved (b in, z out); at
// 67 TFLOP/s f32 that is ~0.11 ms per application at 256^3 against
// 0.04 ms for the bytes.  The first port (a block of 512 threads a tile)
// paid three block barriers a sweep and read every warp's total from
// shared memory in every thread for each dot: ~39 shared-memory accesses
// a cell a sweep against ~12 FP32 instructions, 19x the bound.  So:
//
// - One warp a tile, every CG vector in registers.  A lane owns a
//   2 x 2 x 4 brick of cells (a = 2ba + i, b = 2bb + j, k = 4bk + m for
//   lane = 8ba + 2bb + bk): 16 cells of z, r, p and Ap.  The stencil's
//   neighbours inside the brick are registers; the 40 on the brick's
//   faces (the fewest for 16 cells: a 2 x 2 x 4 brick's surface) come
//   from the lanes 8, 2 and 1 away by __shfl_up/down_sync, and a face on
//   the tile's boundary SELECTS the zero halo (never a foreign lane's
//   value).  No barrier of any kind inside the sweep loop.
// - The two dots are warp reductions in a fixed order: each lane sums its
//   16 products (four k-rows of 4, then the rows pairwise), an xor
//   butterfly sums the lanes; f32 addition is commutative, so every lane
//   holds the same bits, alpha and beta agree across the warp, and
//   reruns are bitwise.  No float atomics.
// - Loads and stores that use every sector: a CTA of 8 warps takes 8
//   consecutive tiles.  In the lanes layout each cell row of the 8 tiles
//   is 32 contiguous bytes; in the blocks layout the 8 tiles are 16 KB of
//   contiguous memory.  The CTA stages the slab through shared memory
//   (b in, then z out) with coalesced word accesses, and each warp moves
//   its tile between the slab and its registers as 16-byte vectors.  The
//   slab keeps cell (a,b,k) of tile w at 772w + 96a + 12b + k: the word
//   accesses of the lanes layout and the 16-byte accesses of the bricks
//   hit 32 distinct banks.  A CTA's tiles past T (T % 8 != 0) are read
//   as zeros and not written; their warps sweep the zeros (z stays 0 by
//   the guards), so that no warp branches around the shuffles.
// - At most 85 registers a thread (three CTAs of 8 warps an SM; ptxas
//   keeps the sweep in 80 without spills): the sweep is bound by
//   instruction issue and its latency (the butterflies, the divides), and
//   24 warps an SM hide more of that latency than the 16 that fit when
//   ptxas is left free to use more registers.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kCells = 512;             // cells of one 8^3 tile
constexpr int kCgWarps = 8;             // tiles a CTA
constexpr int kCgThreads = 32 * kCgWarps;
constexpr int kRowB = 12, kRowA = 96;   // slab offset of cell (a,b,k)
constexpr int kSlot = 8 * kRowA + 4;    // one tile's slot in the slab
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int slab_off(int c) {
  return (c >> 6) * kRowA + ((c >> 3) & 7) * kRowB + (c & 7);
}

// a brick's 16 cells: index (i*2 + j)*4 + m
__device__ __forceinline__ constexpr int q(int i, int j, int m) {
  return (i * 2 + j) * 4 + m;
}

// sum over the warp of this lane's 16 products x.y, in a fixed order; the
// same bits in every lane
__device__ __forceinline__ float warp_dot(const float (&x)[16],
                                          const float (&y)[16]) {
  float row[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float s = x[4 * r] * y[4 * r];
#pragma unroll
    for (int m = 1; m < 4; ++m) s = fmaf(x[4 * r + m], y[4 * r + m], s);
    row[r] = s;
  }
  float v = (row[0] + row[1]) + (row[2] + row[3]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ap = (-lap + shift) p on the brick, the tile's zero-Dirichlet halo
// selected at its faces; the neighbours summed in the reference's order
// (+a, -a, +b, -b, +k, -k)
__device__ __forceinline__ void apply(const float (&p)[16], float (&ap)[16],
                                      float shift, bool a_lo, bool a_hi,
                                      bool b_lo, bool b_hi, bool k_lo,
                                      bool k_hi) {
  // faces across bricks: the neighbour lane's cells, or the zero halo
  float am[2][4], apl[2][4], bm[2][4], bp[2][4], km[2][2], kp[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float xa = __shfl_up_sync(kFull, p[q(1, u, m)], 8);
      const float ya = __shfl_down_sync(kFull, p[q(0, u, m)], 8);
      const float xb = __shfl_up_sync(kFull, p[q(u, 1, m)], 2);
      const float yb = __shfl_down_sync(kFull, p[q(u, 0, m)], 2);
      am[u][m] = a_lo ? 0.f : xa;   // a - 1 of cells i = 0 (j = u)
      apl[u][m] = a_hi ? 0.f : ya;  // a + 1 of cells i = 1 (j = u)
      bm[u][m] = b_lo ? 0.f : xb;   // b - 1 of cells j = 0 (i = u)
      bp[u][m] = b_hi ? 0.f : yb;   // b + 1 of cells j = 1 (i = u)
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float xk = __shfl_up_sync(kFull, p[q(u, j, 3)], 1);
      const float yk = __shfl_down_sync(kFull, p[q(u, j, 0)], 1);
      km[u][j] = k_lo ? 0.f : xk;   // k - 1 of cells m = 0 (i = u)
      kp[u][j] = k_hi ? 0.f : yk;   // k + 1 of cells m = 3 (i = u)
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float xp = i == 0 ? p[q(1, j, m)] : apl[j][m];
        const float xm = i == 1 ? p[q(0, j, m)] : am[j][m];
        const float yp = j == 0 ? p[q(i, 1, m)] : bp[i][m];
        const float ym = j == 1 ? p[q(i, 0, m)] : bm[i][m];
        const float zp = m < 3 ? p[q(i, j, m + 1)] : kp[i][j];
        const float zm = m > 0 ? p[q(i, j, m - 1)] : km[i][j];
        const float c = p[q(i, j, m)];
        const float lap = ((((xp + xm) + yp) + ym) + zp) + zm - 6.f * c;
        ap[q(i, j, m)] = fmaf(shift, c, -lap);
      }
}

__global__ void __launch_bounds__(kCgThreads, 3)
k_getz_cg(const float* __restrict__ b, const float* __restrict__ shift_col,
          float shift_val, float* __restrict__ z_out, int n, long long cs,
          long long ts, int iters) {
  __shared__ __align__(16) float slab[kCgWarps * kSlot];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t0 = (long long)blockIdx.x * kCgWarps;
  // the slab's words in a coalesced order: tile fastest in the lanes
  // layout (a cell row of the 8 tiles is contiguous), cell fastest else
  const bool lanes = cs != 1;
  for (int e = threadIdx.x; e < kCgWarps * kCells; e += kCgThreads) {
    const int w = lanes ? (e & 7) : (e >> 9);
    const int c = lanes ? (e >> 3) : (e & 511);
    const long long t = t0 + w;
    slab[w * kSlot + slab_off(c)] =
        t < n ? __ldg(b + t * ts + (long long)c * cs) : 0.f;
  }
  __syncthreads();

  const long long t = t0 + warp;
  const int ba = lane >> 3, bb = (lane >> 1) & 3, bk = lane & 1;
  float* brick = slab + warp * kSlot + (2 * ba) * kRowA + (2 * bb) * kRowB +
                 4 * bk;
  const float shift = shift_col && t < n ? shift_col[t] : shift_val;
  float z[16], r[16], p[16], ap[16];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 v =
          *reinterpret_cast<const float4*>(brick + i * kRowA + j * kRowB);
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        z[q(i, j, m)] = 0.f;
        r[q(i, j, m)] = vv[m];
        p[q(i, j, m)] = vv[m];
      }
    }
  const bool a_lo = ba == 0, a_hi = ba == 3, b_lo = bb == 0, b_hi = bb == 3;
  const bool k_lo = bk == 0, k_hi = bk == 1;
  float rs = warp_dot(r, r);
  for (int it = 0; it < iters; ++it) {
    apply(p, ap, shift, a_lo, a_hi, b_lo, b_hi, k_lo, k_hi);
    const float denom = warp_dot(p, ap);
    const float alpha = fabsf(denom) > 1e-30f ? rs / denom : 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      z[e] = fmaf(alpha, p[e], z[e]);
      r[e] = fmaf(-alpha, ap[e], r[e]);
    }
    const float rs_new = warp_dot(r, r);
    const float beta = rs > 1e-30f ? rs_new / rs : 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) p[e] = fmaf(beta, p[e], r[e]);
    rs = rs_new;
  }
  // z into the warp's own slot (its b was read by this warp alone)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float4*>(brick + i * kRowA + j * kRowB) =
          make_float4(z[q(i, j, 0)], z[q(i, j, 1)], z[q(i, j, 2)],
                      z[q(i, j, 3)]);
  __syncthreads();
  for (int e = threadIdx.x; e < kCgWarps * kCells; e += kCgThreads) {
    const int w = lanes ? (e & 7) : (e >> 9);
    const int c = lanes ? (e >> 3) : (e & 511);
    const long long tt = t0 + w;
    if (tt < n)
      z_out[tt * ts + (long long)c * cs] = slab[w * kSlot + slab_off(c)];
  }
}

}  // namespace

extern "C" {

// n tiles; cell c of tile t at t*ts + c*cs in b and z; shift_col (n,) per
// tile or nullptr for the scalar shift_val
int cup3d_getz_cg(const float* b, const float* shift_col, float shift_val,
                  float* z, int n, long long cs, long long ts, int iters,
                  void* stream) {
  k_getz_cg<<<(n + kCgWarps - 1) / kCgWarps, kCgThreads, 0,
              (cudaStream_t)stream>>>(b, shift_col, shift_val, z, n, cs, ts,
                                      iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
