// Hopper (sm_90a) kernel of the CG getZ (cup3d_tpu_torch/ops/getz_cg.py):
// `iters` sweeps of conjugate gradients on every 8^3 tile of
// (-lap_tile + shift) z = b, with the tile's zero-Dirichlet halo and a
// per-tile shift (0 for the Poisson getZ).
//
// Replaces _cg_kernel of cup3d_tpu/ops/getz_pallas.py (:42, call :96),
// which batches 256 tiles along the TPU's lanes; here one thread block
// owns one tile, one thread one cell (512 threads).  The search direction
// p sits in shared memory for the stencil, z and the residual in
// registers.  The two dots of a sweep (p.Ap and r.r) are block
// reductions in a fixed order (warp shuffles, then every thread sums the
// 16 warp totals in warp order from shared memory), so every thread holds
// the same bits and reruns are bitwise; no float atomics.  The guards are
// the reference's (getz_pallas.py:70-76): alpha = 0 when |p.Ap| <= 1e-30,
// beta = 0 when r.r <= 1e-30.
//
// Layout: cell c = (a*8 + b)*8 + k of tile t lives at t*ts + c*cs, so the
// same kernel reads the lanes layout (8,8,8,T) of the uniform legacy solve
// (cs = T, ts = 1) and the block layout (nb,8,8,8) of the forest (cs = 1,
// ts = 512) without a transpose.  In the lanes layout a warp's 32 loads
// and stores are T floats apart, one sector each: b and z cross device
// memory once per application but in 32-byte sectors.
//
// What bounds it on an H100: operations, not bytes.  A sweep costs 19
// flops a cell (stencil 7, shifted apply 2, two dots 4, three axpys 6), so
// 24 sweeps are ~456 flops a cell against 8 B moved (b in, z out); at
// 67 TFLOP/s f32 that is ~0.11 ms per application at 256^3 against
// 0.04 ms for the bytes.  Each sweep also pays three __syncthreads.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kCells = 512;             // cells of one 8^3 tile = threads
constexpr int kWarps = kCells / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block of one value per thread, returned to EVERY thread:
// lane 0 of each warp stores its warp's total, and after the barrier each
// thread adds the 16 totals in warp order (the same bits everywhere).
__device__ __forceinline__ float block_sum_all(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(kCells)
k_getz_cg(const float* __restrict__ b, const float* __restrict__ shift_col,
          float shift_val, float* __restrict__ z_out, long long cs,
          long long ts, int iters) {
  __shared__ float p_sh[kCells];
  // two reduction slots, used in turn: a slot is rewritten only after a
  // barrier that every reader of its previous value has passed
  __shared__ float red_pap[kWarps];
  __shared__ float red_rr[kWarps];
  const long long t = blockIdx.x;
  const int c = threadIdx.x;
  const int a = c >> 6, bb = (c >> 3) & 7, k = c & 7;
  const long long i = t * ts + (long long)c * cs;
  const float shift = shift_col ? shift_col[t] : shift_val;

  const float bv = b[i];
  float z = 0.f, r = bv, p = bv;
  float rs = block_sum_all(bv * bv, red_rr);
  for (int it = 0; it < iters; ++it) {
    p_sh[c] = p;
    __syncthreads();
    // lap(p) with the zero-Dirichlet halo, summed as the reference does
    float lap = -6.f * p;
    lap += a < 7 ? p_sh[c + 64] : 0.f;
    lap += a > 0 ? p_sh[c - 64] : 0.f;
    lap += bb < 7 ? p_sh[c + 8] : 0.f;
    lap += bb > 0 ? p_sh[c - 8] : 0.f;
    lap += k < 7 ? p_sh[c + 1] : 0.f;
    lap += k > 0 ? p_sh[c - 1] : 0.f;
    const float ap = -lap + shift * p;
    const float denom = block_sum_all(p * ap, red_pap);
    const float alpha = fabsf(denom) > 1e-30f ? rs / denom : 0.f;
    z = z + alpha * p;
    r = r - alpha * ap;
    const float rs_new = block_sum_all(r * r, red_rr);
    const float beta = rs > 1e-30f ? rs_new / rs : 0.f;
    p = r + beta * p;
    rs = rs_new;
  }
  z_out[i] = z;
}

}  // namespace

extern "C" {

// n tiles; cell c of tile t at t*ts + c*cs in b and z; shift_col (n,) per
// tile or nullptr for the scalar shift_val
int cup3d_getz_cg(const float* b, const float* shift_col, float shift_val,
                  float* z, int n, long long cs, long long ts, int iters,
                  void* stream) {
  k_getz_cg<<<n, kCells, 0, (cudaStream_t)stream>>>(b, shift_col, shift_val,
                                                     z, cs, ts, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
