// Hopper (sm_90a) kernels for the stages of the fused BiCGSTAB
// iterations: the uniform grid's (cup3d_tpu_torch/ops/fused_bicgstab.py)
// and the AMR forest's (cup3d_tpu_torch/ops/fused_amr_bicgstab.py).
//
// They replace the Pallas stage bodies of cup3d_tpu/ops/fused_bicgstab.py
// (_k_update :173, _k_getz_two :185, _k_getz_tile :190, _k_lap :195,
// _k_axpy :203, _k_finish :209) and of cup3d_tpu/ops/fused_amr_bicgstab.py
// (_k_update :183, _k_getz_two :195, _k_getz_tile :202, _k_lap :208,
// _k_axpy :217, _k_finish :224), and
// compute what those compute, not how: the TPU stages stream chunks of
// 256 tiles or 64 blocks through VMEM; here every vector is BLOCK-MAJOR,
// shape (T,8,8,8), so one 8^3 tile (a tile of the uniform grid or a block
// of the forest) is 2 KB of contiguous memory in f32 (1 KB in bf16) and
// one thread block owns one tile.  On the uniform grid the tile index
// t = (tx*NBy + ty)*NBz + tz is the JAX lane index; on the forest it is
// the block's slot.  A cell (a,b,c) of tile t lives at
// t*512 + (a*8 + b)*8 + c.
//
// What bounds them on an H100: all are memory-bound (T = 32768 tiles at
// 256^3, ~10^4 blocks on the forest of BASELINE config #3).  Per launch
// they move (f32):
//   update  r, p, v in; p out                         4 x 4 B / cell
//           (+ rhat out on a breakdown, when it is re-seeded from r)
//   getz    w in, y out (+ 8 aux floats per tile)     2 x 4 B / cell
//   getz_tile w in, y out (+ 1 h^2 per block)         2 x 4 B / cell
//   getz_amr w, azf in; y out (+ 2 floats per block)  3 x 4 B / cell
//   lap     w, a in; 6 face planes in; Aw out        3.75 x 4 B / cell
//   lap_amr (10^3 lab)/8^3, corr, a in; Aw out  (1000/512 + 3) x 4 B / cell
//   axpy    r, v in; s out                            3 x 4 B / cell
//   finish  x, y, z, s, t, rhat in; x, r out         8 x 4 B / cell
// plus O(T) partials and per-block columns.  The design keeps each
// tile's data in registers / shared memory for the whole stage so every
// vector crosses device memory exactly once per launch, loads and stores
// 16 B per thread where the access is elementwise, and does the per-tile
// reductions in the block (warp shuffles, then a fixed-order sum over
// the warps) so partials are bitwise reproducible run to run -- no float
// atomics.  The per-tile partials are combined by one torch.sum on the
// caller's side, exactly as the TPU drivers' _combine does.
//
// Storage.  Each kernel is a template over the storage type S of the
// Krylov vectors (r, rhat, p, v, y, z, s, t): float, or __nv_bfloat16
// under CUP3D_KRYLOV_DTYPE=bf16 (the TPU stages' _Stages.store,
// cup3d_tpu/ops/fused_bicgstab.py:232, fused_amr_bicgstab.py:252).  x, the
// per-tile partials, the aux / h^2 / zc columns, the forest's labs, its
// reflux increment corr and its azf stay f32.  A bf16 kernel keeps the
// f32 kernel's thread-to-cell mapping and fixed-order reductions and
// changes only the width of its loads and stores: four cells a thread are
// one 8-byte load, unpacked with __bfloat1622float2, and a store rounds to
// nearest even with __floats2bfloat162_rn, as XLA's astype does.  All
// arithmetic is f32, and every partial is summed over the value as
// STORED (after rounding), as the TPU stages' math is; the bf16 builds
// move about half the bytes of the f32 ones.  The entry points are
// cup3d_<stage> (f32) and cup3d_<stage>_bf16.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kCells = 512;           // cells of one 8^3 tile
constexpr int kVecThreads = 128;      // elementwise stages: 4 cells / thread
constexpr int kWarps = kVecThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of one value per thread over a 128-thread block, valid in thread 0.
// Fixed shuffle tree then a fixed-order sum of the 4 warp totals:
// the same inputs always give the same bits.
__device__ __forceinline__ float block_sum(float v, float* shared4) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) shared4[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += shared4[w];
  }
  return s;
}

// f32 arithmetic rounded at each operation, in the plain versions' order:
// no multiply-add contraction, so an elementwise stage's f32 value before
// its store is the plain version's bit for bit, and a bf16 store rounds
// the same number (a contracted s - omega t differs in its last bits
// wherever s and omega t nearly cancel, and rounds to another bf16 value
// in ~0.1% of the cells)
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

__device__ __forceinline__ float hsum(float4 a) {
  return ((a.x + a.y) + a.z) + a.w;
}

__device__ __forceinline__ float hdot(float4 a, float4 b) {
  return ((a.x * b.x + a.y * b.y) + a.z * b.z) + a.w * b.w;
}

// -- storage: four consecutive cells (index i counts groups of four) ------

__device__ __forceinline__ float4 ld4(const float* p, size_t i) {
  return reinterpret_cast<const float4*>(p)[i];
}

__device__ __forceinline__ float2 bf2_to_f2(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ unsigned f2_to_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ float4 ld4(const bf16* p, size_t i) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];
  const float2 a = bf2_to_f2(u.x), b = bf2_to_f2(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// store four cells; returns them as stored (rounded), the values the
// partials sum
__device__ __forceinline__ float4 st4(float* p, size_t i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
  return v;
}

__device__ __forceinline__ float4 st4(bf16* p, size_t i, float4 v) {
  const uint2 u = make_uint2(f2_to_bf2(v.x, v.y), f2_to_bf2(v.z, v.w));
  reinterpret_cast<uint2*>(p)[i] = u;
  const float2 a = bf2_to_f2(u.x), b = bf2_to_f2(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// one 8-cell pencil (16-byte aligned) to and from registers
__device__ __forceinline__ void ld8(const float* g, float (&o)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(g);
  const float4 hi = *reinterpret_cast<const float4*>(g + 4);
  o[0] = lo.x; o[1] = lo.y; o[2] = lo.z; o[3] = lo.w;
  o[4] = hi.x; o[5] = hi.y; o[6] = hi.z; o[7] = hi.w;
}

__device__ __forceinline__ void ld8(const bf16* g, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(g);
  const float2 a = bf2_to_f2(u.x), b = bf2_to_f2(u.y);
  const float2 c = bf2_to_f2(u.z), d = bf2_to_f2(u.w);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  o[4] = c.x; o[5] = c.y; o[6] = d.x; o[7] = d.y;
}

__device__ __forceinline__ void st8(float* g, const float (&v)[8]) {
  reinterpret_cast<float4*>(g)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(g)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void st8(bf16* g, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(g) =
      make_uint4(f2_to_bf2(v[0], v[1]), f2_to_bf2(v[2], v[3]),
                 f2_to_bf2(v[4], v[5]), f2_to_bf2(v[6], v[7]));
}

// ---------------------------------------------------------------------------
// B1 update: p = r + beta (p - omega v), breakdown re-seed, per-tile sum p.
// Replaces _k_update (cup3d_tpu/ops/fused_bicgstab.py:173, math :96-108).
// On breakdown (scal[2] > 0.5) p and v are SELECTED to zero (not scaled
// by beta = 0), so a non-finite p or v cannot leak through 0 * inf, and
// rhat is re-seeded to r.  p and rhat are updated in place.
//
// B8 (the forest's update) is the same kernel with a per-block weight
// wt: the partial is sum(p * wt[t]) over the tile, the volume-weighted
// coarse restriction of the forest's two-level preconditioner.  Replaces
// _k_update (cup3d_tpu/ops/fused_amr_bicgstab.py:183, math :97-108).
// wt == nullptr weighs every cell by 1.0f, which leaves B1's bits as
// they were.
//
// Lanes (the fleet's lane-batched forest): T = L x bpl blocks, lane l's
// blocks contiguous, each lane its own 8-float scalar row, scal (L, 8);
// block t reads row t / bpl.  bpl = T is one lane, the call as it was.
// B12 (axpy) and B13 (finish) take the same bpl.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float upd1(float r, float p, float v, float beta,
                                      float omega, bool broke) {
  const float pe = broke ? 0.f : p;
  const float ve = broke ? 0.f : v;
  return add(r, mul(beta, sub(pe, mul(omega, ve))));
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

template <typename S>
__global__ void __launch_bounds__(kVecThreads)
k_update(const S* __restrict__ r, S* p, const S* __restrict__ v, S* rhat,
         const float* __restrict__ scal, const float* __restrict__ wt,
         float* __restrict__ ts, int bpl) {
  __shared__ float red[kWarps];
  const float* row = scal + 8 * (size_t)(blockIdx.x / bpl);
  const float beta = row[0], omega = row[1];
  const bool broke = row[2] > 0.5f;
  const float weight = wt ? wt[blockIdx.x] : 1.f;
  const size_t i = (size_t)blockIdx.x * (kCells / 4) + threadIdx.x;
  const float4 rr = ld4(r, i), pp = ld4(p, i), vv = ld4(v, i);
  float4 pn;
  pn.x = upd1(rr.x, pp.x, vv.x, beta, omega, broke);
  pn.y = upd1(rr.y, pp.y, vv.y, beta, omega, broke);
  pn.z = upd1(rr.z, pp.z, vv.z, beta, omega, broke);
  pn.w = upd1(rr.w, pp.w, vv.w, beta, omega, broke);
  pn = st4(p, i, pn);
  if (broke) st4(rhat, i, rr);  // r's stored value: exact in S
  const float s = block_sum(hsum(scale4(pn, weight)), red);
  if (threadIdx.x == 0) ts[blockIdx.x] = s;
}

// ---------------------------------------------------------------------------
// B4 lap: Aw = 7-point Laplacian / h^2 with cross-tile face planes, plus
// the per-tile partials sum(a * Aw) and sum(Aw * Aw).
// Replaces _k_lap (:195, math :133-148 over stencils.laplacian_lanes_chunk).
// The planes come from make_lane_planes (built by torch outside the
// kernel, as the TPU driver builds them outside its kernel), tile-major
// (T, 6, 8, 8): rows lo0, hi0, lo1, hi1, lo2, hi2, each indexed by the
// two remaining in-tile axes.  The tile and its planes sit in shared
// memory; each thread owns 4 consecutive cells along the last axis.
// ---------------------------------------------------------------------------

template <typename S>
__global__ void __launch_bounds__(kVecThreads)
k_lap(const S* __restrict__ w, const S* __restrict__ planes,
      const S* __restrict__ a, S* __restrict__ aw, float* __restrict__ pa,
      float* __restrict__ ps, float inv_h2) {
  __shared__ __align__(16) float tile[kCells];
  __shared__ __align__(16) float pl[6 * 64];
  __shared__ float red_a[kWarps];
  __shared__ float red_s[kWarps];
  const size_t t = blockIdx.x;
  const int tid = threadIdx.x;
  reinterpret_cast<float4*>(tile)[tid] = ld4(w, t * (kCells / 4) + tid);
  if (tid < 96) reinterpret_cast<float4*>(pl)[tid] = ld4(planes, t * 96 + tid);
  __syncthreads();

  const int cell0 = tid * 4;  // (ia*8 + ib)*8 + ic0, ic0 in {0, 4}
  const int ia = cell0 >> 6, ib = (cell0 >> 3) & 7, ic0 = cell0 & 7;
  float out[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ic = ic0 + q;
    const int cc = cell0 + q;
    const float xp = ia < 7 ? tile[cc + 64] : pl[1 * 64 + ib * 8 + ic];
    const float xm = ia > 0 ? tile[cc - 64] : pl[0 * 64 + ib * 8 + ic];
    const float yp = ib < 7 ? tile[cc + 8] : pl[3 * 64 + ia * 8 + ic];
    const float ym = ib > 0 ? tile[cc - 8] : pl[2 * 64 + ia * 8 + ic];
    const float zp = ic < 7 ? tile[cc + 1] : pl[5 * 64 + ia * 8 + ib];
    const float zm = ic > 0 ? tile[cc - 1] : pl[4 * 64 + ia * 8 + ib];
    float o = mul(-6.f, tile[cc]);
    o = add(o, xp);
    o = add(o, xm);
    o = add(o, yp);
    o = add(o, ym);
    o = add(o, zp);
    o = add(o, zm);
    out[q] = mul(o, inv_h2);
  }
  const float4 res = st4(aw, t * (kCells / 4) + tid,
                         make_float4(out[0], out[1], out[2], out[3]));
  const float4 av = ld4(a, t * (kCells / 4) + tid);
  const float sa = block_sum(hdot(av, res), red_a);
  const float ss = block_sum(hdot(res, res), red_s);
  if (tid == 0) {
    pa[t] = sa;
    ps[t] = ss;
  }
}

// ---------------------------------------------------------------------------
// B11 lap (forest): Aw = (7-point sum on the block's width-1 lab) / h_t^2
// + corr, plus the per-block partials sum(a * Aw) and sum(Aw * Aw).
// Replaces _k_lap (cup3d_tpu/ops/fused_amr_bicgstab.py:208, math
// :136-158).  The lab (T, 10, 10, 10) comes from the face-table assembly
// and corr (the dense coarse-fine reflux increment) from the flux
// tables, both built by torch between the stages as the TPU driver
// builds them outside its kernel.  The 4000-byte lab is 16-byte aligned
// per block, so it is loaded as float4 into shared memory; each thread
// owns 4 consecutive cells along the last axis, as in B4.  Moves
// (1000/512 + 3) x 4 B / cell.
// ---------------------------------------------------------------------------

constexpr int kLab = 10;                // width-1 lab edge
constexpr int kLabCells = kLab * kLab * kLab;

template <typename S>
__global__ void __launch_bounds__(kVecThreads)
k_lap_amr(const float4* __restrict__ lab, const float4* __restrict__ corr,
          const S* __restrict__ a, const float* __restrict__ inv_h2,
          S* __restrict__ aw, float* __restrict__ pa,
          float* __restrict__ ps) {
  __shared__ __align__(16) float tile[kLabCells];
  __shared__ float red_a[kWarps];
  __shared__ float red_s[kWarps];
  const size_t t = blockIdx.x;
  const int tid = threadIdx.x;
  for (int q = tid; q < kLabCells / 4; q += kVecThreads)
    reinterpret_cast<float4*>(tile)[q] = lab[t * (kLabCells / 4) + q];
  __syncthreads();

  const float ih = inv_h2[t];
  const int cell0 = tid * 4;  // (ia*8 + ib)*8 + ic0, ic0 in {0, 4}
  const int ia = cell0 >> 6, ib = (cell0 >> 3) & 7, ic0 = cell0 & 7;
  const float4 cc = corr[t * (kCells / 4) + tid];
  const float cv[4] = {cc.x, cc.y, cc.z, cc.w};
  float out[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int l = ((ia + 1) * kLab + (ib + 1)) * kLab + (ic0 + q + 1);
    float s = mul(-6.f, tile[l]);
    s = add(s, tile[l + kLab * kLab]);
    s = add(s, tile[l - kLab * kLab]);
    s = add(s, tile[l + kLab]);
    s = add(s, tile[l - kLab]);
    s = add(s, tile[l + 1]);
    s = add(s, tile[l - 1]);
    out[q] = add(mul(s, ih), cv[q]);
  }
  const float4 res = st4(aw, t * (kCells / 4) + tid,
                         make_float4(out[0], out[1], out[2], out[3]));
  const float4 av = ld4(a, t * (kCells / 4) + tid);
  const float sa = block_sum(hdot(av, res), red_a);
  const float ss = block_sum(hdot(res, res), red_s);
  if (tid == 0) {
    pa[t] = sa;
    ps[t] = ss;
  }
}

// ---------------------------------------------------------------------------
// B5 axpy: s = r - alpha v, per-tile sum s.  Replaces _k_axpy (:203).
// B12 (the forest's axpy, fused_amr_bicgstab.py::_k_axpy :217, math
// :161-163) is the same kernel with the per-block weight wt of B8:
// partial sum(s * wt[t]); wt == nullptr gives B5.
// ---------------------------------------------------------------------------

template <typename S>
__global__ void __launch_bounds__(kVecThreads)
k_axpy(const S* __restrict__ r, const S* __restrict__ v,
       const float* __restrict__ scal, const float* __restrict__ wt,
       S* __restrict__ s, float* __restrict__ ts, int bpl) {
  __shared__ float red[kWarps];
  const float alpha = scal[8 * (size_t)(blockIdx.x / bpl)];
  const float weight = wt ? wt[blockIdx.x] : 1.f;
  const size_t i = (size_t)blockIdx.x * (kCells / 4) + threadIdx.x;
  const float4 rr = ld4(r, i), vv = ld4(v, i);
  const float4 ss = st4(
      s, i, make_float4(sub(rr.x, mul(alpha, vv.x)),
                        sub(rr.y, mul(alpha, vv.y)),
                        sub(rr.z, mul(alpha, vv.z)),
                        sub(rr.w, mul(alpha, vv.w))));
  const float sum = block_sum(hsum(scale4(ss, weight)), red);
  if (threadIdx.x == 0) ts[blockIdx.x] = sum;
}

// ---------------------------------------------------------------------------
// B6 finish: x += alpha y + omega z; r = s - omega t; per-tile partials
// sum(r * r) and sum(rhat * r).  Replaces _k_finish (:209).  x is updated
// in place; r is written into the buffer of s (the TPU stage aliases s
// into r the same way): each thread reads its s before writing its r.
// ---------------------------------------------------------------------------

template <typename S>
__global__ void __launch_bounds__(kVecThreads)
k_finish(float4* x, const S* __restrict__ y, const S* __restrict__ z,
         const S* s, const S* __restrict__ t, const S* __restrict__ rhat,
         const float* __restrict__ scal, S* r, float* __restrict__ prr,
         float* __restrict__ prh, int bpl) {
  __shared__ float red_r[kWarps];
  __shared__ float red_h[kWarps];
  const float* row = scal + 8 * (size_t)(blockIdx.x / bpl);
  const float alpha = row[0], omega = row[1];
  const size_t i = (size_t)blockIdx.x * (kCells / 4) + threadIdx.x;
  const float4 xx = x[i], yy = ld4(y, i), zz = ld4(z, i), sv = ld4(s, i);
  const float4 tv = ld4(t, i), rh = ld4(rhat, i);
  x[i] = make_float4(add(add(xx.x, mul(alpha, yy.x)), mul(omega, zz.x)),
                     add(add(xx.y, mul(alpha, yy.y)), mul(omega, zz.y)),
                     add(add(xx.z, mul(alpha, yy.z)), mul(omega, zz.z)),
                     add(add(xx.w, mul(alpha, yy.w)), mul(omega, zz.w)));
  const float4 rn = st4(
      r, i, make_float4(sub(sv.x, mul(omega, tv.x)),
                        sub(sv.y, mul(omega, tv.y)),
                        sub(sv.z, mul(omega, tv.z)),
                        sub(sv.w, mul(omega, tv.w))));
  const float a = block_sum(hdot(rn, rn), red_r);
  const float b = block_sum(hdot(rh, rn), red_h);
  if (threadIdx.x == 0) {
    prr[blockIdx.x] = a;
    prh[blockIdx.x] = b;
  }
}

// ---------------------------------------------------------------------------
// B2 getz (two-level), redesigned: a persistent, pipelined tile solve,
// y = zc + S3 diag(1/lam) S3 (-h2 (w - A zc)).  Replaces _k_getz_two
// (cup3d_tpu/ops/fused_bicgstab.py:185, math :111-130, _azc_from_aux :65)
// and the first port's k_getz_two (one block of 512 threads a tile, six
// 512-thread barriers, at most 4 tiles in flight an SM).  S3 = S1 (x) S1
// (x) S1 (cup3d_tpu/ops/tilesolve.py:53), so instead of the TPU's
// (512,512) @ (512,C) matmul each tile runs three 8-point axis
// transforms, the scale, and three more: no tensor cores, no TF32
// question.  A zc is rebuilt from the 6 per-tile face deltas in aux rows
// 0..5 (a face cell adds its face's delta, an edge or corner cell one per
// axis), zc is aux row 6; aux is (8, T) as the TPU driver ships it.
//
// B3 / B10 getz (tile-only), y = S3 diag(1/lam) S3 (-h2 w), run on the
// same core as instances of the same template (kGzTile, kGzTileCol).
// Replaces _k_getz_tile of cup3d_tpu/ops/fused_bicgstab.py (:190, math
// :111-130 with two_level=False) and of cup3d_tpu/ops/fused_amr_bicgstab.py
// (:202).  The uniform grid (B3) passes one h2 for every tile, folded into
// the shared scale table as B2's is; the forest (B10) passes each block's
// own h^2 as a column: the table holds 1/lam3 and the tile's -h2[t],
// fetched into a register a tile ahead like B2's aux, multiplies where B2
// applies its scale.  No aux, no face deltas, no + zc; moves w in, y out
// (+ 4 B of h^2 a block): 2 x 4 B / cell.
//
// B9 getz (forest, two-level), y = zc_t + S3 diag(1/lam) S3 (-h2_t (w -
// azf)), is the fourth instance (kGzAmr), kernel k_getz_amr.  Replaces
// _k_getz_two of cup3d_tpu/ops/fused_amr_bicgstab.py (:195, math
// :111-133) and the first port's k_getz_amr (B2's old core: a 512-thread
// block a tile, six block barriers).  On a forest A zf is no sum of face
// deltas, so the caller assembles the refluxed Laplacian azf of the
// injected coarse correction between the stages (as the TPU driver does)
// and the kernel reads it as a field: a stage holds two tiles, the warp's
// next block's w and azf, brought in by two bulk copies that complete on
// the stage's one mbarrier (expecting 4 KB), and the warp forms w - azf
// in registers before the first transform.  As B10 it keeps 1/lam3 in the
// table and multiplies by the block's -h2 in the middle of the solve;
// the block's zc is added at the store.  h2 and zc are prefetched a block
// ahead into every lane.  Moves w and azf in, y out (+ 8 B a block):
// 3 x 4 B / cell.  Its stages double the ring's shared memory (4 warps x
// kStages x 4 KB), so fewer CTAs fit an SM than for B10 (4 of the
// two-stage build, against 7).
//
// Floors on an H100 (3.35 TB/s, 67 TFLOP/s f32 = 33.5 T FMA/s): the
// kernel must read w and write y, 8 B a cell (+ 28 B of aux a tile).  At
// T = 32,768 tiles (256^3) that is 134 MB, 40.1 us; at T = 4,096 (the
// 128^3 fish) 16.8 MB, 5.0 us.  Six dense 8-point transforms are 48 FMA
// a cell, 805 M FMA (24 us) at T = 32,768, 101 M (3 us) at 4,096: the
// compute floor sits close to the byte floor, so the design keeps the
// loads in flight while the FMA pipes work, and cuts the FMAs:
//
// - A warp owns a tile, a thread two 8-cell pencils in registers: the
//   transform along a pencil runs in registers, and a tile changes its
//   pencil axis through a shared-memory buffer, synchronised by
//   __syncwarp() alone (no block barrier after the prologue).  The
//   buffer is padded, cell (a,b,k) at 92a + 12b + k: the k-pencils move
//   as 16-byte vectors, the b- and a-pencils as words, and each of the
//   three access patterns hits 32 distinct banks, each with compile-time
//   offsets from one per-thread base.
// - Persistent CTAs (4 warps, as many CTAs as fit) walk the tiles.  A
//   warp's next tile's w (2 KB, contiguous) comes into a ring of kStages
//   shared-memory stages by one TMA 1-D bulk copy (cp.async.bulk, issued
//   by one lane, completion counted in bytes on the stage's mbarrier)
//   while the current tile computes; the aux column (7 floats at stride
//   T) comes into registers of lanes 0..6 a tile ahead.  Two builds: 2
//   stages when a warp walks many tiles (T = 32,768); 1 stage and 8 CTAs
//   an SM when one round of resident warps takes every tile (T = 4,096).
//   (16-byte cp.async into the padded buffer, the other way to fill the
//   ring, moved the same bytes more slowly on this card.)
// - -h2 / lam3 (512 floats, in the padded layout) is formed once a CTA
//   into shared memory while the first loads fly (the scale by -h2 moves
//   from the right-hand side to the middle of the solve: 8 multiplies a
//   pencil fewer); the 8-point DST-I basis is compile-time structure over
//   4 magnitudes S1[0][0..3] held in registers: S1 is even/odd symmetric
//   (S1[i][7-j] = (-1)^i S1[i][j]), so a transform is 4 sums, 4
//   differences and 30 FMAs (S1[2][2] and S1[5][2] are sin(pi) and
//   sin(2 pi): 0) instead of 64: 28.5 FMA-class operations a cell for the
//   six transforms.  The order of the arithmetic differs from the plain
//   twin's matmuls, as the first port's did; both stay well inside
//   GETZ_RTOL.
// - Stores are y's k-pencils, 2 x 16 bytes a pencil; the tile-major
//   (T, 8, 8, 8) layout and f32 are as before.
//
// bf16 storage (B2, B3, B9, B10 under CUP3D_KRYLOV_DTYPE=bf16): a stage
// holds the tile's w as it is stored, 1 KB, brought in by the same bulk
// copy at half the bytes (B9's azf stays f32 behind it: 3 KB a stage); a
// k-pencil is one 16-byte vector of 8 bf16, unpacked to f32 registers
// before the first transform, and the store rounds the f32 pencil (+ zc)
// to bf16, one 16-byte vector a pencil.  Every transform, the shared
// buffers and the scale table stay f32.  The stages take less shared
// memory, so the occupancy-picked CTA count is at least the f32 build's.
// ---------------------------------------------------------------------------

constexpr int kGzWarps = 4;                 // tiles in flight a CTA
constexpr int kGzThreads = 32 * kGzWarps;
constexpr int kPadA = 92, kPadB = 12;       // padded cell (a,b,k) offset
constexpr int kPad = 7 * kPadA + 7 * kPadB + 8;  // 736 floats a tile
constexpr unsigned kTileBytes = kCells * 4;

__host__ __device__ constexpr int pad_off(int a, int b, int k) {
  return a * kPadA + b * kPadB + k;
}

// S1[i][j] = c sin(pi (i+1)(j+1) / 9): its sign and which of the four
// magnitudes c sin(pi m / 9), m = 1..4, it is (0: the coefficient is 0)
__host__ __device__ constexpr int dst_n(int i, int j) {
  return ((i + 1) * (j + 1)) % 18;
}
__host__ __device__ constexpr int dst_sign(int i, int j) {
  return dst_n(i, j) % 9 == 0 ? 0 : (dst_n(i, j) < 9 ? 1 : -1);
}
__host__ __device__ constexpr int dst_mag(int i, int j) {
  return (dst_n(i, j) % 9) <= 4 ? (dst_n(i, j) % 9) : 9 - (dst_n(i, j) % 9);
}

// x <- S1 x in place (S1 symmetric and orthogonal: the same map forward
// and back); s[m] = c sin(pi m / 9), s[0] unused
__device__ __forceinline__ void dst8(float (&x)[8], const float (&s)[5]) {
  float u[4], v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u[j] = x[j] + x[7 - j];
    v[j] = x[j] - x[7 - j];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (dst_sign(i, j) != 0) {
        const float c = dst_sign(i, j) > 0 ? s[dst_mag(i, j)]
                                           : -s[dst_mag(i, j)];
        acc = fmaf(c, (i & 1) ? v[j] : u[j], acc);
      }
    }
    x[i] = acc;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one tile's w (kW bytes: 2 KB f32, 1 KB bf16), and for B9 the same
// block's f32 azf (kA = 2 KB more, right behind it), into a stage by TMA
// 1-D bulk copies that complete on the stage's mbarrier, which expects the
// bytes of both; the fence orders the warp's earlier reads of the stage
// (generic proxy) before the copies' writes (async proxy)
template <unsigned kW, unsigned kA>
__device__ __forceinline__ void tile_load(unsigned dst, const void* src,
                                          const float* src2, unsigned bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(kW + kA)
      : "memory");
  bulk_copy(dst, src, kW, bar);
  if constexpr (kA > 0) bulk_copy(dst + kW, src2, kA, bar);
}

// wait until the mbarrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the prologue of an instance of the shared core: B2's two-level aux, the
// tile-only solve at one h2 (B3) or at a column of per-block h^2 (B10),
// or the forest's two-level solve on w - azf at that column, + zc (B9)
enum GzMode { kGzTwo, kGzTile, kGzTileCol, kGzAmr };

// the body of every instance; the kernels below name the instances, so
// that a profile tells B2 (k_getz_two) from B3/B10 (k_getz_tile) and B9
// (k_getz_amr)
template <int kMode, int kStages, typename S>
__device__ __forceinline__ void getz_core(const S* __restrict__ w,
                                          const float* __restrict__ s1g,
                                          const float* __restrict__ lam3,
                                          const float* __restrict__ aux,
                                          const float* __restrict__ h2col,
                                          const float* __restrict__ azf,
                                          const float* __restrict__ zccol,
                                          S* __restrict__ y, float h2,
                                          int T) {
  constexpr bool kCol = kMode == kGzTileCol || kMode == kGzAmr;
  // a stage: the tile's w as stored, then (B9) its f32 azf
  constexpr unsigned kW = kCells * sizeof(S);
  constexpr unsigned kA = kMode == kGzAmr ? kTileBytes : 0;
  __shared__ __align__(128) unsigned char stages[kGzWarps][kStages][kW + kA];
  __shared__ __align__(16) float pads[kGzWarps][kPad];
  // -h2 / lam3 (B2, B3); 1 / lam3 (B10, B9: -h2[t] multiplies apart)
  __shared__ __align__(16) float scale[kPad];
  __shared__ __align__(8) unsigned long long bars[kGzWarps][kStages];
  __shared__ float auxs[kGzWarps][8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = gridDim.x * kGzWarps;
  const int t0 = blockIdx.x * kGzWarps + warp;
  // tile tt into stage q (lane 0 only); azf is read for B9 alone
  auto load = [&](int q, int tt) {
    const size_t off = (size_t)tt * kCells;
    tile_load<kW, kA>(smem_addr(stages[warp][q]), w + off,
                      kA > 0 ? azf + off : nullptr,
                      smem_addr(&bars[warp][q]));
  };
  // the first tiles' loads fly while the scale table is formed
  if (lane == 0) {
    for (int q = 0; q < kStages; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_addr(&bars[warp][q])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q + 1 < kStages; ++q)
      if (t0 + q * nw < T) load(q, t0 + q * nw);
  }
  float ra = 0.f;  // B2, lanes 0..6: aux row `lane` of the warp's next tile
  if constexpr (kMode == kGzTwo)
    if (lane < 7 && t0 < T) ra = __ldg(aux + (size_t)lane * T + t0);
  // B10, B9: h^2 (and B9's zc) of the warp's next tile, in every lane
  float hn = 0.f, zn = 0.f;
  if constexpr (kCol)
    if (t0 < T) hn = __ldg(h2col + t0);
  if constexpr (kMode == kGzAmr)
    if (t0 < T) zn = __ldg(zccol + t0);
  for (int c = threadIdx.x; c < kCells; c += kGzThreads) {
    const int o = pad_off(c >> 6, (c >> 3) & 7, c & 7);
    if constexpr (kCol)
      scale[o] = __frcp_rn(lam3[c]);
    else
      scale[o] = -h2 * __frcp_rn(lam3[c]);
  }
  const float s[5] = {0.f, s1g[0], s1g[1], s1g[2], s1g[3]};
  __syncthreads();

  // this lane's pencils in the three phases (set j = 0, 1):
  //   K: (a, b) = (4j + lane/8, lane%8), along k, 16-byte vectors
  //   B: (a, k) = (lane/4, 4j + lane%4), along b
  //   A: (b, k) = (lane/4, 4j + lane%4), along a
  const int ka = lane >> 3, kb = lane & 7;
  const int r4 = lane >> 2, c4 = lane & 3;
  float* buf = pads[warp];
  const float* ax = auxs[warp];
  int i = 0;
  for (int t = t0; t < T; t += nw, ++i) {
    const int slot = i % kStages;
    float nh2 = 0.f;  // B10, B9: this tile's -h^2
    float zct = 0.f;  // B9: this tile's zc
    __syncwarp();  // every lane is done with the stage refilled next
    {
      // tile i + kStages - 1 into the stage tile i - 1 left (with one
      // stage: tile i itself)
      const int tn = t + (kStages - 1) * nw;
      const int sn = (i + kStages - 1) % kStages;
      if (lane == 0 && tn < T) load(sn, tn);
      if constexpr (kMode == kGzTwo) {
        if (lane < 7) {
          auxs[warp][lane] = ra;
          if (t + nw < T) ra = __ldg(aux + (size_t)lane * T + t + nw);
        }
      }
      if constexpr (kCol) {
        nh2 = -hn;
        if (t + nw < T) hn = __ldg(h2col + t + nw);
      }
      if constexpr (kMode == kGzAmr) {
        zct = zn;
        if (t + nw < T) zn = __ldg(zccol + t + nw);
      }
    }
    bar_wait(smem_addr(&bars[warp][slot]), (unsigned)((i / kStages) & 1));
    __syncwarp();
    const S* st = reinterpret_cast<const S*>(stages[warp][slot]);
    const float* sta =
        reinterpret_cast<const float*>(stages[warp][slot] + kW);
    float x[2][8];

    // -- K: load, the right-hand side, the k transform ------------------
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int a = 4 * j + ka;
      float wv[8];
      ld8(st + (a * 8 + kb) * 8, wv);
      if constexpr (kMode == kGzTwo) {
        const float part0 = a == 0 ? ax[0] : (a == 7 ? ax[1] : 0.f);
        const float part1 = kb == 0 ? ax[2] : (kb == 7 ? ax[3] : 0.f);
        const float p01 = part0 + part1;
        // w - A zc; -h2 rides in the scale of the middle of the solve
        x[j][0] = wv[0] - (p01 + ax[4]);
#pragma unroll
        for (int k = 1; k < 7; ++k) x[j][k] = wv[k] - p01;
        x[j][7] = wv[7] - (p01 + ax[5]);
      } else if constexpr (kMode == kGzAmr) {
        // w - azf; -h2 multiplies in the middle of the solve
        float av[8];
        ld8(sta + (a * 8 + kb) * 8, av);
#pragma unroll
        for (int k = 0; k < 8; ++k) x[j][k] = wv[k] - av[k];
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) x[j][k] = wv[k];
      }
      dst8(x[j], s);
      float* p = buf + pad_off(a, kb, 0);
      *reinterpret_cast<float4*>(p) =
          make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
      *reinterpret_cast<float4*>(p + 4) =
          make_float4(x[j][4], x[j][5], x[j][6], x[j][7]);
    }
    __syncwarp();
    // -- B: the b transform ---------------------------------------------
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* p = buf + pad_off(r4, 0, 4 * j + c4);
#pragma unroll
      for (int m = 0; m < 8; ++m) x[j][m] = p[m * kPadB];
      dst8(x[j], s);
#pragma unroll
      for (int m = 0; m < 8; ++m) p[m * kPadB] = x[j][m];
    }
    __syncwarp();
    // -- A: the a transform, the scale, the inverse a transform ----------
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = pad_off(0, r4, 4 * j + c4);
      float* p = buf + o;
#pragma unroll
      for (int m = 0; m < 8; ++m) x[j][m] = p[m * kPadA];
      dst8(x[j], s);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        x[j][m] *= scale[o + m * kPadA];
        if constexpr (kCol) x[j][m] *= nh2;
      }
      dst8(x[j], s);
#pragma unroll
      for (int m = 0; m < 8; ++m) p[m * kPadA] = x[j][m];
    }
    __syncwarp();
    // -- B: the inverse b transform ---------------------------------------
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* p = buf + pad_off(r4, 0, 4 * j + c4);
#pragma unroll
      for (int m = 0; m < 8; ++m) x[j][m] = p[m * kPadB];
      dst8(x[j], s);
#pragma unroll
      for (int m = 0; m < 8; ++m) p[m * kPadB] = x[j][m];
    }
    __syncwarp();
    // -- K: the inverse k transform, (B2, B9: + zc), store ----------------
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int a = 4 * j + ka;
      float v[8];
      ld8(buf + pad_off(a, kb, 0), v);
      dst8(v, s);
      if constexpr (kMode == kGzTwo || kMode == kGzAmr) {
        const float zc = kMode == kGzTwo ? ax[6] : zct;
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] += zc;
      }
      st8(y + (size_t)t * kCells + (a * 8 + kb) * 8, v);
    }
  }
}

#define GZ_PARAMS                                                         \
  const S *__restrict__ w, const float *__restrict__ s1g,                  \
      const float *__restrict__ lam3, const float *__restrict__ aux,       \
      const float *__restrict__ h2col, const float *__restrict__ azf,      \
      const float *__restrict__ zccol, S *__restrict__ y, float h2, int T
#define GZ_ARGS w, s1g, lam3, aux, h2col, azf, zccol, y, h2, T

template <int kStages, int kMinBlocks, typename S>
__global__ void __launch_bounds__(kGzThreads, kMinBlocks)
k_getz_two(GZ_PARAMS) {
  getz_core<kGzTwo, kStages, S>(GZ_ARGS);
}

template <int kMode, int kStages, int kMinBlocks, typename S>
__global__ void __launch_bounds__(kGzThreads, kMinBlocks)
k_getz_tile(GZ_PARAMS) {
  getz_core<kMode, kStages, S>(GZ_ARGS);
}

template <int kStages, int kMinBlocks, typename S>
__global__ void __launch_bounds__(kGzThreads, kMinBlocks)
k_getz_amr(GZ_PARAMS) {
  getz_core<kGzAmr, kStages, S>(GZ_ARGS);
}

template <typename S>
using GetzKernel = void (*)(const S*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, S*, float, int);

template <int kMode, int kStages, int kMinBlocks, typename S>
constexpr GetzKernel<S> getz_kernel() {
  if constexpr (kMode == kGzTwo)
    return k_getz_two<kStages, kMinBlocks, S>;
  else if constexpr (kMode == kGzAmr)
    return k_getz_amr<kStages, kMinBlocks, S>;
  else
    return k_getz_tile<kMode, kStages, kMinBlocks, S>;
}

// CTAs of one build that fit on card `dev` at once (cached; 0 on error)
template <int kMode, int kStages, int kMinBlocks, typename S>
int getz_core_capacity(int dev) {
  static int cached[64] = {0};
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    const GetzKernel<S> kern = getz_kernel<kMode, kStages, kMinBlocks, S>();
    cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kGzThreads, 0) !=
            cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

// the persistent launch of one instance: the one-stage build when its
// resident warps take every tile in one round, else the two-stage ring;
// as many CTAs as fit (fewer when T needs fewer)
template <int kMode, typename S>
int launch_getz_core(const S* w, const float* s1, const float* lam3,
                     const float* aux, const float* h2col, const float* azf,
                     const float* zccol, S* y, float h2, int T,
                     cudaStream_t stream) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return (int)cudaErrorInvalidDevice;
  const int need = (T + kGzWarps - 1) / kGzWarps;
  const int small = getz_core_capacity<kMode, 1, 8, S>(dev);
  if (small < 1) return (int)cudaErrorInvalidConfiguration;
  if (need <= small) {
    getz_kernel<kMode, 1, 8, S>()<<<need, kGzThreads, 0, stream>>>(
        w, s1, lam3, aux, h2col, azf, zccol, y, h2, T);
  } else {
    const int deep = getz_core_capacity<kMode, 2, 1, S>(dev);
    if (deep < 1) return (int)cudaErrorInvalidConfiguration;
    getz_kernel<kMode, 2, 1, S>()<<<need < deep ? need : deep, kGzThreads,
                                    0, stream>>>(w, s1, lam3, aux, h2col,
                                                 azf, zccol, y, h2, T);
  }
  return (int)cudaGetLastError();
}

// -- the launches behind the C entry points, one instance per storage -----

template <typename S>
int launch_update(const S* r, S* p, const S* v, S* rhat, const float* scal,
                  const float* wt, float* ts, int T, int bpl,
                  cudaStream_t stream) {
  if (bpl < 1 || T % bpl) return (int)cudaErrorInvalidValue;
  k_update<S><<<T, kVecThreads, 0, stream>>>(r, p, v, rhat, scal, wt, ts,
                                            bpl);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_getz_tile(const S* w, const float* s1, const float* lam3,
                     const float* h2col, float h2, S* y, int T,
                     cudaStream_t stream) {
  if (h2col)
    return launch_getz_core<kGzTileCol, S>(w, s1, lam3, nullptr, h2col,
                                           nullptr, nullptr, y, 0.f, T,
                                           stream);
  return launch_getz_core<kGzTile, S>(w, s1, lam3, nullptr, nullptr, nullptr,
                                      nullptr, y, h2, T, stream);
}

template <typename S>
int launch_lap(const S* w, const S* planes, const S* a, S* aw, float* pa,
               float* ps, float inv_h2, int T, cudaStream_t stream) {
  k_lap<S><<<T, kVecThreads, 0, stream>>>(w, planes, a, aw, pa, ps, inv_h2);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_axpy(const S* r, const S* v, const float* scal, const float* wt,
                S* s, float* ts, int T, int bpl, cudaStream_t stream) {
  if (bpl < 1 || T % bpl) return (int)cudaErrorInvalidValue;
  k_axpy<S><<<T, kVecThreads, 0, stream>>>(r, v, scal, wt, s, ts, bpl);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_finish(float* x, const S* y, const S* z, const S* s, const S* t,
                  const S* rhat, const float* scal, S* r, float* prr,
                  float* prh, int T, int bpl, cudaStream_t stream) {
  if (bpl < 1 || T % bpl) return (int)cudaErrorInvalidValue;
  k_finish<S><<<T, kVecThreads, 0, stream>>>((float4*)x, y, z, s, t, rhat,
                                             scal, r, prr, prh, bpl);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_lap_amr(const float* lab, const float* corr, const S* a,
                   const float* inv_h2, S* aw, float* pa, float* ps, int T,
                   cudaStream_t stream) {
  k_lap_amr<S><<<T, kVecThreads, 0, stream>>>(
      (const float4*)lab, (const float4*)corr, a, inv_h2, aw, pa, ps);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// plain C interface (loaded with ctypes); T = number of 8^3 tiles or
// blocks; wt may be nullptr (the uniform grid's B1 and B5), h2col too
// (the uniform grid's B3); bpl (update, axpy, finish) is the blocks of
// one lane, each lane reading its own 8-float scalar row (T: one lane).
// Each stage has an f32 entry point and a _bf16
// one (S = __nv_bfloat16: the Krylov vectors in bf16; x, partials,
// columns, labs, corr and azf f32 in both).
// ---------------------------------------------------------------------------

#define CUP3D_STAGES(S, SFX)                                                  \
  int cup3d_update##SFX(const S* r, S* p, const S* v, S* rhat,               \
                        const float* scal, const float* wt, float* ts, int T, \
                        int bpl, void* stream) {                              \
    return launch_update<S>(r, p, v, rhat, scal, wt, ts, T, bpl,              \
                            (cudaStream_t)stream);                            \
  }                                                                           \
  int cup3d_getz_two##SFX(const S* w, const float* s1, const float* lam3,    \
                          const float* aux, S* y, float h2, int T,           \
                          void* stream) {                                     \
    return launch_getz_core<kGzTwo, S>(w, s1, lam3, aux, nullptr, nullptr,   \
                                       nullptr, y, h2, T,                     \
                                       (cudaStream_t)stream);                 \
  }                                                                           \
  int cup3d_getz_tile##SFX(const S* w, const float* s1, const float* lam3,   \
                           const float* h2col, float h2, S* y, int T,        \
                           void* stream) {                                    \
    return launch_getz_tile<S>(w, s1, lam3, h2col, h2, y, T,                 \
                               (cudaStream_t)stream);                         \
  }                                                                           \
  int cup3d_lap##SFX(const S* w, const S* planes, const S* a, S* aw,        \
                     float* pa, float* ps, float inv_h2, int T,              \
                     void* stream) {                                          \
    return launch_lap<S>(w, planes, a, aw, pa, ps, inv_h2, T,                \
                         (cudaStream_t)stream);                               \
  }                                                                           \
  int cup3d_axpy##SFX(const S* r, const S* v, const float* scal,             \
                      const float* wt, S* s, float* ts, int T, int bpl,      \
                      void* stream) {                                         \
    return launch_axpy<S>(r, v, scal, wt, s, ts, T, bpl,                      \
                          (cudaStream_t)stream);                              \
  }                                                                           \
  int cup3d_finish##SFX(float* x, const S* y, const S* z, const S* s,       \
                        const S* t, const S* rhat, const float* scal, S* r,  \
                        float* prr, float* prh, int T, int bpl,              \
                        void* stream) {                                       \
    return launch_finish<S>(x, y, z, s, t, rhat, scal, r, prr, prh, T, bpl,  \
                            (cudaStream_t)stream);                            \
  }                                                                           \
  int cup3d_getz_amr##SFX(const S* w, const float* azf, const float* s1,    \
                          const float* lam3, const float* zc,                \
                          const float* h2, S* y, int T, void* stream) {      \
    return launch_getz_core<kGzAmr, S>(w, s1, lam3, nullptr, h2, azf, zc,   \
                                       y, 0.f, T, (cudaStream_t)stream);     \
  }                                                                           \
  int cup3d_lap_amr##SFX(const float* lab, const float* corr, const S* a,   \
                         const float* inv_h2, S* aw, float* pa, float* ps,   \
                         int T, void* stream) {                               \
    return launch_lap_amr<S>(lab, corr, a, inv_h2, aw, pa, ps, T,            \
                             (cudaStream_t)stream);                           \
  }

extern "C" {
CUP3D_STAGES(float, )
CUP3D_STAGES(bf16, _bf16)
}  // extern "C"
