// Hopper (sm_90a) kernel of the device fish midline's Frenet-Serret
// integration (cup3d_tpu_torch/models/fish/device_midline.py,
// _frenet_scan_dev).
//
// It replaces no Pallas kernel: the JAX package runs this recurrence as a
// lax.scan over the midline's Nm points inside its compiled megaloop
// (cup3d_tpu/models/fish/device_midline.py:158-197, _frenet_scan_dev).
// The port's plain version is a Python loop of about 7 launches a point,
// ~30 ms a megaloop step at 128^3 (Nm = 105) on an H100, host launch
// time; this kernel is the whole recurrence in one launch.
//
// What bounds it: the dependence chain.  Point i+1 needs point i's frame
// (forward Euler, renormalised every step), so the recurrence runs in
// order in ONE thread, its state (the frame ksi, nor, bin, the position
// r, and their time derivatives: 24 floats) in registers; ~60 flops a
// point, a few microseconds for Nm ~ 100.  The other threads of the warp
// idle; there is no parallel work to give them.  Torsion is zero (the
// device midline's eligibility excludes torsion control), so bin and vbin
// only renormalise.  Inputs rs, curv, dcurv (Nm,) f32; output (Nm, 6, 3)
// f32: r, v, nor, vnor, bin, vbin of each point, point 0 the initial
// frame (r = v = 0, nor = e_y, bin = e_z).
//
// Lanes (the fleet's fish lanes): L independent midlines, inputs
// (L, Nm) and output (L, Nm, 6, 3), one CTA a lane in ONE launch (grid
// L); each CTA's thread 0 runs its lane's recurrence as above.  L = 1
// is the one-midline launch.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

// the host renorm threshold: float64 eps, a divide-by-zero guard
constexpr float kEps = 2.220446049250313e-16f;

__device__ __forceinline__ void renorm(float (&x)[3]) {
  const float d = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
  if (d > kEps) {
    const float s = rsqrtf(fmaxf(d, kEps));
    x[0] *= s;
    x[1] *= s;
    x[2] *= s;
  }
}

__device__ __forceinline__ void store(float* o, const float (&x)[3]) {
  o[0] = x[0];
  o[1] = x[1];
  o[2] = x[2];
}

__global__ void __launch_bounds__(32)
k_frenet(const float* __restrict__ rs, const float* __restrict__ curv,
         const float* __restrict__ dcurv, float* __restrict__ out, int n) {
  if (threadIdx.x != 0) return;
  const size_t lane = blockIdx.x;
  rs += lane * n;
  curv += lane * n;
  dcurv += lane * n;
  out += lane * (size_t)n * 18;
  float ksi[3] = {1.f, 0.f, 0.f}, vksi[3] = {0.f, 0.f, 0.f};
  float r[3] = {0.f, 0.f, 0.f}, v[3] = {0.f, 0.f, 0.f};
  float nor[3] = {0.f, 1.f, 0.f}, vnor[3] = {0.f, 0.f, 0.f};
  float bin[3] = {0.f, 0.f, 1.f}, vbin[3] = {0.f, 0.f, 0.f};
  float* o = out;
  store(o + 0, r);
  store(o + 3, v);
  store(o + 6, nor);
  store(o + 9, vnor);
  store(o + 12, bin);
  store(o + 15, vbin);
  for (int i = 0; i + 1 < n; ++i) {
    const float k = curv[i], dk = dcurv[i], ds = rs[i + 1] - rs[i];
    float kn[3], nn[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      // every update reads the OLD frame, as the host loop does
      r[a] += ds * ksi[a];
      v[a] += ds * vksi[a];
      kn[a] = ksi[a] + ds * (k * nor[a]);
      nn[a] = nor[a] + ds * (-k * ksi[a]);
      const float dvksi = dk * nor[a] + k * vnor[a];
      const float dvnu = -dk * ksi[a] - k * vksi[a];
      vnor[a] += ds * dvnu;
      vksi[a] += ds * dvksi;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      ksi[a] = kn[a];
      nor[a] = nn[a];
    }
    renorm(ksi);
    renorm(nor);
    renorm(bin);
    o = out + (size_t)(i + 1) * 18;
    store(o + 0, r);
    store(o + 3, v);
    store(o + 6, nor);
    store(o + 9, vnor);
    store(o + 12, bin);
    store(o + 15, vbin);
  }
}

}  // namespace

extern "C" {

int cup3d_frenet(const float* rs, const float* curv, const float* dcurv,
                 float* out, int n, int lanes, void* stream) {
  if (lanes < 1) return (int)cudaErrorInvalidValue;
  k_frenet<<<lanes, 32, 0, (cudaStream_t)stream>>>(rs, curv, dcurv, out,
                                                     n);
  return (int)cudaGetLastError();
}

}  // extern "C"
