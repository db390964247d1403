// Batched semi-Lagrangian bilinear warp for Hopper (sm_90a).
//
// Replaces the TPU kernel `_warp_kernel` / `advect_2d_pallas` of
// mpgan_tpu/ops/warp_pallas.py (body :45-65, launcher :68-105,
// pl.pallas_call at :89). Same function:
//
//   out[b, y, x] = f[b] sampled bilinearly at (y + by, x + bx),
//   bx = clamp(-dt * v_w, -R, R),  by = clamp(-dt * v_h, -R, R),
//
// with the sample position clamped to the border, f and v float32,
// v interleaved as (v_w, v_h), R = max_disp. It equals the clamped plain
// reference (`advect_2d_clamped_ref` in mpgan_torch/ops/warp_kernel.py).
//
// Bound: bytes. Each pixel reads 4 B of field (once, if neighbouring taps
// hit in cache) and 8 B of velocity and writes 4 B: 16 B for ~20 flops,
// far below the card's 295 flops per byte. At the trainer's shape
// (B=16, 64x64) that is 1 MB, 0.31 us at 3.35 TB/s, so a launch costs more
// than the traffic; at B=256, 256x256 it is 268 MB, 80 us.
//
// Design: one thread per output pixel over a 1-D grid of B*H*W, neighbouring
// threads on neighbouring x, so the velocity load (one float2 per thread) and
// the output store are fully coalesced, and the four taps of neighbouring
// threads fall on the same or adjacent cache lines of the field. The TPU
// kernel's (2R+2)^2 roll-and-select loop and host-side edge pad existed only
// because Mosaic has no gather; here each thread gathers its 4 taps straight
// from the unpadded field with clamped indices, which reproduces the edge
// pad exactly for displacements within +-R. Accumulation is in float32.
// Shared-memory halo tiles and cp.async are later work.

#include <cuda_runtime.h>

namespace {

__global__ void warp2d_kernel(const float* __restrict__ field,
                              const float2* __restrict__ vel,
                              float* __restrict__ out,
                              int n, int h, int w, float dt, float r) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int x = i % w;
  int row = i / w;             // b * h + y
  int y = row % h;
  const float* f = field + (row - y) * w;  // start of image b

  float2 v = vel[i];
  float bx = fminf(fmaxf(-dt * v.x, -r), r);
  float by = fminf(fmaxf(-dt * v.y, -r), r);
  float px = fminf(fmaxf((float)x + bx, 0.0f), (float)(w - 1));
  float py = fminf(fmaxf((float)y + by, 0.0f), (float)(h - 1));
  int x0 = (int)floorf(px);
  int y0 = (int)floorf(py);
  int x1 = min(x0 + 1, w - 1);
  int y1 = min(y0 + 1, h - 1);
  float fx = px - (float)x0;
  float fy = py - (float)y0;

  float top = __ldg(f + y0 * w + x0) * (1.0f - fx) + __ldg(f + y0 * w + x1) * fx;
  float bot = __ldg(f + y1 * w + x0) * (1.0f - fx) + __ldg(f + y1 * w + x1) * fx;
  out[i] = top * (1.0f - fy) + bot * fy;
}

}  // namespace

// field (B, H, W) f32, vel (B, H, W, 2) f32, out (B, H, W) f32, all
// contiguous on the device of `stream`. B*H*W must fit in an int (the
// wrapper checks). Launches on `stream` and returns cudaGetLastError().
extern "C" int mpgan_warp2d(const void* field, const void* vel, void* out,
                            int b, int h, int w, float dt, int max_disp,
                            void* stream) {
  int n = b * h * w;
  if (n == 0) return 0;
  const int threads = 256;
  int blocks = (n + threads - 1) / threads;
  warp2d_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(field), static_cast<const float2*>(vel),
      static_cast<float*>(out), n, h, w, dt, (float)max_disp);
  return (int)cudaGetLastError();
}
