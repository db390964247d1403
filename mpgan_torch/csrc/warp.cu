// Batched semi-Lagrangian bilinear warp for Hopper (sm_90a): forward and
// backward kernels of the temporal loss's frame alignment.
//
// Function. For a field f (B, H, W) and a velocity v (B, H, W, 2) as
// (v_w, v_h), all float32,
//
//   warp(f, dt)[b, y, x] = f[b] sampled bilinearly at (py, px),
//   px = clamp(x - dt * clamp(v_w, -L, L), 0, W-1)   (py alike, from v_h),
//
// with L = max_disp / |dt| (the clamp of `advect_2d_clamped_ref` in
// mpgan_torch/ops/warp_kernel.py, the JAX `_clamped_xla_reference`).
// `locate` below holds that arithmetic once; every entry point uses it.
//
// Entry points and the TPU kernels they replace:
// - mpgan_warp2d: one field, any dt. Replaces `_warp_kernel` /
//   `advect_2d_pallas` of mpgan_tpu/ops/warp_pallas.py (pl.pallas_call at
//   :89). 16 B per pixel (4 field, 8 velocity, 4 out): bound 0.31 us at
//   B=16 64x64 and 80 us at B=256 256x256 (3.35 TB/s).
// - mpgan_warp2d_triplet: the alignment of one triplet for the temporal
//   discriminator, [warp(prev, +1), cur, warp(nxt, -1)] into one
//   (B, H, W, 3) output, the velocity read once. Replaces the two
//   `advect_2d_fast` calls of `align_triplet(use_pallas=True)` and the
//   concatenation. 32 B per pixel (8 velocity, 12 fields, 12 out): bound
//   0.63 us at B=16 64x64, 160 us at B=256 256x256.
// - mpgan_warp2d_bwd / mpgan_warp2d_triplet_bwd: the vector-Jacobian
//   product of the clamped warp, one field or both fields of a triplet
//   (the cur channel's gradient is a view of g and needs no launch).
//   Replaces the `custom_vjp` backward of `advect_2d_fast`
//   (warp_pallas.py:115-133), which is XLA's VJP of the reference.
//   Field gradients read g (4 B per field) and v (8 B) and write 4 B per
//   field: 24 B per pixel for a triplet, bound 0.47 us at B=16 64x64,
//   120 us at B=256 256x256. The velocity gradient, when asked for, adds
//   the fields (4 B each) and its own 8 B.
// All are bytes-bound: about 30 flops per pixel and field, far below the
// card's 20 flops per byte of f32 work.
//
// Forward design. One thread per output pixel, neighbouring threads on
// neighbouring x: the velocity load (one float2) and the stores coalesce,
// and the 4 taps of neighbouring threads fall on the same or adjacent
// cache lines, which L1 catches, so no shared-memory halo is needed. The
// TPU kernel's (2R+2)^2 roll-and-select loop and host-side edge pad
// existed only because Mosaic has no gather; here the taps are gathered
// with clamped indices, which reproduces the edge pad exactly for
// displacements within +-R.
//
// Backward design. The field gradient is the transpose of the 4-tap
// gather, a scatter: pixel p adds g[p] * weight into the 4 cells it read.
// The scatter is turned into ownership: each block owns a tile of
// kTile x kTile cells of one image, holds the tile's gradient planes (one
// per field, 32 KB for a triplet) in shared memory, and visits every
// pixel whose taps can reach the tile: the tile and a halo of
// ceil(|dt| L) + 1 pixels (the clamp bounds the reach), clipped to the
// image. It adds the taps that fall in its tile with shared-memory
// atomics and drops the others, then stores the planes with plain
// coalesced writes. So no output is zeroed first, no block writes
// another's cells, and no global atomic is needed. A halo pixel is
// visited by each tile it can reach: at B=256 256x256 with R = 8,
// (64+18)^2 / 64^2 = 1.64 visits per pixel, whose second reads of g and v
// hit L2 behind the neighbouring tile's. An image that fits one tile
// (H, W <= 64: the trainer's 64x64 tiles) is one block with no halo and
// 1024 threads, so B=16 runs 16 blocks: a launch-bound shape whatever the
// layout.
//
// The velocity gradient needs no atomics: each pixel's own
// -dt g (d out / d p), with d out / d px = (1-fy)(f[y0,x1] - f[y0,x0])
// + fy (f[y1,x1] - f[y1,x0]) and d out / d py alike, summed over the
// fields, and masked as torch's clamp backward masks: inclusively, so the
// gradient passes where the velocity or the backtrace lies exactly on its
// bound (zero velocity on a border pixel).
//
// Tolerance. Shared-memory float32 atomics add in an order that changes
// from run to run, so a field gradient differs from the plain version's
// (and from one run to the next) by the rounding of a reordered sum: a
// few ulps of the sum of the cell's |terms|. That is about 1e-7 for
// |g| <= 1 where a cell takes a few taps, and grows where the clamps pile
// many pixels onto one border cell. Gradients are held at 1e-4 against
// the plain version, the tolerance the JAX package's tests give the VJP.
// The forward has no reduction; its gap to the plain version is FMA
// contraction in the blend, held at 1e-5.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // backward: the edge of the tile a block owns

// The bilinear taps of the clamped backtrace from pixel (x, y), and the
// masks of the two clamps' backward (velocity, border), as the plain
// version computes them. __fmul_rn keeps nvcc from contracting dt * v
// into the subtraction, so the backtrace rounds as torch's does.
struct Taps {
  int x0, x1, y0, y1;
  float fx, fy;
  bool pass_x, pass_y;  // the gradient passes both clamps
};

__device__ __forceinline__ Taps locate(int x, int y, int h, int w, float vw,
                                       float vh, float dt, float lim) {
  Taps t;
  float cw = fminf(fmaxf(vw, -lim), lim);
  float ch = fminf(fmaxf(vh, -lim), lim);
  float cx = (float)x - __fmul_rn(dt, cw);
  float cy = (float)y - __fmul_rn(dt, ch);
  float xmax = (float)(w - 1), ymax = (float)(h - 1);
  t.pass_x = vw >= -lim && vw <= lim && cx >= 0.0f && cx <= xmax;
  t.pass_y = vh >= -lim && vh <= lim && cy >= 0.0f && cy <= ymax;
  float px = fminf(fmaxf(cx, 0.0f), xmax);
  float py = fminf(fmaxf(cy, 0.0f), ymax);
  t.x0 = (int)floorf(px);
  t.y0 = (int)floorf(py);
  t.x1 = min(t.x0 + 1, w - 1);
  t.y1 = min(t.y0 + 1, h - 1);
  t.fx = px - (float)t.x0;
  t.fy = py - (float)t.y0;
  return t;
}

// f: start of one (H, W) image.
__device__ __forceinline__ float blend(const float* __restrict__ f, int w,
                                       const Taps& t) {
  float top = __ldg(f + t.y0 * w + t.x0) * (1.0f - t.fx)
              + __ldg(f + t.y0 * w + t.x1) * t.fx;
  float bot = __ldg(f + t.y1 * w + t.x0) * (1.0f - t.fx)
              + __ldg(f + t.y1 * w + t.x1) * t.fx;
  return top * (1.0f - t.fy) + bot * t.fy;
}

__global__ void warp2d_kernel(const float* __restrict__ field,
                              const float2* __restrict__ vel,
                              float* __restrict__ out, int n, int h, int w,
                              float dt, float lim) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int x = i % w;
  int row = i / w;  // b * h + y
  int y = row % h;
  float2 v = vel[i];
  out[i] = blend(field + (size_t)(row - y) * w, w,
                 locate(x, y, h, w, v.x, v.y, dt, lim));
}

__global__ void warp2d_triplet_kernel(const float* __restrict__ prev,
                                      const float* __restrict__ cur,
                                      const float* __restrict__ nxt,
                                      const float2* __restrict__ vel,
                                      float* __restrict__ out, int n, int h,
                                      int w, float lim) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int x = i % w;
  int row = i / w;
  int y = row % h;
  size_t img = (size_t)(row - y) * w;
  float2 v = vel[i];
  float* o = out + 3 * (size_t)i;
  o[0] = blend(prev + img, w, locate(x, y, h, w, v.x, v.y, 1.0f, lim));
  o[1] = cur[i];
  o[2] = blend(nxt + img, w, locate(x, y, h, w, v.x, v.y, -1.0f, lim));
}

// NF fields (1, or 2 for a triplet) warped by one velocity.
template <int NF>
struct BwdArgs {
  const float* g[NF];  // g of field k at (b, y, x): g[k][b*gsb + y*gsy + x*gsx]
  long long gsb, gsy, gsx;
  const float* f[NF];  // the fields (read only for the velocity gradient)
  float dt[NF];
  const float2* vel;
  float* df[NF];       // field gradients (B, H, W), or null
  float2* dvel;        // velocity gradient (B, H, W), or null
  int h, w, tiles_x, halo;
  float lim;
};

template <int NF>
__global__ void __launch_bounds__(1024) warp2d_bwd_kernel(BwdArgs<NF> a) {
  __shared__ float acc[NF][kTile * kTile];
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / a.tiles_x) * kTile;
  const int ox0 = (blockIdx.x % a.tiles_x) * kTile;
  const int th = min(kTile, a.h - oy0), tw = min(kTile, a.w - ox0);
  const bool field_grad = a.df[0] != nullptr;
  // the pixels whose taps can reach the tile: the tile and a halo, clipped
  // to the image (for the velocity gradient alone, the tile)
  const int halo = field_grad ? a.halo : 0;
  const int sy0 = max(oy0 - halo, 0), sx0 = max(ox0 - halo, 0);
  const int sh = min(oy0 + th - 1 + halo, a.h - 1) - sy0 + 1;
  const int sw = min(ox0 + tw - 1 + halo, a.w - 1) - sx0 + 1;
  if (field_grad) {
    for (int q = threadIdx.x; q < NF * kTile * kTile; q += blockDim.x)
      acc[q / (kTile * kTile)][q % (kTile * kTile)] = 0.0f;
    __syncthreads();
  }
  const size_t img = (size_t)b * a.h * a.w;
  for (int p = threadIdx.x; p < sh * sw; p += blockDim.x) {
    const int y = sy0 + p / sw, x = sx0 + p % sw;
    const size_t i = img + (size_t)y * a.w + x;
    const float2 v = a.vel[i];
    const long long go = b * a.gsb + y * a.gsy + x * a.gsx;
    const bool own = y - oy0 >= 0 && y - oy0 < th && x - ox0 >= 0
                     && x - ox0 < tw;
    float dvx = 0.0f, dvy = 0.0f;
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      const Taps t = locate(x, y, a.h, a.w, v.x, v.y, a.dt[k], a.lim);
      const float g = __ldg(a.g[k] + go);
      if (field_grad) {  // the taps that fall in the tile
        const int r0 = t.y0 - oy0, r1 = t.y1 - oy0;
        const int c0 = t.x0 - ox0, c1 = t.x1 - ox0;
        const bool in_r0 = r0 >= 0 && r0 < th, in_r1 = r1 >= 0 && r1 < th;
        const bool in_c0 = c0 >= 0 && c0 < tw, in_c1 = c1 >= 0 && c1 < tw;
        const float gt = g * (1.0f - t.fy), gb = g * t.fy;
        const float wx0 = 1.0f - t.fx, wx1 = t.fx;
        float* s = acc[k];
        if (in_r0 && in_c0) atomicAdd(s + r0 * kTile + c0, gt * wx0);
        if (in_r0 && in_c1) atomicAdd(s + r0 * kTile + c1, gt * wx1);
        if (in_r1 && in_c0) atomicAdd(s + r1 * kTile + c0, gb * wx0);
        if (in_r1 && in_c1) atomicAdd(s + r1 * kTile + c1, gb * wx1);
      }
      if (a.dvel != nullptr && own) {
        const float* f = a.f[k] + img;
        const float f00 = __ldg(f + t.y0 * a.w + t.x0);
        const float f01 = __ldg(f + t.y0 * a.w + t.x1);
        const float f10 = __ldg(f + t.y1 * a.w + t.x0);
        const float f11 = __ldg(f + t.y1 * a.w + t.x1);
        const float s = -a.dt[k] * g;
        if (t.pass_x)
          dvx += s * ((1.0f - t.fy) * (f01 - f00) + t.fy * (f11 - f10));
        if (t.pass_y)
          dvy += s * (((1.0f - t.fx) * f10 + t.fx * f11)
                      - ((1.0f - t.fx) * f00 + t.fx * f01));
      }
    }
    if (a.dvel != nullptr && own) a.dvel[i] = make_float2(dvx, dvy);
  }
  if (!field_grad) return;
  __syncthreads();
  for (int q = threadIdx.x; q < th * tw; q += blockDim.x) {
    const int r = q / tw, c = q % tw;
    const size_t i = img + (size_t)(oy0 + r) * a.w + ox0 + c;
#pragma unroll
    for (int k = 0; k < NF; ++k) a.df[k][i] = acc[k][r * kTile + c];
  }
}

// Launch the backward for NF fields over b images: one block per tile.
template <int NF>
int launch_bwd(BwdArgs<NF> a, int b, cudaStream_t stream) {
  if (b * a.h * a.w == 0) return 0;
  float reach = 0.0f;
  for (int k = 0; k < NF; ++k) reach = fmaxf(reach, fabsf(a.dt[k]) * a.lim);
  a.halo = (int)ceilf(reach) + 1;
  a.tiles_x = (a.w + kTile - 1) / kTile;
  const int tiles = a.tiles_x * ((a.h + kTile - 1) / kTile);
  // an image of one tile is one block: give it the most threads
  warp2d_bwd_kernel<NF><<<dim3(tiles, b), tiles == 1 ? 1024 : 512, 0,
                          stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// All pointers are to float32 device memory of the device current on the
// calling thread, contiguous unless strides are given; B*H*W (3*B*H*W for
// a triplet's output) fits in an int and B <= 65535 (the wrapper checks).
// Each function launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

// field (B, H, W), vel (B, H, W, 2), out (B, H, W).
extern "C" int mpgan_warp2d(const void* field, const void* vel, void* out,
                            int b, int h, int w, float dt, float lim,
                            void* stream) {
  int n = b * h * w;
  if (n == 0) return 0;
  const int threads = 256;
  warp2d_kernel<<<(n + threads - 1) / threads, threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(field), static_cast<const float2*>(vel),
      static_cast<float*>(out), n, h, w, dt, lim);
  return (int)cudaGetLastError();
}

// prev, cur, nxt (B, H, W), vel (B, H, W, 2), out (B, H, W, 3); dt = +1
// for prev, -1 for nxt, so L = max_disp.
extern "C" int mpgan_warp2d_triplet(const void* prev, const void* cur,
                                    const void* nxt, const void* vel,
                                    void* out, int b, int h, int w, float lim,
                                    void* stream) {
  int n = b * h * w;
  if (n == 0) return 0;
  const int threads = 256;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  warp2d_triplet_kernel<<<(n + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      f(prev), f(cur), f(nxt), static_cast<const float2*>(vel),
      static_cast<float*>(out), n, h, w, lim);
  return (int)cudaGetLastError();
}

// g: the gradient of out, read at g + b*gsb + y*gsy + x*gsx; field (B, H, W)
// (read only when d_vel is given); vel (B, H, W, 2). Writes d_field
// (B, H, W) unless null and d_vel (B, H, W, 2) unless null.
extern "C" int mpgan_warp2d_bwd(const void* g, long long gsb, long long gsy,
                                long long gsx, const void* field,
                                const void* vel, void* d_field, void* d_vel,
                                int b, int h, int w, float dt, float lim,
                                void* stream) {
  BwdArgs<1> a{};
  a.g[0] = static_cast<const float*>(g);
  a.gsb = gsb; a.gsy = gsy; a.gsx = gsx;
  a.f[0] = static_cast<const float*>(field);
  a.dt[0] = dt;
  a.vel = static_cast<const float2*>(vel);
  a.df[0] = static_cast<float*>(d_field);
  a.dvel = static_cast<float2*>(d_vel);
  a.h = h; a.w = w; a.lim = lim;
  return launch_bwd(a, b, static_cast<cudaStream_t>(stream));
}

// g: the gradient of the triplet's (B, H, W, 3) output, read at
// g + b*gsb + y*gsy + x*gsx + c*gsc (channels 0 and 2). prev, nxt (B, H, W)
// (read only when d_vel is given); vel (B, H, W, 2). Writes d_prev and
// d_nxt (B, H, W) unless d_prev is null (both or neither), and d_vel
// (B, H, W, 2) unless null.
extern "C" int mpgan_warp2d_triplet_bwd(const void* g, long long gsb,
                                        long long gsy, long long gsx,
                                        long long gsc, const void* prev,
                                        const void* nxt, const void* vel,
                                        void* d_prev, void* d_nxt,
                                        void* d_vel, int b, int h, int w,
                                        float lim, void* stream) {
  BwdArgs<2> a{};
  const float* g0 = static_cast<const float*>(g);
  a.g[0] = g0;
  a.g[1] = g0 + 2 * gsc;
  a.gsb = gsb; a.gsy = gsy; a.gsx = gsx;
  a.f[0] = static_cast<const float*>(prev);
  a.f[1] = static_cast<const float*>(nxt);
  a.dt[0] = 1.0f;
  a.dt[1] = -1.0f;
  a.vel = static_cast<const float2*>(vel);
  a.df[0] = static_cast<float*>(d_prev);
  a.df[1] = d_prev != nullptr ? static_cast<float*>(d_nxt) : nullptr;
  a.dvel = static_cast<float2*>(d_vel);
  a.h = h; a.w = w; a.lim = lim;
  return launch_bwd(a, b, static_cast<cudaStream_t>(stream));
}
