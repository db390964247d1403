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
// Forward design. A block owns a tile of th x tw output pixels of one
// image (`fwd_tile` in mpgan_torch/ops/warp_kernel.py picks it, the one
// place of the rule). Before it reads any tap it puts every copy of the
// tile in flight at once with cp.async (LDGSTS): the velocity tile, and the
// window of each field that the tile's taps can reach, the tile and a halo
// of ceil(|dt| L) + 1 cells, clipped to the image (the clamp bounds the
// backtrace to +-|dt| L cells for any velocity, so the window's address
// does not depend on the velocity). One thread per pixel (below) makes
// two dependent trips to device memory, the velocity and then the taps it
// names; a block here makes one, with its whole tile's bytes in flight.
// Rows whose addresses allow it (W % 4 == 0, 16-byte aligned tensors) are
// copied in 16-byte pieces, the window widened to multiples of 4 columns;
// other shapes take 8-byte (velocity) and 4-byte (field) copies. The taps
// are then read from shared memory with the arithmetic of `locate`, so
// border clamping is exact and the result is the plain version's up to
// FMA contraction. The TPU kernel's (2R+2)^2 roll-and-select loop and
// host-side edge pad existed only because Mosaic has no gather; here the
// taps are gathered with clamped indices, which reproduces the edge pad
// exactly for displacements within +-R.
//
// The triplet stages its (pixel, 3) output in shared memory: the two warps
// and cur (copied into its slot with the other copies) are written there,
// then each row of the tile, 3 tw contiguous floats in the output, is
// stored in coalesced 16-byte pieces, where one thread per pixel stores
// 3 floats at a 12-byte stride, touching each sector three times.
//
// Where the batch is too small for several waves of tiles (`fwd_tile`
// gives 0 x 0: below 1024 tiles for one field, 4096 for a triplet, as at
// the trainer's B=16 64x64), the forwards run one thread per pixel
// instead: the velocity, then its 4 taps through L1. There the input sits
// in L2 and a call is latency-bound; a block's window brings 3-5 times its
// tile's bytes (a halo of 9 cells), and on the card every tile tried was
// slower than two dependent trips of one pixel per thread. The counts are
// where the tiled kernel overtook it on the H100 (PERF.md §6). Windows too
// large for kFwdSmemBudget (a clamp far above the trainer's 8 cells) take
// that path too.

// Backward design. The field gradient is the transpose of the 4-tap
// gather, a scatter: pixel p adds g[p] * weight into the 4 cells it read.
// The scatter is turned into ownership: each block owns a tile of TH x TW
// cells of one image and visits every pixel whose taps can reach it: the
// tile and a halo of ceil(|dt| L) + 1 pixels (the clamp bounds the reach),
// clipped to the image. It adds the taps that fall in its tile into
// shared memory and drops the others, then stores the tile with plain
// coalesced writes. No output is zeroed first, no block writes another's
// cells, and no global atomic is needed.
//
// Staging. A block first copies its window's v and g into shared memory
// with cp.async (every copy in flight at once, LDGSTS), takes max |g| from
// there, and scatters from there; a window too large for its share of
// shared memory (kSmemBudget, two blocks per SM) is staged in chunks of
// rows, its max read from device memory first. The kernel is instantiated
// for the gradients asked for, so the train step's (field gradients only)
// carries no velocity-gradient code.
//
// Tiles that fill the card. The wrapper picks the tile (`bwd_tile` in
// mpgan_torch/ops/warp_kernel.py, the one place of the rule): the largest
// (64x64 for one field, 32x64 for a triplet, whose 64x64 window would need
// three chunks) when the batch gives at least two blocks per SM, else
// 16x32: the trainer's B=16 64x64 runs 128 blocks, where one 64x64 tile
// per image ran 16 on 132 SMs. A block has 512 threads. A pixel is visited
// once per tile its taps can reach: 1.6 times at 64x64 in 256x256, 2.0 at
// 32x64, 2.4 at 16x32 in 64x64.
//
// Fixed-point sums, so that the gradient does not depend on the order of
// the adds. Float atomics add in an order that changes from run to run,
// and a shared float atomicAdd is a CAS loop on sm_90a (ATOMS.CAST.SPIN).
// Integer adds are exact and commute, so each block:
// 1. reduces M = max |g| over its window, per field (REDUX.MAX on the
//    bits of |g|, which order as the floats do, then one slot per warp);
// 2. takes e = 30 - E for M = m 2^E, m in [1/2, 1), clamped to
//    [-126, 127] so that 2^e and 2^-e are floats: M 2^e < 2^30;
// 3. rounds each tap's term q = rn(g 2^e w_y w_x), |q| <= 2^30, to an int
//    and adds it to its cell's 64-bit sum, kept as two 32-bit words: a
//    native add into the low word (started at 2^31), and a second into the
//    high word only when the low word wraps (add_fixed). A cell's sum stays
//    far inside 64 bits, so the words hold it exactly;
// 4. stores each cell as (hi 2^32 + lo - 2^31) 2^-e, rounded once.
// The same inputs give the same bits on every run. The SASS (cuobjdump
// -sass of the built library) shows why 32-bit words: a 64-bit shared
// atomicAdd is a CAS loop on sm_90a (ATOMS.CAST.SPIN.64), a 32-bit integer
// one is native (ATOMS.ADD), as are REDUX.MAX and LDGSTS; the backward has
// no ATOMS.CAST.SPIN.
//
// Error budget. Each term's rounding is at most 2^-(e+1) <= 2^-30 M. A
// pixel adds at most one nonzero term to a cell (its coinciding border
// taps carry weight 0), and only pixels within halo - 1 of a cell in each
// axis reach it: at most (2 halo)^2 terms, so a cell is off the exact sum
// of its float terms by at most (2 halo)^2 2^-30 M, 3.0e-7 M at the
// trainer's clamp (halo 9). The float products g w_y w_x round as the
// plain version's do. A window with a non-finite g stores NaN in its whole
// tile (the plain version spreads NaN or inf to the taps only); a window
// whose g is all zero stores zeros.
//
// Bound: the field gradients read g (4 B per field) and v (8 B) and write
// 4 B per field, each once: 24 B per pixel for a triplet, 16 B for one
// field (above). The halo re-reads g and v, from L2 at best.
//
// The velocity gradient needs no atomics: each pixel's own
// -dt g (d out / d p), with d out / d px = (1-fy)(f[y0,x1] - f[y0,x0])
// + fy (f[y1,x1] - f[y1,x0]) and d out / d py alike, summed over the
// fields, and masked as torch's clamp backward masks: inclusively, so the
// gradient passes where the velocity or the backtrace lies exactly on its
// bound (zero velocity on a border pixel).
//
// Tolerance. The field gradients differ from the plain version's by the
// fixed-point budget above and by the plain version's own float sums,
// whose order differs (on a card they are float atomics): a few ulps of
// the sum of a cell's |terms|, most where the clamps pile many pixels onto
// one border cell. They are held at 1e-4 against the plain version, the
// tolerance the JAX package's tests give the VJP, and bit for bit against
// themselves over repeated calls. The forward has no reduction; its gap to
// the plain version is FMA contraction in the blend, held at 1e-5.
//
// Launch. Each entry point takes the device of its tensors and PyTorch's
// current stream on it, makes that device current only if it is not, and
// restores it.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;           // backward: threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBudget = 112 * 1024; // backward: two blocks per SM
constexpr int kFwdThreads = 256;        // forward: threads of a block
constexpr int kFwdSmemBudget = 112 * 1024;  // forward: two blocks per SM

// Make device `dev` current for a launch if it is not, and restore the
// caller's device after.
struct DeviceGuard {
  int prev = -1, dev;
  explicit DeviceGuard(int d) : dev(d) {
    cudaGetDevice(&prev);
    if (prev != dev) cudaSetDevice(dev);
  }
  ~DeviceGuard() {
    if (prev != dev) cudaSetDevice(prev);
  }
};

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

// The 4-tap bilinear blend of taps t; f(y, x) reads the field at image
// cell (y, x), from the staged window or from device memory.
template <class Field>
__device__ __forceinline__ float blend(Field f, const Taps& t) {
  float top = f(t.y0, t.x0) * (1.0f - t.fx) + f(t.y0, t.x1) * t.fx;
  float bot = f(t.y1, t.x0) * (1.0f - t.fx) + f(t.y1, t.x1) * t.fx;
  return top * (1.0f - t.fy) + bot * t.fy;
}

// NF fields (1, or 2 for a triplet's prev and nxt) warped by one velocity.
template <int NF>
struct FwdArgs {
  const float* f[NF];  // the fields (B, H, W)
  float dt[NF];
  const float* cur;    // a triplet's middle field (B, H, W)
  const float2* vel;
  float* out;          // (B, H, W) for one field, (B, H, W, 3) for a triplet
  int h, w, th, tw, halo;
  int tw_shift;        // tw = 2^tw_shift
  int win_shift;       // a window row's copies fit 2^win_shift slots
  int win_cap;         // floats of one field's staged window
  bool vec;            // W % 4 == 0 and every tensor 16-byte aligned
  float lim;
};

// One thread per output pixel (the latency-bound shapes): the velocity,
// then its taps, read from device memory, the triplet's three values
// stored at a 12-byte stride.
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
  const float* f = field + (size_t)(row - y) * w;
  out[i] = blend([&](int yy, int xx) { return __ldg(f + yy * w + xx); },
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
  const float* p = prev + img;
  const float* q = nxt + img;
  o[0] = blend([&](int yy, int xx) { return __ldg(p + yy * w + xx); },
               locate(x, y, h, w, v.x, v.y, 1.0f, lim));
  o[1] = cur[i];
  o[2] = blend([&](int yy, int xx) { return __ldg(q + yy * w + xx); },
               locate(x, y, h, w, v.x, v.y, -1.0f, lim));
}

// One tile per block (the bandwidth-bound shapes), the field windows
// staged in shared memory. Block (x, y, z) owns the tile at column x tw,
// row y th of image z. Every loop maps its index to (row, column) with
// shifts and masks over power-of-two row slots, never a division.
template <int NF>
__global__ void __launch_bounds__(kFwdThreads)
    warp2d_fwd_kernel(FwdArgs<NF> a) {
  // shared: the velocity tile (th x tw, row stride tw), then each field's
  // window (sh x sw, row stride sw), then a triplet's output tile
  // (th x tw x 3, row stride 3 tw)
  extern __shared__ float4 smem[];
  float2* s_vel = reinterpret_cast<float2*>(smem);
  float* s_f = reinterpret_cast<float*>(s_vel + a.th * a.tw);
  float* s_out = s_f + NF * a.win_cap;
  const int oy0 = blockIdx.y * a.th, ox0 = blockIdx.x * a.tw;
  const int th = min(a.th, a.h - oy0), tw = min(a.tw, a.w - ox0);
  const size_t img = (size_t)blockIdx.z * a.h * a.w;
  const int ts = a.tw_shift, tmask = a.tw - 1;
  // the window: the tile and a halo, clipped to the image; with 16-byte
  // copies its columns widened to multiples of 4 (W % 4 == 0)
  const int sy0 = max(oy0 - a.halo, 0);
  const int sh = min(oy0 + th + a.halo, a.h) - sy0;
  int sx0 = max(ox0 - a.halo, 0), sx1 = min(ox0 + tw + a.halo, a.w);
  if (a.vec) {
    sx0 &= ~3;
    sx1 = min((sx1 + 3) & ~3, a.w);
  }
  const int sw = sx1 - sx0;
  const int step = a.vec ? 4 : 1;  // floats per copy of a field row

  // 1. every copy in flight at once (cp.async), then wait
  if (a.vec) {  // two velocity pixels per 16-byte copy (tw is even)
    for (int q = threadIdx.x; q < th << (ts - 1); q += blockDim.x) {
      const int r = q >> (ts - 1), c = 2 * (q & (tmask >> 1));
      if (c < tw)
        __pipeline_memcpy_async(
            s_vel + r * a.tw + c,
            a.vel + img + (size_t)(oy0 + r) * a.w + ox0 + c, 16);
    }
  } else {
    for (int q = threadIdx.x; q < th << ts; q += blockDim.x) {
      const int r = q >> ts, c = q & tmask;
      if (c < tw)
        __pipeline_memcpy_async(
            s_vel + r * a.tw + c,
            a.vel + img + (size_t)(oy0 + r) * a.w + ox0 + c, sizeof(float2));
    }
  }
  {
    const int ws = a.win_shift, wmask = (1 << ws) - 1, pieces = sw / step;
    for (int q = threadIdx.x; q < sh << ws; q += blockDim.x) {
      const int r = q >> ws, c = (q & wmask) * step;
      if (c >= pieces * step) continue;
      const size_t src = img + (size_t)(sy0 + r) * a.w + sx0 + c;
#pragma unroll
      for (int k = 0; k < NF; ++k)
        __pipeline_memcpy_async(s_f + k * a.win_cap + r * sw + c,
                                a.f[k] + src, step * sizeof(float));
    }
  }
  if (NF == 2) {  // cur into its slot of the staged output
    for (int q = threadIdx.x; q < th << ts; q += blockDim.x) {
      const int r = q >> ts, c = q & tmask;
      if (c < tw)
        __pipeline_memcpy_async(
            s_out + (r * a.tw + c) * 3 + 1,
            a.cur + img + (size_t)(oy0 + r) * a.w + ox0 + c, sizeof(float));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2. the warps, from the staged taps
  for (int q = threadIdx.x; q < th << ts; q += blockDim.x) {
    const int r = q >> ts, c = q & tmask;
    if (c >= tw) continue;
    const int y = oy0 + r, x = ox0 + c;
    const float2 v = s_vel[q];
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      const Taps t = locate(x, y, a.h, a.w, v.x, v.y, a.dt[k], a.lim);
      const float* win = s_f + k * a.win_cap;
      const float res = blend([&](int yy, int xx) {
        return win[(yy - sy0) * sw + (xx - sx0)];
      }, t);
      if (NF == 1)
        a.out[img + (size_t)y * a.w + x] = res;
      else
        s_out[q * 3 + 2 * k] = res;
    }
  }
  if (NF == 1) return;
  __syncthreads();

  // 3. a triplet's tile: each row 3 tw contiguous floats of the output, in
  // 16-byte stores where the addresses allow (3 tw / 4 <= tw slots a row;
  // 3 tw <= 4 tw for single floats)
  const int ss = a.vec ? ts : ts + 2, smask = (1 << ss) - 1;
  const int pieces = 3 * tw / step;
  for (int q = threadIdx.x; q < th << ss; q += blockDim.x) {
    const int r = q >> ss, c = (q & smask) * step;
    if (c >= pieces * step) continue;
    const float* src = s_out + r * 3 * a.tw + c;
    float* dst = a.out + 3 * (img + (size_t)(oy0 + r) * a.w + ox0) + c;
    if (a.vec)
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    else
      *dst = *src;
  }
}

// Launch the forward for NF fields over b images: one block per tile of
// th x tw pixels (tw a power of 2, at least 4) with its windows staged, or,
// for th = tw = 0 or windows too large for kFwdSmemBudget (a clamp far
// above the trainer's), one thread per pixel.
template <int NF>
int launch_fwd(FwdArgs<NF> a, int b, int dev, cudaStream_t stream) {
  const int n = b * a.h * a.w;
  if (n == 0) return 0;
  const bool tiled = a.th > 0;
  if (a.th < 0 || (tiled && (a.tw < 4 || (a.tw & (a.tw - 1)))))
    return (int)cudaErrorInvalidValue;
  float reach = 0.0f;
  for (int k = 0; k < NF; ++k) reach = fmaxf(reach, fabsf(a.dt[k]) * a.lim);
  a.halo = (int)ceilf(fminf(reach, 1e6f)) + 1;
  // the widest window: the tile, the halo and up to 3 + 3 columns of
  // widening to multiples of 4, within the image; rounded up to 4 floats,
  // so that every window starts 16-byte aligned
  const long long win_h = std::min(a.th + 2 * a.halo, a.h);
  const long long win_w = std::min(a.tw + 2 * a.halo + 6, a.w);
  a.win_cap = (int)std::min((win_h * win_w + 3) & ~3ll, 1ll << 28);
  const long long tile = (long long)a.th * a.tw;
  const long long smem = tile * sizeof(float2) + (NF == 2 ? tile * 12 : 0)
                         + (long long)NF * a.win_cap * sizeof(float);
  const dim3 grid(tiled ? (a.w + a.tw - 1) / a.tw : 0,
                  tiled ? (a.h + a.th - 1) / a.th : 0, b);
  DeviceGuard guard(dev);
  if (!tiled || smem > kFwdSmemBudget || grid.y > 65535) {
    const int blocks = (n + kFwdThreads - 1) / kFwdThreads;
    if constexpr (NF == 1)
      warp2d_kernel<<<blocks, kFwdThreads, 0, stream>>>(
          a.f[0], a.vel, a.out, n, a.h, a.w, a.dt[0], a.lim);
    else
      warp2d_triplet_kernel<<<blocks, kFwdThreads, 0, stream>>>(
          a.f[0], a.cur, a.f[1], a.vel, a.out, n, a.h, a.w, a.lim);
    return (int)cudaGetLastError();
  }
  a.vec = a.w % 4 == 0 && (uintptr_t)a.vel % 16 == 0
          && (uintptr_t)a.out % 16 == 0;
  for (int k = 0; k < NF; ++k) a.vec = a.vec && (uintptr_t)a.f[k] % 16 == 0;
  a.tw_shift = 0;
  while ((1 << a.tw_shift) < a.tw) ++a.tw_shift;
  const long long slots = a.vec ? (win_w + 3) / 4 : win_w;
  a.win_shift = 0;
  while ((1ll << a.win_shift) < slots) ++a.win_shift;
  if (smem > 48 * 1024) {
    int err = (int)cudaFuncSetAttribute(
        warp2d_fwd_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
  }
  warp2d_fwd_kernel<NF><<<grid, (int)std::min<long long>(kFwdThreads, tile),
                          (int)smem, stream>>>(a);
  return (int)cudaGetLastError();
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
  int h, w, th, tw, tiles_x, halo;
  int win_cap;         // window pixels staged in shared memory at once
  float lim;
};

// Add the term q = rn(term) to a cell's 64-bit sum, held as a low word
// (unsigned, started at 2^31) and a high word (signed): one native 32-bit
// add into the low word, and one into the high word only when the low word
// wraps (its carry, or its borrow for a negative q). The start at 2^31
// keeps the low word away from its wrap while the cell's sum stays within
// +-2^31, so the second add is rare. Integer adds commute, so the cell's
// final words do not depend on the order of the adds.
__device__ __forceinline__ void add_fixed(unsigned* lo, int* hi, int cell,
                                          float term) {
  const int q = __float2int_rn(term);
  if (q == 0) return;
  const unsigned old = atomicAdd(lo + cell, (unsigned)q);
  const int qh = (q >> 31) + (old + (unsigned)q < old ? 1 : 0);
  if (qh != 0) atomicAdd(hi + cell, qh);
}

// (y, x) of window pixel q of a window sw pixels wide, for a thread that
// walks q = first, first + step, ...: division once, then adds.
struct WindowWalk {
  int wy, wx, dy, dx, sw;
  __device__ WindowWalk(int first, int step, int width)
      : wy(first / width), wx(first % width), dy(step / width),
        dx(step % width), sw(width) {}
  __device__ void next() {
    wx += dx;
    wy += dy;
    if (wx >= sw) {
      wx -= sw;
      ++wy;
    }
  }
};

// FG: the field gradients are asked for; VG: the velocity gradient.
template <int NF, bool FG, bool VG>
__global__ void __launch_bounds__(kThreads, 2)
    warp2d_bwd_kernel(BwdArgs<NF> a) {
  // shared: the staged window (v, then g of each field), then the planes
  // (low words, then high words, of each field's th * tw cells)
  extern __shared__ float4 smem[];
  __shared__ unsigned warp_max[NF][kWarps];
  const int cells = a.th * a.tw;
  float2* s_vel = reinterpret_cast<float2*>(smem);
  float* s_g = reinterpret_cast<float*>(s_vel + a.win_cap);
  unsigned* lo = reinterpret_cast<unsigned*>(s_g + NF * a.win_cap);
  int* hi = reinterpret_cast<int*>(lo + NF * cells);
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / a.tiles_x) * a.th;
  const int ox0 = (blockIdx.x % a.tiles_x) * a.tw;
  const int th = min(a.th, a.h - oy0), tw = min(a.tw, a.w - ox0);
  // the pixels whose taps can reach the tile: the tile and a halo, clipped
  // to the image (for the velocity gradient alone, the halo is 0)
  const int sy0 = max(oy0 - a.halo, 0), sx0 = max(ox0 - a.halo, 0);
  const int sh = min(oy0 + th - 1 + a.halo, a.h - 1) - sy0 + 1;
  const int sw = min(ox0 + tw - 1 + a.halo, a.w - 1) - sx0 + 1;
  const int n = sh * sw;
  const size_t img = (size_t)b * a.h * a.w;
  const long long gb = b * a.gsb;
  const int rows_cap = a.win_cap / sw;  // >= 1 (the launcher sees to it)
  const int chunks = (sh + rows_cap - 1) / rows_cap;

  // stage window rows [r0, r1) in shared memory: every copy in flight at
  // once (cp.async), then wait
  auto stage = [&](int r0, int r1) {
    WindowWalk it(threadIdx.x, blockDim.x, sw);
    for (int q = threadIdx.x; q < (r1 - r0) * sw; q += blockDim.x) {
      const int y = sy0 + r0 + it.wy, x = sx0 + it.wx;
      __pipeline_memcpy_async(s_vel + q, a.vel + img + (size_t)y * a.w + x,
                              sizeof(float2));
      const long long go = gb + y * a.gsy + x * a.gsx;
#pragma unroll
      for (int k = 0; k < NF; ++k)
        __pipeline_memcpy_async(s_g + k * a.win_cap + q, a.g[k] + go,
                                sizeof(float));
      it.next();
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  };

  // 1. start the planes; max |g| over the window, per field (from the
  // staged window, or from device memory when it is staged in chunks)
  float scale[NF], inv[NF];
  bool bad[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    scale[k] = inv[k] = 1.0f;
    bad[k] = false;
  }
  if (FG) {
    for (int q = threadIdx.x; q < 2 * NF * cells; q += blockDim.x)
      lo[q] = q < NF * cells ? 0x80000000u : 0u;  // then hi, after lo
    unsigned m[NF];
#pragma unroll
    for (int k = 0; k < NF; ++k) m[k] = 0u;
    if (chunks == 1) {
      stage(0, sh);
      for (int q = threadIdx.x; q < n; q += blockDim.x) {
#pragma unroll
        for (int k = 0; k < NF; ++k)
          m[k] = max(m[k], __float_as_uint(fabsf(s_g[k * a.win_cap + q])));
      }
    } else {
      WindowWalk it(threadIdx.x, blockDim.x, sw);
      for (int q = threadIdx.x; q < n; q += blockDim.x) {
        const long long go =
            gb + (sy0 + it.wy) * a.gsy + (sx0 + it.wx) * a.gsx;
#pragma unroll
        for (int k = 0; k < NF; ++k)
          m[k] = max(m[k], __float_as_uint(fabsf(__ldg(a.g[k] + go))));
        it.next();
      }
    }
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      m[k] = __reduce_max_sync(0xffffffffu, m[k]);
      if ((threadIdx.x & 31) == 0) warp_max[k][warp] = m[k];
    }
    __syncthreads();
    // 2. the exponent: M 2^e < 2^30, so that every term fits an int
    const int nwarps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      unsigned bits = 0u;
      for (int j = 0; j < nwarps; ++j) bits = max(bits, warp_max[k][j]);
      bad[k] = bits >= 0x7f800000u;  // inf or NaN (fabsf clears the sign)
      int e = 0;
      if (bits != 0u && !bad[k]) {
        int ex;
        frexpf(__uint_as_float(bits), &ex);  // M < 2^ex
        e = min(max(30 - ex, -126), 127);
      }
      scale[k] = ldexpf(1.0f, e);
      inv[k] = ldexpf(1.0f, -e);
    }
  }

  // 3. the scatter, and the velocity gradient of the tile's own pixels,
  // chunk by chunk of window rows
  for (int c = 0; c < chunks; ++c) {
    const int r0 = c * rows_cap, r1 = min(r0 + rows_cap, sh);
    if (!FG || chunks > 1) {
      if (c > 0) __syncthreads();  // the last chunk's reads are done
      stage(r0, r1);
    }
    WindowWalk it(threadIdx.x, blockDim.x, sw);
    for (int q = threadIdx.x; q < (r1 - r0) * sw; q += blockDim.x) {
      const int y = sy0 + r0 + it.wy, x = sx0 + it.wx;
      it.next();
      const float2 v = s_vel[q];
      float dvx = 0.0f, dvy = 0.0f;
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const Taps t = locate(x, y, a.h, a.w, v.x, v.y, a.dt[k], a.lim);
        const float g = s_g[k * a.win_cap + q];
        if (FG) {  // the taps that fall in the tile
          const int r0t = t.y0 - oy0, r1t = t.y1 - oy0;
          const int c0t = t.x0 - ox0, c1t = t.x1 - ox0;
          const bool in_r0 = (unsigned)r0t < (unsigned)th;
          const bool in_r1 = (unsigned)r1t < (unsigned)th;
          const bool in_c0 = (unsigned)c0t < (unsigned)tw;
          const bool in_c1 = (unsigned)c1t < (unsigned)tw;
          const float gs = g * scale[k];
          const float gt = gs * (1.0f - t.fy), gbt = gs * t.fy;
          const float wx0 = 1.0f - t.fx, wx1 = t.fx;
          unsigned* pl = lo + k * cells;
          int* ph = hi + k * cells;
          if (in_r0 && in_c0) add_fixed(pl, ph, r0t * a.tw + c0t, gt * wx0);
          if (in_r0 && in_c1) add_fixed(pl, ph, r0t * a.tw + c1t, gt * wx1);
          if (in_r1 && in_c0) add_fixed(pl, ph, r1t * a.tw + c0t, gbt * wx0);
          if (in_r1 && in_c1) add_fixed(pl, ph, r1t * a.tw + c1t, gbt * wx1);
        }
        if (VG) {
          const float* f = a.f[k] + img;
          const float f00 = __ldg(f + t.y0 * a.w + t.x0);
          const float f01 = __ldg(f + t.y0 * a.w + t.x1);
          const float f10 = __ldg(f + t.y1 * a.w + t.x0);
          const float f11 = __ldg(f + t.y1 * a.w + t.x1);
          const float sg = -a.dt[k] * g;
          if (t.pass_x)
            dvx += sg * ((1.0f - t.fy) * (f01 - f00) + t.fy * (f11 - f10));
          if (t.pass_y)
            dvy += sg * (((1.0f - t.fx) * f10 + t.fx * f11)
                         - ((1.0f - t.fx) * f00 + t.fx * f01));
        }
      }
      if (VG && (unsigned)(y - oy0) < (unsigned)th
          && (unsigned)(x - ox0) < (unsigned)tw)  // a pixel of the tile
        a.dvel[img + (size_t)y * a.w + x] = make_float2(dvx, dvy);
    }
  }
  if (!FG) return;
  __syncthreads();

  // 4. the tile: (hi 2^32 + lo - 2^31) 2^-e, rounded once
  for (int q = threadIdx.x; q < th * tw; q += blockDim.x) {
    const int r = q / tw, cc = q % tw;
    const size_t i = img + (size_t)(oy0 + r) * a.w + ox0 + cc;
    const int cell = r * a.tw + cc;
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      const long long sum = (long long)hi[k * cells + cell] * 4294967296ll
                            + (long long)lo[k * cells + cell] - 2147483648ll;
      a.df[k][i] = bad[k] ? __int_as_float(0x7fc00000)
                          : __ll2float_rn(sum) * inv[k];
    }
  }
}

// Launch one instantiation on the current device, its shared memory above
// 48 KB allowed first.
template <int NF, bool FG, bool VG>
int launch_one(const BwdArgs<NF>& a, dim3 grid, int smem,
               cudaStream_t stream) {
  if (smem > 48 * 1024) {
    int err = (int)cudaFuncSetAttribute(
        warp2d_bwd_kernel<NF, FG, VG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  warp2d_bwd_kernel<NF, FG, VG><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Launch the backward for NF fields over b images: one block per tile of
// th x tw cells, its window staged in at most kSmemBudget bytes of shared
// memory (two blocks per SM), in one chunk where it fits.
template <int NF>
int launch_bwd(BwdArgs<NF> a, int b, int dev, cudaStream_t stream) {
  const bool fg = a.df[0] != nullptr, vg = a.dvel != nullptr;
  if (b * a.h * a.w == 0 || !(fg || vg)) return 0;
  if (a.th <= 0 || a.tw <= 0) return (int)cudaErrorInvalidValue;
  float reach = 0.0f;
  for (int k = 0; k < NF; ++k) reach = fmaxf(reach, fabsf(a.dt[k]) * a.lim);
  a.halo = fg ? (int)ceilf(fminf(reach, 1e6f)) + 1 : 0;
  const long long win_h = std::min(a.th + 2 * a.halo, a.h);
  const long long win_w = std::min(a.tw + 2 * a.halo, a.w);
  const long long px_bytes = sizeof(float2) + NF * sizeof(float);
  const long long planes = fg ? 2ll * NF * a.th * a.tw * 4 : 0;
  const long long rows = (kSmemBudget - planes) / (px_bytes * win_w);
  if (rows < 1) return (int)cudaErrorInvalidValue;  // a window row too wide
  a.win_cap = (int)(std::min(rows, win_h) * win_w);
  const int smem = (int)(a.win_cap * px_bytes + planes);
  a.tiles_x = (a.w + a.tw - 1) / a.tw;
  const dim3 grid(a.tiles_x * ((a.h + a.th - 1) / a.th), b);
  DeviceGuard guard(dev);
  if (fg && vg) return launch_one<NF, true, true>(a, grid, smem, stream);
  if (fg) return launch_one<NF, true, false>(a, grid, smem, stream);
  return launch_one<NF, false, true>(a, grid, smem, stream);
}

}  // namespace

// All pointers are to float32 device memory of device `dev`, contiguous
// unless strides are given; B*H*W (3*B*H*W for a triplet's output) fits in
// an int and B <= 65535 (the wrapper checks). Each function launches on
// `stream` (a stream of `dev`), allocates nothing, does not synchronise,
// and returns cudaGetLastError() (cudaErrorInvalidValue for a tile it does
// not take). csrc/warp_ops.cpp calls the two forwards from PyTorch's
// dispatcher; the backwards are called through ctypes.

// field (B, H, W), vel (B, H, W, 2), out (B, H, W); th x tw is the tile of
// a block (tw a power of 2, at least 4), or 0 x 0 for one thread per pixel.
extern "C" int mpgan_warp2d(const void* field, const void* vel, void* out,
                            int b, int h, int w, int th, int tw, float dt,
                            float lim, int dev, void* stream) {
  FwdArgs<1> a{};
  a.f[0] = static_cast<const float*>(field);
  a.dt[0] = dt;
  a.vel = static_cast<const float2*>(vel);
  a.out = static_cast<float*>(out);
  a.h = h; a.w = w; a.th = th; a.tw = tw; a.lim = lim;
  return launch_fwd(a, b, dev, static_cast<cudaStream_t>(stream));
}

// prev, cur, nxt (B, H, W), vel (B, H, W, 2), out (B, H, W, 3); dt = +1
// for prev, -1 for nxt, so L = max_disp; th x tw as for mpgan_warp2d.
extern "C" int mpgan_warp2d_triplet(const void* prev, const void* cur,
                                    const void* nxt, const void* vel,
                                    void* out, int b, int h, int w, int th,
                                    int tw, float lim, int dev,
                                    void* stream) {
  FwdArgs<2> a{};
  a.f[0] = static_cast<const float*>(prev);
  a.f[1] = static_cast<const float*>(nxt);
  a.dt[0] = 1.0f;
  a.dt[1] = -1.0f;
  a.cur = static_cast<const float*>(cur);
  a.vel = static_cast<const float2*>(vel);
  a.out = static_cast<float*>(out);
  a.h = h; a.w = w; a.th = th; a.tw = tw; a.lim = lim;
  return launch_fwd(a, b, dev, static_cast<cudaStream_t>(stream));
}

// g: the gradient of out, read at g + b*gsb + y*gsy + x*gsx; field (B, H, W)
// (read only when d_vel is given); vel (B, H, W, 2). Writes d_field
// (B, H, W) unless null and d_vel (B, H, W, 2) unless null; th x tw is the
// tile of a block.
extern "C" int mpgan_warp2d_bwd(const void* g, long long gsb, long long gsy,
                                long long gsx, const void* field,
                                const void* vel, void* d_field, void* d_vel,
                                int b, int h, int w, int th, int tw, float dt,
                                float lim, int dev, void* stream) {
  BwdArgs<1> a{};
  a.g[0] = static_cast<const float*>(g);
  a.gsb = gsb; a.gsy = gsy; a.gsx = gsx;
  a.f[0] = static_cast<const float*>(field);
  a.dt[0] = dt;
  a.vel = static_cast<const float2*>(vel);
  a.df[0] = static_cast<float*>(d_field);
  a.dvel = static_cast<float2*>(d_vel);
  a.h = h; a.w = w; a.th = th; a.tw = tw; a.lim = lim;
  return launch_bwd(a, b, dev, static_cast<cudaStream_t>(stream));
}

// g: the gradient of the triplet's (B, H, W, 3) output, read at
// g + b*gsb + y*gsy + x*gsx + c*gsc (channels 0 and 2). prev, nxt (B, H, W)
// (read only when d_vel is given); vel (B, H, W, 2). Writes d_prev and
// d_nxt (B, H, W) unless d_prev is null (both or neither), and d_vel
// (B, H, W, 2) unless null; th x tw is the tile of a block.
extern "C" int mpgan_warp2d_triplet_bwd(const void* g, long long gsb,
                                        long long gsy, long long gsx,
                                        long long gsc, const void* prev,
                                        const void* nxt, const void* vel,
                                        void* d_prev, void* d_nxt,
                                        void* d_vel, int b, int h, int w,
                                        int th, int tw, float lim, int dev,
                                        void* stream) {
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
  a.h = h; a.w = w; a.th = th; a.tw = tw; a.lim = lim;
  return launch_bwd(a, b, dev, static_cast<cudaStream_t>(stream));
}
