// The slice generator's convolutions for Hopper (sm_90a): 3x3 convolutions
// of bf16 NHWC activations with the bias, the ReLU, the residual sum (and
// the ResBlock's 1x1 projection) or the output head's global density skip
// in the epilogue.
//
// Why. The generator's inference forward ran its convolutions through
// cuDNN in NCHW views: every convolution paid cuDNN's nchwToNhwc and
// nhwcToNchw transposes around an NHWC implicit GEMM, then an ATen add for
// the bias, another for the residual sum and a clamp for the ReLU. In the
// frame cells those kernels took about 80-90% of the device time (PERF.md
// section 5). This replaces no Pallas kernel: the JAX package leaves its
// convolutions to XLA (`nn.Conv` in mpgan_tpu/models/generator.py).
//
// Bound. At widths 8-32 a 3x3 convolution does about 44 flops per byte it
// must move (bf16 in and out), far below the H100's 295: each is bound by
// bytes. So the design moves each tensor once: a ResBlock is two launches
// (conv1 + bias + ReLU; conv2 + bias + skip + ReLU, the skip being the
// block's input or its 1x1 projection computed here from the same pixels),
// the stem one, the used head one. Nothing is transposed.
//
// Function. For an input x (B, H, W, CIN) read at strides (slice, row,
// pixel) with unit channel stride, weights w (COUT, CIN, 3, 3) float32 as
// nn.Conv2d holds them and bias b (COUT) float32, zero padding 1:
//   mode 0: out = relu(conv(x) + b)                          (bf16, NHWC)
//   mode 1: out = relu(conv(x) + b + skip)                    (bf16, NHWC)
//           skip = wp . s + bp (wp (COUT, CX), bp (COUT)) or s itself,
//           s (B, H, W, CX) the ResBlock's input at its own strides
//   mode 2: out = conv(x) + b [+ up(d)], one output channel   (f32 or bf16)
//           d (B, DH, DW) the generator's input density at its strides,
//           up the half-pixel, edge-clamped bilinear upsample to (H, W)
//           with PyTorch's source-index arithmetic (F.interpolate,
//           align_corners=False).
// Weights and biases are rounded to bf16 inside each call (the model's
// parameters are float32 and may change in place between replays of a
// captured program), products are summed in float32 by the tensor cores
// in one fixed order, and the result is rounded once at its store. No
// atomics: the same inputs give the same bits on every call.
//
// Design. A block owns a tile of 16 x 32 output pixels of one slice and
// every output channel: the GEMM of M = 512 pixels, N = COUT, K = 9 CIN
// (+ CX for the projection). Blocks are persistent: each walks tiles
// blockIdx.x, + gridDim.x, ... and puts the next tile's loads in flight
// (cp.async, zero fill out of bounds = the convolution's zero padding)
// before it computes the current one from the other of two shared-memory
// buffers. A buffer holds the tile's 18 x 34 input halo (and, in mode 1,
// the 16 x 32 pixels of s); the packed weights stay for the whole launch.
// Each of 8 warps computes two rows of 32 pixels (four m16 tiles) with
// mma.sync m16n8k16 bf16 on ldmatrix fragments: per tap and 16 input
// channels one k16 step; at CIN 8 two taps share a k16 step, and CIN 4 is
// held as 8 channels with zeros. Pixels, weight rows and output rows are
// padded in shared memory to an odd number of 16-byte units, so the eight
// rows of an ldmatrix phase and the fragment stores fall in distinct banks.
// The epilogue adds the bias, applies the ReLU (modes 0 and 1; the skip is
// a part of the GEMM there, with identity weights for s itself), stages
// the tile in shared memory and stores it in 16-byte NHWC pieces; the head
// (mode 2, N padded to 8) stages its one channel and stores it with
// every thread, neighbouring pixels side by side.
// Tiles are walked slice-fastest when the input's slices lie closer in
// memory than its pixels (pass 3's yz slices of an xyz volume), so blocks
// in flight together share the input's sectors through L2; else row-major.
//
// Launch. The entry point takes the device of its tensors and PyTorch's
// current stream on it, makes that device current only if it is not, and
// restores it. It returns -1 for widths it has no kernel for, else
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 16;       // tile rows
constexpr int kTW = 32;       // tile columns
constexpr int kThreads = 256; // 8 warps, two tile rows each
constexpr int kMaxDevices = 64;

// bytes of a row of `elems` bf16 values, padded to an odd number of
// 16-byte units (conflict-free ldmatrix phases and fragment stores)
constexpr int padded(int elems) {
  return ((elems / 8) % 2 ? elems / 8 : elems / 8 + 1) * 16;
}

template <int CIN, int COUT, int CX, int MODE>
struct Cfg {
  static constexpr int CIN_S = CIN < 8 ? 8 : CIN;    // channels held
  static constexpr int NP = MODE == 2 ? 8 : COUT;    // GEMM width
  static constexpr int NREAL = MODE == 2 ? 1 : COUT; // output channels
  static constexpr int NT = NP / 8;                  // n8 tiles
  static constexpr int HH = kTH + 2, HW = kTW + 2;   // halo tile
  static constexpr int PS = padded(CIN_S);           // halo pixel bytes
  static constexpr int XS = MODE == 1 ? padded(CX) : 0;
  static constexpr int OS = padded(NP);               // staged pixel bytes
  static constexpr int KC = CIN_S >= 16 ? 9 * CIN_S / 16 : 5;  // conv k16
  static constexpr int KS = MODE == 1 ? (CX >= 16 ? CX / 16 : 1) : 0;
  static constexpr int K = 16 * (KC + KS);
  static constexpr int WROW = padded(K);
  static constexpr int BIAS_BYTES = 128;
  static constexpr int W_BYTES = NP * WROW;
  static constexpr int HALO_BYTES = HH * HW * PS;
  static constexpr int X_BYTES = kTH * kTW * XS;
  // mode 2 stages its one channel as float32
  static constexpr int STAGE_BYTES = kTH * kTW * (MODE == 2 ? 4 : OS);
  // the staged output reuses the computed halo buffer where it fits (a
  // CIN 4 halo keeps zeros in its upper half, so it is never reused)
  static constexpr bool STAGE_ALIAS = STAGE_BYTES <= HALO_BYTES && CIN >= 8;
  static constexpr int SMEM = BIAS_BYTES + W_BYTES + 2 * HALO_BYTES +
                              2 * X_BYTES + (STAGE_ALIAS ? 0 : STAGE_BYTES);
};

struct Args {
  const __nv_bfloat16* x;        // input (B, H, W, CIN)
  long long sb, sh, sw;          // its strides in elements
  int b, h, w;
  const float* wt;               // (COUT, CIN, 3, 3)
  const float* bias;             // (COUT)
  const __nv_bfloat16* skip;     // mode 1: s (B, H, W, CX); mode 2: d
  long long kb, kh, kw;          // its strides in elements
  const float* wp;               // mode 1: (COUT, CX) or null (identity)
  const float* bp;               // mode 1: (COUT) or null
  int dh, dw;                    // mode 2: d's size (0: no skip)
  void* out;
  int out_f32;                   // mode 2: float32 output, else bf16
  int ntx, nty, ntiles, slice_fastest;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp8(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// tile t → slice, first row, first column
__device__ __forceinline__ void decode(const Args& a, int t, int& bi,
                                       int& y0, int& x0) {
  int tx, ty;
  if (a.slice_fastest) {
    bi = t % a.b;
    const int r = t / a.b;
    tx = r % a.ntx;
    ty = r / a.ntx;
  } else {
    tx = t % a.ntx;
    const int r = t / a.ntx;
    ty = r % a.nty;
    bi = r / a.nty;
  }
  y0 = ty * kTH;
  x0 = tx * kTW;
}

// Put tile t's copies in flight: the input halo (and mode 1's s pixels).
template <class C, int CIN, int CX, int MODE>
__device__ __forceinline__ void load_tile(const Args& a, int t,
                                          uint8_t* halo, uint8_t* xb) {
  int bi, y0, x0;
  decode(a, t, bi, y0, x0);
  constexpr int CH = CIN >= 8 ? CIN / 8 : 1;  // copies per pixel
  constexpr int N = C::HH * C::HW * CH;
  const __nv_bfloat16* base = a.x + bi * a.sb;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int q = i / CH, c = i % CH;
    const int hy = q / C::HW, hx = q % C::HW;
    const int gy = y0 + hy - 1, gx = x0 + hx - 1;
    const bool in = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
    const __nv_bfloat16* src = in ? base + gy * a.sh + gx * a.sw + c * 8 : a.x;
    const uint32_t dst = smem_addr(halo + q * C::PS + c * 16);
    if constexpr (CIN >= 8) {
      cp16(dst, src, in ? 16 : 0);
    } else {
      cp8(dst, src, in ? 8 : 0);
    }
  }
  if constexpr (MODE == 1) {
    constexpr int CHX = CX / 8;
    constexpr int NX = kTH * kTW * CHX;
    const __nv_bfloat16* sbase = a.skip + bi * a.kb;
    for (int i = threadIdx.x; i < NX; i += kThreads) {
      const int q = i / CHX, c = i % CHX;
      const int gy = y0 + q / kTW, gx = x0 + q % kTW;
      const bool in = gy < a.h && gx < a.w;
      const __nv_bfloat16* src =
          in ? sbase + gy * a.kh + gx * a.kw + c * 8 : a.skip;
      cp16(smem_addr(xb + q * C::XS + c * 16), src, in ? 16 : 0);
    }
  }
}

// The tile's GEMM: acc[m16 tile][n8 tile][fragment] of this warp.
template <class C, int CX, int MODE>
__device__ __forceinline__ void compute(const uint8_t* halo,
                                        const uint8_t* xb,
                                        const uint8_t* wsm,
                                        float (&acc)[4][C::NT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = lane >> 3;                     // ldmatrix.x4 matrix
  const int prow = (lane & 7) + 8 * (m & 1);   // pixel of the m16 tile
  const int khalf = m >> 1;                    // k 0-7 or 8-15
  const uint32_t hbase = smem_addr(halo), wbase = smem_addr(wsm);
  uint32_t aoff[4], xoff[4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int ty = 2 * warp + (mt >> 1), tx = (mt & 1) * 16 + prow;
    aoff[mt] = hbase + (ty * C::HW + tx) * C::PS;
    xoff[mt] = MODE == 1 ? smem_addr(xb) + (ty * kTW + tx) * C::XS : 0;
  }
  // B rows: n = lane & 7 of an n8 tile, k half from lanes 8-15
  const uint32_t boff = wbase + (lane & 7) * C::WROW + ((lane >> 3) & 1) * 16;

#pragma unroll
  for (int s = 0; s < C::KC; ++s) {
    uint32_t b[C::NT][2];
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
      ldsm_x2(b[nt], boff + nt * 8 * C::WROW + s * 32);
    uint32_t koff;
    if constexpr (C::CIN_S >= 16) {
      constexpr int per = C::CIN_S / 16;
      const int tap = s / per, c0 = (s % per) * 16;
      koff = ((tap / 3) * C::HW + tap % 3) * C::PS + (c0 + 8 * khalf) * 2;
    } else {
      // CIN 8: taps 2s and 2s + 1 share the k16 step (the tenth tap, past
      // the ninth, reads the ninth's pixels against zero weights)
      const int t0 = 2 * s < 8 ? 2 * s : 8;
      const int t1 = 2 * s + 1 < 8 ? 2 * s + 1 : 8;
      const int tap = khalf ? t1 : t0;
      koff = ((tap / 3) * C::HW + tap % 3) * C::PS;
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t a[4];
      ldsm_x4(a, aoff[mt] + koff);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) mma(acc[mt][nt], a, b[nt]);
    }
  }
  if constexpr (MODE == 1) {
#pragma unroll
    for (int s = 0; s < C::KS; ++s) {
      uint32_t b[C::NT][2];
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
        ldsm_x2(b[nt], boff + nt * 8 * C::WROW + (C::KC + s) * 32);
      // CX 8: the upper k half reads the same channels against zeros
      const uint32_t koff = CX >= 16 ? (16 * s + 8 * khalf) * 2 : 0;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, xoff[mt] + koff);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) mma(acc[mt][nt], a, b[nt]);
      }
    }
  }
}

// The generator's input density, upsampled to output pixel (gy, gx) as
// F.interpolate(mode="bilinear", align_corners=False) computes it.
__device__ __forceinline__ float density_skip(const Args& a, int bi, int gy,
                                              int gx) {
  const float scale_h = (float)a.dh / (float)a.h;
  const float scale_w = (float)a.dw / (float)a.w;
  float sy = scale_h * ((float)gy + 0.5f) - 0.5f;
  float sx = scale_w * ((float)gx + 0.5f) - 0.5f;
  sy = sy < 0.f ? 0.f : sy;
  sx = sx < 0.f ? 0.f : sx;
  const int y1 = (int)sy, x1 = (int)sx;
  const int y1p = y1 < a.dh - 1 ? 1 : 0, x1p = x1 < a.dw - 1 ? 1 : 0;
  const float ly1 = sy - (float)y1, lx1 = sx - (float)x1;
  const float ly0 = 1.f - ly1, lx0 = 1.f - lx1;
  const __nv_bfloat16* d = a.skip + bi * a.kb;
  const long long r0 = y1 * a.kh, r1 = (y1 + y1p) * a.kh;
  const long long c0 = x1 * a.kw, c1 = (x1 + x1p) * a.kw;
  // a tap of weight 0 adds 0 (finite inputs): it is not read, so pass 3's
  // density, at factor 1 and strided, costs one read a pixel
  const float d00 = __bfloat162float(d[r0 + c0]);
  const float d01 = lx1 != 0.f ? __bfloat162float(d[r0 + c1]) : 0.f;
  const float d10 = ly1 != 0.f ? __bfloat162float(d[r1 + c0]) : 0.f;
  const float d11 =
      lx1 != 0.f && ly1 != 0.f ? __bfloat162float(d[r1 + c1]) : 0.f;
  return ly0 * (lx0 * d00 + lx1 * d01) + ly1 * (lx0 * d10 + lx1 * d11);
}

template <int CIN, int COUT, int CX, int MODE>
__global__ void __launch_bounds__(kThreads, 2) conv_kernel(const Args a) {
  using C = Cfg<CIN, COUT, CX, MODE>;
  extern __shared__ __align__(128) uint8_t smem[];
  float* bias_s = reinterpret_cast<float*>(smem);
  uint8_t* wsm = smem + C::BIAS_BYTES;
  // two buffers each of the halo and of mode 1's pixels, then the staged
  // output where it has its own room
  uint8_t* halo0 = wsm + C::W_BYTES;
  uint8_t* xb0 = halo0 + 2 * C::HALO_BYTES;
  uint8_t* stage_own = xb0 + 2 * C::X_BYTES;

  int tile = blockIdx.x;
  if constexpr (CIN < 8) {
    // the upper 8 bytes of each CIN 4 pixel stay zero: copies fill the
    // lower 8
    uint4* z = reinterpret_cast<uint4*>(halo0);
    for (int i = threadIdx.x; i < 2 * C::HALO_BYTES / 16; i += kThreads)
      z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  if (tile < a.ntiles) load_tile<C, CIN, CX, MODE>(a, tile, halo0, xb0);
  cp_commit();

  // the weights as bf16 rows [n][k], k = tap-major then channel; then the
  // skip's rows (mode 1); zero where there is no weight
  for (int i = threadIdx.x; i < C::NP * C::K; i += kThreads) {
    const int n = i / C::K, k = i % C::K;
    float v = 0.f;
    if (n < C::NREAL) {
      if (k < 16 * C::KC) {
        const int tap = k / C::CIN_S, ci = k % C::CIN_S;
        if (tap < 9 && ci < CIN) v = a.wt[(n * CIN + ci) * 9 + tap];
      } else if constexpr (MODE == 1) {
        const int ci = k - 16 * C::KC;
        if (ci < CX) v = a.wp ? a.wp[n * CX + ci] : (ci == n ? 1.f : 0.f);
      }
    }
    reinterpret_cast<__nv_bfloat16*>(wsm + n * C::WROW)[k] =
        __float2bfloat16_rn(v);
  }
  for (int n = threadIdx.x; n < C::NP; n += kThreads) {
    float v = 0.f;
    if (n < C::NREAL) {
      v = round_bf16(a.bias[n]);
      if constexpr (MODE == 1) {
        if (a.bp) v += round_bf16(a.bp[n]);
      }
    }
    bias_s[n] = v;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int buf = 0;
  for (; tile < a.ntiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    uint8_t* halo = halo0 + buf * C::HALO_BYTES;
    if (next < a.ntiles)
      load_tile<C, CIN, CX, MODE>(a, next, halo0 + (buf ^ 1) * C::HALO_BYTES,
                                  xb0 + (buf ^ 1) * C::X_BYTES);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    float acc[4][C::NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
    compute<C, CX, MODE>(halo, xb0 + buf * C::X_BYTES, wsm, acc);

    int bi, y0, x0;
    decode(a, tile, bi, y0, x0);
    if constexpr (MODE == 2) {
      // channel 0 lies in lanes 0, 4, ..., 28 (pixels lane/4 and lane/4 +
      // 8 of each m16 tile): staged, then every thread adds the bias and
      // the skip of two pixels and stores them, neighbours side by side
      float* stage = reinterpret_cast<float*>(halo);
      __syncthreads();  // every warp is done reading the halo
      if ((lane & 3) == 0) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            stage[(2 * warp + (mt >> 1)) * kTW + (mt & 1) * 16 +
                  (lane >> 2) + 8 * hh] = acc[mt][0][2 * hh];
          }
        }
      }
      __syncthreads();
      for (int p = threadIdx.x; p < kTH * kTW; p += kThreads) {
        const int gy = y0 + p / kTW, gx = x0 + p % kTW;
        if (gy < a.h && gx < a.w) {
          float v = stage[p] + bias_s[0];
          if (a.dh) v += density_skip(a, bi, gy, gx);
          const long long o = ((long long)bi * a.h + gy) * a.w + gx;
          if (a.out_f32) {
            static_cast<float*>(a.out)[o] = v;
          } else {
            static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(v);
          }
        }
      }
    } else {
      uint8_t* stage = C::STAGE_ALIAS ? halo : stage_own;
      __syncthreads();  // every warp is done reading the halo
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = (2 * warp + (mt >> 1)) * kTW + (mt & 1) * 16 +
                        (lane >> 2) + 8 * hh;
#pragma unroll
          for (int nt = 0; nt < C::NT; ++nt) {
            const int ch = nt * 8 + (lane & 3) * 2;
            const float v0 = fmaxf(acc[mt][nt][2 * hh] + bias_s[ch], 0.f);
            const float v1 = fmaxf(acc[mt][nt][2 * hh + 1] + bias_s[ch + 1],
                                   0.f);
            *reinterpret_cast<__nv_bfloat162*>(stage + p * C::OS + ch * 2) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
      __syncthreads();
      constexpr int CHO = COUT / 8;
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
      for (int i = threadIdx.x; i < kTH * kTW * CHO; i += kThreads) {
        const int p = i / CHO, c = i % CHO;
        const int gy = y0 + p / kTW, gx = x0 + p % kTW;
        if (gy < a.h && gx < a.w) {
          const long long o =
              (((long long)bi * a.h + gy) * a.w + gx) * COUT + c * 8;
          *reinterpret_cast<uint4*>(out + o) =
              *reinterpret_cast<const uint4*>(stage + p * C::OS + c * 16);
        }
      }
    }
    __syncthreads();  // the buffer is free for the tile after next
    buf ^= 1;
  }
  cp_wait<0>();
}

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

template <int CIN, int COUT, int CX, int MODE>
int launch(const Args& a, int dev, cudaStream_t stream) {
  using C = Cfg<CIN, COUT, CX, MODE>;
  static_assert(C::SMEM <= 232448, "tile does not fit shared memory");
  // blocks per SM and SMs, per device, found at the first launch there
  // (outside any capture: a captured program's first use runs eagerly)
  static int grid_of[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  auto kern = conv_kernel<CIN, COUT, CX, MODE>;
  if (!grid_of[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, C::SMEM);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    grid_of[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const int grid = a.ntiles < grid_of[dev] ? a.ntiles : grid_of[dev];
  if (grid > 0) kern<<<grid, kThreads, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

typedef int (*LaunchFn)(const Args&, int, cudaStream_t);

// the widths with a kernel (ops/conv_kernel.py RELU, RESIDUAL, HEAD)
LaunchFn find(int mode, int cin, int cout, int cx) {
#define MPGAN_CONV(M, I, O, X) \
  if (mode == M && cin == I && cout == O && cx == X) return launch<I, O, X, M>;
#define MPGAN_RELU(I) \
  MPGAN_CONV(0, I, 8, 0) MPGAN_CONV(0, I, 16, 0) MPGAN_CONV(0, I, 32, 0)
#define MPGAN_RES(C) \
  MPGAN_CONV(1, C, C, 8) MPGAN_CONV(1, C, C, 16) MPGAN_CONV(1, C, C, 32)
  MPGAN_RELU(4) MPGAN_RELU(8) MPGAN_RELU(16) MPGAN_RELU(32)
  MPGAN_RES(8) MPGAN_RES(16) MPGAN_RES(32)
  MPGAN_CONV(2, 8, 1, 0) MPGAN_CONV(2, 16, 1, 0) MPGAN_CONV(2, 32, 1, 0)
#undef MPGAN_RES
#undef MPGAN_RELU
#undef MPGAN_CONV
  return nullptr;
}

}  // namespace

// x (B, H, W, cin) bf16 at strides (sb, sh, sw), unit channel stride;
// wt (cout, cin, 3, 3) and bias (cout) float32, contiguous. mode 1: skip
// (B, H, W, cx) bf16 at strides (kb, kh, kw), wp (cout, cx) and bp (cout)
// float32 or both null (identity, cx == cout). mode 2 (cout 1): skip the
// density (B, dh, dw) at those strides, or dh = 0 for none; out_f32 picks
// the output dtype. out: contiguous (B, H, W, cout). 16-byte aligned
// tensors and strides in multiples of 8 elements (4 for cin 4).
extern "C" int mpgan_conv(int mode, int cin, int cout, int cx,
                          const void* x, long long sb, long long sh,
                          long long sw, int b, int h, int w, const void* wt,
                          const void* bias, const void* skip, long long kb,
                          long long kh, long long kw, const void* wp,
                          const void* bp, int dh, int dw, void* out,
                          int out_f32, int slice_fastest, int dev,
                          void* stream) {
  LaunchFn fn = find(mode, cin, cout, cx);
  if (fn == nullptr) return -1;
  Args a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.sb = sb; a.sh = sh; a.sw = sw;
  a.b = b; a.h = h; a.w = w;
  a.wt = static_cast<const float*>(wt);
  a.bias = static_cast<const float*>(bias);
  a.skip = static_cast<const __nv_bfloat16*>(skip);
  a.kb = kb; a.kh = kh; a.kw = kw;
  a.wp = static_cast<const float*>(wp);
  a.bp = static_cast<const float*>(bp);
  a.dh = dh; a.dw = dw;
  a.out = out;
  a.out_f32 = out_f32;
  a.ntx = (w + kTW - 1) / kTW;
  a.nty = (h + kTH - 1) / kTH;
  a.ntiles = b * a.ntx * a.nty;
  a.slice_fastest = slice_fastest;
  DeviceGuard guard(dev);
  return fn(a, dev, static_cast<cudaStream_t>(stream));
}
