// The slice generator's convolutions for Hopper (sm_90a): 3x3 convolutions
// of bf16 NHWC activations with the bias, the ReLU, the residual sum (and
// the ResBlock's 1x1 projection) or the output head's global density skip
// in the epilogue, and with the growth stage's bilinear upsample in the
// loads of each stage's first ResBlock.
//
// Why. The generator's inference forward ran its convolutions through
// cuDNN in NCHW views: every convolution paid cuDNN's nchwToNhwc and
// nhwcToNchw transposes around an NHWC implicit GEMM, then an ATen add for
// the bias, another for the residual sum and a clamp for the ReLU. In the
// frame cells those kernels took about 80-90% of the device time (PERF.md
// section 5). This replaces no Pallas kernel: the JAX package leaves its
// convolutions to XLA (`nn.Conv` in mpgan_tpu/models/generator.py).
// The stage upsample then ran as ATen's bilinear upsample
// (upsample_bilinear2d_nhwc_out_frame; below 16 channels
// upsample_bilinear2d_out_frame, through the NHWC tensor's strides): it
// wrote the upsampled tensor, 2x or 4x the stage input, and the block's
// conv1 and conv2 read it back, at about a tenth of the card's bandwidth,
// the largest op of every frame. It replaces no Pallas kernel either (the
// JAX package resizes with XLA). Here the two kernels that read the
// upsampled tensor read the stage input instead and interpolate it in
// shared memory: the write and both reads of the large tensor, and the
// upsample's own read, become two reads of one 2x or 4x smaller: 3U - L
// bytes less to move for an upsampled tensor of U bytes from L (3.2 GB a
// 4x frame, 17.4 GB an 8x frame, from the configurations' shapes).
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
// Upsampled (modes 0 and 1, factors (FH, FW) = (2, 2) or (2, 1)): mode 0's
// x, or mode 1's s, is given at (H/FH, W/FW) and read as its upsample to
// (H, W) rounded to bf16: ATen's upsample_bilinear2d arithmetic (source
// index max(scale (j + 0.5) - 0.5, 0), the upper tap clamped to n - 1,
// h0 (w0 v00 + w1 v01) + h1 (w0 v10 + w1 v11) in float32, rounded once),
// so the kernel's input is the bits ATen's upsample would have written
// (finite inputs: along a factor of 1, and at output row 0, ATen's second
// tap has weight 0 and is not read here).
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
// Upsampled, the copies in flight are the low-resolution window that
// covers the halo (mode 0: 10 x 18 pixels at (2, 2), 10 x 34 at (2, 1)) or
// the skip's pixels (mode 1: 10 x 18, 10 x 32), two buffers of it; after
// the wait the block expands the window into one halo (or skip) buffer as
// bf16, zero outside the image (the padding of the upsampled tensor), then
// runs the same GEMM and epilogue on it. The expansion is the kernel's
// added work, in instructions (it runs between two barriers while the next
// tile's copies are in flight): a thread takes two output rows that share
// their low rows, at one column and 8 channels, and sums each low row
// along the row once for both (expand below). On an H100 that beat a
// pixel a thread (four taps summed per pixel) and a column of rows a
// thread (too few threads at 32 channels, divergent bands at 8). The
// no-upsample specialisation is the code without those branches (every
// one is `if constexpr`).
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

template <int CIN, int COUT, int CX, int MODE, int FH = 1, int FW = 1>
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
  // upsampled: the operand read at low resolution (mode 0's x, mode 1's
  // s), its channels, the pixels it is expanded to (mode 0 the halo) and
  // the low-resolution window that covers them, held raw
  static constexpr bool UP = FH > 1 || FW > 1;
  static constexpr int UC = MODE == 1 ? CX : CIN;
  static constexpr int EDGE = MODE == 0 ? 1 : 0;     // halo around the tile
  static constexpr int LH = FH == 2 ? kTH / 2 + 2 : kTH + 2 * EDGE;
  static constexpr int LW = FW == 2 ? kTW / 2 + 2 : kTW + 2 * EDGE;
  static constexpr int RAW_BYTES = UP ? LH * LW * UC * 2 : 0;
  // buffers of the halo and of mode 1's pixels: the one expanded into is
  // single, the one copied into double
  static constexpr int NHALO = UP && MODE == 0 ? 1 : 2;
  static constexpr int NX = UP ? 1 : 2;
  // mode 2 stages its one channel as float32
  static constexpr int STAGE_BYTES = kTH * kTW * (MODE == 2 ? 4 : OS);
  // the staged output reuses the computed halo buffer where it fits (a
  // CIN 4 halo keeps zeros in its upper half, so it is never reused)
  static constexpr bool STAGE_ALIAS = STAGE_BYTES <= HALO_BYTES && CIN >= 8;
  static constexpr int SMEM = BIAS_BYTES + W_BYTES + NHALO * HALO_BYTES +
                              NX * X_BYTES + 2 * RAW_BYTES +
                              (STAGE_ALIAS ? 0 : STAGE_BYTES);
  static_assert(!UP || (FH == 2 && (FW == 1 || FW == 2) && MODE != 2 &&
                        UC >= 8),
                "upsampled by (2, 2) or (2, 1), modes 0 and 1, 8+ channels");
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

// First low-resolution row (or column) of the window that covers the
// pixels j0 - edge .. j0 + n - 1 + edge upsampled by f (1 or 2).
template <int F, int EDGE>
__device__ __forceinline__ int window_origin(int j0) {
  return F == 2 ? j0 / 2 - 1 : j0 - EDGE;
}

// Put tile t's copies in flight: the input halo (and mode 1's s pixels);
// upsampled, the low-resolution window of the operand read there instead.
template <class C, int CIN, int CX, int MODE, int FH, int FW>
__device__ __forceinline__ void load_tile(const Args& a, int t,
                                          uint8_t* halo, uint8_t* xb,
                                          uint8_t* raw) {
  int bi, y0, x0;
  decode(a, t, bi, y0, x0);
  if constexpr (!(C::UP && MODE == 0)) {
    constexpr int CH = CIN >= 8 ? CIN / 8 : 1;  // copies per pixel
    constexpr int N = C::HH * C::HW * CH;
    const __nv_bfloat16* base = a.x + bi * a.sb;
    for (int i = threadIdx.x; i < N; i += kThreads) {
      const int q = i / CH, c = i % CH;
      const int hy = q / C::HW, hx = q % C::HW;
      const int gy = y0 + hy - 1, gx = x0 + hx - 1;
      const bool in = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
      const __nv_bfloat16* src =
          in ? base + gy * a.sh + gx * a.sw + c * 8 : a.x;
      const uint32_t dst = smem_addr(halo + q * C::PS + c * 16);
      if constexpr (CIN >= 8) {
        cp16(dst, src, in ? 16 : 0);
      } else {
        cp8(dst, src, in ? 8 : 0);
      }
    }
  }
  if constexpr (MODE == 1 && !C::UP) {
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
  if constexpr (C::UP) {
    // rows and columns past the low-resolution edges are zero: where the
    // expansion reads one, ATen's clamped taps give it no weight
    constexpr int CHU = C::UC / 8;
    constexpr int N = C::LH * C::LW * CHU;
    const __nv_bfloat16* op = MODE == 0 ? a.x : a.skip;
    const __nv_bfloat16* base = op + bi * (MODE == 0 ? a.sb : a.kb);
    const long long rs = MODE == 0 ? a.sh : a.kh;
    const long long ps = MODE == 0 ? a.sw : a.kw;
    const int oy = window_origin<FH, C::EDGE>(y0);
    const int ox = window_origin<FW, C::EDGE>(x0);
    const int lh = a.h / FH, lw = a.w / FW;
    for (int i = threadIdx.x; i < N; i += kThreads) {
      const int q = i / CHU, c = i % CHU;
      const int ly = oy + q / C::LW, lx = ox + q % C::LW;
      const bool in = ly >= 0 && ly < lh && lx >= 0 && lx < lw;
      const __nv_bfloat16* src = in ? base + ly * rs + lx * ps + c * 8 : op;
      cp16(smem_addr(raw + q * C::UC * 2 + c * 16), src, in ? 16 : 0);
    }
  }
}

__device__ __forceinline__ void unpack8(const uint8_t* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

// Rows of a 2x upsample as ATen computes them at scale 1/2: output row j
// reads source row max(j/2 - 1/4, 0), exact in float32, so rows 2m + 1
// and 2m + 2 read low rows m and m + 1, with weights (3/4, 1/4) and
// (1/4, 3/4); row 0 reads row 0 alone, and the last row, 2m + 1 with m the
// last low row, reads row m twice. Columns likewise. The sums of the
// products are taken as ATen's build contracts them: the first product
// fused, the second rounded.
// Odd row 2m + 1 from the row sums p (low row m) and q (m + 1).
__device__ __forceinline__ uint4 odd_row(const float (&p)[8],
                                         const float (&q)[8], bool last) {
  uint4 o;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float u0 = last ? p[2 * j] : q[2 * j];
    const float u1 = last ? p[2 * j + 1] : q[2 * j + 1];
    h[j] = __floats2bfloat162_rn(
        __fmaf_rn(0.75f, p[2 * j], __fmul_rn(0.25f, u0)),
        __fmaf_rn(0.75f, p[2 * j + 1], __fmul_rn(0.25f, u1)));
  }
  return o;
}

// Even row 2m + 2 from the row sums p (low row m) and q (m + 1); row 0
// (top) is q alone (its tap of weight 0 is not read).
__device__ __forceinline__ uint4 even_row(const float (&p)[8],
                                          const float (&q)[8], bool top) {
  uint4 o;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h[j] = top ? __floats2bfloat162_rn(q[2 * j], q[2 * j + 1])
               : __floats2bfloat162_rn(
                     __fmaf_rn(0.25f, p[2 * j], __fmul_rn(0.75f, q[2 * j])),
                     __fmaf_rn(0.25f, p[2 * j + 1],
                               __fmul_rn(0.75f, q[2 * j + 1])));
  }
  return o;
}

// Expand tile t's low-resolution window (raw) into the pixels the GEMM
// reads (mode 0: the 18 x 34 halo, zero outside the image; mode 1: the
// 16 x 32 pixels of s), each channel as ATen's bilinear upsample computes
// it (upsample_bilinear2d_nhwc_out_frame and upsample_bilinear2d_out_frame:
// h0 (w0 v00 + w1 v01) + h1 (w0 v10 + w1 v11) in float32, rounded once).
// A work item is two output rows at one column and 8 channels, whose low
// rows are each summed along the row once: mode 0's halo rows pair as
// (2m + 1, 2m + 2), two low rows for two output rows; mode 1's tile rows
// as (2m + 2, 2m + 3), three low rows, so that 8 pairs cover the tile.
template <class C, int MODE, int FH, int FW>
__device__ __forceinline__ void expand(const Args& a, int t,
                                       const uint8_t* raw, uint8_t* dst) {
  constexpr int PIX = C::UC * 2, CH = C::UC / 8;
  constexpr int EW = kTW + 2 * C::EDGE;
  constexpr int DS = MODE == 0 ? C::PS : C::XS;       // dst pixel bytes
  constexpr int PAIRS = MODE == 0 ? kTH / 2 + 1 : kTH / 2;
  constexpr int SUMS = MODE == 0 ? 2 : 3;             // low rows a pair
  int bi, y0, x0;
  decode(a, t, bi, y0, x0);
  const int oy = window_origin<FH, C::EDGE>(y0);
  const int ox = window_origin<FW, C::EDGE>(x0);
  const int lh = a.h / 2;
  for (int i = threadIdx.x; i < PAIRS * EW * CH; i += kThreads) {
    const int c = i % CH, col = i / CH % EW, k = i / (CH * EW);
    const int gx = x0 + col - C::EDGE;
    const int m = oy + k;               // low row, window row k
    const int g0 = MODE == 0 ? 2 * m + 1 : 2 * m + 2;  // first output row
    uint4 o0 = make_uint4(0, 0, 0, 0), o1 = o0;
    if (gx >= 0 && gx < a.w && g0 + 1 >= 0 && g0 < a.h) {
      // the column's taps: byte offsets in a window row, weights
      int k0, k1 = 0;
      float lx0 = 1.f, lx1 = 0.f;
      if constexpr (FW == 2) {
        const int x1 = gx > 0 ? (gx - 1) >> 1 : 0;
        lx1 = gx > 0 ? ((gx & 1) ? 0.25f : 0.75f) : 0.f;
        lx0 = 1.f - lx1;
        k0 = (x1 - ox) * PIX + c * 16;
        k1 = k0 + (x1 < a.w / 2 - 1 ? PIX : 0);
      } else {
        k0 = (gx - ox) * PIX + c * 16;   // scale 1: the column itself
      }
      // window rows k, k + 1 (, k + 2) summed along the row: a row past
      // the image is zero and weighs nothing
      float s[SUMS][8];
#pragma unroll
      for (int n = 0; n < SUMS; ++n) {
        const uint8_t* p = raw + (k + n) * C::LW * PIX;
        if constexpr (FW == 2) {
          float v0[8], v1[8];
          unpack8(p + k0, v0);
          unpack8(p + k1, v1);
          // products of a weight in {0, 1/4, 3/4, 1} and a bf16 value
          // are exact: the sum is rounded once, contracted or not
#pragma unroll
          for (int j = 0; j < 8; ++j)
            s[n][j] = __fmaf_rn(lx0, v0[j], __fmul_rn(lx1, v1[j]));
        } else {
          unpack8(p + k0, s[n]);
        }
      }
      if constexpr (MODE == 0) {
        o0 = odd_row(s[0], s[1], m >= lh - 1);
        o1 = even_row(s[0], s[1], g0 + 1 == 0);
        if (g0 < 0) o0 = make_uint4(0, 0, 0, 0);
        if (g0 + 1 >= a.h) o1 = make_uint4(0, 0, 0, 0);
      } else {
        o0 = even_row(s[0], s[1], g0 == 0);
        o1 = odd_row(s[1], s[2], m + 1 >= lh - 1);
      }
    }
    uint8_t* d = dst + (2 * k * EW + col) * DS + c * 16;
    *reinterpret_cast<uint4*>(d) = o0;
    *reinterpret_cast<uint4*>(d + EW * DS) = o1;
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

template <int CIN, int COUT, int CX, int MODE, int FH, int FW>
__global__ void __launch_bounds__(kThreads, 2) conv_kernel(const Args a) {
  using C = Cfg<CIN, COUT, CX, MODE, FH, FW>;
  extern __shared__ __align__(128) uint8_t smem[];
  float* bias_s = reinterpret_cast<float*>(smem);
  uint8_t* wsm = smem + C::BIAS_BYTES;
  // the buffers of the halo, of mode 1's pixels and of the low-resolution
  // window, then the staged output where it has its own room
  uint8_t* halo0 = wsm + C::W_BYTES;
  uint8_t* xb0 = halo0 + C::NHALO * C::HALO_BYTES;
  uint8_t* raw0 = xb0 + C::NX * C::X_BYTES;
  uint8_t* stage_own = raw0 + 2 * C::RAW_BYTES;
  // buffer b of each: a single buffer is every tile's
  auto halo_of = [&](int b) {
    return halo0 + (C::NHALO - 1) * b * C::HALO_BYTES;
  };
  auto xb_of = [&](int b) { return xb0 + (C::NX - 1) * b * C::X_BYTES; };

  int tile = blockIdx.x;
  if constexpr (CIN < 8) {
    // the upper 8 bytes of each CIN 4 pixel stay zero: copies fill the
    // lower 8
    uint4* z = reinterpret_cast<uint4*>(halo0);
    for (int i = threadIdx.x; i < C::NHALO * C::HALO_BYTES / 16;
         i += kThreads)
      z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  if (tile < a.ntiles)
    load_tile<C, CIN, CX, MODE, FH, FW>(a, tile, halo0, xb0, raw0);
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
    uint8_t* halo = halo_of(buf);
    if (next < a.ntiles)
      load_tile<C, CIN, CX, MODE, FH, FW>(a, next, halo_of(buf ^ 1),
                                          xb_of(buf ^ 1),
                                          raw0 + (buf ^ 1) * C::RAW_BYTES);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if constexpr (C::UP) {
      // the previous tile's epilogue is done with the single buffer
      expand<C, MODE, FH, FW>(a, tile, raw0 + buf * C::RAW_BYTES,
                              MODE == 0 ? halo : xb0);
      __syncthreads();
    }

    float acc[4][C::NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
    compute<C, CX, MODE>(halo, xb_of(buf), wsm, acc);

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

template <int CIN, int COUT, int CX, int MODE, int FH, int FW>
int launch(const Args& a, int dev, cudaStream_t stream) {
  using C = Cfg<CIN, COUT, CX, MODE, FH, FW>;
  static_assert(C::SMEM <= 232448, "tile does not fit shared memory");
  // blocks per SM and SMs, per device, found at the first launch there
  // (outside any capture: a captured program's first use runs eagerly)
  static int grid_of[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  auto kern = conv_kernel<CIN, COUT, CX, MODE, FH, FW>;
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

// the widths and factors with a kernel (ops/conv_kernel.py RELU,
// RESIDUAL, HEAD; upsampled RELU_UP, RESIDUAL_UP at UP_FACTORS)
LaunchFn find(int mode, int cin, int cout, int cx, int fh, int fw) {
#define MPGAN_CONV(M, I, O, X, FH, FW)                                \
  if (mode == M && cin == I && cout == O && cx == X && fh == FH &&  \
      fw == FW)                                                      \
    return launch<I, O, X, M, FH, FW>;
#define MPGAN_PLAIN(M, I, O, X) MPGAN_CONV(M, I, O, X, 1, 1)
#define MPGAN_UP(M, I, O, X) \
  MPGAN_CONV(M, I, O, X, 2, 2) MPGAN_CONV(M, I, O, X, 2, 1)
#define MPGAN_RELU(I) \
  MPGAN_PLAIN(0, I, 8, 0) MPGAN_PLAIN(0, I, 16, 0) MPGAN_PLAIN(0, I, 32, 0)
#define MPGAN_RES(C) \
  MPGAN_PLAIN(1, C, C, 8) MPGAN_PLAIN(1, C, C, 16) MPGAN_PLAIN(1, C, C, 32)
  MPGAN_RELU(4) MPGAN_RELU(8) MPGAN_RELU(16) MPGAN_RELU(32)
  MPGAN_RES(8) MPGAN_RES(16) MPGAN_RES(32)
  MPGAN_PLAIN(2, 8, 1, 0) MPGAN_PLAIN(2, 16, 1, 0) MPGAN_PLAIN(2, 32, 1, 0)
  // each growth stage's first ResBlock: conv1 32->16, 16->8, 8->8 and
  // conv2 at 16 (skip 32), 8 (skip 16), 8 (skip 8, identity)
  MPGAN_UP(0, 32, 16, 0) MPGAN_UP(0, 16, 8, 0) MPGAN_UP(0, 8, 8, 0)
  MPGAN_UP(1, 16, 16, 32) MPGAN_UP(1, 8, 8, 16) MPGAN_UP(1, 8, 8, 8)
#undef MPGAN_RES
#undef MPGAN_RELU
#undef MPGAN_UP
#undef MPGAN_PLAIN
#undef MPGAN_CONV
  return nullptr;
}

}  // namespace

// x (B, H, W, cin) bf16 at strides (sb, sh, sw), unit channel stride;
// wt (cout, cin, 3, 3) and bias (cout) float32, contiguous. mode 1: skip
// (B, H, W, cx) bf16 at strides (kb, kh, kw), wp (cout, cx) and bp (cout)
// float32 or both null (identity, cx == cout). mode 2 (cout 1): skip the
// density (B, dh, dw) at those strides, or dh = 0 for none; out_f32 picks
// the output dtype. out: contiguous (B, H, W, cout). (fh, fw) other than
// (1, 1), modes 0 and 1: mode 0's x, or mode 1's skip, is (B, H/fh, W/fw,
// .) and is read upsampled to (H, W). 16-byte aligned tensors and strides
// in multiples of 8 elements (4 for cin 4).
extern "C" int mpgan_conv(int mode, int cin, int cout, int cx, int fh,
                          int fw, const void* x, long long sb, long long sh,
                          long long sw, int b, int h, int w, const void* wt,
                          const void* bias, const void* skip, long long kb,
                          long long kh, long long kw, const void* wp,
                          const void* bp, int dh, int dw, void* out,
                          int out_f32, int slice_fastest, int dev,
                          void* stream) {
  LaunchFn fn = find(mode, cin, cout, cx, fh, fw);
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
