// The two warp forwards as operators of PyTorch's dispatcher: one call from
// Python checks the tensors, allocates the output and launches the kernel
// in C++, as torch's own operators (grid_sample) do.
//
//   torch.ops.mpgan_warp.warp2d(field, vel, dt, max_disp, th, tw)
//   torch.ops.mpgan_warp.warp2d_triplet(prev, cur, nxt, vel, max_disp,
//                                       th, tw)
//
// field, prev, cur, nxt (B, H, W, 1) and vel (B, H, W, 2): contiguous
// float32 tensors on one CUDA device, vel 8-byte aligned, 3 B H W < 2^31,
// B <= 65535. The output is (B, H, W, 1), or (B, H, W, 3) for a triplet,
// float32 on that device; the kernel (csrc/warp.cu, mpgan_warp2d and
// mpgan_warp2d_triplet) runs on PyTorch's current stream of that device.
// th x tw is the tile of a block, chosen in Python (`fwd_tile` in
// mpgan_torch/ops/warp_kernel.py).
//
// A tensor the kernel does not take raises an error whose text holds
// kRefused; the Python wrapper then finds which and raises its ValueError.
// A failed launch raises "<entry> failed: CUDA error <n>".
//
// Built with g++ against PyTorch's header-only stable ABI
// (torch/csrc/stable, the C shim of torch/csrc/inductor/aoti_torch), not
// torch/extension.h, and linked to the warp library (mpgan_torch/_build.py
// `build_ops`): the build takes seconds.

#include <torch/csrc/inductor/aoti_torch/c/shim.h>
#include <torch/csrc/stable/library.h>
#include <torch/csrc/stable/tensor.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

extern "C" int mpgan_warp2d(const void* field, const void* vel, void* out,
                            int b, int h, int w, int th, int tw, float dt,
                            float lim, int dev, void* stream);
extern "C" int mpgan_warp2d_triplet(const void* prev, const void* cur,
                                    const void* nxt, const void* vel,
                                    void* out, int b, int h, int w, int th,
                                    int tw, float lim, int dev, void* stream);

namespace {

using torch::stable::Tensor;

constexpr const char* kRefused = "mpgan_warp: inputs refused";

void ok(AOTITorchError err) {
  STD_TORCH_CHECK(err == AOTI_TORCH_SUCCESS, "mpgan_warp: torch C shim error");
}

void refuse_unless(bool cond) { STD_TORCH_CHECK(cond, kRefused); }

struct Shape {
  int64_t b, h, w;
  int32_t dev;
};

// A float32 tensor on CUDA device `dev` of sizes `want` (n dims), with
// torch's default contiguity (strides of size-1 dims not compared).
void check_tensor(AtenTensorHandle t, int32_t dev, const int64_t* want,
                  int64_t n) {
  int32_t type, index, dtype;
  int64_t dim;
  ok(aoti_torch_get_device_type(t, &type));
  ok(aoti_torch_get_device_index(t, &index));
  ok(aoti_torch_get_dtype(t, &dtype));
  ok(aoti_torch_get_dim(t, &dim));
  refuse_unless(type == aoti_torch_device_type_cuda() && index == dev
                && dtype == aoti_torch_dtype_float32() && dim == n);
  int64_t *sizes, *strides;
  ok(aoti_torch_get_sizes(t, &sizes));
  ok(aoti_torch_get_strides(t, &strides));
  bool empty = false;
  for (int64_t d = 0; d < n; ++d) {
    refuse_unless(sizes[d] == want[d]);
    empty = empty || sizes[d] == 0;
  }
  int64_t expected = 1;
  for (int64_t d = n - 1; d >= 0 && !empty; --d) {
    if (sizes[d] != 1) {
      refuse_unless(strides[d] == expected);
      expected *= sizes[d];
    }
  }
}

// The shape of vel (B, H, W, 2), after every tensor is checked.
Shape check(const Tensor& vel, std::initializer_list<const Tensor*> fields) {
  AtenTensorHandle v = vel.get();
  int32_t type, dev;
  int64_t dim;
  ok(aoti_torch_get_device_type(v, &type));
  ok(aoti_torch_get_device_index(v, &dev));
  ok(aoti_torch_get_dim(v, &dim));
  refuse_unless(type == aoti_torch_device_type_cuda() && dim == 4);
  int64_t* sizes;
  ok(aoti_torch_get_sizes(v, &sizes));
  const Shape s{sizes[0], sizes[1], sizes[2], dev};
  const int64_t want_vel[4] = {s.b, s.h, s.w, 2};
  const int64_t want_field[4] = {s.b, s.h, s.w, 1};
  check_tensor(v, dev, want_vel, 4);
  void* p;
  ok(aoti_torch_get_data_ptr(v, &p));
  refuse_unless(reinterpret_cast<uintptr_t>(p) % 8 == 0);
  for (const Tensor* f : fields) check_tensor(f->get(), dev, want_field, 4);
  refuse_unless(3 * s.b * s.h * s.w < (int64_t{1} << 31) && s.b <= 65535);
  return s;
}

void* data(const Tensor& t) {
  void* p;
  ok(aoti_torch_get_data_ptr(t.get(), &p));
  return p;
}

// An uninitialised contiguous float32 (B, H, W, c) tensor on the device.
Tensor output(const Shape& s, int64_t c) {
  const int64_t sizes[4] = {s.b, s.h, s.w, c};
  const int64_t strides[4] = {s.h * s.w * c, s.w * c, c, 1};
  AtenTensorHandle out;
  ok(aoti_torch_empty_strided(4, sizes, strides, aoti_torch_dtype_float32(),
                              aoti_torch_device_type_cuda(), s.dev, &out));
  return Tensor(out);
}

void* stream(int32_t dev) {
  void* st;
  ok(aoti_torch_get_current_cuda_stream(dev, &st));
  return st;
}

// The velocity clamp max_disp / |dt| of the plain version, computed in
// double and rounded once to float, as the Python wrapper did.
float clamp_limit(double dt, int64_t max_disp) {
  return (float)((double)max_disp / std::fmax(std::fabs(dt), 1e-9));
}

Tensor warp2d(Tensor field, Tensor vel, double dt, int64_t max_disp,
              int64_t th, int64_t tw) {
  const Shape s = check(vel, {&field});
  Tensor out = output(s, 1);
  const int err = mpgan_warp2d(data(field), data(vel), data(out), (int)s.b,
                               (int)s.h, (int)s.w, (int)th, (int)tw,
                               (float)dt, clamp_limit(dt, max_disp), s.dev,
                               stream(s.dev));
  STD_TORCH_CHECK(err == 0, "mpgan_warp2d failed: CUDA error ", err);
  return out;
}

Tensor warp2d_triplet(Tensor prev, Tensor cur, Tensor nxt, Tensor vel,
                      int64_t max_disp, int64_t th, int64_t tw) {
  const Shape s = check(vel, {&prev, &cur, &nxt});
  Tensor out = output(s, 3);
  const int err = mpgan_warp2d_triplet(
      data(prev), data(cur), data(nxt), data(vel), data(out), (int)s.b,
      (int)s.h, (int)s.w, (int)th, (int)tw, (float)max_disp, s.dev,
      stream(s.dev));
  STD_TORCH_CHECK(err == 0, "mpgan_warp2d_triplet failed: CUDA error ", err);
  return out;
}

}  // namespace

STABLE_TORCH_LIBRARY(mpgan_warp, m) {
  m.def("warp2d(Tensor field, Tensor vel, float dt, int max_disp, int th, "
        "int tw) -> Tensor");
  m.def("warp2d_triplet(Tensor prev, Tensor cur, Tensor nxt, Tensor vel, "
        "int max_disp, int th, int tw) -> Tensor");
}

STABLE_TORCH_LIBRARY_IMPL(mpgan_warp, CUDA, m) {
  m.impl("warp2d", TORCH_BOX(&warp2d));
  m.impl("warp2d_triplet", TORCH_BOX(&warp2d_triplet));
}
