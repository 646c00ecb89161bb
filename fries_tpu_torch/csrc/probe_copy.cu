// The backend probe (kernel #5): a (16, 128) f32 copy over a grid of two
// blocks of (8, 128).
//
// Replaces the TPU kernel fries_tpu/runtime/pallas_merge.py:77, the body
// `_k` of `tpu_supported`, which the reference compiles once to learn
// whether the backend takes sequential-grid Pallas kernels (and falls back
// to XLA if not).  Here the loader (fries_tpu_torch/_build.py) launches it
// once after loading the library and raises if the launch fails or the copy
// differs, so a card that cannot run this sm_90a build fails at load time,
// not in the middle of a step.  Bound by bytes (16 KB moved), in practice by
// the launch: block b, thread (lane, r) copies element (8 b + r) * 128 + lane.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockRows = 8, kLanes = 128, kBlocks = 2;

__global__ void probe_copy_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const int pos = (blockIdx.x * kBlockRows + threadIdx.y) * kLanes + threadIdx.x;
  out[pos] = x[pos];
}

}  // namespace

// x, out: (16, 128) f32, contiguous on the device.
extern "C" int fries_probe_copy(const float* x, float* out, void* stream) {
  probe_copy_kernel<<<kBlocks, dim3(kLanes, kBlockRows), 0, static_cast<cudaStream_t>(stream)>>>(
      x, out);
  return cudaGetLastError();
}
