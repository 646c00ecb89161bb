// The packed-to-column relayout of tools/probe_reshape.py (kernel #6).
//
// Replaces the TPU kernel tools/probe_reshape.py:33 (the `direct` body, a
// Mosaic lowering probe for the deleted v3 merge's transpose): an (8, 128)
// int32 tile becomes a (1024, 1) column with pos = r * 128 + lane.  On the
// TPU this moves data from lanes to sublanes; on the H100 both shapes are
// the same row-major 4 KB, so one block of 1024 threads, thread (lane, r),
// copies element r * 128 + lane.  Bound by bytes (8 KB moved), in practice
// by the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8, kLanes = 128;

__global__ void probe_reshape_kernel(const int32_t* __restrict__ x,
                                     int32_t* __restrict__ out) {
  const int pos = threadIdx.y * kLanes + threadIdx.x;
  out[pos] = x[pos];
}

}  // namespace

// x: (8, 128) int32, out: (1024, 1) int32, both contiguous on the device.
extern "C" int fries_probe_reshape(const int32_t* x, int32_t* out, void* stream) {
  probe_reshape_kernel<<<1, dim3(kLanes, kRows), 0, static_cast<cudaStream_t>(stream)>>>(
      x, out);
  return cudaGetLastError();
}
