// The shared vertex-sum kernel (vertex_sum.cuh) on its own: corner rows of
// width 1 or 3 summed into vertex rows, float or double.  The frozen-tilt and
// curvature entry points launch the same kernel inside their own calls; this
// library serves kernels/vertex_sum.py (tests, chip_smoke's check against the
// plain twin, and any other corner-to-vertex sum).

#include "vertex_sum.cuh"

// ``f64`` selects double (1) or float (0); ``width`` is 1 or 3.  Launches on
// the given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for another width).
extern "C" int vertex_sum_rows(int f64, int width, const int32_t* offsets, const int32_t* slots,
                               const void* src, void* out, int n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (width != 1 && width != 3) return (int)cudaErrorInvalidValue;
  if (f64) {
    if (width == 3) {
      vertex_sum::launch<double, 3>(offsets, slots, (const double*)src, (double*)out, nullptr,
                                    nullptr, n, st);
    } else {
      vertex_sum::launch<double, 1>(offsets, slots, (const double*)src, (double*)out, nullptr,
                                    nullptr, n, st);
    }
  } else {
    if (width == 3) {
      vertex_sum::launch<float, 3>(offsets, slots, (const float*)src, (float*)out, nullptr,
                                   nullptr, n, st);
    } else {
      vertex_sum::launch<float, 1>(offsets, slots, (const float*)src, (float*)out, nullptr,
                                   nullptr, n, st);
    }
  }
  return (int)cudaGetLastError();
}
