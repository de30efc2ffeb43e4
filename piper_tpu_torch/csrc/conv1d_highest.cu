// K1 at "highest" (3xTF32 on the tensor cores), in its own translation unit
// so that nvcc compiles it beside conv1d.cu's bf16 tiers; conv1d.cu's header
// says what the kernel computes and how it is laid out.

#include "conv1d.cuh"

int conv1d_highest(const float* x, const float* w, const float* bias, const int* bounds,
                   int bounds_cols, float* out, int B, int C, int N, int k, int dil, int tile,
                   float slope, int m_tiles, int n_tiles, int device, void* stream) {
  switch (n_tiles) {
    case 2: return launch_tier<0, 2>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, m_tiles, device, stream);
    case 4: return launch_tier<0, 4>(x, w, bias, bounds, bounds_cols, out, B, C, N, k, dil, tile, slope, m_tiles, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
