// K2-K4 at "highest" (3xTF32 on wgmma), in their own translation unit so
// that nvcc compiles them beside resblock1.cu's bf16 tiers; resblock1.cu's
// header says what the kernels compute and how they are laid out.

#include "resblock1.cuh"

namespace piper_rb {

template <bool kMean, bool kFolded>
int start_highest(const Args& a, int B, size_t smem, int device, void* stream) {
  if (a.C != 16 && a.C != 32 && a.C != 64)
    return start_highest_other<kMean, kFolded>(a, B, smem, device, stream);
  return start_wgmma<kMean, kFolded, 0, float>(a, B, smem, device, stream);
}

template int start_highest<false, false>(const Args&, int, size_t, int, void*);
template int start_highest<true, false>(const Args&, int, size_t, int, void*);
template int start_highest<true, true>(const Args&, int, size_t, int, void*);

}  // namespace piper_rb
