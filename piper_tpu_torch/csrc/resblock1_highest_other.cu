// K2-K4 at "highest" at C = 48, 80, 96 and 112: the multiples of 16 below
// 128 that the kernels take at "highest" and no preset voice has, compiled
// in a translation unit of their own beside resblock1_highest.cu. Past C =
// 64 the ring's unit is one swizzle atom of a tap (tap_units), and from C =
// 48 act(y) and act(conv1) share one buffer (in_place).

#include "resblock1.cuh"

namespace piper_rb {

template <bool kMean, bool kFolded>
int start_highest_other(const Args& a, int B, size_t smem, int device, void* stream) {
  switch (a.C) {
    case 48: return start<kMean, kFolded, 0, float, 48>(a, B, smem, device, stream);
    case 80: return start<kMean, kFolded, 0, float, 80>(a, B, smem, device, stream);
    case 96: return start<kMean, kFolded, 0, float, 96>(a, B, smem, device, stream);
    default: return start<kMean, kFolded, 0, float, 112>(a, B, smem, device, stream);
  }
}

template int start_highest_other<false, false>(const Args&, int, size_t, int, void*);
template int start_highest_other<true, false>(const Args&, int, size_t, int, void*);
template int start_highest_other<true, true>(const Args&, int, size_t, int, void*);

}  // namespace piper_rb
