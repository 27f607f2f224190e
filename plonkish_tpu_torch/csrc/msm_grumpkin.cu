// K1 and K2 for Grumpkin G1 (coordinates in BN254's Fr): the templates of
// csrc/msm.cuh instantiated in a source of their own, so that nvcc builds
// them beside BN254's (csrc/msm.cu); the entry points there call these.
#include "msm.cuh"

#ifdef __CUDACC__

namespace pk {

int bucket_level_grumpkin(const int32_t* keys, const int32_t* aux, const uint32_t* points,
                          long long m, int num_keys, int affine, uint32_t* buckets,
                          int32_t* ck, int32_t* cf, uint32_t* cp, cudaStream_t st) {
  return bucket_level<Fr>(keys, aux, points, m, num_keys, affine, buckets, ck, cf, cp, st);
}

int window_level_grumpkin(const uint32_t* in, int level, int n_in, int windows,
                          uint32_t* out, int n_out, cudaStream_t st) {
  return window_level<Fr>(in, level, n_in, windows, out, n_out, st);
}

int window_combine_grumpkin(const uint32_t* pv, int windows, int c, uint32_t* out,
                            cudaStream_t st) {
  return window_combine<Fr>(pv, windows, c, out, st);
}

}  // namespace pk

#endif  // __CUDACC__
