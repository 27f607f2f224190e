// The C entry points of K1 and K2 (csrc/msm.cuh): the curve is an argument,
// BN254 G1's kernels are compiled here and Grumpkin G1's in
// msm_grumpkin.cu, so that nvcc builds the two in parallel.
#include "msm.cuh"

// Checks the callers' sizes against the ones compiled here (0 or -1).
extern "C" int msm_check_layout(int tile, int segment, int threads) {
  return tile == pk::K1_TILE && segment == pk::K2_SEGMENT && threads == pk::K2_THREADS
             ? 0 : -1;
}

#ifdef __CUDACC__

using namespace pk;

// The entry points take the curve: CURVE_BN254 (G1 over Fq) or CURVE_GRUMPKIN
// (G1 over BN254's Fr); any other value is refused with -1.

// One K1 level over m sorted entries: ceil(m / K1_TILE) blocks.
extern "C" int msm_bucket_level(const int32_t* keys, const int32_t* aux,
                                const uint32_t* points, long long m, int num_keys,
                                int affine, uint32_t* buckets, int32_t* ck, int32_t* cf,
                                uint32_t* cp, int curve, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (curve == CURVE_BN254)
    return bucket_level<Fq>(keys, aux, points, m, num_keys, affine, buckets, ck, cf, cp, st);
  if (curve == CURVE_GRUMPKIN)
    return bucket_level_grumpkin(keys, aux, points, m, num_keys, affine, buckets, ck, cf, cp,
                                 st);
  return -1;
}

// One K2 level: grid (n_out, windows).  Level 0 reads the buckets
// ([W, n_in, 3, 8]); level l > 0 the previous level's items ([W, n_in, 2, 3,
// 8]).  An item of level l spans K2_SEGMENT * K2_THREADS^l buckets.
extern "C" int msm_window_level(const uint32_t* in, int level, int n_in, int windows,
                                uint32_t* out, int n_out, int curve, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (curve == CURVE_BN254) return window_level<Fq>(in, level, n_in, windows, out, n_out, st);
  if (curve == CURVE_GRUMPKIN)
    return window_level_grumpkin(in, level, n_in, windows, out, n_out, st);
  return -1;
}

// sum_w 2^(c * w) * V_w over the last level's items [W, 1, 2, 3, 8] -> out [3, 8].
extern "C" int msm_window_combine(const uint32_t* pv, int windows, int c, uint32_t* out,
                                  int curve, void* stream) {
  if (windows > K2_THREADS) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (curve == CURVE_BN254) return window_combine<Fq>(pv, windows, c, out, st);
  if (curve == CURVE_GRUMPKIN) return window_combine_grumpkin(pv, windows, c, out, st);
  return -1;
}

#endif  // __CUDACC__
