// K6, the device-resident Fiat-Shamir round message (port-only; see
// fiat_shamir.cuh for what it replaces and what bounds it): one launch of
// one thread a round, between K3 (whose sums it reads) and K4 (which reads
// its challenge), so that a sum-check round enqueues with no host read.
// field: 0 = Fr, 1 = Fq (kernels/__init__.py: FIELDS); any other value, or a
// degree outside 1..FS_MAX_DEGREE, is refused.
#include "fiat_shamir.cuh"

#ifdef __CUDACC__

using namespace pk;

template <class F>
__global__ void fs_round_kernel(const uint32_t* sums, uint32_t* scal, uint32_t* sponge,
                                const uint32_t* fixed, const uint32_t* rows, int degree,
                                uint32_t* out, uint32_t* ch_mont, uint32_t* ids_next) {
  fs_round_message<F>(sums, scal, sponge, fixed, rows, degree, out, ch_mont, ids_next);
}

template <class F>
__global__ void fs_coeff_kernel(const uint32_t* v, uint32_t* scal, uint32_t* sponge,
                                const uint32_t* c0_base, uint32_t* out, uint32_t* ch_mont) {
  fs_coeff_message<F>(v, scal, sponge, c0_base, out, ch_mont);
}

extern "C" int fs_round(const uint32_t* sums, uint32_t* scal, uint32_t* sponge,
                        const uint32_t* fixed, const uint32_t* rows, int degree,
                        uint32_t* out, uint32_t* ch_mont, uint32_t* ids_next, int field,
                        void* stream) {
  if (degree < 1 || degree > FS_MAX_DEGREE) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (field == 0)
    fs_round_kernel<Fr><<<1, 1, 0, st>>>(sums, scal, sponge, fixed, rows, degree, out, ch_mont,
                                          ids_next);
  else if (field == 1)
    fs_round_kernel<Fq><<<1, 1, 0, st>>>(sums, scal, sponge, fixed, rows, degree, out, ch_mont,
                                          ids_next);
  else
    return -1;
  return (int)cudaGetLastError();
}

extern "C" int fs_coeff(const uint32_t* v, uint32_t* scal, uint32_t* sponge,
                        const uint32_t* c0_base, uint32_t* out, uint32_t* ch_mont, int field,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (field == 0)
    fs_coeff_kernel<Fr><<<1, 1, 0, st>>>(v, scal, sponge, c0_base, out, ch_mont);
  else if (field == 1)
    fs_coeff_kernel<Fq><<<1, 1, 0, st>>>(v, scal, sponge, c0_base, out, ch_mont);
  else
    return -1;
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
