// K6, the device-resident Fiat-Shamir round message (port-only; see
// fiat_shamir.cuh for what it replaces, what bounds it and its design): one
// launch of one warp a round, between K3 (whose sums it reads) and K4 (which
// reads its challenge), so that a sum-check round enqueues with no host read.
// field: 0 = Fr, 1 = Fq (kernels/__init__.py: FIELDS); any other value, or a
// degree outside 1..FS_MAX_DEGREE, is refused.  The warp's code is in
// fs_warp.cuh, which K7 (sumcheck_fused.cuh) shares.
#include "fs_warp.cuh"

#ifdef __CUDACC__

using namespace pk;

template <class F>
__global__ void __launch_bounds__(FS_THREADS)
    fs_round_kernel(const uint32_t* sums, uint32_t* scal, uint32_t* sponge,
                    const uint32_t* fixed, const uint32_t* rows, int degree, uint32_t* out,
                    uint32_t* ch_mont, uint32_t* ids_next) {
  __shared__ FsShared sh;
  fs_round_warp<F>(threadIdx.x, sums, scal, sponge, fixed, rows, degree, out, ch_mont, ids_next,
                   sh);
}

template <class F>
__global__ void __launch_bounds__(FS_THREADS)
    fs_coeff_kernel(const uint32_t* v, uint32_t* scal, uint32_t* sponge,
                    const uint32_t* c0_base, uint32_t* out, uint32_t* ch_mont) {
  __shared__ FsShared sh;
  const int lane = threadIdx.x;
  Fe c0, c1, c2;
  fs_coeff_message<F>(v, scal, c0_base, c0, c1, c2);
  if (lane < 3) fs_coeff_prepare<F>(lane, c0, c1, c2, out, sh);
  __syncwarp();
  Fe ch = fs_squeeze_warp<F>(lane, sponge, 12, sh);
  fs_coeff_finish<F>(lane, FS_THREADS, c0, c1, c2, ch, fe_to_mont<F>(ch), scal, sponge, out,
                     ch_mont, sh);
}

extern "C" int fs_round(const uint32_t* sums, uint32_t* scal, uint32_t* sponge,
                        const uint32_t* fixed, const uint32_t* rows, int degree,
                        uint32_t* out, uint32_t* ch_mont, uint32_t* ids_next, int field,
                        void* stream) {
  if (degree < 1 || degree > FS_MAX_DEGREE) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (field == 0)
    fs_round_kernel<Fr><<<1, FS_THREADS, 0, st>>>(sums, scal, sponge, fixed, rows, degree, out,
                                                   ch_mont, ids_next);
  else if (field == 1)
    fs_round_kernel<Fq><<<1, FS_THREADS, 0, st>>>(sums, scal, sponge, fixed, rows, degree, out,
                                                   ch_mont, ids_next);
  else
    return -1;
  return (int)cudaGetLastError();
}

extern "C" int fs_coeff(const uint32_t* v, uint32_t* scal, uint32_t* sponge,
                        const uint32_t* c0_base, uint32_t* out, uint32_t* ch_mont, int field,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (field == 0)
    fs_coeff_kernel<Fr><<<1, FS_THREADS, 0, st>>>(v, scal, sponge, c0_base, out, ch_mont);
  else if (field == 1)
    fs_coeff_kernel<Fq><<<1, FS_THREADS, 0, st>>>(v, scal, sponge, c0_base, out, ch_mont);
  else
    return -1;
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
