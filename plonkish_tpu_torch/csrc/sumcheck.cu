// Sum-check kernel K4 over BN254 Fr: the fold of every table.
//
// K4 replaces plonkish_tpu/pallas/sumcheck.py::_fold_kernel (sumcheck.py:225):
// new[i] = lo + c * (hi - lo) over every table at once; the state keeps
// fix_var pairs as neighbouring rows (2i, 2i + 1), so element e of the output
// reads rows 2e and 2e + 1.  Bound: memory (read 2 elements, write 1, one
// product each).
//
// K3, the round evaluations, is generated for each expression: see
// sumcheck.cuh and kernels/sumcheck_gen.py.
#include "field.cuh"

namespace pk {

PK_HD void fold_element(int64_t e, const uint32_t* state, const Fe& c,
                        uint32_t* out) {
  Fe lo = fe_load(state + 2 * e * 8);
  Fe hi = fe_load(state + (2 * e + 1) * 8);
  fe_store(out + e * 8, fe_add<Fr>(lo, fe_mul<Fr>(fe_sub<Fr>(hi, lo), c)));
}

}  // namespace pk

#ifdef __CUDACC__

using namespace pk;

__global__ void fold_kernel(const uint32_t* state, int64_t n_out,
                            const uint32_t* challenge, uint32_t* out) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  fold_element(e, state, fe_load(challenge), out);
}

extern "C" int sumcheck_fold(const uint32_t* state, long long n_out,
                             const uint32_t* challenge, uint32_t* out,
                             void* stream) {
  int block = 256;
  long long grid = (n_out + block - 1) / block;
  fold_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      state, n_out, challenge, out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
