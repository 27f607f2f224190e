// Sum-check kernel K4, the fold of every table, over BN254 Fr or Fq.
//
// K4 replaces plonkish_tpu/pallas/sumcheck.py::_fold_kernel (sumcheck.py:225):
// new[i] = lo + c * (hi - lo) over every table at once; the state keeps
// fix_var pairs as neighbouring rows (2i, 2i + 1), so element e of the output
// reads rows 2e and 2e + 1.  Bound: memory (read 2 elements, write 1, one
// product each).  HyperPlonk runs over Fr with KZG, Gemini, Zeromorph and
// Brakedown, and over Fq (Grumpkin's scalar field) with IPA and Hyrax.
//
// K3, the round evaluations, is generated for each expression: see
// sumcheck.cuh and kernels/sumcheck_gen.py.
#include "field.cuh"

namespace pk {

template <class F>
PK_HD void fold_element(int64_t e, const uint32_t* state, const Fe& c,
                        uint32_t* out) {
  Fe lo = fe_load(state + 2 * e * 8);
  Fe hi = fe_load(state + (2 * e + 1) * 8);
  fe_store(out + e * 8, fe_add<F>(lo, fe_mul<F>(fe_sub<F>(hi, lo), c)));
}

}  // namespace pk

#ifdef __CUDACC__

using namespace pk;

template <class F>
__global__ void fold_kernel(const uint32_t* state, int64_t n_out,
                            const uint32_t* challenge, uint32_t* out) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  fold_element<F>(e, state, fe_load(challenge), out);
}

// field: 0 = Fr, 1 = Fq (kernels/__init__.py: FIELDS); any other value is refused.
extern "C" int sumcheck_fold(const uint32_t* state, long long n_out,
                             const uint32_t* challenge, uint32_t* out, int field,
                             void* stream) {
  int block = 256;
  long long grid = (n_out + block - 1) / block;
  cudaStream_t st = (cudaStream_t)stream;
  if (field == 0)
    fold_kernel<Fr><<<(unsigned)grid, block, 0, st>>>(state, n_out, challenge, out);
  else if (field == 1)
    fold_kernel<Fq><<<(unsigned)grid, block, 0, st>>>(state, n_out, challenge, out);
  else
    return -1;
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
