// Brakedown's encoding (pcs/brakedown_code.py): one sparse matrix of the
// code's A or B chain, or the dense Reed-Solomon base case, applied to every
// row of the commitment matrix at once, over BN254 Fr or Fq.
//
// Port-only: no Pallas kernel corresponds.  The JAX package's SparseMatrix.dot
// is an XLA gather, a product and a scatter-add; the port's plain version
// (limb.mont_mul, limb.scatter_sum) holds every term's 16-bit digits in int64
// tensors, 1.47 GB a tensor for the first A matrix at k = 20.  Here the
// matrix is kept by output (kernels/brakedown.py ByOutput: for output j the
// input indices and Montgomery coefficients of its nonzeros, offsets[j] to
// offsets[j + 1]), and thread (j, b) computes
//     out[b, j] = sum_e coeff[e] * in[b, index[e]]
// in registers, each product by fe_mul_ptx (field_ptx.cuh: the coefficient
// kept whole, the input taken a word a step; output below p) and each sum by
// fe_add_ptx, and writes it once.  Nothing but the output is stored.
//
// Bound: operations.  At k = 20 (Spec 6) a commit is 32 rows x 848,115
// nonzeros, 27.1 M products of 256 multiply-adds; the bytes (the input, the
// codeword, the matrices once) are a tenth of that time.  Threads run b
// fastest, so with 32 rows a warp is one output: its coefficient and index
// loads are one address for the warp, and where the rows are the codeword's
// columns ([codeword_len, rows, 8], in_sb = 1) its inputs are 1 KiB
// contiguous.  Strides are in elements of 8 limbs, so a [rows, n, 8] tensor
// and a column-major slice of the codeword both go in as they are.
#include "field_ptx.cuh"

namespace pk {

PK_HD Fe bd_load(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 lo = q[0], hi = q[1];
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
#else
  return fe_load(p);
#endif
}

// Output t = j * rows + b of the launch: out[b, j].
template <class F>
PK_HD void bd_dot_item(int64_t t, int rows, const uint32_t* in, int64_t in_sb, int64_t in_si,
                       uint32_t* out, int64_t out_sb, int64_t out_sj, const int32_t* offsets,
                       const int32_t* index, const uint32_t* coeff) {
  int64_t j = t / rows, b = t % rows;
  const uint32_t* row = in + 8 * b * in_sb;
  Fe acc = fe_zero();
  for (int32_t e = offsets[j], end = offsets[j + 1]; e < end; e++) {
    Fe x = bd_load(row + 8 * (int64_t)index[e] * in_si);
    acc = fe_add_ptx<F>(acc, fe_mul_ptx<F>(bd_load(coeff + 8 * (int64_t)e), x));
  }
  fe_store(out + 8 * (b * out_sb + j * out_sj), acc);
}

}  // namespace pk

#ifdef __CUDACC__

using namespace pk;

template <class F>
__global__ void brakedown_dot_kernel(int64_t total, int rows, const uint32_t* in, int64_t in_sb,
                                     int64_t in_si, uint32_t* out, int64_t out_sb,
                                     int64_t out_sj, const int32_t* offsets,
                                     const int32_t* index, const uint32_t* coeff) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  bd_dot_item<F>(t, rows, in, in_sb, in_si, out, out_sb, out_sj, offsets, index, coeff);
}

// in: rows x n elements at strides (in_sb, in_si); out: rows x m at (out_sb,
// out_sj); offsets int32[m + 1], index int32[nnz], coeff int32[nnz, 8]
// Montgomery; every element pointer 16-byte aligned.  field: 0 = Fr, 1 = Fq.
// Enqueues one launch on `stream` (none for an empty output) and returns 0,
// a CUDA error code, or -1 for a field or shape the kernel is not built for.
extern "C" int brakedown_dot(const uint32_t* in, long long in_sb, long long in_si, uint32_t* out,
                             long long out_sb, long long out_sj, const int32_t* offsets,
                             const int32_t* index, const uint32_t* coeff, long long m, int rows,
                             int field, int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m < 0 || rows <= 0 || threads <= 0) return -1;
  long long total = m * rows;
  if (total == 0) return 0;
  long long grid = (total + threads - 1) / threads;
  if (field == 0)
    brakedown_dot_kernel<Fr><<<(unsigned)grid, threads, 0, st>>>(
        total, rows, in, in_sb, in_si, out, out_sb, out_sj, offsets, index, coeff);
  else if (field == 1)
    brakedown_dot_kernel<Fq><<<(unsigned)grid, threads, 0, st>>>(
        total, rows, in, in_sb, in_si, out, out_sb, out_sj, offsets, index, coeff);
  else
    return -1;
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
