// Sum-check kernels over BN254 Fr: K3 round evaluations and K4 fold.
//
// K3 replaces plonkish_tpu/pallas/sumcheck.py::_round_kernel
// (sumcheck.py:159).  The Pallas kernel traces the expression into the
// kernel, once per expression and size, and keeps per-lane 16-bit digit sums
// that the host reduces.  Here one build serves every expression: each
// thread interprets the SSA tape of piop/tape.py (op, a, b, dst) over its
// hypercube pairs, with every leaf at lo + t * (hi - lo) for t = 1..d, and
// keeps d running sums mod p.  The sums are added in a shared-memory tree
// per block and then over the blocks by a second, one-block kernel.  The
// identity leaf is made from the pair index.  Registers and leaves live in
// thread-local arrays (the tape indexes them at run time).
//
// K4 replaces ::_fold_kernel (sumcheck.py:225): new[i] = lo + c * (hi - lo)
// over every table at once; the state keeps fix_var pairs as neighbouring
// rows (2i, 2i + 1), so element e of the output reads rows 2e and 2e + 1.
//
// Bound: K3 by integer multiply-adds (the tape's products per pair and t);
// K4 by memory (read 2 elements, write 1, one product each).
#include "field.cuh"

namespace pk {

constexpr int SC_MAX_REGS = 32;
constexpr int SC_MAX_LEAVES = 40;
constexpr int SC_MAX_DEGREE = 8;
constexpr int OP_ADD = 0, OP_MUL = 1, OP_NEG = 2, OP_CONST = 3;  // else OP_LOAD

// Adds expr(t) for t = 1..degree at pair i into acc[0..degree).
// state: [T, 2s, 8]; leaf operand T of OP_LOAD is the identity polynomial,
// valued ids[1] + i * ids[0] + (t - 1) * ids[2] (ids[0] raw, so that the
// Montgomery product with the raw pair index is Montgomery).
PK_HD void round_pair(int64_t i, const uint32_t* state, int T, int64_t s,
                      const int32_t* instrs, int n_instr, const uint32_t* consts,
                      int out_reg, int degree, const uint32_t* ids, Fe* acc) {
  Fe cur[SC_MAX_LEAVES];
  Fe step[SC_MAX_LEAVES];
  Fe regs[SC_MAX_REGS];
  for (int j = 0; j < T; j++) {
    const uint32_t* row = state + ((int64_t)j * 2 * s + 2 * i) * 8;
    Fe lo = fe_load(row);
    Fe hi = fe_load(row + 8);
    cur[j] = hi;
    step[j] = fe_sub<Fr>(hi, lo);
  }
  Fe idx = fe_zero();
  idx.v[0] = (uint32_t)i;
  idx.v[1] = (uint32_t)(i >> 32);
  Fe ident = fe_add<Fr>(fe_mul<Fr>(idx, fe_load(ids)), fe_load(ids + 8));
  Fe id_step = fe_load(ids + 16);
  for (int t = 1; t <= degree; t++) {
    if (t > 1) {
      for (int j = 0; j < T; j++) cur[j] = fe_add<Fr>(cur[j], step[j]);
      ident = fe_add<Fr>(ident, id_step);
    }
    for (int k = 0; k < n_instr; k++) {
      const int32_t* in = instrs + 4 * k;
      int op = in[0], a = in[1], b = in[2], dst = in[3];
      Fe v;
      switch (op) {
        case OP_ADD: v = fe_add<Fr>(regs[a], regs[b]); break;
        case OP_MUL: v = fe_mul<Fr>(regs[a], regs[b]); break;
        case OP_NEG: v = fe_neg<Fr>(regs[a]); break;
        case OP_CONST: v = fe_load(consts + 8 * a); break;
        default: v = (a == T) ? ident : cur[a]; break;
      }
      regs[dst] = v;
    }
    acc[t - 1] = fe_add<Fr>(acc[t - 1], regs[out_reg]);
  }
}

PK_HD void fold_element(int64_t e, const uint32_t* state, const Fe& c,
                        uint32_t* out) {
  Fe lo = fe_load(state + 2 * e * 8);
  Fe hi = fe_load(state + (2 * e + 1) * 8);
  fe_store(out + e * 8, fe_add<Fr>(lo, fe_mul<Fr>(fe_sub<Fr>(hi, lo), c)));
}

}  // namespace pk

#ifdef __CUDACC__

using namespace pk;

__global__ void round_kernel(const uint32_t* state, int T, int64_t s,
                             const int32_t* instrs, int n_instr,
                             const uint32_t* consts, int out_reg, int degree,
                             const uint32_t* ids, uint32_t* partial) {
  extern __shared__ uint32_t sh[];  // [blockDim.x][8]
  Fe acc[SC_MAX_DEGREE];
  for (int t = 0; t < SC_MAX_DEGREE; t++) acc[t] = fe_zero();
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < s; i += stride)
    round_pair(i, state, T, s, instrs, n_instr, consts, out_reg, degree, ids, acc);
  int tid = threadIdx.x;
  for (int t = 0; t < degree; t++) {
    fe_store(sh + tid * 8, acc[t]);
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w >>= 1) {
      if (tid < w)
        fe_store(sh + tid * 8, fe_add<Fr>(fe_load(sh + tid * 8), fe_load(sh + (tid + w) * 8)));
      __syncthreads();
    }
    if (tid == 0) fe_store(partial + ((int64_t)blockIdx.x * degree + t) * 8, fe_load(sh));
    __syncthreads();
  }
}

__global__ void round_reduce_kernel(const uint32_t* partial, int blocks,
                                    int degree, uint32_t* out) {
  extern __shared__ uint32_t sh[];
  int tid = threadIdx.x;
  for (int t = 0; t < degree; t++) {
    Fe acc = fe_zero();
    for (int b = tid; b < blocks; b += blockDim.x)
      acc = fe_add<Fr>(acc, fe_load(partial + ((int64_t)b * degree + t) * 8));
    fe_store(sh + tid * 8, acc);
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w >>= 1) {
      if (tid < w)
        fe_store(sh + tid * 8, fe_add<Fr>(fe_load(sh + tid * 8), fe_load(sh + (tid + w) * 8)));
      __syncthreads();
    }
    if (tid == 0) fe_store(out + t * 8, fe_load(sh));
    __syncthreads();
  }
}

__global__ void fold_kernel(const uint32_t* state, int64_t n_out,
                            const uint32_t* challenge, uint32_t* out) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  fold_element(e, state, fe_load(challenge), out);
}

extern "C" int sumcheck_round(const uint32_t* state, int T, int s,
                              const int32_t* instrs, int n_instr,
                              const uint32_t* consts, int num_regs, int out_reg,
                              int degree, const uint32_t* ids, int blocks,
                              int threads, uint32_t* partial, uint32_t* out,
                              void* stream) {
  if (num_regs > SC_MAX_REGS || T + 1 > SC_MAX_LEAVES || degree > SC_MAX_DEGREE)
    return -1;
  size_t shmem = (size_t)threads * 8 * sizeof(uint32_t);
  cudaStream_t st = (cudaStream_t)stream;
  round_kernel<<<blocks, threads, shmem, st>>>(state, T, s, instrs, n_instr,
                                               consts, out_reg, degree, ids, partial);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  round_reduce_kernel<<<1, threads, shmem, st>>>(partial, blocks, degree, out);
  return (int)cudaGetLastError();
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
