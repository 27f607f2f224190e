// The Montgomery product of field.cuh (a * b * R^-1 mod p, 8 x 32-bit limbs,
// inputs and output below p) written for the card's integer pipe: inline
// PTX carry chains (mad.lo.cc / madc.hi.cc / addc), where fe_mul is C over
// uint64_t accumulators that nvcc builds from wide multiply-adds and
// separate carry arithmetic.
//
// Operand scanning, one word of b a step, with the reduction interleaved
// (CIOS).  The running sum T is kept as two numbers of eight words: `ev`,
// whose words sit at columns 0..7, and `od`, whose words sit at columns
// 1..8 (T = ev + od * 2^32).  The products of a's even limbs with b[i]
// (columns 2j, 2j + 1) go into ev, those of its odd limbs into od, each a
// chain of eight multiply-adds with its own carry, so that the two chains
// never wait on each other's carries (the layout of the even and odd
// columns in supranational's sppark ff/mont_t.cuh; this is our own
// formulation of it).  The reduction m = ev[0] * (-p^-1) adds m * p the
// same way; then T / 2^32 swaps the roles: od is at columns 0..7 and
// becomes the next ev, and ev (its word 0 now zero) becomes the next od
// once shifted down by two words, its word 1 (at column 0) added into the
// next ev's word 0 with the carry going on into the next od's chain.
//
// Bounds: p < 2^254 and a < p put a's and p's top limbs below 2^30, so each
// of a's and p's odd halves times a word is below 2^254 + 2^224, and od
// stays below 2^256 with every carry that ev hands it: od's chains never
// carry out.  T < 2p after every step (p < R / 4), so one conditional
// subtraction ends the product.
//
// On the card each chain is one asm statement, so the carries stay in the
// condition code from one instruction to the next.  The sum and difference
// at the end (fe_add_ptx, fe_sub_ptx) are chains of the same kind.  The host
// build (g++, the CPU tests) runs the same steps with the carry in a
// variable, so the tests check the algorithm; phase 2 of chip_smoke.py
// holds the card's build against fe_mul, fe_add and fe_sub.
#pragma once

#include "field.cuh"

namespace pk {

// acc = x * y: x's four words at 64-bit steps, so their products do not overlap.
PK_HD void cc_mul4(uint32_t* acc, const uint32_t* x, uint32_t y) {
#pragma unroll
  for (int j = 0; j < 4; j++) {
    uint64_t t = (uint64_t)x[j] * y;
    acc[2 * j] = (uint32_t)t;
    acc[2 * j + 1] = (uint32_t)(t >> 32);
  }
}

// acc += x * y; the carry out of word 7 is added to `top`.
PK_HD void cc_mad4(uint32_t* acc, const uint32_t* x, uint32_t y, uint32_t& top) {
#ifdef __CUDA_ARCH__
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]),
        "+r"(acc[6]), "+r"(acc[7]), "+r"(top)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(y));
#else
  uint64_t c = 0;
  for (int j = 0; j < 4; j++) {
    uint64_t t = (uint64_t)x[j] * y;
    uint64_t s = (uint64_t)acc[2 * j] + (uint32_t)t + c;
    acc[2 * j] = (uint32_t)s;
    s = (uint64_t)acc[2 * j + 1] + (t >> 32) + (s >> 32);
    acc[2 * j + 1] = (uint32_t)s;
    c = s >> 32;
  }
  top += (uint32_t)c;
#endif
}

// acc += x * y where the sum is known to fit eight words (no carry out).
PK_HD void cc_mad4_top(uint32_t* acc, const uint32_t* x, uint32_t y) {
#ifdef __CUDA_ARCH__
  asm("mad.lo.cc.u32 %0, %8, %12, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
      "madc.hi.u32 %7, %11, %12, %7;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]),
        "+r"(acc[6]), "+r"(acc[7])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(y));
#else
  uint32_t top = 0;
  cc_mad4(acc, x, y, top);
#endif
}

// The shift between two steps and the next odd chain in one carry chain:
// ev0 += od[1] (column 0), then od = (od >> 64) + x * y with that carry
// entering at od's word 0 (column 1).  od[0] is zero here and not read.
PK_HD void cc_shift_mad4(uint32_t& ev0, uint32_t* od, const uint32_t* x, uint32_t y) {
#ifdef __CUDA_ARCH__
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "madc.lo.cc.u32 %1, %16, %20, %10;\n\t"
      "madc.hi.cc.u32 %2, %16, %20, %11;\n\t"
      "madc.lo.cc.u32 %3, %17, %20, %12;\n\t"
      "madc.hi.cc.u32 %4, %17, %20, %13;\n\t"
      "madc.lo.cc.u32 %5, %18, %20, %14;\n\t"
      "madc.hi.cc.u32 %6, %18, %20, %15;\n\t"
      "madc.lo.cc.u32 %7, %19, %20, 0;\n\t"
      "madc.hi.u32 %8, %19, %20, 0;"
      : "+r"(ev0), "=r"(od[0]), "=r"(od[1]), "=r"(od[2]), "=r"(od[3]), "=r"(od[4]),
        "=r"(od[5]), "=r"(od[6]), "=r"(od[7])
      : "r"(od[1]), "r"(od[2]), "r"(od[3]), "r"(od[4]), "r"(od[5]), "r"(od[6]), "r"(od[7]),
        "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(y));
#else
  uint32_t in[8];
  for (int w = 0; w < 8; w++) in[w] = od[w];
  uint64_t s = (uint64_t)ev0 + in[1];
  ev0 = (uint32_t)s;
  uint64_t c = s >> 32;
  for (int j = 0; j < 4; j++) {
    uint64_t t = (uint64_t)x[j] * y;
    uint32_t lo_in = j < 3 ? in[2 * j + 2] : 0, hi_in = j < 3 ? in[2 * j + 3] : 0;
    s = (uint64_t)lo_in + (uint32_t)t + c;
    od[2 * j] = (uint32_t)s;
    s = (uint64_t)hi_in + (t >> 32) + (s >> 32);
    od[2 * j + 1] = (uint32_t)s;
    c = s >> 32;
  }
#endif
}

// r = od + ev / 2^32 (ev[0] is zero): T after the last step, below 2p.
PK_HD void cc_merge(uint32_t* r, const uint32_t* od, const uint32_t* ev) {
#ifdef __CUDA_ARCH__
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]),
        "=r"(r[7])
      : "r"(od[0]), "r"(od[1]), "r"(od[2]), "r"(od[3]), "r"(od[4]), "r"(od[5]), "r"(od[6]),
        "r"(od[7]), "r"(ev[1]), "r"(ev[2]), "r"(ev[3]), "r"(ev[4]), "r"(ev[5]), "r"(ev[6]),
        "r"(ev[7]));
#else
  uint64_t c = 0;
  for (int w = 0; w < 8; w++) {
    uint64_t s = (uint64_t)od[w] + (w < 7 ? ev[w + 1] : 0) + c;
    r[w] = (uint32_t)s;
    c = s >> 32;
  }
#endif
}

// One step i >= 1: `ev` (the last step's od) and `od` (the last step's ev,
// reduced: word 0 zero) take b[i] and the reduction.
template <class F>
PK_HD void cc_step(uint32_t* ev, uint32_t* od, const uint32_t* a_even, const uint32_t* a_odd,
                   const uint32_t* p_even, const uint32_t* p_odd, uint32_t bi) {
  cc_shift_mad4(ev[0], od, a_odd, bi);
  cc_mad4(ev, a_even, bi, od[7]);
  uint32_t m = ev[0] * F::INV;
  cc_mad4_top(od, p_odd, m);
  cc_mad4(ev, p_even, m, od[7]);
}

// Montgomery product a * b * R^-1 mod p, inputs < p, output < p; equal to fe_mul.
template <class F>
PK_HD Fe fe_mul_ptx(const Fe& a, const Fe& b) {
  const uint32_t ae[4] = {a.v[0], a.v[2], a.v[4], a.v[6]};
  const uint32_t ao[4] = {a.v[1], a.v[3], a.v[5], a.v[7]};
  const uint32_t pe[4] = {F::p(0), F::p(2), F::p(4), F::p(6)};
  const uint32_t po[4] = {F::p(1), F::p(3), F::p(5), F::p(7)};
  uint32_t x[8], y[8];
  // step 0: x even, y odd
  cc_mul4(x, ae, b.v[0]);
  cc_mul4(y, ao, b.v[0]);
  uint32_t m = x[0] * F::INV;
  cc_mad4_top(y, po, m);
  cc_mad4(x, pe, m, y[7]);
  // the roles swap each step: odd steps leave y even, even steps x
  cc_step<F>(y, x, ae, ao, pe, po, b.v[1]);
  cc_step<F>(x, y, ae, ao, pe, po, b.v[2]);
  cc_step<F>(y, x, ae, ao, pe, po, b.v[3]);
  cc_step<F>(x, y, ae, ao, pe, po, b.v[4]);
  cc_step<F>(y, x, ae, ao, pe, po, b.v[5]);
  cc_step<F>(x, y, ae, ao, pe, po, b.v[6]);
  cc_step<F>(y, x, ae, ao, pe, po, b.v[7]);
  Fe r, d;
  cc_merge(r.v, x, y);
  return sub_p<F>(d, r) ? r : d;
}

// a + b mod p and a - b mod p (inputs < p, outputs < p) in carry chains:
// the sum, then the sum less p with its borrow choosing between the two; the
// difference, then p added back under the mask of its borrow.  Equal to
// field.cuh's fe_add and fe_sub, which build each carry from a 64-bit add.
template <class F>
PK_HD Fe fe_add_ptx(const Fe& a, const Fe& b) {
  Fe t, d;
  uint32_t borrow;
#ifdef __CUDA_ARCH__
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(t.v[0]), "=r"(t.v[1]), "=r"(t.v[2]), "=r"(t.v[3]), "=r"(t.v[4]), "=r"(t.v[5]),
        "=r"(t.v[6]), "=r"(t.v[7])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]), "=r"(d.v[5]),
        "=r"(d.v[6]), "=r"(d.v[7]), "=r"(borrow)
      : "r"(t.v[0]), "r"(t.v[1]), "r"(t.v[2]), "r"(t.v[3]), "r"(t.v[4]), "r"(t.v[5]),
        "r"(t.v[6]), "r"(t.v[7]), "r"(F::p(0)), "r"(F::p(1)), "r"(F::p(2)), "r"(F::p(3)),
        "r"(F::p(4)), "r"(F::p(5)), "r"(F::p(6)), "r"(F::p(7)));
#else
  uint64_t c = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)a.v[i] + b.v[i] + c;
    t.v[i] = (uint32_t)x;
    c = x >> 32;
  }
  c = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)t.v[i] - F::p(i) - c;
    d.v[i] = (uint32_t)x;
    c = (x >> 32) & 1;
  }
  borrow = c ? 0xffffffffu : 0u;  // subc.u32 0, 0 with the borrow in: 0 - 0 - 1
#endif
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = borrow ? t.v[i] : d.v[i];
  return r;
}

template <class F>
PK_HD Fe fe_sub_ptx(const Fe& a, const Fe& b) {
  Fe d, r;
  uint32_t mask;
#ifdef __CUDA_ARCH__
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]), "=r"(d.v[5]),
        "=r"(d.v[6]), "=r"(d.v[7]), "=r"(mask)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]), "=r"(r.v[4]), "=r"(r.v[5]),
        "=r"(r.v[6]), "=r"(r.v[7])
      : "r"(d.v[0]), "r"(d.v[1]), "r"(d.v[2]), "r"(d.v[3]), "r"(d.v[4]), "r"(d.v[5]),
        "r"(d.v[6]), "r"(d.v[7]), "r"(F::p(0) & mask), "r"(F::p(1) & mask),
        "r"(F::p(2) & mask), "r"(F::p(3) & mask), "r"(F::p(4) & mask), "r"(F::p(5) & mask),
        "r"(F::p(6) & mask), "r"(F::p(7) & mask));
#else
  uint64_t c = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)a.v[i] - b.v[i] - c;
    d.v[i] = (uint32_t)x;
    c = (x >> 32) & 1;
  }
  mask = c ? 0xffffffffu : 0u;
  c = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)d.v[i] + (F::p(i) & mask) + c;
    r.v[i] = (uint32_t)x;
    c = x >> 32;
  }
#endif
  return r;
}

}  // namespace pk
