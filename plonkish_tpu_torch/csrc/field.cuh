// Prime-field arithmetic for the port's kernels: 8 x 32-bit limbs, little
// endian, Montgomery form with R = 2^256, CIOS multiplication.
//
// Counterpart of plonkish_tpu/fields/soa.py (add, sub, neg, mont_mul, _redc),
// which the Pallas kernels inline.  On the TPU a 254-bit product is built
// from 16 x 16-bit digit products because the VPU has no 64-bit multiplier;
// here each 32 x 32 -> 64-bit partial product is one IMAD.WIDE pair, so a
// product is 2 * 64 multiply-adds plus carries.  These kernels are bound by
// the integer multiply rate, not by memory.
//
// Every function is __host__ __device__: the CPU tests compile this header
// with g++ (csrc/cpu_twin.cpp) and hold it against the plain torch version.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define PK_HD __host__ __device__ __forceinline__

namespace pk {

struct Fe {
  uint32_t v[8];
};

// BN254 scalar field Fr.
struct Fr {
  PK_HD static uint32_t p(int i) {
    const uint32_t P[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i];
  }
  PK_HD static uint32_t one(int i) {  // R mod p
    const uint32_t O[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                           0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return O[i];
  }
  static constexpr uint32_t INV = 0xefffffffu;  // -p^-1 mod 2^32
};

// BN254 base field Fq (G1 coordinates).
struct Fq {
  PK_HD static uint32_t p(int i) {
    const uint32_t P[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i];
  }
  PK_HD static uint32_t one(int i) {
    const uint32_t O[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                           0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return O[i];
  }
  static constexpr uint32_t INV = 0xe4866389u;
};

PK_HD Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = 0;
  return r;
}

template <class F>
PK_HD Fe fe_one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = F::one(i);
  return r;
}

PK_HD bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.v[i];
  return acc == 0;
}

PK_HD bool fe_eq(const Fe& a, const Fe& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// s = a - p; returns the borrow out (1 when a < p).
template <class F>
PK_HD uint32_t sub_p(Fe& s, const Fe& a) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t d = (uint64_t)a.v[i] - F::p(i) - borrow;
    s.v[i] = (uint32_t)d;
    borrow = (d >> 32) & 1;
  }
  return (uint32_t)borrow;
}

// a + b mod p for a, b < p (p < 2^254, so a + b never carries out).
template <class F>
PK_HD Fe fe_add(const Fe& a, const Fe& b) {
  Fe s, d;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)a.v[i] + b.v[i] + carry;
    s.v[i] = (uint32_t)t;
    carry = t >> 32;
  }
  return sub_p<F>(d, s) ? s : d;
}

template <class F>
PK_HD Fe fe_sub(const Fe& a, const Fe& b) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  if (borrow) {
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      uint64_t t = (uint64_t)d.v[i] + F::p(i) + carry;
      d.v[i] = (uint32_t)t;
      carry = t >> 32;
    }
  }
  return d;
}

template <class F>
PK_HD Fe fe_neg(const Fe& a) {
  return fe_sub<F>(fe_zero(), a);
}

// Montgomery product a * b * R^-1 mod p (CIOS), inputs < p, output < p.
template <class F>
PK_HD Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c = (uint64_t)a.v[j] * b.v[i] + t[j] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = (uint64_t)t[8] + (c >> 32);
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * F::INV;
    c = (uint64_t)m * F::p(0) + t[0];
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c = (uint64_t)m * F::p(j) + t[j] + (c >> 32);
      t[j - 1] = (uint32_t)c;
    }
    c = (uint64_t)t[8] + (c >> 32);
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  Fe r, d;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = t[i];
  return sub_p<F>(d, r) ? r : d;
}

template <class F>
PK_HD Fe fe_sqr(const Fe& a) {
  return fe_mul<F>(a, a);
}

PK_HD Fe fe_load(const uint32_t* p) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = p[i];
  return r;
}

PK_HD void fe_store(uint32_t* p, const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; i++) p[i] = a.v[i];
}

}  // namespace pk
