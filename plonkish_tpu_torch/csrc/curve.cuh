// Jacobian point arithmetic on a short Weierstrass curve with a = 0
// (x = X/Z^2, y = Y/Z^3, identity Z = 0).
//
// Counterpart of plonkish_tpu/curves/device.py::_jdbl_soa (:282),
// ::_jmadd_soa (:308) and ::_jadd_soa (:362).  The TPU versions evaluate
// every case and select, because its lanes cannot branch; here the rare
// cases (an identity operand, equal or opposite points) are branches, and the
// common case costs 7M + 4S (mixed) or 11M + 5S (full).  Each operation is
// complete: any input pair gives the right sum.
#pragma once

#include "field.cuh"

namespace pk {

// The curves that the kernels' entry points take (kernels/__init__.py:
// CURVES).  Both have a = 0, so the formulas below hold for both; only
// the base field differs.
constexpr int CURVE_BN254 = 0;  // BN254 G1, coordinates in Fq
constexpr int CURVE_GRUMPKIN = 1;  // Grumpkin G1, coordinates in BN254's Fr

struct Jac {
  Fe x, y, z;
};

PK_HD Jac jac_identity() {
  Jac r;
  r.x = fe_zero();
  r.y = fe_zero();
  r.z = fe_zero();
  return r;
}

PK_HD bool jac_is_identity(const Jac& p) { return fe_is_zero(p.z); }

// dbl-2009-l (a = 0).
template <class F>
PK_HD Jac jac_dbl(const Jac& p) {
  if (jac_is_identity(p)) return p;
  Fe a = fe_sqr<F>(p.x);
  Fe b = fe_sqr<F>(p.y);
  Fe c = fe_sqr<F>(b);
  Fe d = fe_sqr<F>(fe_add<F>(p.x, b));
  d = fe_sub<F>(fe_sub<F>(d, a), c);
  d = fe_add<F>(d, d);
  Fe e = fe_add<F>(fe_add<F>(a, a), a);
  Fe f = fe_sqr<F>(e);
  Jac r;
  r.x = fe_sub<F>(f, fe_add<F>(d, d));
  Fe c8 = fe_add<F>(c, c);
  c8 = fe_add<F>(c8, c8);
  c8 = fe_add<F>(c8, c8);
  r.y = fe_sub<F>(fe_mul<F>(e, fe_sub<F>(d, r.x)), c8);
  Fe z = fe_mul<F>(p.y, p.z);
  r.z = fe_add<F>(z, z);
  return r;
}

// p + (x2, y2) with (x2, y2) affine (madd-2007-bl); inf2 marks the identity.
template <class F>
PK_HD Jac jac_madd(const Jac& p, const Fe& x2, const Fe& y2, bool inf2) {
  if (inf2) return p;
  if (jac_is_identity(p)) {
    Jac r;
    r.x = x2;
    r.y = y2;
    r.z = fe_one<F>();
    return r;
  }
  Fe z1z1 = fe_sqr<F>(p.z);
  Fe u2 = fe_mul<F>(x2, z1z1);
  Fe s2 = fe_mul<F>(y2, fe_mul<F>(p.z, z1z1));
  Fe h = fe_sub<F>(u2, p.x);
  Fe r = fe_sub<F>(s2, p.y);
  if (fe_is_zero(h)) {
    if (fe_is_zero(r)) return jac_dbl<F>(p);
    return jac_identity();
  }
  r = fe_add<F>(r, r);
  Fe hh = fe_sqr<F>(h);
  Fe i4 = fe_add<F>(hh, hh);
  i4 = fe_add<F>(i4, i4);
  Fe j = fe_mul<F>(h, i4);
  Fe v = fe_mul<F>(p.x, i4);
  Jac o;
  o.x = fe_sub<F>(fe_sub<F>(fe_sqr<F>(r), j), fe_add<F>(v, v));
  Fe yj = fe_mul<F>(p.y, j);
  o.y = fe_sub<F>(fe_mul<F>(r, fe_sub<F>(v, o.x)), fe_add<F>(yj, yj));
  Fe zh = fe_add<F>(p.z, h);
  o.z = fe_sub<F>(fe_sub<F>(fe_sqr<F>(zh), z1z1), hh);
  return o;
}

// p + q, both Jacobian (add-2007-bl).
template <class F>
PK_HD Jac jac_add(const Jac& p, const Jac& q) {
  if (jac_is_identity(p)) return q;
  if (jac_is_identity(q)) return p;
  Fe z1z1 = fe_sqr<F>(p.z);
  Fe z2z2 = fe_sqr<F>(q.z);
  Fe u1 = fe_mul<F>(p.x, z2z2);
  Fe u2 = fe_mul<F>(q.x, z1z1);
  Fe s1 = fe_mul<F>(p.y, fe_mul<F>(q.z, z2z2));
  Fe s2 = fe_mul<F>(q.y, fe_mul<F>(p.z, z1z1));
  Fe h = fe_sub<F>(u2, u1);
  Fe r = fe_sub<F>(s2, s1);
  if (fe_is_zero(h)) {
    if (fe_is_zero(r)) return jac_dbl<F>(p);
    return jac_identity();
  }
  r = fe_add<F>(r, r);
  Fe h2 = fe_add<F>(h, h);
  Fe i = fe_sqr<F>(h2);
  Fe j = fe_mul<F>(h, i);
  Fe v = fe_mul<F>(u1, i);
  Jac o;
  o.x = fe_sub<F>(fe_sub<F>(fe_sqr<F>(r), j), fe_add<F>(v, v));
  Fe sj = fe_mul<F>(s1, j);
  o.y = fe_sub<F>(fe_mul<F>(r, fe_sub<F>(v, o.x)), fe_add<F>(sj, sj));
  Fe zz = fe_add<F>(p.z, q.z);
  o.z = fe_mul<F>(fe_sub<F>(fe_sub<F>(fe_sqr<F>(zz), z1z1), z2z2), h);
  return o;
}

PK_HD Jac jac_load(const uint32_t* p) {
  Jac r;
  r.x = fe_load(p);
  r.y = fe_load(p + 8);
  r.z = fe_load(p + 16);
  return r;
}

PK_HD void jac_store(uint32_t* p, const Jac& a) {
  fe_store(p, a.x);
  fe_store(p + 8, a.y);
  fe_store(p + 16, a.z);
}

}  // namespace pk
