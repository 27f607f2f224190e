// Copied from plonkish_tpu/ops/field_native.cpp: the native multicore host
// runtime, the baseline column of plonkish_tpu_torch/bench.py (ops/field_cpp.py
// builds it with g++ at first use).
// Native host field/curve kernels for the plonkish_tpu runtime.
//
// The TPU compute path is JAX/XLA over uint32[...,16] digit tensors; this
// library provides the same operations for host-side execution (tests,
// verifiers, protocol glue) at native speed: 4x64-bit limb CIOS Montgomery
// multiplication (unsigned __int128 accumulators), batched complete-formula
// EC point ops, and a serial-window Pippenger MSM.
//
// ABI: all field elements cross the boundary as 16 little-endian 16-bit
// digits held in uint32 lanes — bit-identical to the device layout.  Fields
// and curves are registered once and referenced by small integer ids.

#include <cstdint>
#include <cstring>
#include <vector>

using u32 = uint32_t;
using u64 = uint64_t;
using u128 = unsigned __int128;

namespace {

struct Fe {
  u64 v[4];
};

inline Fe load(const u32* d) {
  Fe f;
  for (int i = 0; i < 4; ++i) {
    f.v[i] = (u64)d[4 * i] | ((u64)d[4 * i + 1] << 16) |
             ((u64)d[4 * i + 2] << 32) | ((u64)d[4 * i + 3] << 48);
  }
  return f;
}

inline void store(u32* d, const Fe& f) {
  for (int i = 0; i < 4; ++i) {
    d[4 * i] = (u32)(f.v[i] & 0xffff);
    d[4 * i + 1] = (u32)((f.v[i] >> 16) & 0xffff);
    d[4 * i + 2] = (u32)((f.v[i] >> 32) & 0xffff);
    d[4 * i + 3] = (u32)((f.v[i] >> 48) & 0xffff);
  }
}

struct Field {
  Fe p;
  u64 n0inv;  // -p^{-1} mod 2^64
  Fe r;       // 2^256 mod p (Montgomery one)
  Fe r2;      // (2^256)^2 mod p
};

std::vector<Field> g_fields;

inline bool gte(const Fe& a, const Fe& b) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
  }
  return true;
}

inline bool is_zero(const Fe& a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

inline void sub_inplace(Fe& a, const Fe& b) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    a.v[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
}

inline Fe fadd(const Fe& a, const Fe& b, const Field& f) {
  Fe out;
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    out.v[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || gte(out, f.p)) sub_inplace(out, f.p);
  return out;
}

inline Fe fsub(const Fe& a, const Fe& b, const Field& f) {
  Fe out = a;
  if (!gte(a, b)) {
    // out = a + p - b
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)a.v[i] + f.p.v[i] + carry;
      out.v[i] = (u64)s;
      carry = s >> 64;
    }
  }
  sub_inplace(out, b);
  return out;
}

inline Fe fneg(const Fe& a, const Field& f) {
  if (is_zero(a)) return a;
  Fe out = f.p;
  sub_inplace(out, a);
  return out;
}

// CIOS Montgomery multiplication, 4x64 limbs.
inline Fe fmul(const Fe& a, const Fe& b, const Field& f) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    // t += a[i] * b
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[4] + carry;
    t[4] = (u64)cur;
    t[5] = (u64)(cur >> 64);
    // m = t[0] * n0inv mod 2^64; t += m * p; t >>= 64
    u64 m = t[0] * f.n0inv;
    carry = ((u128)t[0] + (u128)m * f.p.v[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 c2 = (u128)t[j] + (u128)m * f.p.v[j] + carry;
      t[j - 1] = (u64)c2;
      carry = c2 >> 64;
    }
    u128 c3 = (u128)t[4] + carry;
    t[3] = (u64)c3;
    t[4] = t[5] + (u64)(c3 >> 64);
    t[5] = 0;
  }
  Fe out{{t[0], t[1], t[2], t[3]}};
  if (t[4] || gte(out, f.p)) sub_inplace(out, f.p);
  return out;
}

inline Fe fsqr(const Fe& a, const Field& f) { return fmul(a, a, f); }

// a^e with 256-bit exponent (most significant limb first not required; e is
// little-endian 4x64), constant pattern square&multiply.
inline Fe fpow(const Fe& a, const Fe& e, const Field& f) {
  Fe result = f.r;  // one
  bool started = false;
  for (int limb = 3; limb >= 0; --limb) {
    for (int bit = 63; bit >= 0; --bit) {
      if (started) result = fsqr(result, f);
      if ((e.v[limb] >> bit) & 1) {
        if (started)
          result = fmul(result, a, f);
        else {
          result = a;
          started = true;
        }
      }
    }
  }
  if (!started) return f.r;
  return result;
}

inline Fe finv(const Fe& a, const Field& f) {
  // Fermat: a^(p-2)
  Fe e = f.p;
  // subtract 2
  u64 borrow = (e.v[0] < 2) ? 1 : 0;
  e.v[0] -= 2;
  for (int i = 1; i < 4 && borrow; ++i) {
    borrow = (e.v[i] == 0) ? 1 : 0;
    e.v[i] -= 1;
  }
  return fpow(a, e, f);
}

// ---------------------------------------------------------------------------
// Curves (a = 0, projective complete formulas)
// ---------------------------------------------------------------------------

struct Curve {
  int field_id;
  Fe b3;  // 3*b in Montgomery form
};

std::vector<Curve> g_curves;

struct Pt {
  Fe x, y, z;
};

inline Pt pt_identity(const Field& f) {
  Pt p;
  std::memset(&p, 0, sizeof(p));
  p.y = f.r;
  return p;
}

// RCB16 Alg. 7 (a=0): 12M complete addition.
inline Pt padd(const Pt& P, const Pt& Q, const Curve& c, const Field& f) {
  const Fe &x1 = P.x, &y1 = P.y, &z1 = P.z;
  const Fe &x2 = Q.x, &y2 = Q.y, &z2 = Q.z;
  Fe t0 = fmul(x1, x2, f);
  Fe t1 = fmul(y1, y2, f);
  Fe t2 = fmul(z1, z2, f);
  Fe t3 = fmul(fadd(x1, y1, f), fadd(x2, y2, f), f);
  t3 = fsub(t3, fadd(t0, t1, f), f);
  Fe t4 = fmul(fadd(y1, z1, f), fadd(y2, z2, f), f);
  t4 = fsub(t4, fadd(t1, t2, f), f);
  Fe x3 = fmul(fadd(x1, z1, f), fadd(x2, z2, f), f);
  Fe y3 = fsub(x3, fadd(t0, t2, f), f);
  x3 = fadd(fadd(t0, t0, f), t0, f);
  t2 = fmul(c.b3, t2, f);
  Fe z3 = fadd(t1, t2, f);
  t1 = fsub(t1, t2, f);
  y3 = fmul(c.b3, y3, f);
  Fe x3o = fsub(fmul(t3, t1, f), fmul(t4, y3, f), f);
  Fe y3o = fadd(fmul(y3, x3, f), fmul(t1, z3, f), f);
  Fe z3o = fadd(fmul(z3, t4, f), fmul(x3, t3, f), f);
  Pt out{x3o, y3o, z3o};
  return out;
}

inline Pt pdbl(const Pt& P, const Curve& c, const Field& f) {
  Fe t0 = fmul(P.y, P.y, f);
  Fe z3 = fadd(t0, t0, f);
  z3 = fadd(z3, z3, f);
  z3 = fadd(z3, z3, f);
  Fe t1 = fmul(P.y, P.z, f);
  Fe t2 = fmul(P.z, P.z, f);
  t2 = fmul(c.b3, t2, f);
  Fe x3 = fmul(t2, z3, f);
  Fe y3 = fadd(t0, t2, f);
  z3 = fmul(t1, z3, f);
  t1 = fadd(t2, t2, f);
  t2 = fadd(t1, t2, f);
  t0 = fsub(t0, t2, f);
  y3 = fmul(t0, y3, f);
  y3 = fadd(x3, y3, f);
  t1 = fmul(P.x, P.y, f);
  x3 = fmul(t0, t1, f);
  x3 = fadd(x3, x3, f);
  Pt out{x3, y3, z3};
  return out;
}

inline Pt pt_load(const u32* d) {
  Pt p;
  p.x = load(d);
  p.y = load(d + 16);
  p.z = load(d + 32);
  return p;
}

inline void pt_store(u32* d, const Pt& p) {
  store(d, p.x);
  store(d + 16, p.y);
  store(d + 32, p.z);
}

}  // namespace

extern "C" {

int register_field(const u32* p_digits, const u32* r_digits,
                   const u32* r2_digits, u64 n0inv64) {
  Field f;
  f.p = load(p_digits);
  f.r = load(r_digits);
  f.r2 = load(r2_digits);
  f.n0inv = n0inv64;
  g_fields.push_back(f);
  return (int)g_fields.size() - 1;
}

int register_curve(int field_id, const u32* b3_mont_digits) {
  Curve c;
  c.field_id = field_id;
  c.b3 = load(b3_mont_digits);
  g_curves.push_back(c);
  return (int)g_curves.size() - 1;
}

// Elementwise ops.  sb = stride of b in 16-lane units (0 broadcasts b[0]).
void fe_add(int fid, const u32* a, const u32* b, u32* out, long n, long sb) {
  const Field& f = g_fields[fid];
  #pragma omp parallel for schedule(static) if (n >= 2048)
  for (long i = 0; i < n; ++i)
    store(out + 16 * i, fadd(load(a + 16 * i), load(b + 16 * i * sb), f));
}

void fe_sub(int fid, const u32* a, const u32* b, u32* out, long n, long sb) {
  const Field& f = g_fields[fid];
  #pragma omp parallel for schedule(static) if (n >= 2048)
  for (long i = 0; i < n; ++i)
    store(out + 16 * i, fsub(load(a + 16 * i), load(b + 16 * i * sb), f));
}

void fe_neg(int fid, const u32* a, u32* out, long n) {
  const Field& f = g_fields[fid];
  #pragma omp parallel for schedule(static) if (n >= 2048)
  for (long i = 0; i < n; ++i) store(out + 16 * i, fneg(load(a + 16 * i), f));
}

void fe_mul(int fid, const u32* a, const u32* b, u32* out, long n, long sa,
            long sb) {
  const Field& f = g_fields[fid];
  #pragma omp parallel for schedule(static) if (n >= 512)
  for (long i = 0; i < n; ++i)
    store(out + 16 * i,
          fmul(load(a + 16 * i * sa), load(b + 16 * i * sb), f));
}

void fe_pow(int fid, const u32* a, const u32* e_digits, u32* out, long n) {
  const Field& f = g_fields[fid];
  Fe e = load(e_digits);
  #pragma omp parallel for schedule(static) if (n >= 64)
  for (long i = 0; i < n; ++i) store(out + 16 * i, fpow(load(a + 16 * i), e, f));
}

void fe_inv_batch(int fid, const u32* a, u32* out, long n) {
  // Montgomery trick with zero skipping.
  const Field& f = g_fields[fid];
  std::vector<Fe> prefix((size_t)n);
  Fe acc = f.r;
  for (long i = 0; i < n; ++i) {
    prefix[i] = acc;
    Fe v = load(a + 16 * i);
    if (!is_zero(v)) acc = fmul(acc, v, f);
  }
  acc = finv(acc, f);
  for (long i = n - 1; i >= 0; --i) {
    Fe v = load(a + 16 * i);
    if (is_zero(v)) {
      store(out + 16 * i, v);
    } else {
      store(out + 16 * i, fmul(acc, prefix[i], f));
      acc = fmul(acc, v, f);
    }
  }
}

void fe_sum(int fid, const u32* a, u32* out, long n) {
  const Field& f = g_fields[fid];
  Fe acc;
  std::memset(&acc, 0, sizeof(acc));
  for (long i = 0; i < n; ++i) acc = fadd(acc, load(a + 16 * i), f);
  store(out, acc);
}

// out[j] = sum over axis-0 of a[i*inner + j] for i in [0, outer)
void fe_sum_axis0(int fid, const u32* a, u32* out, long outer, long inner) {
  const Field& f = g_fields[fid];
  for (long j = 0; j < inner; ++j) {
    Fe acc;
    std::memset(&acc, 0, sizeof(acc));
    for (long i = 0; i < outer; ++i)
      acc = fadd(acc, load(a + 16 * (i * inner + j)), f);
    store(out + 16 * j, acc);
  }
}

void fe_prefix_mul(int fid, const u32* a, u32* out, long n) {
  const Field& f = g_fields[fid];
  Fe acc = f.r;
  for (long i = 0; i < n; ++i) {
    acc = fmul(acc, load(a + 16 * i), f);
    store(out + 16 * i, acc);
  }
}

void fe_scatter_sum(int fid, const u32* terms, const long* idx, u32* out,
                    long n, long size) {
  const Field& f = g_fields[fid];
  for (long j = 0; j < size; ++j) std::memset(out + 16 * j, 0, 64);
  for (long i = 0; i < n; ++i) {
    long j = idx[i];
    Fe cur = load(out + 16 * j);
    store(out + 16 * j, fadd(cur, load(terms + 16 * i), f));
  }
}

// Fused multilinear fold: out[i] = (e[2i+1]-e[2i])*x + e[2i]
void fe_fix_var(int fid, const u32* evals, const u32* x, u32* out, long half) {
  const Field& f = g_fields[fid];
  Fe xv = load(x);
  for (long i = 0; i < half; ++i) {
    Fe lo = load(evals + 16 * (2 * i));
    Fe hi = load(evals + 16 * (2 * i + 1));
    store(out + 16 * i, fadd(fmul(fsub(hi, lo, f), xv, f), lo, f));
  }
}

// Fused fold on split halves: out[i] = (hi[i]-lo[i])*x + lo[i]
void fe_fold_halves(int fid, const u32* lo, const u32* hi, const u32* x,
                    u32* out, long n) {
  const Field& f = g_fields[fid];
  Fe xv = load(x);
  for (long i = 0; i < n; ++i) {
    Fe l = load(lo + 16 * i);
    Fe h = load(hi + 16 * i);
    store(out + 16 * i, fadd(fmul(fsub(h, l, f), xv, f), l, f));
  }
}

// ---------------------------------------------------------------------------
// Curve entry points
// ---------------------------------------------------------------------------

void ec_padd(int cid, const u32* p, const u32* q, u32* out, long n, long sq) {
  const Curve& c = g_curves[cid];
  const Field& f = g_fields[c.field_id];
  #pragma omp parallel for schedule(static) if (n >= 128)
  for (long i = 0; i < n; ++i)
    pt_store(out + 48 * i, padd(pt_load(p + 48 * i), pt_load(q + 48 * i * sq), c, f));
}

void ec_pdbl(int cid, const u32* p, u32* out, long n) {
  const Curve& c = g_curves[cid];
  const Field& f = g_fields[c.field_id];
  #pragma omp parallel for schedule(static) if (n >= 128)
  for (long i = 0; i < n; ++i)
    pt_store(out + 48 * i, pdbl(pt_load(p + 48 * i), c, f));
}

// out[i] = k * p[i] with a shared 256-bit scalar (16-bit digit layout).
void ec_scalar_mul(int cid, const u32* p, const u32* k_digits, u32* out,
                   long n) {
  const Curve& c = g_curves[cid];
  const Field& f = g_fields[c.field_id];
  Fe k = load(k_digits);
  #pragma omp parallel for schedule(static) if (n >= 8)
  for (long i = 0; i < n; ++i) {
    Pt base = pt_load(p + 48 * i);
    Pt acc = pt_identity(f);
    bool started = false;
    for (int limbi = 3; limbi >= 0; --limbi) {
      for (int bit = 63; bit >= 0; --bit) {
        if (started) acc = pdbl(acc, c, f);
        if ((k.v[limbi] >> bit) & 1) {
          if (started) {
            acc = padd(acc, base, c, f);
          } else {
            acc = base;
            started = true;
          }
        }
      }
    }
    pt_store(out + 48 * i, started ? acc : pt_identity(f));
  }
}

void ec_sum(int cid, const u32* p, u32* out, long n) {
  const Curve& c = g_curves[cid];
  const Field& f = g_fields[c.field_id];
  Pt acc = pt_identity(f);
  for (long i = 0; i < n; ++i) acc = padd(acc, pt_load(p + 48 * i), c, f);
  pt_store(out, acc);
}

// Pippenger MSM.  scalars: n x 16 canonical digits; points: n x 48 Montgomery
// projective.  Returns single projective point.
void ec_msm(int cid, const u32* scalars, const u32* points, u32* out, long n,
            int window_bits) {
  const Curve& cv = g_curves[cid];
  const Field& f = g_fields[cv.field_id];
  int c = window_bits;
  int num_windows = (256 + c - 1) / c;
  long num_buckets = (1L << c) - 1;
  std::vector<Pt> window_sums((size_t)num_windows);
#pragma omp parallel for schedule(dynamic, 1)
  for (int w = 0; w < num_windows; ++w) {
    std::vector<Pt> buckets((size_t)num_buckets, pt_identity(f));
    int bit_off = w * c;
    for (long i = 0; i < n; ++i) {
      const u32* s = scalars + 16 * i;
      u64 val = 0;
      int lane = bit_off / 16, sh = bit_off % 16;
      val = s[lane] >> sh;
      if (lane + 1 < 16) val |= (u64)s[lane + 1] << (16 - sh);
      if (lane + 2 < 16) val |= (u64)s[lane + 2] << (32 - sh);
      val &= (1UL << c) - 1;
      if (val) {
        buckets[val - 1] = padd(buckets[val - 1], pt_load(points + 48 * i), cv, f);
      }
    }
    Pt running = pt_identity(f);
    Pt acc = pt_identity(f);
    for (long j = num_buckets - 1; j >= 0; --j) {
      running = padd(running, buckets[j], cv, f);
      acc = padd(acc, running, cv, f);
    }
    window_sums[w] = acc;
  }
  Pt result = pt_identity(f);
  for (int w = num_windows - 1; w >= 0; --w) {
    if (w != num_windows - 1) {
      for (int k = 0; k < c; ++k) result = pdbl(result, cv, f);
    }
    result = padd(result, window_sums[w], cv, f);
  }
  pt_store(out, result);
}

}  // extern "C"
