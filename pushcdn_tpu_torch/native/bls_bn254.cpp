// BLS signatures over BN254 (alt_bn128) — native implementation.
//
// The reference's signature crypto is BLS over BN254 from jellyfish
// (cdn-proto/src/crypto/signature.rs:113-175); the pairing math is the one
// native-performance-critical piece of its crypto layer (SURVEY.md §2a
// "Signature crypto" row, §7 design-stance seam (b)). This file is a
// from-scratch C++ implementation — not a port of jellyfish/arkworks —
// validated structurally by in-library bilinearity self-tests and by the
// Python test suite.
//
// Layout (min-sig convention, matching jellyfish's BLS-over-BN254):
//   secret key : 32 bytes big-endian scalar in [1, r)
//   public key : 128 bytes — G2 affine (x.c0 ‖ x.c1 ‖ y.c0 ‖ y.c1), BE
//   signature  : 64 bytes  — G1 affine (x ‖ y), BE
//   hash-to-G1 : try-and-increment over SHA-256 candidates (G1 cofactor
//                is 1, so any curve point is in the r-torsion)
//
// Tower (validated by in-library bilinearity + Frobenius self-tests):
//   Fp2  = Fp[u]/(u²+1)          (Karatsuba mul, 2-mul squaring)
//   Fp6  = Fp2[v]/(v³-ξ), ξ=9+u  (Toom/Karatsuba-3: 6 Fp2 muls; ξ-mul
//                                 by additions only)
//   Fp12 = Fp6[w]/(w²-v)         (Karatsuba + complex squaring)
//   untwist (D-twist): (x,y) ∈ E'(Fp2) → (w²x, w³y) ∈ E(Fp12)
//   Miller loop: ate count 6t+2 walked in NAF form (22 add-steps instead
//     of 37 — digit 'm' adds -Q, whose negation is free), INVERSION-FREE —
//     the G2 ladder runs in Jacobian twist coordinates and emits
//     denominator-cleared sparse line coefficients (clearing constants
//     are Fp2 elements, which the final exponentiation kills); the
//     frobenius tail uses the twist endomorphism psi with init-computed
//     xi^(k(p-1)/6) constants.
//   Base field: unrolled "no-carry" Montgomery multiply (P's top limb
//     < 2^62) + dedicated SOS squaring; the generic CIOS survives as
//     fp_mul_cios, cross-checked against both in the self-test.
//   Final exp: full easy part (p⁶-1)(p²+1) via conjugate/inverse and a
//     coefficient-wise Fp12 Frobenius, then the 762-bit hard exponent
//     (p⁴-p²+1)/r.
//
// Verification includes the G2 subgroup check on the public key
// (r·pk == ∞) — BN254's G2 has a nontrivial cofactor, and skipping the
// check admits rogue-torsion keys.
//
// Build: g++ -O3 -shared -fPIC bls_bn254.cpp -o libpushcdn_bls.so

#include <cstdint>
#include <cstring>

#include <list>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

typedef uint64_t u64;
typedef unsigned __int128 u128;

// ---------------------------------------------------------------------------
// Fp: 4x64 Montgomery form
// ---------------------------------------------------------------------------

static const u64 P[4] = {4332616871279656263ULL, 10917124144477883021ULL,
                         13281191951274694749ULL, 3486998266802970665ULL};
static const u64 N0 = 0x87d20782e4866389ULL;           // -p^-1 mod 2^64
static const u64 R2[4] = {17522657719365597833ULL, 13107472804851548667ULL,
                          5164255478447964150ULL, 493319470278259999ULL};
static const u64 R1[4] = {15230403791020821917ULL, 754611498739239741ULL,
                          7381016538464732716ULL, 1011752739694698287ULL};
static const u64 ORDER[4] = {4891460686036598785ULL, 2896914383306846353ULL,
                             13281191951274694749ULL, 3486998266802970665ULL};

// Derived constants (G2 generator, b2 = 3/xi, hard-exponent bytes, ate bits) —
// generated by scripts/gen_bls_constants.py.
#include "bls_generated.inc"

struct Fp { u64 l[4]; };

static inline bool fp_is_zero(const Fp& a) {
  return (a.l[0] | a.l[1] | a.l[2] | a.l[3]) == 0;
}
static inline bool fp_eq(const Fp& a, const Fp& b) {
  return a.l[0] == b.l[0] && a.l[1] == b.l[1] && a.l[2] == b.l[2] &&
         a.l[3] == b.l[3];
}
static inline int cmp4(const u64 a[4], const u64 b[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] < b[i]) return -1;
    if (a[i] > b[i]) return 1;
  }
  return 0;
}
static inline void sub4(u64 out[4], const u64 a[4], const u64 b[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - b[i] - (u64)borrow;
    out[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}
static inline void fp_add(Fp& out, const Fp& a, const Fp& b) {
  u128 c;
  u64 t0, t1, t2, t3;
  c = (u128)a.l[0] + b.l[0];                 t0 = (u64)c;
  c = (u128)a.l[1] + b.l[1] + (u64)(c >> 64); t1 = (u64)c;
  c = (u128)a.l[2] + b.l[2] + (u64)(c >> 64); t2 = (u64)c;
  c = (u128)a.l[3] + b.l[3] + (u64)(c >> 64); t3 = (u64)c;
  u64 carry = (u64)(c >> 64);
  // subtract p unconditionally, keep whichever representative is in range
  u128 d;
  u64 s0, s1, s2, s3, br;
  d = (u128)t0 - P[0];                  s0 = (u64)d; br = (u64)(d >> 64) & 1;
  d = (u128)t1 - P[1] - br;             s1 = (u64)d; br = (u64)(d >> 64) & 1;
  d = (u128)t2 - P[2] - br;             s2 = (u64)d; br = (u64)(d >> 64) & 1;
  d = (u128)t3 - P[3] - br;             s3 = (u64)d; br = (u64)(d >> 64) & 1;
  if (carry | (br ^ 1)) { t0 = s0; t1 = s1; t2 = s2; t3 = s3; }
  out.l[0] = t0; out.l[1] = t1; out.l[2] = t2; out.l[3] = t3;
}
static inline void fp_sub(Fp& out, const Fp& a, const Fp& b) {
  u128 d;
  u64 t0, t1, t2, t3, br;
  d = (u128)a.l[0] - b.l[0];            t0 = (u64)d; br = (u64)(d >> 64) & 1;
  d = (u128)a.l[1] - b.l[1] - br;       t1 = (u64)d; br = (u64)(d >> 64) & 1;
  d = (u128)a.l[2] - b.l[2] - br;       t2 = (u64)d; br = (u64)(d >> 64) & 1;
  d = (u128)a.l[3] - b.l[3] - br;       t3 = (u64)d; br = (u64)(d >> 64) & 1;
  if (br) {  // went negative: add p back
    u128 c;
    c = (u128)t0 + P[0];                t0 = (u64)c;
    c = (u128)t1 + P[1] + (u64)(c >> 64); t1 = (u64)c;
    c = (u128)t2 + P[2] + (u64)(c >> 64); t2 = (u64)c;
    c = (u128)t3 + P[3] + (u64)(c >> 64); t3 = (u64)c;
  }
  out.l[0] = t0; out.l[1] = t1; out.l[2] = t2; out.l[3] = t3;
}
static inline void fp_neg(Fp& out, const Fp& a) {
  if (fp_is_zero(a)) { out = a; return; }
  sub4(out.l, P, a.l);
}

// CIOS Montgomery multiplication (generic carry handling) — kept as the
// cross-check reference for the self-test; fp_mul below is the hot version.
static void fp_mul_cios(Fp& out, const Fp& a, const Fp& b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)a.l[i] * b.l[j] + t[j] + (u64)carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 s = (u128)t[4] + (u64)carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);

    u64 m = t[0] * N0;
    carry = ((u128)m * P[0] + t[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 cur = (u128)m * P[j] + t[j] + (u64)carry;
      t[j - 1] = (u64)cur;
      carry = cur >> 64;
    }
    s = (u128)t[4] + (u64)carry;
    t[3] = (u64)s;
    t[4] = t[5] + (u64)(s >> 64);
    t[5] = 0;
  }
  u64 res[4] = {t[0], t[1], t[2], t[3]};
  if (t[4] || cmp4(res, P) >= 0) sub4(res, res, P);
  std::memcpy(out.l, res, sizeof res);
}

// "No-carry" Montgomery multiplication, fully unrolled: because the top
// limb of P is < 2^62, the running accumulator's top limb C + A cannot
// overflow 64 bits, so the t[4]/t[5] spill handling of generic CIOS
// drops out entirely (one add and zero branches per round instead of a
// double-width spill). ~17% faster than the generic loop here.
static void fp_mul(Fp& out, const Fp& a, const Fp& b) {
  u64 t0, t1, t2, t3;
  u64 A, C, m;
  u128 c;
  c = (u128)a.l[0] * b.l[0];             t0 = (u64)c; A = (u64)(c >> 64);
  m = t0 * N0;
  c = (u128)m * P[0] + t0;               C = (u64)(c >> 64);
  c = (u128)a.l[1] * b.l[0] + A;         t1 = (u64)c; A = (u64)(c >> 64);
  c = (u128)m * P[1] + t1 + C;           t0 = (u64)c; C = (u64)(c >> 64);
  c = (u128)a.l[2] * b.l[0] + A;         t2 = (u64)c; A = (u64)(c >> 64);
  c = (u128)m * P[2] + t2 + C;           t1 = (u64)c; C = (u64)(c >> 64);
  c = (u128)a.l[3] * b.l[0] + A;         t3 = (u64)c; A = (u64)(c >> 64);
  c = (u128)m * P[3] + t3 + C;           t2 = (u64)c; C = (u64)(c >> 64);
  t3 = C + A;
  for (int i = 1; i < 4; ++i) {
    u64 bi = b.l[i];
    c = (u128)a.l[0] * bi + t0;          t0 = (u64)c; A = (u64)(c >> 64);
    m = t0 * N0;
    c = (u128)m * P[0] + t0;             C = (u64)(c >> 64);
    c = (u128)a.l[1] * bi + t1 + A;      t1 = (u64)c; A = (u64)(c >> 64);
    c = (u128)m * P[1] + t1 + C;         t0 = (u64)c; C = (u64)(c >> 64);
    c = (u128)a.l[2] * bi + t2 + A;      t2 = (u64)c; A = (u64)(c >> 64);
    c = (u128)m * P[2] + t2 + C;         t1 = (u64)c; C = (u64)(c >> 64);
    c = (u128)a.l[3] * bi + t3 + A;      t3 = (u64)c; A = (u64)(c >> 64);
    c = (u128)m * P[3] + t3 + C;         t2 = (u64)c; C = (u64)(c >> 64);
    t3 = C + A;
  }
  u64 res[4] = {t0, t1, t2, t3};
  if (cmp4(res, P) >= 0) sub4(res, res, P);
  std::memcpy(out.l, res, sizeof res);
}

static void fp_sqr(Fp& out, const Fp& a) {
  // Measured on the deployment host (cooperlake): the dedicated
  // schoolbook-square + separate 4-round reduction below runs ~43 ns vs
  // ~27 ns for the fused-CIOS fp_mul on a dependent chain — the saved
  // cross products don't pay for losing the interleaved reduction. Route
  // through fp_mul; the original remains (compiled, self-tested via the
  // fp_sqr_ref cross-check in bls_self_test) as the reference form.
  fp_mul(out, a, a);
}

// Dedicated Montgomery squaring (SOS): 10 limb products instead of 16
// (upper triangle doubled by shifts + 4 diagonals), then a 4-round
// 8-limb Montgomery reduction. On paper fewer products; in practice the
// separate reduction pass loses to the fused-CIOS fp_mul (see fp_sqr).
static void fp_sqr_ref(Fp& out, const Fp& a) {
  const u64 a0 = a.l[0], a1 = a.l[1], a2 = a.l[2], a3 = a.l[3];
  u64 r[9];
  u128 c;
  u64 hi;
  // upper-triangle products
  c = (u128)a0 * a1;        r[1] = (u64)c; hi = (u64)(c >> 64);
  c = (u128)a0 * a2 + hi;   r[2] = (u64)c; hi = (u64)(c >> 64);
  c = (u128)a0 * a3 + hi;   r[3] = (u64)c; r[4] = (u64)(c >> 64);
  c = (u128)a1 * a2 + r[3]; r[3] = (u64)c; hi = (u64)(c >> 64);
  c = (u128)a1 * a3 + r[4] + hi;
                            r[4] = (u64)c; r[5] = (u64)(c >> 64);
  c = (u128)a2 * a3 + r[5]; r[5] = (u64)c; r[6] = (u64)(c >> 64);
  // double the triangle
  r[7] = r[6] >> 63;
  r[6] = (r[6] << 1) | (r[5] >> 63);
  r[5] = (r[5] << 1) | (r[4] >> 63);
  r[4] = (r[4] << 1) | (r[3] >> 63);
  r[3] = (r[3] << 1) | (r[2] >> 63);
  r[2] = (r[2] << 1) | (r[1] >> 63);
  r[1] = r[1] << 1;
  // add the diagonal terms
  c = (u128)a0 * a0;            r[0] = (u64)c; hi = (u64)(c >> 64);
  c = (u128)r[1] + hi;          r[1] = (u64)c; hi = (u64)(c >> 64);
  c = (u128)a1 * a1 + r[2] + hi; r[2] = (u64)c; hi = (u64)(c >> 64);
  c = (u128)r[3] + hi;          r[3] = (u64)c; hi = (u64)(c >> 64);
  c = (u128)a2 * a2 + r[4] + hi; r[4] = (u64)c; hi = (u64)(c >> 64);
  c = (u128)r[5] + hi;          r[5] = (u64)c; hi = (u64)(c >> 64);
  c = (u128)a3 * a3 + r[6] + hi; r[6] = (u64)c; hi = (u64)(c >> 64);
  r[7] += hi;  // cannot overflow: top product + doubled-carry < 2^64
  r[8] = 0;
  // 4-round Montgomery reduction of r[0..7] (tail carry rides into r[8])
  for (int i = 0; i < 4; ++i) {
    u64 m = r[i] * N0;
    u64 carry = (u64)(((u128)m * P[0] + r[i]) >> 64);
    for (int j = 1; j < 4; ++j) {
      c = (u128)m * P[j] + r[i + j] + carry;
      r[i + j] = (u64)c;
      carry = (u64)(c >> 64);
    }
    c = (u128)r[i + 4] + carry;
    r[i + 4] = (u64)c;
    if ((u64)(c >> 64)) {
      // ripple into the limbs above (at most to r[8])
      for (int k = i + 5; k <= 8 && ++r[k] == 0; ++k) {}
    }
  }
  u64 res[4] = {r[4], r[5], r[6], r[7]};
  if (r[8] || cmp4(res, P) >= 0) sub4(res, res, P);
  std::memcpy(out.l, res, sizeof res);
}

static const Fp FP_ZERO = {{0, 0, 0, 0}};
static Fp FP_ONE;   // R1 (Montgomery 1), set in init
static Fp FP_TWO, FP_THREE, FP_B3;  // small constants in Montgomery form

static void fp_from_canonical(Fp& out, const u64 limbs[4]) {
  Fp t;
  std::memcpy(t.l, limbs, sizeof t.l);
  Fp r2;
  std::memcpy(r2.l, R2, sizeof r2.l);
  fp_mul(out, t, r2);  // to Montgomery form
}
static void fp_to_canonical(u64 out[4], const Fp& a) {
  // multiply by 1 (non-Montgomery) = Montgomery-reduce
  Fp one_raw = {{1, 0, 0, 0}};
  Fp t;
  fp_mul(t, a, one_raw);
  std::memcpy(out, t.l, sizeof t.l);
}

// 32-byte big-endian <-> canonical limbs
static void be_to_limbs(u64 out[4], const uint8_t in[32]) {
  for (int i = 0; i < 4; ++i) {
    u64 v = 0;
    for (int j = 0; j < 8; ++j) v = (v << 8) | in[(3 - i) * 8 + j];
    out[i] = v;
  }
}
static void limbs_to_be(uint8_t out[32], const u64 in[4]) {
  for (int i = 0; i < 4; ++i) {
    u64 v = in[3 - i];
    for (int j = 0; j < 8; ++j) out[i * 8 + j] = (uint8_t)(v >> (56 - 8 * j));
  }
}

// generic power with big-endian byte exponent
static void fp_pow_be(Fp& out, const Fp& base, const uint8_t* exp, int n) {
  Fp res = FP_ONE;
  for (int i = 0; i < n; ++i) {
    for (int b = 7; b >= 0; --b) {
      fp_sqr(res, res);
      if ((exp[i] >> b) & 1) fp_mul(res, res, base);
    }
  }
  out = res;
}

static uint8_t EXP_PM2[32], EXP_SQRT[32], EXP_P[32];

static void fp_inv(Fp& out, const Fp& a) { fp_pow_be(out, a, EXP_PM2, 32); }

// ---------------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2+1)
// ---------------------------------------------------------------------------

struct Fp2 { Fp c0, c1; };

static inline void f2_add(Fp2& o, const Fp2& a, const Fp2& b) {
  fp_add(o.c0, a.c0, b.c0);
  fp_add(o.c1, a.c1, b.c1);
}
static inline void f2_sub(Fp2& o, const Fp2& a, const Fp2& b) {
  fp_sub(o.c0, a.c0, b.c0);
  fp_sub(o.c1, a.c1, b.c1);
}
static inline void f2_neg(Fp2& o, const Fp2& a) {
  fp_neg(o.c0, a.c0);
  fp_neg(o.c1, a.c1);
}
static void f2_mul(Fp2& o, const Fp2& a, const Fp2& b) {
  // Karatsuba: 3 base muls instead of 4
  Fp t0, t1, sa, sb, t2;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(sa, a.c0, a.c1);
  fp_add(sb, b.c0, b.c1);
  fp_mul(t2, sa, sb);
  Fp r0, r1;
  fp_sub(r0, t0, t1);
  fp_sub(r1, t2, t0);
  fp_sub(r1, r1, t1);
  o.c0 = r0;
  o.c1 = r1;
}
static void f2_sqr(Fp2& o, const Fp2& a) {
  // (c0+c1)(c0-c1), 2*c0*c1 — 2 base muls
  Fp s, d, m, r0, r1;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(r0, s, d);
  fp_mul(m, a.c0, a.c1);
  fp_add(r1, m, m);
  o.c0 = r0;
  o.c1 = r1;
}
static inline void f2_conj(Fp2& o, const Fp2& a) {
  o.c0 = a.c0;
  fp_neg(o.c1, a.c1);
}
static void f2_mul_xi(Fp2& o, const Fp2& a) {
  // (9+u)(c0 + c1 u) = (9c0 - c1) + (9c1 + c0) u — additions only
  Fp t0, t1, e0, e1;
  fp_add(t0, a.c0, a.c0);
  fp_add(t0, t0, t0);
  fp_add(t0, t0, t0);
  fp_add(t0, t0, a.c0);     // 9*c0
  fp_add(t1, a.c1, a.c1);
  fp_add(t1, t1, t1);
  fp_add(t1, t1, t1);
  fp_add(t1, t1, a.c1);     // 9*c1
  fp_sub(e0, t0, a.c1);
  fp_add(e1, t1, a.c0);
  o.c0 = e0;
  o.c1 = e1;
}
static void f2_pow_be(Fp2& out, const Fp2& base, const uint8_t* exp, int n) {
  Fp2 res;
  bool started = false;
  for (int i = 0; i < n; ++i) {
    for (int b = 7; b >= 0; --b) {
      if (started) f2_sqr(res, res);
      if ((exp[i] >> b) & 1) {
        if (started) f2_mul(res, res, base);
        else { res = base; started = true; }
      }
    }
  }
  if (started) { out = res; }
  else { out.c0 = FP_ONE; out.c1 = FP_ZERO; }
}
static void f2_inv(Fp2& o, const Fp2& a) {
  Fp t0, t1, d, di;
  fp_sqr(t0, a.c0);
  fp_sqr(t1, a.c1);
  fp_add(d, t0, t1);
  fp_inv(di, d);
  Fp r0, r1n;
  fp_mul(r0, a.c0, di);
  fp_mul(r1n, a.c1, di);
  o.c0 = r0;
  fp_neg(o.c1, r1n);
}
static inline bool f2_is_zero(const Fp2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
static inline bool f2_eq(const Fp2& a, const Fp2& b) {
  return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}

// ---------------------------------------------------------------------------
// Fp6 = Fp2[v]/(v^3 - xi)
// ---------------------------------------------------------------------------

struct Fp6 { Fp2 c0, c1, c2; };

static inline void f6_add(Fp6& o, const Fp6& a, const Fp6& b) {
  f2_add(o.c0, a.c0, b.c0);
  f2_add(o.c1, a.c1, b.c1);
  f2_add(o.c2, a.c2, b.c2);
}
static inline void f6_sub(Fp6& o, const Fp6& a, const Fp6& b) {
  f2_sub(o.c0, a.c0, b.c0);
  f2_sub(o.c1, a.c1, b.c1);
  f2_sub(o.c2, a.c2, b.c2);
}
static inline void f6_neg(Fp6& o, const Fp6& a) {
  f2_neg(o.c0, a.c0);
  f2_neg(o.c1, a.c1);
  f2_neg(o.c2, a.c2);
}
static void f6_mul(Fp6& o, const Fp6& a, const Fp6& b) {
  // Toom/Karatsuba-3: 6 f2_mul instead of 9, xi-mul via additions
  Fp2 v0, v1, v2, sa, sb, m12, m01, m02;
  f2_mul(v0, a.c0, b.c0);
  f2_mul(v1, a.c1, b.c1);
  f2_mul(v2, a.c2, b.c2);
  f2_add(sa, a.c1, a.c2);
  f2_add(sb, b.c1, b.c2);
  f2_mul(m12, sa, sb);      // (a1+a2)(b1+b2)
  f2_add(sa, a.c0, a.c1);
  f2_add(sb, b.c0, b.c1);
  f2_mul(m01, sa, sb);      // (a0+a1)(b0+b1)
  f2_add(sa, a.c0, a.c2);
  f2_add(sb, b.c0, b.c2);
  f2_mul(m02, sa, sb);      // (a0+a2)(b0+b2)
  // c0 = v0 + xi*(m12 - v1 - v2)
  Fp2 t, xt, r0, r1, r2;
  f2_sub(t, m12, v1);
  f2_sub(t, t, v2);
  f2_mul_xi(xt, t);
  f2_add(r0, v0, xt);
  // c1 = m01 - v0 - v1 + xi*v2
  f2_sub(r1, m01, v0);
  f2_sub(r1, r1, v1);
  f2_mul_xi(xt, v2);
  f2_add(r1, r1, xt);
  // c2 = m02 - v0 - v2 + v1
  f2_sub(r2, m02, v0);
  f2_sub(r2, r2, v2);
  f2_add(r2, r2, v1);
  o.c0 = r0;
  o.c1 = r1;
  o.c2 = r2;
}
static void f6_mul_v(Fp6& o, const Fp6& a) {  // a * v
  Fp2 t;
  f2_mul_xi(t, a.c2);
  Fp2 a0 = a.c0, a1 = a.c1;
  o.c0 = t;
  o.c1 = a0;
  o.c2 = a1;
}
static void f6_inv(Fp6& o, const Fp6& a) {
  Fp2 c0, c1, c2, t, ti;
  Fp2 a0s, xa12, xa22, a0a1, a1s, a0a2;
  f2_sqr(a0s, a.c0);
  Fp2 a1a2;
  f2_mul(a1a2, a.c1, a.c2);
  f2_mul_xi(xa12, a1a2);
  f2_sub(c0, a0s, xa12);
  Fp2 a2s;
  f2_sqr(a2s, a.c2);
  f2_mul_xi(xa22, a2s);
  f2_mul(a0a1, a.c0, a.c1);
  f2_sub(c1, xa22, a0a1);
  f2_sqr(a1s, a.c1);
  f2_mul(a0a2, a.c0, a.c2);
  f2_sub(c2, a1s, a0a2);
  // t = xi*(a2*c1 + a1*c2) + a0*c0
  Fp2 m1, m2, s, xs, m0;
  f2_mul(m1, a.c2, c1);
  f2_mul(m2, a.c1, c2);
  f2_add(s, m1, m2);
  f2_mul_xi(xs, s);
  f2_mul(m0, a.c0, c0);
  f2_add(t, xs, m0);
  f2_inv(ti, t);
  f2_mul(o.c0, c0, ti);
  f2_mul(o.c1, c1, ti);
  f2_mul(o.c2, c2, ti);
}
static inline bool f6_is_zero(const Fp6& a) {
  return f2_is_zero(a.c0) && f2_is_zero(a.c1) && f2_is_zero(a.c2);
}

// ---------------------------------------------------------------------------
// Fp12 = Fp6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

struct Fp12 { Fp6 c0, c1; };

static void f12_mul(Fp12& o, const Fp12& a, const Fp12& b) {
  // Karatsuba over Fp6: 3 f6_mul instead of 4
  Fp6 t0, t1, tv, sa, sb, t2;
  f6_mul(t0, a.c0, b.c0);
  f6_mul(t1, a.c1, b.c1);
  f6_add(sa, a.c0, a.c1);
  f6_add(sb, b.c0, b.c1);
  f6_mul(t2, sa, sb);
  f6_mul_v(tv, t1);
  Fp6 r0, r1;
  f6_add(r0, t0, tv);
  f6_sub(r1, t2, t0);
  f6_sub(r1, r1, t1);
  o.c0 = r0;
  o.c1 = r1;
}
static void f12_sqr(Fp12& o, const Fp12& a) {
  // complex squaring: 2 f6_mul
  //   c0' = (a0 + a1)(a0 + v a1) - t - v t,  c1' = 2t,  t = a0 a1
  Fp6 t, va1, s0, s1, m, vt;
  f6_mul(t, a.c0, a.c1);
  f6_mul_v(va1, a.c1);
  f6_add(s0, a.c0, a.c1);
  f6_add(s1, a.c0, va1);
  f6_mul(m, s0, s1);
  f6_mul_v(vt, t);
  Fp6 r0;
  f6_sub(r0, m, t);
  f6_sub(r0, r0, vt);
  o.c0 = r0;
  f6_add(o.c1, t, t);
}
static void f12_sub(Fp12& o, const Fp12& a, const Fp12& b) {
  f6_sub(o.c0, a.c0, b.c0);
  f6_sub(o.c1, a.c1, b.c1);
}
static void f12_conj(Fp12& o, const Fp12& a) {
  o.c0 = a.c0;
  f6_neg(o.c1, a.c1);
}
static void f12_inv(Fp12& o, const Fp12& a) {
  Fp6 a0s, a1s, va1s, t, ti;
  f6_mul(a0s, a.c0, a.c0);
  f6_mul(a1s, a.c1, a.c1);
  f6_mul_v(va1s, a1s);
  f6_sub(t, a0s, va1s);
  f6_inv(ti, t);
  f6_mul(o.c0, a.c0, ti);
  Fp6 n;
  f6_mul(n, a.c1, ti);
  f6_neg(o.c1, n);
}
static bool f12_is_zero(const Fp12& a) {
  return f6_is_zero(a.c0) && f6_is_zero(a.c1);
}
static bool f12_eq(const Fp12& a, const Fp12& b) {
  Fp12 d;
  f12_sub(d, a, b);
  return f12_is_zero(d);
}

static Fp12 F12_ZERO_, F12_ONE_;

static void f12_pow_be(Fp12& out, const Fp12& base, const uint8_t* exp, int n) {
  Fp12 res = F12_ONE_;
  bool started = false;
  for (int i = 0; i < n; ++i) {
    for (int b = 7; b >= 0; --b) {
      if (started) f12_sqr(res, res);
      if ((exp[i] >> b) & 1) {
        if (started) f12_mul(res, res, base);
        else { res = base; started = true; }
      }
    }
  }
  out = started ? res : F12_ONE_;
}


// ---------------------------------------------------------------------------
// Curve points
// ---------------------------------------------------------------------------

struct G1 { Fp x, y; bool inf; };           // y^2 = x^3 + 3 over Fp
struct G2 { Fp2 x, y; bool inf; };          // y^2 = x^3 + 3/xi over Fp2

static G1 G1_GEN;
static G2 G2_GEN;
static Fp2 B2_MONT;

static void g1_add(G1& o, const G1& a, const G1& b) {
  if (a.inf) { o = b; return; }
  if (b.inf) { o = a; return; }
  Fp m;
  if (fp_eq(a.x, b.x)) {
    Fp ysum;
    fp_add(ysum, a.y, b.y);
    if (fp_is_zero(ysum)) { o.inf = true; return; }
    // m = 3x^2 / 2y
    Fp x2, num, den, deni;
    fp_sqr(x2, a.x);
    fp_mul(num, FP_THREE, x2);
    fp_mul(den, FP_TWO, a.y);
    fp_inv(deni, den);
    fp_mul(m, num, deni);
  } else {
    Fp dy, dx, dxi;
    fp_sub(dy, b.y, a.y);
    fp_sub(dx, b.x, a.x);
    fp_inv(dxi, dx);
    fp_mul(m, dy, dxi);
  }
  Fp m2, x3, y3, t;
  fp_sqr(m2, m);
  fp_sub(x3, m2, a.x);
  fp_sub(x3, x3, b.x);
  fp_sub(t, a.x, x3);
  fp_mul(y3, m, t);
  fp_sub(y3, y3, a.y);
  o.x = x3;
  o.y = y3;
  o.inf = false;
}
// Jacobian scalar multiplication (X/Z^2, Y/Z^3): no per-step inversions,
// one inversion at the end for the affine result.
struct JacG1 { Fp X, Y, Z; bool inf; };

static void jac1_dbl(JacG1& P) {
  if (P.inf || fp_is_zero(P.Y)) { P.inf = true; return; }
  Fp A, B, C, D, E, F, t, t2;
  fp_sqr(A, P.X);
  fp_sqr(B, P.Y);
  fp_sqr(C, B);
  fp_add(t, P.X, B);
  fp_sqr(t, t);
  fp_sub(t, t, A);
  fp_sub(t, t, C);
  fp_add(D, t, t);                 // D = 2((X+B)^2 - A - C)
  fp_add(E, A, A);
  fp_add(E, E, A);                 // E = 3A
  fp_sqr(F, E);
  Fp X3, Y3, Z3;
  fp_add(t, D, D);
  fp_sub(X3, F, t);                // X3 = F - 2D
  fp_sub(t, D, X3);
  fp_mul(t, E, t);
  fp_add(t2, C, C);
  fp_add(t2, t2, t2);
  fp_add(t2, t2, t2);              // 8C
  fp_sub(Y3, t, t2);
  fp_mul(Z3, P.Y, P.Z);
  fp_add(Z3, Z3, Z3);
  P.X = X3; P.Y = Y3; P.Z = Z3;
}

static void jac1_madd(JacG1& P, const G1& Q) {  // P += Q (Q affine)
  if (Q.inf) return;
  if (P.inf) { P.X = Q.x; P.Y = Q.y; P.Z = FP_ONE; P.inf = false; return; }
  Fp Z2, Z3, U2, S2, H, Rr;
  fp_sqr(Z2, P.Z);
  fp_mul(Z3, Z2, P.Z);
  fp_mul(U2, Q.x, Z2);
  fp_mul(S2, Q.y, Z3);
  fp_sub(H, U2, P.X);
  fp_sub(Rr, S2, P.Y);
  if (fp_is_zero(H)) {
    if (fp_is_zero(Rr)) { jac1_dbl(P); return; }
    P.inf = true;
    return;
  }
  Fp H2, H3, UH2, X3, Y3, t;
  fp_sqr(H2, H);
  fp_mul(H3, H2, H);
  fp_mul(UH2, P.X, H2);
  fp_sqr(X3, Rr);
  fp_sub(X3, X3, H3);
  fp_sub(X3, X3, UH2);
  fp_sub(X3, X3, UH2);             // X3 = R^2 - H^3 - 2*U1*H^2
  fp_sub(t, UH2, X3);
  fp_mul(Y3, Rr, t);
  Fp SH3;
  fp_mul(SH3, P.Y, H3);
  fp_sub(Y3, Y3, SH3);             // Y3 = R(U1*H^2 - X3) - S1*H^3
  Fp Z3n;
  fp_mul(Z3n, P.Z, H);
  P.X = X3; P.Y = Y3; P.Z = Z3n;
}

static void jac1_to_affine(G1& o, const JacG1& P) {
  if (P.inf) { o.inf = true; return; }
  Fp zi, zi2, zi3;
  fp_inv(zi, P.Z);
  fp_sqr(zi2, zi);
  fp_mul(zi3, zi2, zi);
  fp_mul(o.x, P.X, zi2);
  fp_mul(o.y, P.Y, zi3);
  o.inf = false;
}

static void g1_mul_be(G1& o, const G1& pt, const uint8_t* k, int n) {
  JacG1 acc;
  acc.inf = true;
  for (int i = 0; i < n; ++i) {
    for (int b = 7; b >= 0; --b) {
      jac1_dbl(acc);
      if ((k[i] >> b) & 1) jac1_madd(acc, pt);
    }
  }
  jac1_to_affine(o, acc);
}

static void g2_add(G2& o, const G2& a, const G2& b) {
  if (a.inf) { o = b; return; }
  if (b.inf) { o = a; return; }
  Fp2 m;
  if (f2_eq(a.x, b.x)) {
    Fp2 ysum;
    f2_add(ysum, a.y, b.y);
    if (f2_is_zero(ysum)) { o.inf = true; return; }
    Fp2 x2, num, den, deni, three2, two2;
    three2.c0 = FP_THREE; three2.c1 = FP_ZERO;
    two2.c0 = FP_TWO; two2.c1 = FP_ZERO;
    f2_sqr(x2, a.x);
    f2_mul(num, three2, x2);
    f2_mul(den, two2, a.y);
    f2_inv(deni, den);
    f2_mul(m, num, deni);
  } else {
    Fp2 dy, dx, dxi;
    f2_sub(dy, b.y, a.y);
    f2_sub(dx, b.x, a.x);
    f2_inv(dxi, dx);
    f2_mul(m, dy, dxi);
  }
  Fp2 m2, x3, y3, t;
  f2_sqr(m2, m);
  f2_sub(x3, m2, a.x);
  f2_sub(x3, x3, b.x);
  f2_sub(t, a.x, x3);
  f2_mul(y3, m, t);
  f2_sub(y3, y3, a.y);
  o.x = x3;
  o.y = y3;
  o.inf = false;
}
// Jacobian scalar multiplication over Fp2 (same formulas as JacG1).
struct JacG2 { Fp2 X, Y, Z; bool inf; };

static void jac2_dbl(JacG2& P) {
  if (P.inf || f2_is_zero(P.Y)) { P.inf = true; return; }
  Fp2 A, B, C, D, E, F, t, t2;
  f2_sqr(A, P.X);
  f2_sqr(B, P.Y);
  f2_sqr(C, B);
  f2_add(t, P.X, B);
  f2_sqr(t, t);
  f2_sub(t, t, A);
  f2_sub(t, t, C);
  f2_add(D, t, t);
  f2_add(E, A, A);
  f2_add(E, E, A);
  f2_sqr(F, E);
  Fp2 X3, Y3, Z3;
  f2_add(t, D, D);
  f2_sub(X3, F, t);
  f2_sub(t, D, X3);
  f2_mul(t, E, t);
  f2_add(t2, C, C);
  f2_add(t2, t2, t2);
  f2_add(t2, t2, t2);
  f2_sub(Y3, t, t2);
  f2_mul(Z3, P.Y, P.Z);
  f2_add(Z3, Z3, Z3);
  P.X = X3; P.Y = Y3; P.Z = Z3;
}

static void jac2_madd(JacG2& P, const G2& Q) {
  if (Q.inf) return;
  if (P.inf) {
    P.X = Q.x; P.Y = Q.y;
    P.Z.c0 = FP_ONE; P.Z.c1 = FP_ZERO;
    P.inf = false;
    return;
  }
  Fp2 Z2, Z3, U2, S2, H, Rr;
  f2_sqr(Z2, P.Z);
  f2_mul(Z3, Z2, P.Z);
  f2_mul(U2, Q.x, Z2);
  f2_mul(S2, Q.y, Z3);
  f2_sub(H, U2, P.X);
  f2_sub(Rr, S2, P.Y);
  if (f2_is_zero(H)) {
    if (f2_is_zero(Rr)) { jac2_dbl(P); return; }
    P.inf = true;
    return;
  }
  Fp2 H2, H3, UH2, X3, Y3, t;
  f2_sqr(H2, H);
  f2_mul(H3, H2, H);
  f2_mul(UH2, P.X, H2);
  f2_sqr(X3, Rr);
  f2_sub(X3, X3, H3);
  f2_sub(X3, X3, UH2);
  f2_sub(X3, X3, UH2);
  f2_sub(t, UH2, X3);
  f2_mul(Y3, Rr, t);
  Fp2 SH3;
  f2_mul(SH3, P.Y, H3);
  f2_sub(Y3, Y3, SH3);
  Fp2 Z3n;
  f2_mul(Z3n, P.Z, H);
  P.X = X3; P.Y = Y3; P.Z = Z3n;
}

static void jac2_to_affine(G2& o, const JacG2& P) {
  if (P.inf) { o.inf = true; return; }
  Fp2 zi, zi2, zi3;
  f2_inv(zi, P.Z);
  f2_sqr(zi2, zi);
  f2_mul(zi3, zi2, zi);
  f2_mul(o.x, P.X, zi2);
  f2_mul(o.y, P.Y, zi3);
  o.inf = false;
}

static void g2_mul_be(G2& o, const G2& pt, const uint8_t* k, int n) {
  JacG2 acc;
  acc.inf = true;
  for (int i = 0; i < n; ++i) {
    for (int b = 7; b >= 0; --b) {
      jac2_dbl(acc);
      if ((k[i] >> b) & 1) jac2_madd(acc, pt);
    }
  }
  jac2_to_affine(o, acc);
}

// Frobenius endomorphism on the twist: psi(x, y) =
// (gamma12 * conj(x), gamma13 * conj(y)) with gamma12 = xi^((p-1)/3),
// gamma13 = xi^((p-1)/2) — untwist(psi(Q)) == frobenius(untwist(Q)),
// replacing four 254-bit Fp12 exponentiations per Miller loop with two
// Fp2 muls. All constants are powers of GW = xi^((p-1)/6), computed once
// at init (p = 1 mod 6, so the exponent is exact).
static Fp2 FROB_GW;                  // xi^((p-1)/6): frob(w)   = GW  * w
static Fp2 GAMMA12;                  // GW^2 = xi^((p-1)/3): frob(v) coeff
static Fp2 GAMMA13;                  // GW^3 = xi^((p-1)/2)
static Fp2 FROB_G2;                  // GW^4 = xi^(2(p-1)/3)
static Fp2 FROB_GW2;                 // GW^5

static void g2_psi(G2& o, const G2& q) {
  o.inf = q.inf;
  if (q.inf) return;
  Fp2 cx, cy;
  f2_conj(cx, q.x);
  f2_conj(cy, q.y);
  f2_mul(o.x, GAMMA12, cx);
  f2_mul(o.y, GAMMA13, cy);
}

// Fp12 Frobenius x -> x^p by coefficients: for a = sum_{i} a_i(v) w^j,
// frob(u) = -u (Fp2 conjugation), frob(v) = GAMMA12 v, frob(w) = GW w.
static void f12_frob(Fp12& o, const Fp12& a) {
  Fp2 t;
  f2_conj(o.c0.c0, a.c0.c0);
  f2_conj(t, a.c0.c1);
  f2_mul(o.c0.c1, t, GAMMA12);
  f2_conj(t, a.c0.c2);
  f2_mul(o.c0.c2, t, FROB_G2);
  f2_conj(t, a.c1.c0);
  f2_mul(o.c1.c0, t, FROB_GW);
  f2_conj(t, a.c1.c1);
  f2_mul(o.c1.c1, t, GAMMA13);
  f2_conj(t, a.c1.c2);
  f2_mul(o.c1.c2, t, FROB_GW2);
}

static int ATE_NBITS = 0;  // set in init (strlen of generated ATE_NAF)

// ---------------------------------------------------------------------
// Inversion-free Miller loop: the G2 ladder runs in Jacobian TWIST
// coordinates (Fp2 arithmetic only) and each step emits its line's
// denominator-cleared coefficients. Clearing constants live in Fp2,
// whose elements the final exponentiation kills ((p^12-1)/r is divisible
// by p^2-1), so the pairing value is unchanged.
//
// With untwist x -> w^2 x, y -> w^3 y, a line through the twist point
// (x1, y1) with twist-slope lambda, evaluated at P = (xP, yP) in G1, is
//   l = -yP + (lambda xP) w + (y1 - lambda x1) w^3
// (slots: w^0 = c0.c0, w^1 = c1.c0, w^3 = c1.c1). For T = (X, Y, Z)
// Jacobian (x = X/Z^2, y = Y/Z^3):
//   doubling, cleared by 2YZ^3 (tangent slope 3x^2/2y = 3X^2/(2YZ)):
//     w^0: -2YZ^3 yP     w^1: 3X^2 Z^2 xP     w^3: 2Y^2 - 3X^3
//   mixed add of affine (x2, y2), H = x2 Z^2 - X, Rr = y2 Z^3 - Y,
//   cleared by Z H (chord slope = Rr / (Z H)):
//     w^0: -Z H yP       w^1: Rr xP           w^3: y2 Z H - Rr x2
// ---------------------------------------------------------------------

static inline void f2_scale(Fp2& o, const Fp2& a, const Fp& s) {
  fp_mul(o.c0, a.c0, s);
  fp_mul(o.c1, a.c1, s);
}

// A line in the sparse basis (w^0, w^1, w^3); the rare vertical /
// degenerate cases fall back to a dense Fp12 value.
struct Line {
  int kind;   // 0 = sparse (b0, b1, b2), 1 = identity, 2 = dense
  Fp2 b0, b1, b2;
  Fp12 dense;
};

// a * (x0 + x1 v) — 5 Fp2 muls (Karatsuba on the low pair)
static void f6_mul_01(Fp6& o, const Fp6& a, const Fp2& x0, const Fp2& x1) {
  Fp2 v0, v1, sa01, sx, c1t, a2x1, xt, c0t, a2x0, c2t;
  f2_mul(v0, a.c0, x0);
  f2_mul(v1, a.c1, x1);
  f2_add(sa01, a.c0, a.c1);
  f2_add(sx, x0, x1);
  f2_mul(c1t, sa01, sx);
  f2_sub(c1t, c1t, v0);
  f2_sub(c1t, c1t, v1);
  f2_mul(a2x1, a.c2, x1);
  f2_mul_xi(xt, a2x1);
  f2_add(c0t, v0, xt);
  f2_mul(a2x0, a.c2, x0);
  f2_add(c2t, a2x0, v1);
  o.c0 = c0t;
  o.c1 = c1t;
  o.c2 = c2t;
}

// f *= (b0 + b1 w + b2 v w) — 13 Fp2 muls vs 18 for the dense product
static void f12_mul_line(Fp12& f, const Fp2& b0, const Fp2& b1,
                         const Fp2& b2) {
  // B0 = (b0, 0, 0), B1 = (b1, b2, 0) over Fp6; Karatsuba as in f12_mul
  Fp6 t0, t1, sa, t2, tv;
  f2_mul(t0.c0, f.c0.c0, b0);
  f2_mul(t0.c1, f.c0.c1, b0);
  f2_mul(t0.c2, f.c0.c2, b0);
  f6_mul_01(t1, f.c1, b1, b2);
  f6_add(sa, f.c0, f.c1);
  Fp2 s0;
  f2_add(s0, b0, b1);
  f6_mul_01(t2, sa, s0, b2);
  f6_mul_v(tv, t1);
  Fp6 r0, r1;
  f6_add(r0, t0, tv);
  f6_sub(r1, t2, t0);
  f6_sub(r1, r1, t1);
  f.c0 = r0;
  f.c1 = r1;
}

static inline void line_apply(Fp12& f, const Line& l) {
  if (l.kind == 0) f12_mul_line(f, l.b0, l.b1, l.b2);
  else if (l.kind == 2) f12_mul(f, f, l.dense);
  // kind 1: multiply by one — nothing to do
}

static void dbl_step_jac(JacG2& T, const Fp& xP, const Fp& yP, Line& l) {
  if (T.inf || f2_is_zero(T.Y)) { T.inf = true; l.kind = 1; return; }
  // line at the current T (cleared by 2YZ^3) and the doubling itself in
  // one pass, sharing X^2 / Y^2 / Z^2 / 2YZ
  Fp2 X2, Y2, Z2, X2_3, X3cube, X3_3, w3, wc, neg, Z3n, YZ3_2;
  f2_sqr(X2, T.X);
  f2_sqr(Y2, T.Y);
  f2_sqr(Z2, T.Z);
  f2_add(X2_3, X2, X2);
  f2_add(X2_3, X2_3, X2);          // E = 3X^2
  f2_mul(X3cube, X2, T.X);         // X^3
  f2_add(X3_3, X3cube, X3cube);
  f2_add(X3_3, X3_3, X3cube);      // 3X^3
  f2_add(w3, Y2, Y2);
  f2_sub(w3, w3, X3_3);            // 2Y^2 - 3X^3
  f2_mul(wc, X2_3, Z2);            // 3X^2 Z^2
  f2_mul(Z3n, T.Y, T.Z);
  f2_add(Z3n, Z3n, Z3n);           // Z' = 2YZ
  f2_mul(YZ3_2, Z3n, Z2);          // 2YZ^3 = Z' * Z^2
  l.kind = 0;
  f2_neg(neg, YZ3_2);
  f2_scale(l.b0, neg, yP);
  f2_scale(l.b1, wc, xP);
  l.b2 = w3;
  // point doubling reusing A=X2, B=Y2 (same formulas as jac2_dbl)
  Fp2 C, D, t, F, X3, Y3;
  f2_sqr(C, Y2);                   // C = Y^4
  f2_add(t, T.X, Y2);
  f2_sqr(t, t);
  f2_sub(t, t, X2);
  f2_sub(t, t, C);
  f2_add(D, t, t);                 // D = 2((X+Y^2)^2 - X^2 - Y^4)
  f2_sqr(F, X2_3);                 // F = E^2
  f2_add(t, D, D);
  f2_sub(X3, F, t);
  f2_sub(t, D, X3);
  f2_mul(t, X2_3, t);
  Fp2 c8;
  f2_add(c8, C, C);
  f2_add(c8, c8, c8);
  f2_add(c8, c8, c8);              // 8C
  f2_sub(Y3, t, c8);
  T.X = X3;
  T.Y = Y3;
  T.Z = Z3n;
}

static void add_step_jac(JacG2& T, const G2& Q, const Fp& xP, const Fp& yP,
                         Line& l) {
  if (Q.inf) { l.kind = 1; return; }
  if (T.inf) { l.kind = 1; jac2_madd(T, Q); return; }
  Fp2 Z2, Z3, U2, S2, H, Rr;
  f2_sqr(Z2, T.Z);
  f2_mul(Z3, Z2, T.Z);
  f2_mul(U2, Q.x, Z2);
  f2_mul(S2, Q.y, Z3);
  f2_sub(H, U2, T.X);
  f2_sub(Rr, S2, T.Y);
  if (f2_is_zero(H)) {
    if (f2_is_zero(Rr)) { dbl_step_jac(T, xP, yP, l); return; }
    // vertical line (Q = -T): l = xP - x2  (slots w^0 and w^2 — not the
    // sparse basis, use the dense fallback; unreachable for r-order
    // inputs, kept for completeness)
    l.kind = 2;
    l.dense = F12_ZERO_;
    l.dense.c0.c0.c0 = xP;
    f2_neg(l.dense.c0.c1, Q.x);
    T.inf = true;
    return;
  }
  Fp2 ZH, neg, m1, m2;
  f2_mul(ZH, T.Z, H);
  l.kind = 0;
  f2_neg(neg, ZH);
  f2_scale(l.b0, neg, yP);
  f2_scale(l.b1, Rr, xP);
  f2_mul(m1, Q.y, ZH);
  f2_mul(m2, Rr, Q.x);
  f2_sub(l.b2, m1, m2);
  // complete the point add reusing H/Rr (same formulas as jac2_madd)
  Fp2 H2, H3, UH2, X3, Y3, tt, SH3;
  f2_sqr(H2, H);
  f2_mul(H3, H2, H);
  f2_mul(UH2, T.X, H2);
  f2_sqr(X3, Rr);
  f2_sub(X3, X3, H3);
  f2_sub(X3, X3, UH2);
  f2_sub(X3, X3, UH2);
  f2_sub(tt, UH2, X3);
  f2_mul(Y3, Rr, tt);
  f2_mul(SH3, T.Y, H3);
  f2_sub(Y3, Y3, SH3);
  T.X = X3;
  T.Y = Y3;
  T.Z = ZH;  // Z' = Z*H, already computed for the line
}

// Miller loop for one (Q in G2, P in G1) pair, accumulated into f.
static void miller(Fp12& f, const G2& Qa, const G1& Pa) {
  if (Qa.inf || Pa.inf) return;  // degenerate pair contributes 1
  JacG2 T;
  T.X = Qa.x;
  T.Y = Qa.y;
  T.Z.c0 = FP_ONE;
  T.Z.c1 = FP_ZERO;
  T.inf = false;
  G2 nQ = Qa;
  f2_neg(nQ.y, Qa.y);  // NAF ladder: digit 'm' adds -Q
  Line l;
  for (int i = 1; i < ATE_NBITS; ++i) {
    f12_sqr(f, f);
    dbl_step_jac(T, Pa.x, Pa.y, l);
    line_apply(f, l);
    const char d = ATE_NAF[i];
    if (d != '0') {
      add_step_jac(T, d == '1' ? Qa : nQ, Pa.x, Pa.y, l);
      line_apply(f, l);
    }
  }
  // Q1 = frob(Q), nQ2 = -frob(Q1) via the twist endomorphism psi
  G2 q1t, q2t;
  g2_psi(q1t, Qa);
  g2_psi(q2t, q1t);
  f2_neg(q2t.y, q2t.y);
  add_step_jac(T, q1t, Pa.x, Pa.y, l);
  line_apply(f, l);
  add_step_jac(T, q2t, Pa.x, Pa.y, l);
  line_apply(f, l);
}

// ---------------------------------------------------------------------
// Fixed-G2 Miller line table. Every verification pairs the signature
// against the SAME G2 generator, so the generator's whole Jacobian
// ladder runs once at init; verify replays the recorded per-step line
// coefficients, scaling b0/b1 by the runtime G1 point (2 Fp muls per
// coefficient) — the point arithmetic disappears from the hot path.
// Recording runs the ordinary steps with xP = yP = 1 (Montgomery one),
// which leaves exactly the unscaled coefficients in b0/b1.
// ---------------------------------------------------------------------

static Line GEN_TABLE[2 * 72 + 2];
static int GEN_TABLE_LEN = 0;

static void record_lines(const G2& Qa, Line* tab, int* out_len) {
  JacG2 T;
  T.X = Qa.x;
  T.Y = Qa.y;
  T.Z.c0 = FP_ONE;
  T.Z.c1 = FP_ZERO;
  T.inf = false;
  G2 nQ = Qa;
  f2_neg(nQ.y, Qa.y);
  int n = 0;
  for (int i = 1; i < ATE_NBITS; ++i) {
    dbl_step_jac(T, FP_ONE, FP_ONE, tab[n++]);
    const char d = ATE_NAF[i];
    if (d != '0')
      add_step_jac(T, d == '1' ? Qa : nQ, FP_ONE, FP_ONE, tab[n++]);
  }
  G2 q1t, q2t;
  g2_psi(q1t, Qa);
  g2_psi(q2t, q1t);
  f2_neg(q2t.y, q2t.y);
  add_step_jac(T, q1t, FP_ONE, FP_ONE, tab[n++]);
  add_step_jac(T, q2t, FP_ONE, FP_ONE, tab[n++]);
  *out_len = n;
}

static void gen_table_init() {
  record_lines(G2_GEN, GEN_TABLE, &GEN_TABLE_LEN);
}

static inline void line_apply_scaled(Fp12& f, const Line& l, const G1& Pa) {
  if (l.kind == 0) {
    Fp2 b0, b1;
    f2_scale(b0, l.b0, Pa.y);
    f2_scale(b1, l.b1, Pa.x);
    f12_mul_line(f, b0, b1, l.b2);
  }
  // kind 1/2 cannot occur for the r-order generator's ladder (no
  // verticals); treat them as identity if they ever did
}

static void miller_pretab(Fp12& f, const Line* tab, int len, const G1& Pa) {
  if (Pa.inf) return;
  int idx = 0;
  for (int i = 1; i < ATE_NBITS; ++i) {
    f12_sqr(f, f);
    line_apply_scaled(f, tab[idx++], Pa);
    if (ATE_NAF[i] != '0') line_apply_scaled(f, tab[idx++], Pa);
  }
  line_apply_scaled(f, tab[idx++], Pa);
  line_apply_scaled(f, tab[idx++], Pa);
  (void)len;
}

// Fused dual Miller loop: the table pair (G2 generator vs P_tab) and one
// live pair (Q vs P) share a single squaring chain — one f12_sqr per ate
// bit instead of two, which is what makes a verification's two pairings
// cost little more than one.
static void miller_dual(Fp12& f, const Line* tab, const G1& Ptab,
                        const G2& Q, const G1& P) {
  const bool with_tab = !Ptab.inf;
  const bool live = !(Q.inf || P.inf);
  JacG2 T;
  Line l;
  if (live) {
    T.X = Q.x;
    T.Y = Q.y;
    T.Z.c0 = FP_ONE;
    T.Z.c1 = FP_ZERO;
    T.inf = false;
  }
  G2 nQ;
  if (live) { nQ = Q; f2_neg(nQ.y, Q.y); }
  int idx = 0;
  for (int i = 1; i < ATE_NBITS; ++i) {
    f12_sqr(f, f);
    if (with_tab) line_apply_scaled(f, tab[idx], Ptab);
    ++idx;
    if (live) {
      dbl_step_jac(T, P.x, P.y, l);
      line_apply(f, l);
    }
    const char d = ATE_NAF[i];
    if (d != '0') {
      if (with_tab) line_apply_scaled(f, tab[idx], Ptab);
      ++idx;
      if (live) {
        add_step_jac(T, d == '1' ? Q : nQ, P.x, P.y, l);
        line_apply(f, l);
      }
    }
  }
  if (with_tab) line_apply_scaled(f, tab[idx], Ptab);
  ++idx;
  if (with_tab) line_apply_scaled(f, tab[idx], Ptab);
  if (live) {
    G2 q1t, q2t;
    g2_psi(q1t, Q);
    g2_psi(q2t, q1t);
    f2_neg(q2t.y, q2t.y);
    add_step_jac(T, q1t, P.x, P.y, l);
    line_apply(f, l);
    add_step_jac(T, q2t, P.x, P.y, l);
    line_apply(f, l);
  }
}

// ---------------------------------------------------------------------
// Per-public-key Miller line tables (bounded LRU).
//
// The generator side of every verification replays GEN_TABLE; the pk
// side re-ran its full Jacobian ladder per verification. For repeat
// connectors (reconnect storms, elastic-client churn — the marshal's
// steady state) the pk is as fixed as the generator, so its ladder runs
// ONCE and subsequent verifications replay recorded line coefficients:
// the Fp2 point arithmetic AND the G2 subgroup check (validated before
// insert; the key is the exact 128-byte encoding) drop off the warm
// path, leaving two table replays fused on one squaring chain.
//
// Memory bound: a table is one SparseLine (3×Fp2 = 192 B) per recorded
// line — ATE_NBITS-1 doublings + the NAF's add-steps + 2 frobenius
// lines ≈ 89 lines ≈ 17 KB per key, heap-allocated at exact length.
// The LRU holds at most PK_CACHE_CAP entries (default 128 ≈ 2.2 MB);
// bls_pk_cache_configure resizes (0 disables — cached entrypoints then
// take the plain uncached path).
// ---------------------------------------------------------------------

struct SparseLine { Fp2 b0, b1, b2; };

struct PkTable {
  int len = 0;
  std::unique_ptr<SparseLine[]> lines;
};

// Record Q's whole ladder as sparse lines on the same (dbl, add?) per-NAF-
// digit schedule miller_dual walks, so replay indexes line up with
// GEN_TABLE's. Returns false if any step emits a non-sparse line
// (vertical — unreachable for the r-order points that pass the subgroup
// check; such a pk is simply not cached and verifies via the plain loop).
static bool record_pk_table(const G2& Qa, PkTable& out) {
  SparseLine tmp[2 * 72 + 2];
  JacG2 T;
  T.X = Qa.x;
  T.Y = Qa.y;
  T.Z.c0 = FP_ONE;
  T.Z.c1 = FP_ZERO;
  T.inf = false;
  G2 nQ = Qa;
  f2_neg(nQ.y, Qa.y);
  Line l;
  int n = 0;
  for (int i = 1; i < ATE_NBITS; ++i) {
    dbl_step_jac(T, FP_ONE, FP_ONE, l);
    if (l.kind != 0) return false;
    tmp[n].b0 = l.b0; tmp[n].b1 = l.b1; tmp[n].b2 = l.b2; ++n;
    const char d = ATE_NAF[i];
    if (d != '0') {
      add_step_jac(T, d == '1' ? Qa : nQ, FP_ONE, FP_ONE, l);
      if (l.kind != 0) return false;
      tmp[n].b0 = l.b0; tmp[n].b1 = l.b1; tmp[n].b2 = l.b2; ++n;
    }
  }
  G2 q1t, q2t;
  g2_psi(q1t, Qa);
  g2_psi(q2t, q1t);
  f2_neg(q2t.y, q2t.y);
  add_step_jac(T, q1t, FP_ONE, FP_ONE, l);
  if (l.kind != 0) return false;
  tmp[n].b0 = l.b0; tmp[n].b1 = l.b1; tmp[n].b2 = l.b2; ++n;
  add_step_jac(T, q2t, FP_ONE, FP_ONE, l);
  if (l.kind != 0) return false;
  tmp[n].b0 = l.b0; tmp[n].b1 = l.b1; tmp[n].b2 = l.b2; ++n;
  out.len = n;
  out.lines.reset(new SparseLine[n]);
  std::memcpy(out.lines.get(), tmp, (size_t)n * sizeof(SparseLine));
  return true;
}

static inline void sparse_apply_scaled(Fp12& f, const SparseLine& l,
                                       const G1& Pa) {
  Fp2 b0, b1;
  f2_scale(b0, l.b0, Pa.y);
  f2_scale(b1, l.b1, Pa.x);
  f12_mul_line(f, b0, b1, l.b2);
}

// Fused multi-pair Miller walk where EVERY pair replays a table: one
// f12_sqr per ate bit total (the miller_dual trick generalized to n+1
// pairs). Pair 0 is (GEN_TABLE, Pg); pairs 1..n are (tabs[j], Ps[j]).
// Degenerate points (inf) contribute 1, matching miller().
static void miller_multi_tab(Fp12& f, const Line* gtab, const G1& Pg,
                             const PkTable* const* tabs, const G1* Ps,
                             int n) {
  const bool wg = !Pg.inf;
  int idx = 0;
  for (int i = 1; i < ATE_NBITS; ++i) {
    f12_sqr(f, f);
    if (wg) line_apply_scaled(f, gtab[idx], Pg);
    for (int j = 0; j < n; ++j)
      if (!Ps[j].inf) sparse_apply_scaled(f, tabs[j]->lines[idx], Ps[j]);
    ++idx;
    if (ATE_NAF[i] != '0') {
      if (wg) line_apply_scaled(f, gtab[idx], Pg);
      for (int j = 0; j < n; ++j)
        if (!Ps[j].inf) sparse_apply_scaled(f, tabs[j]->lines[idx], Ps[j]);
      ++idx;
    }
  }
  for (int k = 0; k < 2; ++k) {
    if (wg) line_apply_scaled(f, gtab[idx], Pg);
    for (int j = 0; j < n; ++j)
      if (!Ps[j].inf) sparse_apply_scaled(f, tabs[j]->lines[idx], Ps[j]);
    ++idx;
  }
}

// The LRU proper. shared_ptr entries make eviction safe against a
// concurrent verification still replaying the table; the mutex guards
// only map/list/counter surgery (table contents are immutable after
// insert). ctypes calls release the GIL, so concurrent entry from
// to_thread offload workers is the normal case, not a corner.
static std::mutex PK_MUTEX;
static std::unordered_map<std::string,
                          std::pair<std::shared_ptr<PkTable>,
                                    std::list<std::string>::iterator>>
    PK_MAP;
static std::list<std::string> PK_LRU;  // front = most recently used
static size_t PK_CACHE_CAP = 128;
static u64 PK_HITS = 0, PK_MISSES = 0, PK_EVICTIONS = 0;

static std::shared_ptr<PkTable> pk_cache_lookup(const uint8_t pk[128]) {
  std::string key((const char*)pk, 128);
  std::lock_guard<std::mutex> g(PK_MUTEX);
  auto it = PK_MAP.find(key);
  if (it == PK_MAP.end()) {
    ++PK_MISSES;
    return nullptr;
  }
  ++PK_HITS;
  PK_LRU.splice(PK_LRU.begin(), PK_LRU, it->second.second);
  return it->second.first;
}

static void pk_cache_insert(const uint8_t pk[128],
                            std::shared_ptr<PkTable> tab) {
  std::string key((const char*)pk, 128);
  std::lock_guard<std::mutex> g(PK_MUTEX);
  if (PK_CACHE_CAP == 0) return;
  auto it = PK_MAP.find(key);
  if (it != PK_MAP.end()) {  // raced another builder: keep the incumbent
    PK_LRU.splice(PK_LRU.begin(), PK_LRU, it->second.second);
    return;
  }
  while (PK_MAP.size() >= PK_CACHE_CAP && !PK_LRU.empty()) {
    PK_MAP.erase(PK_LRU.back());
    PK_LRU.pop_back();
    ++PK_EVICTIONS;
  }
  PK_LRU.push_front(key);
  PK_MAP.emplace(std::move(key),
                 std::make_pair(std::move(tab), PK_LRU.begin()));
}

// ---------------------------------------------------------------------
// Fast G2 subgroup membership: psi(Q) == [6u^2]Q. The untwist-Frobenius
// endomorphism acts as multiplication by t-1 = 6u^2 on the r-torsion
// (the standard BN fast membership test); the caller has already
// checked the twist-curve equation in g2_read. A 127-bit scalar ladder
// replaces the 254-bit multiply-by-order check.
// ---------------------------------------------------------------------

static bool g2_eq_pt(const G2& a, const G2& b) {
  if (a.inf || b.inf) return a.inf == b.inf;
  return f2_eq(a.x, b.x) && f2_eq(a.y, b.y);
}

// NAF digits of the fixed scalar 6u^2, computed once at init: the signed
// form needs only {Q, -Q} (G2 negation is free) and cuts the ladder's
// additions from ~H(k) to ~len/3.
static signed char SIX_U2_NAF[136];
static int SIX_U2_NAF_LEN = 0;

static void six_u2_naf_init() {
  // load the <=16-byte big-endian scalar into two limbs
  u64 lo = 0, hi = 0;
  for (int i = 0; i < SIX_U2_LEN; ++i) {
    hi = (hi << 8) | (lo >> 56);
    lo = (lo << 8) | SIX_U2[i];
  }
  int n = 0;
  while (lo | hi) {
    signed char d = 0;
    if (lo & 1) {
      d = (signed char)(2 - (int)(lo & 3));  // +-1
      if (d > 0) {
        u64 nlo = lo - 1;
        lo = nlo;
      } else {
        u64 nlo = lo + 1;
        if (nlo < lo) ++hi;  // carry
        lo = nlo;
      }
    }
    SIX_U2_NAF[n++] = d;
    lo = (lo >> 1) | (hi << 63);
    hi >>= 1;
  }
  SIX_U2_NAF_LEN = n;
}

static void g2_mul_six_u2(G2& o, const G2& q) {
  G2 nq = q;
  f2_neg(nq.y, q.y);
  JacG2 acc;
  acc.inf = true;
  for (int i = SIX_U2_NAF_LEN - 1; i >= 0; --i) {
    jac2_dbl(acc);
    if (SIX_U2_NAF[i] > 0) jac2_madd(acc, q);
    else if (SIX_U2_NAF[i] < 0) jac2_madd(acc, nq);
  }
  jac2_to_affine(o, acc);
}

static bool g2_in_subgroup(const G2& q) {
  if (q.inf) return true;
  G2 lhs, rhs;
  g2_psi(lhs, q);
  g2_mul_six_u2(rhs, q);
  return g2_eq_pt(lhs, rhs);
}

static void final_exp_slow(Fp12& o, const Fp12& f) {
  // full easy part: f^((p^6-1)(p^2+1))
  Fp12 c, fi, m, m2, u;
  f12_conj(c, f);
  f12_inv(fi, f);
  f12_mul(m, c, fi);          // ^(p^6-1)
  f12_frob(m2, m);
  f12_frob(m2, m2);           // ^(p^2)
  f12_mul(u, m2, m);          // ^(p^2+1)
  // hard part: ^((p^4-p^2+1)/r) — 762 bits instead of the 1268-bit
  // (p^6+1)/r that a (p^6-1)-only easy part leaves behind
  f12_pow_be(o, u, EXP_HARD, EXP_HARD_LEN);
}

// Granger–Scott cyclotomic squaring: valid only AFTER the easy part
// (elements of the cyclotomic subgroup, where x^(p^6+1) = norm = 1) —
// three Fp4 squarings instead of a full Fp12 square. Verified against
// f12_sqr on a live pairing value in the self-test.
static inline void fp4_sqr(Fp2& o0, Fp2& o1, const Fp2& a, const Fp2& b) {
  // Fp4 = Fp2[t]/(t^2 - xi): (a + b t)^2 = a^2 + xi b^2 + 2ab t
  Fp2 a2, b2, ab;
  f2_sqr(a2, a);
  f2_sqr(b2, b);
  f2_add(ab, a, b);
  f2_sqr(ab, ab);
  f2_sub(ab, ab, a2);
  f2_sub(ab, ab, b2);          // 2ab
  f2_mul_xi(o0, b2);
  f2_add(o0, o0, a2);
  o1 = ab;
}

static void f12_sqr_cyc(Fp12& o, const Fp12& f) {
  // coordinates (arkworks layout on the same tower):
  //   z0 = c0.c0, z4 = c0.c1, z3 = c0.c2, z2 = c1.c0, z1 = c1.c1,
  //   z5 = c1.c2
  const Fp2 z0 = f.c0.c0, z4 = f.c0.c1, z3 = f.c0.c2;
  const Fp2 z2 = f.c1.c0, z1 = f.c1.c1, z5 = f.c1.c2;
  Fp2 t0, t1, t2, t3, t4, t5, t;
  fp4_sqr(t0, t1, z0, z1);
  fp4_sqr(t2, t3, z2, z3);
  fp4_sqr(t4, t5, z4, z5);
  // z0' = 2(t0 - z0) + t0 ; z1' = 2(t1 + z1) + t1
  f2_sub(t, t0, z0);
  f2_add(t, t, t);
  f2_add(o.c0.c0, t, t0);
  f2_add(t, t1, z1);
  f2_add(t, t, t);
  f2_add(o.c1.c1, t, t1);
  // z4' = 2(t2 - z4) + t2 ; z5' = 2(t3 + z5) + t3
  f2_sub(t, t2, z4);
  f2_add(t, t, t);
  f2_add(o.c0.c1, t, t2);
  f2_add(t, t3, z5);
  f2_add(t, t, t);
  f2_add(o.c1.c2, t, t3);
  // t = xi * t5; z2' = 2(t + z2) + t ; z3' = 2(t4 - z3) + t4
  f2_mul_xi(t5, t5);
  f2_add(t, t5, z2);
  f2_add(t, t, t);
  f2_add(o.c1.c0, t, t5);
  f2_sub(t, t4, z3);
  f2_add(t, t, t);
  f2_add(o.c0.c2, t, t4);
}

// x^u for the 63-bit BN parameter u (MSB-first over BN_U_BITS) — the
// building block of the fast hard part: 3 of these replace one generic
// 762-bit exponentiation. Cyclotomic-subgroup inputs only.
static int BN_U_NBITS = 0;  // set in init

static void f12_pow_u_bits(Fp12& o, const Fp12& a) {
  // plain square-and-multiply over BN_U_BITS — kept as the self-test
  // reference for the w2-NAF ladder below
  Fp12 r = a;
  for (int i = 1; i < BN_U_NBITS; ++i) {
    f12_sqr_cyc(r, r);
    if (BN_U_BITS[i] == '1') f12_mul(r, r, a);
  }
  o = r;
}

static void f12_pow_u(Fp12& o, const Fp12& a) {
  // width-2 NAF ladder (digits 0/±1/±3, BN_U_W2NAF): in the cyclotomic
  // subgroup inversion is conjugation, so the negative digits cost
  // nothing extra — 18 multiplications instead of popcount(u) = 28, for
  // one a^3 precompute. Same squaring count.
  Fp12 a3, na, na3, r;
  f12_sqr_cyc(a3, a);
  f12_mul(a3, a3, a);
  f12_conj(na, a);
  f12_conj(na3, a3);
  r = a;  // leading digit is '1' (asserted at init)
  for (const char* d = BN_U_W2NAF + 1; *d; ++d) {
    f12_sqr_cyc(r, r);
    switch (*d) {
      case '1': f12_mul(r, r, a); break;
      case '3': f12_mul(r, r, a3); break;
      case 'm': f12_mul(r, r, na); break;
      case 'n': f12_mul(r, r, na3); break;
      default: break;
    }
  }
  o = r;
}

// Fast final exponentiation: same easy part, then the Devegili–Scott–
// Dominguez addition chain for the BN hard part (p^4-p^2+1)/r expressed
// in powers of u — 3 exp-by-u + ~13 multiplications + 4 squarings +
// Frobenius maps instead of the generic 762-bit square-and-multiply.
// After the easy part the value is in the cyclotomic subgroup, where
// inversion is conjugation (x^(p^6) = x^-1). The self-test cross-checks
// this chain against the generated-exponent slow path on a live pairing
// value, so a transcription slip cannot survive unnoticed.
static void final_exp(Fp12& o, const Fp12& f) {
  Fp12 c, fi, m, m2, u;
  f12_conj(c, f);
  f12_inv(fi, f);
  f12_mul(m, c, fi);          // ^(p^6-1)
  f12_frob(m2, m);
  f12_frob(m2, m2);
  f12_mul(u, m2, m);          // ^(p^2+1): cyclotomic from here on

  Fp12 fu, fu2, fu3;
  f12_pow_u(fu, u);           // f^u
  f12_pow_u(fu2, fu);         // f^(u^2)
  f12_pow_u(fu3, fu2);        // f^(u^3)
  Fp12 fp1, fp2, fp3, t;
  f12_frob(fp1, u);
  f12_frob(fp2, fp1);
  f12_frob(fp3, fp2);
  Fp12 y0, y1, y2, y3, y4, y5, y6;
  f12_mul(t, fp1, fp2);
  f12_mul(y0, t, fp3);        // y0 = f^p * f^(p^2) * f^(p^3)
  f12_conj(y1, u);            // y1 = f^-1
  f12_frob(y2, fu2);
  f12_frob(y2, y2);           // y2 = (f^(u^2))^(p^2)
  f12_frob(t, fu);
  f12_conj(y3, t);            // y3 = (f^(up))^-1
  f12_frob(t, fu2);
  f12_mul(t, fu, t);
  f12_conj(y4, t);            // y4 = (f^u * f^(u^2 p))^-1
  f12_conj(y5, fu2);          // y5 = (f^(u^2))^-1
  f12_frob(t, fu3);
  f12_mul(t, fu3, t);
  f12_conj(y6, t);            // y6 = (f^(u^3) * f^(u^3 p))^-1
  Fp12 T0, T1;
  f12_sqr_cyc(T0, y6);
  f12_mul(T0, T0, y4);
  f12_mul(T0, T0, y5);
  f12_mul(T1, y3, y5);
  f12_mul(T1, T1, T0);
  f12_mul(T0, T0, y2);
  f12_sqr_cyc(T1, T1);
  f12_mul(T1, T1, T0);
  f12_sqr_cyc(T1, T1);
  f12_mul(T0, T1, y1);
  f12_mul(T1, T1, y0);
  f12_sqr_cyc(T0, T0);
  f12_mul(o, T0, T1);
}

// ---------------------------------------------------------------------------
// SHA-256 (compact)
// ---------------------------------------------------------------------------

static const uint32_t K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static void sha256(uint8_t out[32], const uint8_t* data, size_t len) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  size_t total = len;
  size_t padded = ((len + 9 + 63) / 64) * 64;
  uint8_t block[64];
  for (size_t off = 0; off < padded; off += 64) {
    for (int i = 0; i < 64; ++i) {
      size_t idx = off + i;
      if (idx < len) block[i] = data[idx];
      else if (idx == len) block[i] = 0x80;
      else if (idx >= padded - 8) {
        uint64_t bits = (uint64_t)total * 8;
        block[i] = (uint8_t)(bits >> (8 * (padded - 1 - idx)));
      } else block[i] = 0;
    }
    uint32_t w[64];
    for (int i = 0; i < 16; ++i)
      w[i] = ((uint32_t)block[4 * i] << 24) | ((uint32_t)block[4 * i + 1] << 16) |
             ((uint32_t)block[4 * i + 2] << 8) | block[4 * i + 3];
    for (int i = 16; i < 64; ++i) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; ++i) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K256[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }
  for (int i = 0; i < 8; ++i) {
    out[4 * i] = (uint8_t)(h[i] >> 24);
    out[4 * i + 1] = (uint8_t)(h[i] >> 16);
    out[4 * i + 2] = (uint8_t)(h[i] >> 8);
    out[4 * i + 3] = (uint8_t)h[i];
  }
}

// ---------------------------------------------------------------------------
// hash-to-G1 (try-and-increment; G1 cofactor = 1)
// ---------------------------------------------------------------------------

static bool fp_from_be_reduce(Fp& out, const uint8_t in[32]) {
  u64 limbs[4];
  be_to_limbs(limbs, in);
  // value < 2^256 < 6p: subtract p until < p
  while (cmp4(limbs, P) >= 0) sub4(limbs, limbs, P);
  fp_from_canonical(out, limbs);
  return true;
}

static void hash_to_g1(G1& out, const uint8_t* msg, long long len) {
  uint8_t h0[32];
  sha256(h0, msg, (size_t)len);
  uint8_t buf[33];
  std::memcpy(buf, h0, 32);
  for (int ctr = 0; ctr < 256; ++ctr) {
    buf[32] = (uint8_t)ctr;
    uint8_t d[32];
    sha256(d, buf, 33);
    Fp x;
    fp_from_be_reduce(x, d);
    // y^2 = x^3 + 3
    Fp x2, x3, y2, y, ycheck;
    fp_sqr(x2, x);
    fp_mul(x3, x2, x);
    fp_add(y2, x3, FP_B3);
    fp_pow_be(y, y2, EXP_SQRT, 32);  // candidate sqrt (p = 3 mod 4)
    fp_sqr(ycheck, y);
    if (fp_eq(ycheck, y2)) {
      // deterministic sign choice from the hash
      if (d[31] & 1) fp_neg(y, y);
      out.x = x;
      out.y = y;
      out.inf = false;
      return;
    }
  }
  // unreachable for any practical input (each try succeeds w.p. ~1/2)
  out = G1_GEN;
}

// ---------------------------------------------------------------------------
// serialization
// ---------------------------------------------------------------------------

static void fp_write_be(uint8_t out[32], const Fp& a) {
  u64 limbs[4];
  fp_to_canonical(limbs, a);
  limbs_to_be(out, limbs);
}
static bool fp_read_be(Fp& out, const uint8_t in[32]) {
  u64 limbs[4];
  be_to_limbs(limbs, in);
  if (cmp4(limbs, P) >= 0) return false;  // non-canonical
  fp_from_canonical(out, limbs);
  return true;
}

static void g1_write(uint8_t out[64], const G1& a) {
  fp_write_be(out, a.x);
  fp_write_be(out + 32, a.y);
}
static bool g1_read(G1& out, const uint8_t in[64]) {
  if (!fp_read_be(out.x, in) || !fp_read_be(out.y, in + 32)) return false;
  out.inf = fp_is_zero(out.x) && fp_is_zero(out.y);
  if (out.inf) return false;  // infinity is not a valid signature point
  // on-curve check: y^2 == x^3 + 3
  Fp x2, x3, rhs, y2;
  fp_sqr(x2, out.x);
  fp_mul(x3, x2, out.x);
  fp_add(rhs, x3, FP_B3);
  fp_sqr(y2, out.y);
  return fp_eq(y2, rhs);
}
static void g2_write(uint8_t out[128], const G2& a) {
  fp_write_be(out, a.x.c0);
  fp_write_be(out + 32, a.x.c1);
  fp_write_be(out + 64, a.y.c0);
  fp_write_be(out + 96, a.y.c1);
}
static bool g2_read(G2& out, const uint8_t in[128]) {
  if (!fp_read_be(out.x.c0, in) || !fp_read_be(out.x.c1, in + 32) ||
      !fp_read_be(out.y.c0, in + 64) || !fp_read_be(out.y.c1, in + 96))
    return false;
  out.inf = f2_is_zero(out.x) && f2_is_zero(out.y);
  if (out.inf) return false;
  // on-curve: y^2 == x^3 + b2
  Fp2 x2, x3, rhs, y2;
  f2_sqr(x2, out.x);
  f2_mul(x3, x2, out.x);
  f2_add(rhs, x3, B2_MONT);
  f2_sqr(y2, out.y);
  return f2_eq(y2, rhs);
}

// ---------------------------------------------------------------------------
// init
// ---------------------------------------------------------------------------

static bool INITED = false;

static void write_exp_be(uint8_t* out, const u64 limbs[4]) {
  limbs_to_be(out, limbs);
}

static void bls_init() {
  if (INITED) return;
  // Montgomery 1 = R1
  std::memcpy(FP_ONE.l, R1, sizeof R1);
  fp_add(FP_TWO, FP_ONE, FP_ONE);
  fp_add(FP_THREE, FP_TWO, FP_ONE);
  FP_B3 = FP_THREE;  // curve b = 3
  // exponents
  u64 t[4];
  std::memcpy(t, P, sizeof t);
  write_exp_be(EXP_P, t);
  u64 two[4] = {2, 0, 0, 0};
  sub4(t, P, two);
  write_exp_be(EXP_PM2, t);
  // (p+1)/4: p+1 then >>2 (p+1 cannot carry out of 254 bits)
  u64 pp1[4];
  u64 one4[4] = {1, 0, 0, 0};
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)P[i] + one4[i] + (u64)carry;
    pp1[i] = (u64)s;
    carry = s >> 64;
  }
  for (int i = 0; i < 4; ++i) {
    u64 lo = pp1[i] >> 2;
    u64 hi = (i < 3) ? (pp1[i + 1] & 3) << 62 : 0;
    pp1[i] = lo | hi;
  }
  write_exp_be(EXP_SQRT, pp1);
  // zero / one of Fp12
  std::memset(&F12_ZERO_, 0, sizeof F12_ZERO_);
  F12_ONE_ = F12_ZERO_;
  F12_ONE_.c0.c0.c0 = FP_ONE;
  // xi = 9 + u (Montgomery) — only needed to seed the Frobenius powers
  Fp2 xi;
  u64 nine[4] = {9, 0, 0, 0};
  fp_from_canonical(xi.c0, nine);
  xi.c1 = FP_ONE;
  // Frobenius constants: GW = xi^((p-1)/6) (exact: p = 1 mod 6) and its
  // powers 2..5 cover both the twist endomorphism and the Fp12 Frobenius
  {
    u64 pm1[4], one4b[4] = {1, 0, 0, 0};
    sub4(pm1, P, one4b);
    u64 sixth[4];
    u128 rem = 0;
    for (int i = 3; i >= 0; --i) {
      u128 cur = (rem << 64) | pm1[i];
      sixth[i] = (u64)(cur / 6);
      rem = cur % 6;
    }
    uint8_t ebytes[32];
    write_exp_be(ebytes, sixth);
    f2_pow_be(FROB_GW, xi, ebytes, 32);
    f2_mul(GAMMA12, FROB_GW, FROB_GW);
    f2_mul(GAMMA13, GAMMA12, FROB_GW);
    f2_mul(FROB_G2, GAMMA13, FROB_GW);
    f2_mul(FROB_GW2, FROB_G2, FROB_GW);
  }
  // ate bits length
  ATE_NBITS = 0;
  while (ATE_NAF[ATE_NBITS]) ++ATE_NBITS;
  BN_U_NBITS = 0;
  while (BN_U_BITS[BN_U_NBITS]) ++BN_U_NBITS;
  // generators
  u64 g1x[4] = {1, 0, 0, 0}, g1y[4] = {2, 0, 0, 0};
  fp_from_canonical(G1_GEN.x, g1x);
  fp_from_canonical(G1_GEN.y, g1y);
  G1_GEN.inf = false;
  fp_from_canonical(G2_GEN.x.c0, G2X0);
  fp_from_canonical(G2_GEN.x.c1, G2X1);
  fp_from_canonical(G2_GEN.y.c0, G2Y0);
  fp_from_canonical(G2_GEN.y.c1, G2Y1);
  G2_GEN.inf = false;
  fp_from_canonical(B2_MONT.c0, B2C0);
  fp_from_canonical(B2_MONT.c1, B2C1);
  // precompute the G2-generator Miller line table: every signature
  // verification pairs against the same fixed G2 point, so the whole
  // Jacobian ladder for that side runs ONCE here and each verify replays
  // stored line coefficients (scaled by the G1 point at apply time)
  gen_table_init();
  six_u2_naf_init();
  INITED = true;
}

// ---------------------------------------------------------------------------
// public C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Returns 0 on success. Deterministic from seed.
int bls_keygen(const uint8_t seed[32], uint8_t out_sk[32],
               uint8_t out_pk[128]) {
  bls_init();
  uint8_t buf[33];
  std::memcpy(buf, seed, 32);
  uint8_t sk[32];
  u64 limbs[4];
  for (int ctr = 0;; ++ctr) {
    if (ctr > 255) return 1;
    buf[32] = (uint8_t)ctr;
    sha256(sk, buf, 33);
    be_to_limbs(limbs, sk);
    bool zero = (limbs[0] | limbs[1] | limbs[2] | limbs[3]) == 0;
    if (!zero && cmp4(limbs, ORDER) < 0) break;
  }
  std::memcpy(out_sk, sk, 32);
  G2 pk;
  g2_mul_be(pk, G2_GEN, sk, 32);
  if (pk.inf) return 1;
  g2_write(out_pk, pk);
  return 0;
}

int bls_sign(const uint8_t sk[32], const uint8_t* msg, long long len,
             uint8_t out_sig[64]) {
  bls_init();
  u64 limbs[4];
  be_to_limbs(limbs, sk);
  bool zero = (limbs[0] | limbs[1] | limbs[2] | limbs[3]) == 0;
  if (zero || cmp4(limbs, ORDER) >= 0) return 1;
  G1 h, sig;
  hash_to_g1(h, msg, len);
  g1_mul_be(sig, h, sk, 32);
  if (sig.inf) return 1;
  g1_write(out_sig, sig);
  return 0;
}

// Returns 1 if valid, 0 if invalid, negative on malformed input.
int bls_verify(const uint8_t pk_bytes[128], const uint8_t* msg, long long len,
               const uint8_t sig_bytes[64]) {
  bls_init();
  G2 pk;
  G1 sig;
  if (!g2_read(pk, pk_bytes)) return -1;
  if (!g1_read(sig, sig_bytes)) return -2;
  if (!g2_in_subgroup(pk)) return -3;  // psi eigenvalue test (fast)
  G1 h;
  hash_to_g1(h, msg, len);
  // e(sig, G2gen) == e(H(m), pk)
  // <=> finalexp( miller(G2gen, sig) * miller(-pk, H(m)) ) == 1
  G2 npk = pk;
  f2_neg(npk.y, pk.y);
  // ONE fused Miller loop for both pairs (shared squaring chain; the
  // generator side replays the precomputed line table) and one final exp
  Fp12 f = F12_ONE_, out;
  miller_dual(f, GEN_TABLE, sig, npk, h);
  final_exp(out, f);
  return f12_eq(out, F12_ONE_) ? 1 : 0;
}

// bls_verify with the per-public-key line-table cache: same result and
// error codes for any input. A cache hit skips the pk-side Jacobian
// ladder AND the parse/on-curve/subgroup checks (the key is the exact
// 128-byte encoding, which was fully validated before insert); a miss
// validates, records the pk's ladder once (the recording walk replaces
// the live ladder, so a cold verify costs ~a plain one), and caches the
// table for the next connector with this key.
int bls_verify_cached(const uint8_t pk_bytes[128], const uint8_t* msg,
                      long long len, const uint8_t sig_bytes[64]) {
  bls_init();
  bool disabled;
  {
    std::lock_guard<std::mutex> g(PK_MUTEX);
    disabled = PK_CACHE_CAP == 0;
  }
  if (disabled)  // plain path, no recording overhead — and no lock held
    return bls_verify(pk_bytes, msg, len, sig_bytes);
  std::shared_ptr<PkTable> tab = pk_cache_lookup(pk_bytes);
  G2 pk;
  if (!tab && !g2_read(pk, pk_bytes)) return -1;
  G1 sig;
  if (!g1_read(sig, sig_bytes)) return -2;
  if (!tab) {
    if (!g2_in_subgroup(pk)) return -3;
    G2 npk = pk;
    f2_neg(npk.y, pk.y);
    auto built = std::make_shared<PkTable>();
    if (!record_pk_table(npk, *built))  // vertical (unreachable in-subgroup)
      return bls_verify(pk_bytes, msg, len, sig_bytes);
    pk_cache_insert(pk_bytes, built);
    tab = built;
  }
  G1 h;
  hash_to_g1(h, msg, len);
  const PkTable* tabs[1] = {tab.get()};
  Fp12 f = F12_ONE_, out;
  miller_multi_tab(f, GEN_TABLE, sig, tabs, &h, 1);
  final_exp(out, f);
  return f12_eq(out, F12_ONE_) ? 1 : 0;
}

// Batch verification via random linear combination (the connection-storm
// path): with per-item 128-bit random weights r_i drawn from the caller's
// seed,  prod_i e(sig_i, G2)^{r_i} == prod_i e(H_i, pk_i)^{r_i}  checks as
//   finalexp( miller(G2gen, sum_i [r_i] sig_i)
//             * prod_i miller(-pk_i, [r_i] H_i) ) == 1
// — ONE shared final exponentiation and one generator-side Miller loop
// regardless of n, plus one Miller loop + fast subgroup check per ITEM
// (no public-key dedup is attempted). A forged item fails with
// probability 1 - 2^-128 (standard small-exponent batching argument).
// Layout: pks = n*128 bytes, sigs = n*64 bytes, msgs/lens per item.
// Returns 1 if the whole batch verifies, 0 if not, negative on malformed.
int bls_verify_batch(int n, const uint8_t* pks, const uint8_t* const* msgs,
                     const long long* lens, const uint8_t* sigs,
                     const uint8_t seed[32]) {
  bls_init();
  if (n <= 0) return -4;
  G1 sig_acc;
  sig_acc.inf = true;
  Fp12 f = F12_ONE_;
  uint8_t rbuf[36];
  std::memcpy(rbuf, seed, 32);
  for (int i = 0; i < n; ++i) {
    G2 pk;
    G1 sig;
    if (!g2_read(pk, pks + (size_t)i * 128)) return -1;
    if (!g1_read(sig, sigs + (size_t)i * 64)) return -2;
    if (!g2_in_subgroup(pk)) return -3;
    // r_i = 16 bytes of sha256(seed || i), forced nonzero
    rbuf[32] = (uint8_t)(i >> 24);
    rbuf[33] = (uint8_t)(i >> 16);
    rbuf[34] = (uint8_t)(i >> 8);
    rbuf[35] = (uint8_t)i;
    uint8_t ri[32];
    sha256(ri, rbuf, 36);
    ri[15] |= 1;
    G1 rsig, h, rh;
    g1_mul_be(rsig, sig, ri, 16);
    g1_add(sig_acc, sig_acc, rsig);
    hash_to_g1(h, msgs[i], lens[i]);
    g1_mul_be(rh, h, ri, 16);
    G2 npk = pk;
    f2_neg(npk.y, pk.y);
    Fp12 fi = F12_ONE_;
    miller(fi, npk, rh);
    f12_mul(f, f, fi);
  }
  Fp12 fg = F12_ONE_, out;
  miller_pretab(fg, GEN_TABLE, GEN_TABLE_LEN, sig_acc);
  f12_mul(f, f, fg);
  final_exp(out, f);
  return f12_eq(out, F12_ONE_) ? 1 : 0;
}

// bls_verify_batch with per-pk line tables: identical semantics, but the
// per-item pk-side Miller loops become table replays fused — together
// with the generator side — on ONE shared squaring chain (one f12_sqr
// per ate bit for the WHOLE batch, vs one full Miller loop per item).
// Tables are pinned by shared_ptr for the walk, so mid-batch LRU
// eviction (capacity < batch size) cannot free a table in use.
int bls_verify_batch_cached(int n, const uint8_t* pks,
                            const uint8_t* const* msgs,
                            const long long* lens, const uint8_t* sigs,
                            const uint8_t seed[32]) {
  bls_init();
  if (n <= 0) return -4;
  bool disabled;
  {
    std::lock_guard<std::mutex> g(PK_MUTEX);
    disabled = PK_CACHE_CAP == 0;
  }
  if (disabled)
    return bls_verify_batch(n, pks, msgs, lens, sigs, seed);
  G1 sig_acc;
  sig_acc.inf = true;
  std::vector<std::shared_ptr<PkTable>> tabs((size_t)n);
  std::vector<const PkTable*> tab_ptrs((size_t)n);
  std::vector<G1> rhs((size_t)n);
  uint8_t rbuf[36];
  std::memcpy(rbuf, seed, 32);
  for (int i = 0; i < n; ++i) {
    const uint8_t* pkb = pks + (size_t)i * 128;
    std::shared_ptr<PkTable> tab = pk_cache_lookup(pkb);
    G2 pk;
    if (!tab && !g2_read(pk, pkb)) return -1;
    G1 sig;
    if (!g1_read(sig, sigs + (size_t)i * 64)) return -2;
    if (!tab) {
      if (!g2_in_subgroup(pk)) return -3;
      G2 npk = pk;
      f2_neg(npk.y, pk.y);
      auto built = std::make_shared<PkTable>();
      if (!record_pk_table(npk, *built))
        return bls_verify_batch(n, pks, msgs, lens, sigs, seed);
      pk_cache_insert(pkb, built);
      tab = built;
    }
    rbuf[32] = (uint8_t)(i >> 24);
    rbuf[33] = (uint8_t)(i >> 16);
    rbuf[34] = (uint8_t)(i >> 8);
    rbuf[35] = (uint8_t)i;
    uint8_t ri[32];
    sha256(ri, rbuf, 36);
    ri[15] |= 1;
    G1 rsig, h;
    g1_mul_be(rsig, sig, ri, 16);
    g1_add(sig_acc, sig_acc, rsig);
    hash_to_g1(h, msgs[i], lens[i]);
    g1_mul_be(rhs[(size_t)i], h, ri, 16);
    tabs[(size_t)i] = std::move(tab);
    tab_ptrs[(size_t)i] = tabs[(size_t)i].get();
  }
  Fp12 f = F12_ONE_, out;
  miller_multi_tab(f, GEN_TABLE, sig_acc, tab_ptrs.data(), rhs.data(), n);
  final_exp(out, f);
  return f12_eq(out, F12_ONE_) ? 1 : 0;
}

// Cache observability/control. stats: {hits, misses, evictions, current
// entries, capacity, resident table bytes}.
void bls_pk_cache_stats(u64 out[6]) {
  std::lock_guard<std::mutex> g(PK_MUTEX);
  out[0] = PK_HITS;
  out[1] = PK_MISSES;
  out[2] = PK_EVICTIONS;
  out[3] = (u64)PK_MAP.size();
  out[4] = (u64)PK_CACHE_CAP;
  u64 bytes = 0;
  for (const auto& kv : PK_MAP)
    bytes += (u64)kv.second.first->len * sizeof(SparseLine);
  out[5] = bytes;
}

int bls_pk_cache_configure(long long capacity) {
  if (capacity < 0) return -1;
  std::lock_guard<std::mutex> g(PK_MUTEX);
  PK_CACHE_CAP = (size_t)capacity;
  while (PK_MAP.size() > PK_CACHE_CAP && !PK_LRU.empty()) {
    PK_MAP.erase(PK_LRU.back());
    PK_LRU.pop_back();
    ++PK_EVICTIONS;
  }
  return 0;
}

void bls_pk_cache_clear(void) {
  std::lock_guard<std::mutex> g(PK_MUTEX);
  PK_MAP.clear();
  PK_LRU.clear();
  PK_HITS = PK_MISSES = PK_EVICTIONS = 0;
}

// Bilinearity + scheme self-test; returns 0 if everything holds.
int bls_self_test(void) {
  bls_init();
  // the no-carry multiply and the dedicated squaring must agree with the
  // generic CIOS reference on a long chained sweep (catches any carry or
  // bound slip in the unrolled paths)
  {
    Fp a = FP_THREE, b = FP_TWO, r_fast, r_ref, s_fast;
    for (int i = 0; i < 20000; ++i) {
      fp_mul(r_fast, a, b);
      fp_mul_cios(r_ref, a, b);
      if (!fp_eq(r_fast, r_ref)) return 19;
      fp_sqr(s_fast, a);
      fp_mul_cios(r_ref, a, a);
      if (!fp_eq(s_fast, r_ref)) return 20;
      fp_sqr_ref(s_fast, a);  // keep the dedicated square honest too
      if (!fp_eq(s_fast, r_ref)) return 21;
      a = r_fast;
      fp_add(b, b, FP_ONE);
    }
  }
  // e(G2, G1) != 1
  Fp12 f = F12_ONE_, e1;
  miller(f, G2_GEN, G1_GEN);
  final_exp(e1, f);
  if (f12_eq(e1, F12_ONE_)) return 1;
  // the fast (addition-chain) final exponentiation must agree with the
  // generated-exponent slow path on a live Miller value
  {
    Fp12 slow;
    final_exp_slow(slow, f);
    if (!f12_eq(e1, slow)) return 9;
  }
  // the w2-NAF exp-by-u ladder agrees with plain square-and-multiply on
  // a live cyclotomic element
  {
    if (BN_U_W2NAF[0] != '1') return 22;
    Fp12 pw, pw_ref;
    f12_pow_u(pw, e1);
    f12_pow_u_bits(pw_ref, e1);
    if (!f12_eq(pw, pw_ref)) return 23;
  }
  // cyclotomic squaring agrees with the dense square on a cyclotomic
  // element (the pairing output e1)
  {
    Fp12 a, b;
    f12_sqr(a, e1);
    f12_sqr_cyc(b, e1);
    if (!f12_eq(a, b)) return 16;
  }
  // the precomputed generator line table must reproduce the plain loop
  {
    Fp12 ft = F12_ONE_, et;
    miller_pretab(ft, GEN_TABLE, GEN_TABLE_LEN, G1_GEN);
    final_exp(et, ft);
    if (!f12_eq(et, e1)) return 10;
    // and the fused dual loop must equal the product of separate loops
    uint8_t k2 = 2, k3 = 3;
    G2 Q2; G1 P3;
    g2_mul_be(Q2, G2_GEN, &k2, 1);
    g1_mul_be(P3, G1_GEN, &k3, 1);
    Fp12 fd = F12_ONE_, ed;
    miller_dual(fd, GEN_TABLE, G1_GEN, Q2, P3);
    final_exp(ed, fd);
    Fp12 fa = F12_ONE_, fb = F12_ONE_, fab, eab;
    miller(fa, G2_GEN, G1_GEN);
    miller(fb, Q2, P3);
    f12_mul(fab, fa, fb);
    final_exp(eab, fab);
    if (!f12_eq(ed, eab)) return 17;
  }
  // psi acts as multiplication by 6u^2 on G2 (the fast membership test's
  // eigenvalue identity), and the generator passes the test
  {
    G2 lhs, rhs, rhs_naf;
    g2_psi(lhs, G2_GEN);
    g2_mul_be(rhs, G2_GEN, SIX_U2, SIX_U2_LEN);
    if (!g2_eq_pt(lhs, rhs)) return 11;
    g2_mul_six_u2(rhs_naf, G2_GEN);
    if (!g2_eq_pt(rhs, rhs_naf)) return 18;
    if (!g2_in_subgroup(G2_GEN)) return 12;
  }
  // coefficient Frobenius must agree with the generic x^p power
  Fp12 fr1, fr2;
  f12_frob(fr1, e1);
  f12_pow_be(fr2, e1, EXP_P, 32);
  if (!f12_eq(fr1, fr2)) return 8;
  // e(aG2, bG1) == e(G2, G1)^(ab) with a=3, b=5
  uint8_t a1 = 3, b1 = 5;
  G2 aQ;
  G1 bP;
  g2_mul_be(aQ, G2_GEN, &a1, 1);
  g1_mul_be(bP, G1_GEN, &b1, 1);
  f = F12_ONE_;
  Fp12 e2;
  miller(f, aQ, bP);
  final_exp(e2, f);
  uint8_t ab = 15;
  Fp12 e1ab;
  f12_pow_be(e1ab, e1, &ab, 1);
  if (!f12_eq(e2, e1ab)) return 2;
  // keygen/sign/verify round trip
  uint8_t seed[32] = {42};
  uint8_t sk[32], pk[128], sig[64];
  if (bls_keygen(seed, sk, pk) != 0) return 3;
  const uint8_t msg[] = "pushcdn-tpu self test";
  if (bls_sign(sk, msg, sizeof msg, sig) != 0) return 4;
  if (bls_verify(pk, msg, sizeof msg, sig) != 1) return 5;
  // tampered message must fail
  const uint8_t msg2[] = "pushcdn-tpu self tesT";
  if (bls_verify(pk, msg2, sizeof msg2, sig) != 0) return 6;
  // tampered signature must fail (flip a bit, may also be off-curve)
  sig[5] ^= 1;
  if (bls_verify(pk, msg, sizeof msg, sig) == 1) return 7;
  sig[5] ^= 1;  // restore for the batch test
  // batch verification: two honest items pass; a swapped signature fails
  {
    uint8_t seed2[32] = {7};
    uint8_t sk2[32], pk2[128], sig2[64];
    if (bls_keygen(seed2, sk2, pk2) != 0) return 13;
    const uint8_t msg2b[] = "second message";
    if (bls_sign(sk2, msg2b, sizeof msg2b, sig2) != 0) return 13;
    uint8_t pks[256], sigs[128];
    std::memcpy(pks, pk, 128);
    std::memcpy(pks + 128, pk2, 128);
    std::memcpy(sigs, sig, 64);
    std::memcpy(sigs + 64, sig2, 64);
    const uint8_t* msgs[2] = {msg, msg2b};
    long long lens[2] = {sizeof msg, sizeof msg2b};
    uint8_t bseed[32] = {99};
    if (bls_verify_batch(2, pks, msgs, lens, sigs, bseed) != 1) return 14;
    // cross the signatures: the batch must reject
    std::memcpy(sigs, sig2, 64);
    std::memcpy(sigs + 64, sig, 64);
    if (bls_verify_batch(2, pks, msgs, lens, sigs, bseed) == 1) return 15;
  }
  // per-pk line-table cache: cached and plain verification must agree —
  // accept/reject/error-code — cold (miss), warm (hit), and across an
  // LRU evict/repopulate cycle at capacity 2 with 3 keys
  {
    u64 st0[6], st1[6];
    bls_pk_cache_stats(st0);
    const u64 saved_cap = st0[4];
    bls_pk_cache_clear();
    bls_pk_cache_configure(2);
    uint8_t cks[3][32], ckp[3][128], csig[3][64];
    const uint8_t cmsg[] = "cache agreement probe";
    for (int i = 0; i < 3; ++i) {
      uint8_t cseed[32] = {(uint8_t)(120 + i)};
      if (bls_keygen(cseed, cks[i], ckp[i]) != 0) return 24;
      if (bls_sign(cks[i], cmsg, sizeof cmsg, csig[i]) != 0) return 24;
    }
    for (int i = 0; i < 3; ++i) {      // miss then hit, each == plain
      for (int rep = 0; rep < 2; ++rep)
        if (bls_verify_cached(ckp[i], cmsg, sizeof cmsg, csig[i]) !=
            bls_verify(ckp[i], cmsg, sizeof cmsg, csig[i]) ||
            bls_verify_cached(ckp[i], cmsg, sizeof cmsg, csig[i]) != 1)
          return 25;
    }
    bls_pk_cache_stats(st1);
    if (st1[2] < 1 || st1[3] != 2) return 26;  // key 0 was evicted at cap 2
    // repopulate the evicted key: must agree with plain again
    if (bls_verify_cached(ckp[0], cmsg, sizeof cmsg, csig[0]) != 1) return 27;
    // warm-path rejections: tampered message / crossed signature
    const uint8_t cmsg2[] = "cache agreement probE";
    if (bls_verify_cached(ckp[0], cmsg2, sizeof cmsg2, csig[0]) != 0)
      return 28;
    if (bls_verify_cached(ckp[0], cmsg, sizeof cmsg, csig[1]) != 0) return 28;
    // malformed inputs keep plain error codes on hit and miss paths
    uint8_t badsig[64];
    std::memset(badsig, 0xff, sizeof badsig);
    if (bls_verify_cached(ckp[0], cmsg, sizeof cmsg, badsig) !=
        bls_verify(ckp[0], cmsg, sizeof cmsg, badsig))
      return 29;
    // cached batch: honest pair passes, crossed pair rejects — with the
    // warm tables AND after a clear (cold tables), matching the plain
    // batch on both
    {
      uint8_t pks2[256], sigs2[128];
      std::memcpy(pks2, ckp[0], 128);
      std::memcpy(pks2 + 128, ckp[1], 128);
      const uint8_t* msgs2[2] = {cmsg, cmsg};
      long long lens2[2] = {sizeof cmsg, sizeof cmsg};
      uint8_t bseed2[32] = {123};
      for (int round = 0; round < 2; ++round) {
        std::memcpy(sigs2, csig[0], 64);
        std::memcpy(sigs2 + 64, csig[1], 64);
        if (bls_verify_batch_cached(2, pks2, msgs2, lens2, sigs2, bseed2)
            != 1)
          return 30;
        std::memcpy(sigs2, csig[1], 64);
        std::memcpy(sigs2 + 64, csig[0], 64);
        if (bls_verify_batch_cached(2, pks2, msgs2, lens2, sigs2, bseed2)
            != 0)
          return 31;
        bls_pk_cache_clear();  // round 2 runs cold
      }
    }
    bls_pk_cache_clear();
    bls_pk_cache_configure((long long)saved_cap);
  }
  return 0;
}

}  // extern "C"
