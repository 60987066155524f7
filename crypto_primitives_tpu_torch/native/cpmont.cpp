// Native host-side field / curve / Poseidon engine of the PyTorch port.
//
// The port's own copy of the JAX package's crypto_primitives_tpu/native/
// cpmont.cpp (the reference gets its native, non-circuit paths from compiled
// Rust: ark-ff/ark-ec Montgomery backends, e.g.
// crypto-primitives/src/signature/schnorr/mod.rs:77-148).  It provides:
//   * N-limb (N = 4 or 6 -> <=256 / <=384-bit moduli) Montgomery CIOS
//     arithmetic with __int128 carries,
//   * twisted-Edwards extended-coordinate unified addition (HWCD complete
//     law, the same branch-free formulas as ops/curve.py te_add),
//   * short-Weierstrass complete projective addition (Renes-Costello-
//     Batina Alg. 1, same as ops/curve_sw.py sw_add; infinity = (0:1:0)),
//   * scalar multiplication / bit-table MSMs over both models,
//   * the Poseidon permutation, batched two-to-one compression, and full
//     Merkle level builds.
// The port calls it only by name (native/engine.py), as a compiled third
// implementation beside the python-int host tier and the batched tier.
//
// Pure C ABI, loaded via ctypes.  All values are little-endian N x u64
// limbs in Montgomery form (R = 2^(64 N)) unless noted; the Python side
// precomputes -p^-1 mod 2^64.

#include <cstdint>
#include <cstring>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint8_t u8;

namespace {

template <int N>
struct FieldCtx {
  u64 p[N];
  u64 one[N];       // R mod p (Montgomery 1)
  u64 pminus2[N];   // exponent for Fermat inversion
  u64 n0;           // -p^{-1} mod 2^64
};

template <int N>
inline bool geq(const u64 a[N], const u64 b[N]) {
  for (int i = N - 1; i >= 0; --i) {
    if (a[i] > b[i]) return true;
    if (a[i] < b[i]) return false;
  }
  return true;  // equal
}

template <int N>
inline void sub_limbs(u64 a[N], const u64 b[N]) {
  u128 borrow = 0;
  for (int i = 0; i < N; ++i) {
    u128 d = (u128)a[i] - b[i] - borrow;
    a[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

template <int N>
inline void add_mod(const FieldCtx<N>* c, const u64 a[N], const u64 b[N],
                    u64 out[N]) {
  u128 carry = 0;
  for (int i = 0; i < N; ++i) {
    u128 s = (u128)a[i] + b[i] + carry;
    out[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || geq<N>(out, c->p)) sub_limbs<N>(out, c->p);
}

template <int N>
inline void sub_mod(const FieldCtx<N>* c, const u64 a[N], const u64 b[N],
                    u64 out[N]) {
  u64 t[N];
  std::memcpy(t, a, N * 8);
  u128 borrow = 0;
  for (int i = 0; i < N; ++i) {
    u128 d = (u128)t[i] - b[i] - borrow;
    t[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) {  // add p back
    u128 carry = 0;
    for (int i = 0; i < N; ++i) {
      u128 s = (u128)t[i] + c->p[i] + carry;
      t[i] = (u64)s;
      carry = s >> 64;
    }
  }
  std::memcpy(out, t, N * 8);
}

// CIOS Montgomery multiplication (Acar et al.)
template <int N>
inline void mont_mul(const FieldCtx<N>* c, const u64 a[N], const u64 b[N],
                     u64 out[N]) {
  u64 t[N + 2];
  std::memset(t, 0, sizeof(t));
  for (int i = 0; i < N; ++i) {
    u128 carry = 0;
    for (int j = 0; j < N; ++j) {
      u128 cur = (u128)t[j] + (u128)a[j] * b[i] + carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[N] + carry;
    t[N] = (u64)cur;
    t[N + 1] = (u64)(cur >> 64);

    u64 m = t[0] * c->n0;
    carry = ((u128)t[0] + (u128)m * c->p[0]) >> 64;
    for (int j = 1; j < N; ++j) {
      u128 cur2 = (u128)t[j] + (u128)m * c->p[j] + carry;
      t[j - 1] = (u64)cur2;
      carry = cur2 >> 64;
    }
    u128 cur3 = (u128)t[N] + carry;
    t[N - 1] = (u64)cur3;
    t[N] = t[N + 1] + (u64)(cur3 >> 64);
  }
  std::memcpy(out, t, N * 8);
  if (t[N] || geq<N>(out, c->p)) sub_limbs<N>(out, c->p);
}

// Montgomery pow with an N-limb exponent (MSB-first square-and-multiply).
template <int N>
inline void mont_pow(const FieldCtx<N>* c, const u64 base[N], const u64 e[N],
                     u64 out[N]) {
  u64 acc[N];
  std::memcpy(acc, c->one, N * 8);
  bool started = false;
  for (int limb = N - 1; limb >= 0; --limb) {
    for (int bit = 63; bit >= 0; --bit) {
      if (started) mont_mul<N>(c, acc, acc, acc);
      if ((e[limb] >> bit) & 1) {
        if (started) {
          mont_mul<N>(c, acc, base, acc);
        } else {
          std::memcpy(acc, base, N * 8);
          started = true;
        }
      }
    }
  }
  std::memcpy(out, acc, N * 8);
}

template <int N>
inline void mont_pow_u64(const FieldCtx<N>* c, const u64 base[N], u64 e,
                         u64 out[N]) {
  u64 el[N];
  std::memset(el, 0, sizeof(el));
  el[0] = e;
  mont_pow<N>(c, base, el, out);
}

template <int N>
inline void mont_inv(const FieldCtx<N>* c, const u64 a[N], u64 out[N]) {
  mont_pow<N>(c, a, c->pminus2, out);
}

// ----------------------------------------------------------------------
// Twisted-Edwards extended coordinates (X, Y, T, Z), unified HWCD addition
// — complete for a square / d nonsquare (same law as ops/curve.py te_add).
// ----------------------------------------------------------------------

template <int N>
struct TECtx {
  FieldCtx<N> f;
  u64 a[N], d[N];  // Montgomery curve constants
};

template <int N>
inline void te_identity(const TECtx<N>* tc, u64 pt[4 * N]) {
  std::memset(pt, 0, 4 * N * 8);
  std::memcpy(pt + N, tc->f.one, N * 8);      // Y = 1
  std::memcpy(pt + 3 * N, tc->f.one, N * 8);  // Z = 1
}

template <int N>
inline void te_add(const TECtx<N>* tc, const u64 p1[4 * N], const u64 p2[4 * N],
                   u64 out[4 * N]) {
  const FieldCtx<N>* c = &tc->f;
  const u64 *X1 = p1, *Y1 = p1 + N, *T1 = p1 + 2 * N, *Z1 = p1 + 3 * N;
  const u64 *X2 = p2, *Y2 = p2 + N, *T2 = p2 + 2 * N, *Z2 = p2 + 3 * N;
  u64 A[N], B[N], TT[N], D[N], S[N], s1[N], s2[N], C[N], aA[N];
  u64 E[N], F[N], G[N], H[N];
  mont_mul<N>(c, X1, X2, A);
  mont_mul<N>(c, Y1, Y2, B);
  mont_mul<N>(c, T1, T2, TT);
  mont_mul<N>(c, Z1, Z2, D);
  add_mod<N>(c, X1, Y1, s1);
  add_mod<N>(c, X2, Y2, s2);
  mont_mul<N>(c, s1, s2, S);
  mont_mul<N>(c, tc->d, TT, C);
  mont_mul<N>(c, tc->a, A, aA);
  sub_mod<N>(c, S, A, E);
  sub_mod<N>(c, E, B, E);
  sub_mod<N>(c, D, C, F);
  add_mod<N>(c, D, C, G);
  sub_mod<N>(c, B, aA, H);
  mont_mul<N>(c, E, F, out);              // X3
  mont_mul<N>(c, G, H, out + N);          // Y3
  mont_mul<N>(c, E, H, out + 2 * N);      // T3
  mont_mul<N>(c, F, G, out + 3 * N);      // Z3
}

// scalar mul: bits LSB-first (one byte per bit), branch on host (no
// side-channel hardening needed: this is a test/proof-generation tier).
template <int N>
inline void te_scalar_mul(const TECtx<N>* tc, const u64 base[4 * N],
                          const u8* bits, long nbits, u64 out[4 * N]) {
  u64 acc[4 * N], dbl[4 * N];
  te_identity<N>(tc, acc);
  std::memcpy(dbl, base, 4 * N * 8);
  for (long i = 0; i < nbits; ++i) {
    if (bits[i]) te_add<N>(tc, acc, dbl, acc);
    if (i + 1 < nbits) te_add<N>(tc, dbl, dbl, dbl);
  }
  std::memcpy(out, acc, 4 * N * 8);
}

// conditional sum over a precomputed table: out = sum_i bits[i] * table[i]
// (the Pedersen fixed-base MSM, crh/pedersen/mod.rs:113-124 shape).
template <int N>
inline void te_msm_bits(const TECtx<N>* tc, const u64* table, const u8* bits,
                        long nbits, u64 out[4 * N]) {
  u64 acc[4 * N];
  te_identity<N>(tc, acc);
  for (long i = 0; i < nbits; ++i)
    if (bits[i]) te_add<N>(tc, acc, table + (size_t)i * 4 * N, acc);
  std::memcpy(out, acc, 4 * N * 8);
}

template <int N>
inline void te_to_affine(const TECtx<N>* tc, const u64 pt[4 * N],
                         u64 xy[2 * N]) {
  u64 zi[N];
  mont_inv<N>(&tc->f, pt + 3 * N, zi);
  mont_mul<N>(&tc->f, pt, zi, xy);
  mont_mul<N>(&tc->f, pt + N, zi, xy + N);
}

// ----------------------------------------------------------------------
// Short-Weierstrass projective (X, Y, Z), RCB complete addition
// (eprint 2015/1060 Alg. 1, arbitrary a — same as ops/curve_sw.py sw_add).
// Infinity is (0 : 1 : 0).
// ----------------------------------------------------------------------

template <int N>
struct SWCtx {
  FieldCtx<N> f;
  u64 a[N], b3[N], a2[N];  // Montgomery a, 3b, a^2
};

template <int N>
inline void sw_identity(const SWCtx<N>* sc, u64 pt[3 * N]) {
  std::memset(pt, 0, 3 * N * 8);
  std::memcpy(pt + N, sc->f.one, N * 8);  // (0 : 1 : 0)
}

template <int N>
inline void sw_add(const SWCtx<N>* sc, const u64 p1[3 * N], const u64 p2[3 * N],
                   u64 out[3 * N]) {
  const FieldCtx<N>* c = &sc->f;
  const u64 *X1 = p1, *Y1 = p1 + N, *Z1 = p1 + 2 * N;
  const u64 *X2 = p2, *Y2 = p2 + N, *Z2 = p2 + 2 * N;
  u64 m0[N], m1[N], m2[N], A[N], B[N], C[N], t[N], u[N];
  u64 sxy[N], sxz[N], syz[N];
  mont_mul<N>(c, X1, X2, m0);
  mont_mul<N>(c, Y1, Y2, m1);
  mont_mul<N>(c, Z1, Z2, m2);
  add_mod<N>(c, X1, Y1, t); add_mod<N>(c, X2, Y2, u); mont_mul<N>(c, t, u, A);
  add_mod<N>(c, X1, Z1, t); add_mod<N>(c, X2, Z2, u); mont_mul<N>(c, t, u, B);
  add_mod<N>(c, Y1, Z1, t); add_mod<N>(c, Y2, Z2, u); mont_mul<N>(c, t, u, C);
  sub_mod<N>(c, A, m0, sxy); sub_mod<N>(c, sxy, m1, sxy);  // X1Y2+X2Y1
  sub_mod<N>(c, B, m0, sxz); sub_mod<N>(c, sxz, m2, sxz);  // X1Z2+X2Z1
  sub_mod<N>(c, C, m1, syz); sub_mod<N>(c, syz, m2, syz);  // Y1Z2+Y2Z1
  u64 a_sxz[N], b3_m2[N], a_m2[N], b3_sxz[N], a_m0[N], a2_m2[N];
  mont_mul<N>(c, sc->a, sxz, a_sxz);
  mont_mul<N>(c, sc->b3, m2, b3_m2);
  mont_mul<N>(c, sc->a, m2, a_m2);
  mont_mul<N>(c, sc->b3, sxz, b3_sxz);
  mont_mul<N>(c, sc->a, m0, a_m0);
  mont_mul<N>(c, sc->a2, m2, a2_m2);
  u64 Zp[N], U[N], V[N], t1p[N], t4p[N];
  add_mod<N>(c, b3_m2, a_sxz, Zp);
  sub_mod<N>(c, m1, Zp, U);
  add_mod<N>(c, m1, Zp, V);
  add_mod<N>(c, m0, m0, t1p); add_mod<N>(c, t1p, m0, t1p);
  add_mod<N>(c, t1p, a_m2, t1p);                     // 3*t0 + a*t2
  sub_mod<N>(c, a_m0, a2_m2, t4p);
  add_mod<N>(c, b3_sxz, t4p, t4p);                   // b3*t4 + a*(t0 - a*t2)
  u64 r0[N], r1[N];
  mont_mul<N>(c, U, V, r0); mont_mul<N>(c, t1p, t4p, r1);
  u64 Y3[N]; add_mod<N>(c, r0, r1, Y3);
  mont_mul<N>(c, sxy, U, r0); mont_mul<N>(c, syz, t4p, r1);
  u64 X3[N]; sub_mod<N>(c, r0, r1, X3);
  mont_mul<N>(c, syz, V, r0); mont_mul<N>(c, sxy, t1p, r1);
  u64 Z3[N]; add_mod<N>(c, r0, r1, Z3);
  std::memcpy(out, X3, N * 8);
  std::memcpy(out + N, Y3, N * 8);
  std::memcpy(out + 2 * N, Z3, N * 8);
}

template <int N>
inline void sw_scalar_mul(const SWCtx<N>* sc, const u64 base[3 * N],
                          const u8* bits, long nbits, u64 out[3 * N]) {
  u64 acc[3 * N], dbl[3 * N];
  sw_identity<N>(sc, acc);
  std::memcpy(dbl, base, 3 * N * 8);
  for (long i = 0; i < nbits; ++i) {
    if (bits[i]) sw_add<N>(sc, acc, dbl, acc);
    if (i + 1 < nbits) sw_add<N>(sc, dbl, dbl, dbl);
  }
  std::memcpy(out, acc, 3 * N * 8);
}

template <int N>
inline void sw_msm_bits(const SWCtx<N>* sc, const u64* table, const u8* bits,
                        long nbits, u64 out[3 * N]) {
  u64 acc[3 * N];
  sw_identity<N>(sc, acc);
  for (long i = 0; i < nbits; ++i)
    if (bits[i]) sw_add<N>(sc, acc, table + (size_t)i * 3 * N, acc);
  std::memcpy(out, acc, 3 * N * 8);
}

// to_affine: xy plus an infinity flag byte (Z == 0).
template <int N>
inline u8 sw_to_affine(const SWCtx<N>* sc, const u64 pt[3 * N], u64 xy[2 * N]) {
  bool inf = true;
  for (int i = 0; i < N; ++i) inf = inf && pt[2 * N + i] == 0;
  if (inf) {
    std::memset(xy, 0, 2 * N * 8);
    return 1;
  }
  u64 zi[N];
  mont_inv<N>(&sc->f, pt + 2 * N, zi);
  mont_mul<N>(&sc->f, pt, zi, xy);
  mont_mul<N>(&sc->f, pt + N, zi, xy + N);
  return 0;
}

// ----------------------------------------------------------------------
// Poseidon (templated over the limb count: N = 4 for <= 256-bit fields,
// N = 6 for 48-byte fields such as the BLS12-381 base field)
// ----------------------------------------------------------------------

template <int N>
void init_field(FieldCtx<N>* c, const u64* p, const u64* one, u64 n0);

template <int N>
struct PoseidonCtxT {
  FieldCtx<N> field;
  int t;
  u64 alpha;
  int full_rounds;
  int partial_rounds;
  std::vector<u64> ark;  // (R_F+R_P) * t * N
  std::vector<u64> mds;  // t * t * N
};

// nl-erased handle so the C ABI keeps single permute/compress/build
// entry points (the curve API's nl-parameter pattern, minus the
// per-call branching)
struct PoseidonAny {
  int nl;
  void* ctx;
};

template <int N>
inline void permute_one(const PoseidonCtxT<N>* pc, u64* state /* t*N */) {
  const FieldCtx<N>* c = &pc->field;
  int t = pc->t;
  int rf2 = pc->full_rounds / 2;
  int total = pc->full_rounds + pc->partial_rounds;
  std::vector<u64> nw((size_t)t * N);
  u64 term[N];
  for (int r = 0; r < total; ++r) {
    bool full = (r < rf2) || (r >= rf2 + pc->partial_rounds);
    const u64* ark_row = &pc->ark[(size_t)r * t * N];
    for (int i = 0; i < t; ++i)
      add_mod<N>(c, &state[i * N], &ark_row[i * N], &state[i * N]);
    int nbox = full ? t : 1;
    for (int i = 0; i < nbox; ++i)
      mont_pow_u64<N>(c, &state[i * N], pc->alpha, &state[i * N]);
    for (int i = 0; i < t; ++i) {
      u64 acc[N];
      std::memset(acc, 0, sizeof(acc));
      for (int j = 0; j < t; ++j) {
        mont_mul<N>(c, &pc->mds[((size_t)i * t + j) * N], &state[j * N], term);
        add_mod<N>(c, acc, term, acc);
      }
      std::memcpy(&nw[(size_t)i * N], acc, N * 8);
    }
    std::memcpy(state, nw.data(), (size_t)t * N * 8);
  }
}

template <int N>
PoseidonCtxT<N>* poseidon_new_t(const u64* p, const u64* one, u64 n0, int t,
                                u64 alpha, int full_rounds, int partial_rounds,
                                const u64* ark, const u64* mds) {
  auto* pc = new PoseidonCtxT<N>();
  init_field<N>(&pc->field, p, one, n0);
  pc->t = t;
  pc->alpha = alpha;
  pc->full_rounds = full_rounds;
  pc->partial_rounds = partial_rounds;
  size_t nark = (size_t)(full_rounds + partial_rounds) * t * N;
  pc->ark.assign(ark, ark + nark);
  pc->mds.assign(mds, mds + (size_t)t * t * N);
  return pc;
}

template <int N>
void poseidon_two_to_one_t(const PoseidonCtxT<N>* pc, const u64* left,
                           const u64* right, u64* out, long n) {
  int t = pc->t;
  std::vector<u64> state((size_t)t * N);
  for (long i = 0; i < n; ++i) {
    std::memset(state.data(), 0, (size_t)t * N * 8);
    std::memcpy(&state[N], left + (size_t)i * N, N * 8);
    std::memcpy(&state[2 * N], right + (size_t)i * N, N * 8);
    permute_one<N>(pc, state.data());
    std::memcpy(out + (size_t)i * N, &state[N], N * 8);
  }
}

template <int N>
void merkle_build_t(const PoseidonCtxT<N>* pc, const u64* leaves, long n,
                    u64* non_leaf) {
  long level = n / 2;
  long start = level - 1;
  {
    std::vector<u64> l((size_t)level * N), r((size_t)level * N);
    for (long i = 0; i < level; ++i) {
      std::memcpy(&l[(size_t)i * N], leaves + (size_t)(2 * i) * N, N * 8);
      std::memcpy(&r[(size_t)i * N], leaves + (size_t)(2 * i + 1) * N, N * 8);
    }
    poseidon_two_to_one_t<N>(pc, l.data(), r.data(),
                             non_leaf + (size_t)start * N, level);
  }
  while (level > 1) {
    long prev_start = start;
    level /= 2;
    start = level - 1;
    std::vector<u64> l((size_t)level * N), r((size_t)level * N);
    for (long i = 0; i < level; ++i) {
      std::memcpy(&l[(size_t)i * N],
                  non_leaf + (size_t)(prev_start + 2 * i) * N, N * 8);
      std::memcpy(&r[(size_t)i * N],
                  non_leaf + (size_t)(prev_start + 2 * i + 1) * N, N * 8);
    }
    poseidon_two_to_one_t<N>(pc, l.data(), r.data(),
                             non_leaf + (size_t)start * N, level);
  }
}

template <int N>
void init_field(FieldCtx<N>* c, const u64* p, const u64* one, u64 n0) {
  std::memcpy(c->p, p, N * 8);
  std::memcpy(c->one, one, N * 8);
  c->n0 = n0;
  std::memcpy(c->pminus2, p, N * 8);
  u64 two[N];
  std::memset(two, 0, sizeof(two));
  two[0] = 2;
  sub_limbs<N>(c->pminus2, two);
}

}  // namespace

extern "C" {

// -------- field API (nl = 4 or 6 limbs) --------

void* cpm_field_new(int nl, const u64* p, const u64* one, u64 n0) {
  if (nl == 4) {
    auto* c = new FieldCtx<4>();
    init_field<4>(c, p, one, n0);
    return c;
  }
  if (nl == 6) {
    auto* c = new FieldCtx<6>();
    init_field<6>(c, p, one, n0);
    return c;
  }
  return nullptr;
}

void cpm_field_free(void* c, int nl) {
  if (nl == 4) delete (FieldCtx<4>*)c;
  else delete (FieldCtx<6>*)c;
}

// batched: a, b, out are n*nl limb arrays
void cpm_mont_mul_batch(const void* c, int nl, const u64* a, const u64* b,
                        u64* out, long n) {
  if (nl == 4)
    for (long i = 0; i < n; ++i)
      mont_mul<4>((const FieldCtx<4>*)c, a + i * 4, b + i * 4, out + i * 4);
  else
    for (long i = 0; i < n; ++i)
      mont_mul<6>((const FieldCtx<6>*)c, a + i * 6, b + i * 6, out + i * 6);
}

void cpm_add_batch(const void* c, int nl, const u64* a, const u64* b, u64* out,
                   long n) {
  if (nl == 4)
    for (long i = 0; i < n; ++i)
      add_mod<4>((const FieldCtx<4>*)c, a + i * 4, b + i * 4, out + i * 4);
  else
    for (long i = 0; i < n; ++i)
      add_mod<6>((const FieldCtx<6>*)c, a + i * 6, b + i * 6, out + i * 6);
}

void cpm_inv_batch(const void* c, int nl, const u64* a, u64* out, long n) {
  if (nl == 4)
    for (long i = 0; i < n; ++i)
      mont_inv<4>((const FieldCtx<4>*)c, a + i * 4, out + i * 4);
  else
    for (long i = 0; i < n; ++i)
      mont_inv<6>((const FieldCtx<6>*)c, a + i * 6, out + i * 6);
}

// -------- twisted Edwards --------

void* cpm_te_new(int nl, const u64* p, const u64* one, u64 n0, const u64* a,
                 const u64* d) {
  if (nl == 4) {
    auto* tc = new TECtx<4>();
    init_field<4>(&tc->f, p, one, n0);
    std::memcpy(tc->a, a, 32);
    std::memcpy(tc->d, d, 32);
    return tc;
  }
  if (nl == 6) {
    auto* tc = new TECtx<6>();
    init_field<6>(&tc->f, p, one, n0);
    std::memcpy(tc->a, a, 48);
    std::memcpy(tc->d, d, 48);
    return tc;
  }
  return nullptr;
}

void cpm_te_free(void* tc, int nl) {
  if (nl == 4) delete (TECtx<4>*)tc;
  else delete (TECtx<6>*)tc;
}

void cpm_te_add_batch(const void* tc, int nl, const u64* p1, const u64* p2,
                      u64* out, long n) {
  if (nl == 4)
    for (long i = 0; i < n; ++i)
      te_add<4>((const TECtx<4>*)tc, p1 + i * 16, p2 + i * 16, out + i * 16);
  else
    for (long i = 0; i < n; ++i)
      te_add<6>((const TECtx<6>*)tc, p1 + i * 24, p2 + i * 24, out + i * 24);
}

// bases n*(4*nl) extended; bits n*nbits (one byte per bit, LSB-first)
void cpm_te_scalar_mul_batch(const void* tc, int nl, const u64* bases,
                             const u8* bits, long nbits, u64* out, long n) {
  if (nl == 4)
    for (long i = 0; i < n; ++i)
      te_scalar_mul<4>((const TECtx<4>*)tc, bases + i * 16, bits + i * nbits,
                       nbits, out + i * 16);
  else
    for (long i = 0; i < n; ++i)
      te_scalar_mul<6>((const TECtx<6>*)tc, bases + i * 24, bits + i * nbits,
                       nbits, out + i * 24);
}

// table nbits*(4*nl) extended; bits n*nbits; out n*(4*nl)
void cpm_te_msm_bits_batch(const void* tc, int nl, const u64* table,
                           const u8* bits, long nbits, u64* out, long n) {
  if (nl == 4)
    for (long i = 0; i < n; ++i)
      te_msm_bits<4>((const TECtx<4>*)tc, table, bits + i * nbits, nbits,
                     out + i * 16);
  else
    for (long i = 0; i < n; ++i)
      te_msm_bits<6>((const TECtx<6>*)tc, table, bits + i * nbits, nbits,
                     out + i * 24);
}

void cpm_te_to_affine_batch(const void* tc, int nl, const u64* pts, u64* xy,
                            long n) {
  if (nl == 4)
    for (long i = 0; i < n; ++i)
      te_to_affine<4>((const TECtx<4>*)tc, pts + i * 16, xy + i * 8);
  else
    for (long i = 0; i < n; ++i)
      te_to_affine<6>((const TECtx<6>*)tc, pts + i * 24, xy + i * 12);
}

// -------- short Weierstrass --------

void* cpm_sw_new(int nl, const u64* p, const u64* one, u64 n0, const u64* a,
                 const u64* b3, const u64* a2) {
  if (nl == 4) {
    auto* sc = new SWCtx<4>();
    init_field<4>(&sc->f, p, one, n0);
    std::memcpy(sc->a, a, 32);
    std::memcpy(sc->b3, b3, 32);
    std::memcpy(sc->a2, a2, 32);
    return sc;
  }
  if (nl == 6) {
    auto* sc = new SWCtx<6>();
    init_field<6>(&sc->f, p, one, n0);
    std::memcpy(sc->a, a, 48);
    std::memcpy(sc->b3, b3, 48);
    std::memcpy(sc->a2, a2, 48);
    return sc;
  }
  return nullptr;
}

void cpm_sw_free(void* sc, int nl) {
  if (nl == 4) delete (SWCtx<4>*)sc;
  else delete (SWCtx<6>*)sc;
}

void cpm_sw_add_batch(const void* sc, int nl, const u64* p1, const u64* p2,
                      u64* out, long n) {
  if (nl == 4)
    for (long i = 0; i < n; ++i)
      sw_add<4>((const SWCtx<4>*)sc, p1 + i * 12, p2 + i * 12, out + i * 12);
  else
    for (long i = 0; i < n; ++i)
      sw_add<6>((const SWCtx<6>*)sc, p1 + i * 18, p2 + i * 18, out + i * 18);
}

void cpm_sw_scalar_mul_batch(const void* sc, int nl, const u64* bases,
                             const u8* bits, long nbits, u64* out, long n) {
  if (nl == 4)
    for (long i = 0; i < n; ++i)
      sw_scalar_mul<4>((const SWCtx<4>*)sc, bases + i * 12, bits + i * nbits,
                       nbits, out + i * 12);
  else
    for (long i = 0; i < n; ++i)
      sw_scalar_mul<6>((const SWCtx<6>*)sc, bases + i * 18, bits + i * nbits,
                       nbits, out + i * 18);
}

void cpm_sw_msm_bits_batch(const void* sc, int nl, const u64* table,
                           const u8* bits, long nbits, u64* out, long n) {
  if (nl == 4)
    for (long i = 0; i < n; ++i)
      sw_msm_bits<4>((const SWCtx<4>*)sc, table, bits + i * nbits, nbits,
                     out + i * 12);
  else
    for (long i = 0; i < n; ++i)
      sw_msm_bits<6>((const SWCtx<6>*)sc, table, bits + i * nbits, nbits,
                     out + i * 18);
}

// inf_flags: n bytes, 1 where the point is the identity
void cpm_sw_to_affine_batch(const void* sc, int nl, const u64* pts, u64* xy,
                            u8* inf_flags, long n) {
  if (nl == 4)
    for (long i = 0; i < n; ++i)
      inf_flags[i] =
          sw_to_affine<4>((const SWCtx<4>*)sc, pts + i * 12, xy + i * 8);
  else
    for (long i = 0; i < n; ++i)
      inf_flags[i] =
          sw_to_affine<6>((const SWCtx<6>*)sc, pts + i * 18, xy + i * 12);
}

// -------- Poseidon (nl = 4 or 6 limb fields) --------

void* cpm_poseidon_new(int nl, const u64* p, const u64* one, u64 n0, int t,
                       u64 alpha, int full_rounds, int partial_rounds,
                       const u64* ark, const u64* mds) {
  auto* pa = new PoseidonAny();
  pa->nl = nl;
  if (nl == 4)
    pa->ctx = poseidon_new_t<4>(p, one, n0, t, alpha, full_rounds,
                                partial_rounds, ark, mds);
  else if (nl == 6)
    pa->ctx = poseidon_new_t<6>(p, one, n0, t, alpha, full_rounds,
                                partial_rounds, ark, mds);
  else {
    delete pa;
    return nullptr;
  }
  return pa;
}

void cpm_poseidon_free(void* h) {
  auto* pa = (PoseidonAny*)h;
  if (pa->nl == 4) delete (PoseidonCtxT<4>*)pa->ctx;
  else delete (PoseidonCtxT<6>*)pa->ctx;
  delete pa;
}

// states: n * t * nl limbs, Montgomery; permuted in place
void cpm_poseidon_permute(const void* h, u64* states, long n) {
  auto* pa = (const PoseidonAny*)h;
  if (pa->nl == 4) {
    auto* pc = (const PoseidonCtxT<4>*)pa->ctx;
    for (long i = 0; i < n; ++i)
      permute_one<4>(pc, states + (size_t)i * pc->t * 4);
  } else {
    auto* pc = (const PoseidonCtxT<6>*)pa->ctx;
    for (long i = 0; i < n; ++i)
      permute_one<6>(pc, states + (size_t)i * pc->t * 6);
  }
}

// two-to-one compression: capacity-1 duplex absorb(l), absorb(r), squeeze(1)
// == state [0, l, r] permuted once, output element 1 (rate>=2 configs).
void cpm_poseidon_two_to_one(const void* h, const u64* left, const u64* right,
                             u64* out, long n) {
  auto* pa = (const PoseidonAny*)h;
  if (pa->nl == 4)
    poseidon_two_to_one_t<4>((const PoseidonCtxT<4>*)pa->ctx, left, right,
                             out, n);
  else
    poseidon_two_to_one_t<6>((const PoseidonCtxT<6>*)pa->ctx, left, right,
                             out, n);
}

// dense Merkle build over field digests: leaves n*nl -> nodes (n-1)*nl in
// level order (root first), mirroring merkle_tree/mod.rs layout.
void cpm_merkle_build(const void* h, const u64* leaves, long n, u64* non_leaf) {
  auto* pa = (const PoseidonAny*)h;
  if (pa->nl == 4)
    merkle_build_t<4>((const PoseidonCtxT<4>*)pa->ctx, leaves, n, non_leaf);
  else
    merkle_build_t<6>((const PoseidonCtxT<6>*)pa->ctx, leaves, n, non_leaf);
}

}  // extern "C"
