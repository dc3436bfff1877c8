// Host math of the parameter context: the NTT-friendly prime search
// (deterministic Miller-Rabin), the primitive 2N-th roots and the
// bit-reversed psi power banks. In Python these loops take most of a cold
// context's time at logN 16 and 17.
//
// The context layer (fhe/context/) keeps a pure-Python twin of every entry
// point and takes it above 2^63, the range of these functions. Plain C
// interface, loaded with ctypes (native/__init__.py); every modulus is below
// 2^63, so unsigned __int128 products never overflow.

#include <cstdint>

extern "C" {

static inline uint64_t mulmod_u64(uint64_t a, uint64_t b, uint64_t q) {
    return (uint64_t)(((unsigned __int128)a * b) % q);
}

uint64_t powmod_u64(uint64_t a, uint64_t e, uint64_t q) {
    uint64_t r = 1 % q;
    a %= q;
    while (e) {
        if (e & 1) r = mulmod_u64(r, a, q);
        a = mulmod_u64(a, a, q);
        e >>= 1;
    }
    return r;
}

// Deterministic Miller-Rabin, exact for all n < 2^64 (the witnesses and the
// trial divisions of fhe/context/prim_test.py).
static const uint64_t WITNESSES[12] = {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37};
static const uint64_t SMALL_PRIMES[15] = {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47};

int32_t miller_rabin_u64(uint64_t n) {
    if (n < 2) return 0;
    for (int i = 0; i < 15; ++i) {
        if (n == SMALL_PRIMES[i]) return 1;
        if (n % SMALL_PRIMES[i] == 0) return 0;
    }
    uint64_t d = n - 1;
    int r = 0;
    while ((d & 1) == 0) { d >>= 1; ++r; }
    for (int i = 0; i < 12; ++i) {
        uint64_t x = powmod_u64(WITNESSES[i], d, n);
        if (x == 1 || x == n - 1) continue;
        int composite = 1;
        for (int j = 0; j < r - 1; ++j) {
            x = mulmod_u64(x, x, n);
            if (x == n - 1) { composite = 0; break; }
        }
        if (composite) return 0;
    }
    return 1;
}

// The first q from `start` in steps of 2 (up or down) that is prime with
// q = 1 (mod M): generate_primes.find_the_next_prime's search, candidate for
// candidate. Returns 0 if the search leaves (2, 2^63).
uint64_t find_ntt_prime(uint64_t start, uint64_t M, int32_t up) {
    uint64_t q = start;
    while (q > 2 && q < (1ULL << 63)) {
        if ((q - 1) % M == 0 && miller_rabin_u64(q)) return q;
        if (up) q += 2; else q -= 2;
    }
    return 0;
}

// psi power banks in bit-reversed order (ckks_context.psi_bank):
// out_fwd[c][bitrev(i)] = psi_c ^ i mod q_c, likewise the inverse; [C, N].
void psi_banks(const uint64_t* qs, const uint64_t* psis,
               const uint64_t* ipsis, int32_t C, int32_t logN,
               uint64_t* out_fwd, uint64_t* out_inv) {
    const int64_t N = 1LL << logN;
    for (int32_t c = 0; c < C; ++c) {
        const uint64_t q = qs[c];
        const uint64_t psi = psis[c];
        const uint64_t ipsi = ipsis[c];
        uint64_t* fwd = out_fwd + (int64_t)c * N;
        uint64_t* inv = out_inv + (int64_t)c * N;
        uint64_t acc = 1, iacc = 1;
        for (int64_t i = 0; i < N; ++i) {
            uint64_t r = 0, x = (uint64_t)i;
            for (int32_t b = 0; b < logN; ++b) { r = (r << 1) | (x & 1); x >>= 1; }
            fwd[r] = acc;
            inv[r] = iacc;
            acc = mulmod_u64(acc, psi, q);
            iacc = mulmod_u64(iacc, ipsi, q);
        }
    }
}

// A primitive 2N-th root of unity mod q (ckks_context.primitive_root_2N):
// raise candidates x = 2, 3, ... to the (q - 1) / 2N power and return the
// first whose N-th power is not 1 (the last one tried if none is).
uint64_t primitive_root_2N(uint64_t q, uint64_t N) {
    uint64_t K = (q - 1) / (2 * N);
    uint64_t g = 0;
    uint64_t limit = N > 3 ? N : 3;
    for (uint64_t x = 2; x < limit; ++x) {
        g = powmod_u64(x, K, q);
        if (powmod_u64(g, N, q) != 1) break;
    }
    return g;
}

}  // extern "C"
