// pvacnative — native runtime for the TPU-native PVAC-HFHE framework.
//
// C++17, no external dependencies, exposed through a C ABI consumed via
// ctypes.  Provides the host-side hot paths that complement the JAX/TPU
// compute path:
//   - bit-exact .ct serialization codec (SoA edge tables <-> wire bytes)
//   - AES-256-CTR keystream engine (AES-NI when available, portable
//     table-based fallback) — reference semantics (lpn.hpp:41-149)
//   - SHA-256 and multi-lane SHA-256-CTR index streams (prg_choose_k
//     semantics, matrix.hpp:15-92)
//   - F_p bucket reduction (sum of 4x32-limb values mod 2^127-1)
//
// This is an independent implementation written against the wire/format
// semantics documented in SURVEY.md — not a copy of the reference headers.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <atomic>
#include <thread>
#include <vector>

#if defined(__AES__) && defined(__SSE2__)
#include <wmmintrin.h>
#include <emmintrin.h>
#define PVACN_AESNI 1
#else
#define PVACN_AESNI 0
#endif

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#include <cpuid.h>
#define PVACN_X86 1
#else
#define PVACN_X86 0
#endif

extern "C" {

// ---------------------------------------------------------------------------
// SHA-256
// ---------------------------------------------------------------------------

static const uint32_t SHA_K[64] = {
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

static inline uint32_t rotr32(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

struct ShaCtx {
    uint32_t h[8];
    uint64_t len = 0;
    uint8_t buf[64];
    size_t ptr = 0;
};

static void sha_init(ShaCtx& c) {
    static const uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                   0xa54ff53a, 0x510e527f, 0x9b05688c,
                                   0x1f83d9ab, 0x5be0cd19};
    memcpy(c.h, H0, sizeof H0);
    c.len = 0;
    c.ptr = 0;
}

// SHA-NI compression (one block) — standard Intel construction; round
// constants come straight from SHA_K.  Dispatched at runtime below.
#if PVACN_X86
__attribute__((target("sha,sse4.1,ssse3")))
static void sha_block_ni(uint32_t state[8], const uint8_t* data) {
    const __m128i MASK = _mm_set_epi64x(0x0c0d0e0f08090a0bULL,
                                        0x0405060700010203ULL);
    __m128i TMP = _mm_loadu_si128((const __m128i*)&state[0]);
    __m128i STATE1 = _mm_loadu_si128((const __m128i*)&state[4]);
    TMP = _mm_shuffle_epi32(TMP, 0xB1);                    /* CDAB */
    STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);              /* EFGH */
    __m128i STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);      /* ABEF */
    STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);           /* CDGH */
    const __m128i ABEF_SAVE = STATE0, CDGH_SAVE = STATE1;

    __m128i m[4];
    for (int i = 0; i < 4; i++)
        m[i] = _mm_shuffle_epi8(
            _mm_loadu_si128((const __m128i*)(data + 16 * i)), MASK);
    for (int i = 0; i < 16; i++) {
        __m128i msg = _mm_add_epi32(
            m[i & 3], _mm_loadu_si128((const __m128i*)&SHA_K[i * 4]));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, msg);
        msg = _mm_shuffle_epi32(msg, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, msg);
        if (i >= 3 && i < 15) {
            __m128i tmp = _mm_alignr_epi8(m[i & 3], m[(i + 3) & 3], 4);
            m[(i + 1) & 3] = _mm_sha256msg2_epu32(
                _mm_add_epi32(
                    _mm_sha256msg1_epu32(m[(i + 1) & 3], m[(i + 2) & 3]),
                    tmp),
                m[i & 3]);
        }
    }
    STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
    STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
    TMP = _mm_shuffle_epi32(STATE0, 0x1B);                 /* FEBA */
    STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);              /* DCHG */
    STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);           /* DCBA */
    STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);              /* HGFE */
    _mm_storeu_si128((__m128i*)&state[0], STATE0);
    _mm_storeu_si128((__m128i*)&state[4], STATE1);
}

static bool cpu_has_sha_ni() {
    unsigned a = 0, b = 0, c = 0, d = 0;
    if (__get_cpuid_count(7, 0, &a, &b, &c, &d)) return (b >> 29) & 1;
    return false;
}
#endif  // PVACN_X86

static void sha_block_soft(uint32_t h[8], const uint8_t* p);

static void sha_block(uint32_t h[8], const uint8_t* p) {
#if PVACN_X86
    static const bool ni = cpu_has_sha_ni();
    if (ni) { sha_block_ni(h, p); return; }
#endif
    sha_block_soft(h, p);
}

static void sha_block_soft(uint32_t h[8], const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
        w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
               ((uint32_t)p[4 * i + 2] << 8) | p[4 * i + 3];
    for (int i = 16; i < 64; i++) {
        uint32_t s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3);
        uint32_t s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], cc = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
        uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = hh + S1 + ch + SHA_K[i] + w[i];
        uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
        uint32_t mj = (a & b) ^ (a & cc) ^ (b & cc);
        uint32_t t2 = S0 + mj;
        hh = g; g = f; f = e; e = d + t1; d = cc; cc = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += cc; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

static void sha_update(ShaCtx& c, const void* data, size_t n) {
    const uint8_t* p = (const uint8_t*)data;
    c.len += n;
    while (n) {
        size_t take = 64 - c.ptr;
        if (take > n) take = n;
        memcpy(c.buf + c.ptr, p, take);
        c.ptr += take;
        p += take;
        n -= take;
        if (c.ptr == 64) { sha_block(c.h, c.buf); c.ptr = 0; }
    }
}

static void sha_final(ShaCtx& c, uint8_t out[32]) {
    uint64_t bits = c.len * 8;
    uint8_t pad = 0x80;
    sha_update(c, &pad, 1);
    uint8_t z = 0;
    while (c.ptr != 56) sha_update(c, &z, 1);
    uint8_t be[8];
    for (int i = 0; i < 8; i++) be[7 - i] = (uint8_t)(bits >> (8 * i));
    sha_update(c, be, 8);
    for (int i = 0; i < 8; i++) {
        out[4 * i] = (uint8_t)(c.h[i] >> 24);
        out[4 * i + 1] = (uint8_t)(c.h[i] >> 16);
        out[4 * i + 2] = (uint8_t)(c.h[i] >> 8);
        out[4 * i + 3] = (uint8_t)c.h[i];
    }
}

void pvacn_sha256(const uint8_t* data, uint64_t n, uint8_t out[32]) {
    ShaCtx c;
    sha_init(c);
    sha_update(c, data, n);
    sha_final(c, out);
}

// Batched SHA-256(prefix || le64(fields[l][0..n_fields))) digests, one
// per lane, threaded — the AES key-derivation hash (reference
// crypto/lpn.hpp:166-192), which otherwise runs as a lane-vectorized
// numpy SHA on the hot encryption path.
void pvacn_sha256_fields(
    const uint8_t* prefix, uint64_t plen,
    const uint64_t* fields, uint64_t n_fields,
    uint64_t n_lanes, uint8_t* out /* [n_lanes, 32] */) {
    auto work = [&](uint64_t l0, uint64_t l1) {
        std::vector<uint8_t> msg(plen + 8 * n_fields);
        memcpy(msg.data(), prefix, plen);
        for (uint64_t l = l0; l < l1; l++) {
            uint8_t* p = msg.data() + plen;
            for (uint64_t f = 0; f < n_fields; f++) {
                uint64_t x = fields[l * n_fields + f];
                for (int i = 0; i < 8; i++) p[8 * f + i] = (uint8_t)(x >> (8 * i));
            }
            pvacn_sha256(msg.data(), (uint64_t)msg.size(), out + 32 * l);
        }
    };
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 1;
    unsigned nt = (unsigned)(n_lanes < hw ? (n_lanes ? n_lanes : 1) : hw);
    if (nt <= 1) {
        work(0, n_lanes);
        return;
    }
    std::vector<std::thread> ts;
    uint64_t per = (n_lanes + nt - 1) / nt;
    for (unsigned t = 0; t < nt; t++) {
        uint64_t a = (uint64_t)t * per, b = a + per < n_lanes ? a + per : n_lanes;
        if (a >= b) break;
        ts.emplace_back(work, a, b);
    }
    for (auto& th : ts) th.join();
}

// Multi-lane SHA-256-CTR u64 streams: for each lane l, refill c yields
// SHA-256(label || le64(words[l])... || le64(c)) read as 4 LE u64s.
void pvacn_shactr_streams(
    const uint8_t* label, uint64_t label_len,
    const uint64_t* words, uint64_t n_words,
    uint64_t n_lanes, uint64_t n_u64,
    uint64_t* out /* [n_lanes, n_u64] */) {
    uint64_t n_refills = (n_u64 + 3) / 4;
    for (uint64_t l = 0; l < n_lanes; l++) {
        uint64_t pos = 0;
        for (uint64_t c = 0; c < n_refills; c++) {
            ShaCtx s;
            sha_init(s);
            sha_update(s, label, label_len);
            for (uint64_t wI = 0; wI < n_words; wI++) {
                uint64_t x = words[l * n_words + wI];
                uint8_t b[8];
                for (int i = 0; i < 8; i++) b[i] = (uint8_t)(x >> (8 * i));
                sha_update(s, b, 8);
            }
            uint8_t cb[8];
            for (int i = 0; i < 8; i++) cb[i] = (uint8_t)(c >> (8 * i));
            sha_update(s, cb, 8);
            uint8_t d[32];
            sha_final(s, d);
            for (int j = 0; j < 4 && pos < n_u64; j++, pos++) {
                uint64_t x = 0;
                for (int i = 0; i < 8; i++) x |= (uint64_t)d[8 * j + i] << (8 * i);
                out[l * n_u64 + pos] = x;
            }
        }
    }
}

// prg_choose_k over many lanes (reference matrix.hpp:15-92 semantics,
// including bounded() rejection with x <= lim).  indices out [n_lanes, k].
// Lanes are independent streams, so big batches (gen_H's 16384 columns)
// split across hardware threads.
static void choose_k_range(
    const uint8_t* label, uint64_t label_len,
    const uint64_t* words, uint64_t n_words,
    uint64_t l0, uint64_t l1, uint32_t k, uint64_t N,
    int32_t* out) {
    uint64_t lim = N <= 1 ? ~0ull : ~0ull - (~0ull % N);
    // Two-block fast path: message = label || words || ctr.  When the
    // (label, words) prefix covers block 1 and the rest (tail + ctr +
    // padding) fits block 2, hash block 1 ONCE per lane and per draw only
    // patch the 8 ctr bytes of a prebuilt block-2 template — one
    // compression per 32-byte draw instead of two plus byte shuffling.
    uint64_t prefix_len = label_len + 8 * n_words;
    uint64_t total_len = prefix_len + 8;
    bool fast = prefix_len >= 64 && (total_len - 64) + 9 <= 64;
    for (uint64_t l = l0; l < l1; l++) {
        // sequential stream for this lane
        uint64_t ctr = 0;
        uint8_t d[32];
        int idx = 32;
        uint32_t got = 0;
        uint32_t mid[8];
        uint8_t blk2[64];
        uint64_t tail = 0;
        if (fast) {
            uint8_t prefix[64 + 8 * 64];  // label <= 55 in fast mode
            memcpy(prefix, label, label_len);
            for (uint64_t wI = 0; wI < n_words; wI++) {
                uint64_t x = words[l * n_words + wI];
                for (int i = 0; i < 8; i++)
                    prefix[label_len + 8 * wI + i] = (uint8_t)(x >> (8 * i));
            }
            static const uint32_t H0[8] = {
                0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
            memcpy(mid, H0, sizeof H0);
            sha_block(mid, prefix);
            tail = prefix_len - 64;
            memset(blk2, 0, 64);
            memcpy(blk2, prefix + 64, tail);
            blk2[tail + 8] = 0x80;
            uint64_t bits = total_len * 8;
            for (int i = 0; i < 8; i++)
                blk2[56 + i] = (uint8_t)(bits >> (56 - 8 * i));
        }
        // tiny open-addressing set; N <= 65536 in all scheme configs
        static thread_local uint8_t seen[65536];
        memset(seen, 0, (size_t)N);
        while (got < k) {
            if (idx >= 32) {
                if (fast) {
                    for (int i = 0; i < 8; i++)
                        blk2[tail + i] = (uint8_t)(ctr >> (8 * i));
                    ctr++;
                    uint32_t h[8];
                    memcpy(h, mid, sizeof h);
                    sha_block(h, blk2);
                    for (int i = 0; i < 8; i++) {
                        d[4 * i] = (uint8_t)(h[i] >> 24);
                        d[4 * i + 1] = (uint8_t)(h[i] >> 16);
                        d[4 * i + 2] = (uint8_t)(h[i] >> 8);
                        d[4 * i + 3] = (uint8_t)h[i];
                    }
                } else {
                    ShaCtx s;
                    sha_init(s);
                    sha_update(s, label, label_len);
                    for (uint64_t wI = 0; wI < n_words; wI++) {
                        uint64_t x = words[l * n_words + wI];
                        uint8_t b[8];
                        for (int i = 0; i < 8; i++)
                            b[i] = (uint8_t)(x >> (8 * i));
                        sha_update(s, b, 8);
                    }
                    uint8_t cb[8];
                    for (int i = 0; i < 8; i++)
                        cb[i] = (uint8_t)(ctr >> (8 * i));
                    ctr++;
                    sha_update(s, cb, 8);
                    sha_final(s, d);
                }
                idx = 0;
            }
            uint64_t x = 0;
            for (int i = 0; i < 8; i++) x |= (uint64_t)d[idx + i] << (8 * i);
            idx += 8;
            if (N > 1 && x > lim) continue;
            uint64_t v = N <= 1 ? 0 : x % N;
            if (!seen[v]) {
                seen[v] = 1;
                out[l * k + got] = (int32_t)v;
                got++;
            }
        }
    }
}

void pvacn_choose_k(
    const uint8_t* label, uint64_t label_len,
    const uint64_t* words, uint64_t n_words,
    uint64_t n_lanes, uint32_t k, uint64_t N,
    int32_t* out) {
    unsigned hw = std::thread::hardware_concurrency();
    uint64_t nt = hw ? hw : 1;
    if (nt > n_lanes / 256) nt = n_lanes / 256;  // don't spawn for tiny jobs
    if (nt <= 1) {
        choose_k_range(label, label_len, words, n_words, 0, n_lanes, k, N, out);
        return;
    }
    std::vector<std::thread> ts;
    uint64_t per = (n_lanes + nt - 1) / nt;
    for (uint64_t t = 0; t < nt; t++) {
        uint64_t l0 = t * per, l1 = l0 + per < n_lanes ? l0 + per : n_lanes;
        if (l0 >= l1) break;
        ts.emplace_back(choose_k_range, label, label_len, words, n_words,
                        l0, l1, k, N, out);
    }
    for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------------------
// AES-256-CTR
// ---------------------------------------------------------------------------

static const uint8_t* sbox_tab() {
    static uint8_t tab[256];
    static bool init = false;
    if (!init) {
        // GF(2^8) inverse by Fermat + affine; built from the field
        // definition (no copied tables).
        auto gmul = [](uint8_t a, uint8_t b) {
            uint16_t r = 0, aa = a;
            while (b) {
                if (b & 1) r ^= aa;
                aa <<= 1;
                if (aa & 0x100) aa ^= 0x11B;
                b >>= 1;
            }
            return (uint8_t)r;
        };
        for (int x = 0; x < 256; x++) {
            uint8_t inv = 0;
            if (x) {
                uint8_t acc = 1, base = (uint8_t)x;
                int e = 254;
                while (e) {
                    if (e & 1) acc = gmul(acc, base);
                    base = gmul(base, base);
                    e >>= 1;
                }
                inv = acc;
            }
            uint8_t out = 0;
            for (int i = 0; i < 8; i++) {
                int bit = ((inv >> i) ^ (inv >> ((i + 4) % 8)) ^
                           (inv >> ((i + 5) % 8)) ^ (inv >> ((i + 6) % 8)) ^
                           (inv >> ((i + 7) % 8)) ^ (0x63 >> i)) & 1;
                out |= bit << i;
            }
            tab[x] = out;
        }
        init = true;
    }
    return tab;
}

struct AesKey {
    uint32_t w[60];  // big-endian word convention
};

static void aes_expand(const uint8_t key[32], AesKey& ak) {
    const uint8_t* SB = sbox_tab();
    for (int i = 0; i < 8; i++)
        ak.w[i] = ((uint32_t)key[4 * i] << 24) | ((uint32_t)key[4 * i + 1] << 16) |
                  ((uint32_t)key[4 * i + 2] << 8) | key[4 * i + 3];
    uint32_t rcon = 1;
    for (int i = 8; i < 60; i++) {
        uint32_t t = ak.w[i - 1];
        if (i % 8 == 0) {
            t = (t << 8) | (t >> 24);
            t = ((uint32_t)SB[(t >> 24) & 0xFF] << 24) |
                ((uint32_t)SB[(t >> 16) & 0xFF] << 16) |
                ((uint32_t)SB[(t >> 8) & 0xFF] << 8) | SB[t & 0xFF];
            t ^= rcon << 24;
            rcon <<= 1;
        } else if (i % 8 == 4) {
            t = ((uint32_t)SB[(t >> 24) & 0xFF] << 24) |
                ((uint32_t)SB[(t >> 16) & 0xFF] << 16) |
                ((uint32_t)SB[(t >> 8) & 0xFF] << 8) | SB[t & 0xFF];
        }
        ak.w[i] = ak.w[i - 8] ^ t;
    }
}

static inline uint8_t xt(uint8_t a) {
    return (uint8_t)((a << 1) ^ ((a & 0x80) ? 0x1B : 0));
}

static void aes_encrypt_block(const AesKey& ak, const uint8_t in[16],
                              uint8_t out[16]) {
    const uint8_t* SB = sbox_tab();
    uint8_t s[16];
    memcpy(s, in, 16);
    auto ark = [&](int rnd) {
        for (int c = 0; c < 4; c++) {
            uint32_t w = ak.w[4 * rnd + c];
            s[4 * c] ^= (uint8_t)(w >> 24);
            s[4 * c + 1] ^= (uint8_t)(w >> 16);
            s[4 * c + 2] ^= (uint8_t)(w >> 8);
            s[4 * c + 3] ^= (uint8_t)w;
        }
    };
    auto sub_shift = [&]() {
        uint8_t t[16];
        for (int i = 0; i < 16; i++) t[i] = SB[s[i]];
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++)
                s[r + 4 * c] = t[r + 4 * ((c + r) % 4)];
    };
    auto mix = [&]() {
        for (int c = 0; c < 4; c++) {
            uint8_t a0 = s[4 * c], a1 = s[4 * c + 1], a2 = s[4 * c + 2],
                    a3 = s[4 * c + 3];
            s[4 * c] = xt(a0) ^ xt(a1) ^ a1 ^ a2 ^ a3;
            s[4 * c + 1] = a0 ^ xt(a1) ^ xt(a2) ^ a2 ^ a3;
            s[4 * c + 2] = a0 ^ a1 ^ xt(a2) ^ xt(a3) ^ a3;
            s[4 * c + 3] = xt(a0) ^ a0 ^ a1 ^ a2 ^ xt(a3);
        }
    };
    ark(0);
    for (int r = 1; r < 14; r++) { sub_shift(); mix(); ark(r); }
    sub_shift();
    ark(14);
    memcpy(out, s, 16);
}

#if PVACN_AESNI
static inline __m128i aesni_expand_step(__m128i k, __m128i t) {
    t = _mm_shuffle_epi32(t, 0xFF);
    k = _mm_xor_si128(k, _mm_slli_si128(k, 4));
    k = _mm_xor_si128(k, _mm_slli_si128(k, 4));
    k = _mm_xor_si128(k, _mm_slli_si128(k, 4));
    return _mm_xor_si128(k, t);
}
static inline __m128i aesni_expand_step2(__m128i k1, __m128i k2) {
    __m128i t = _mm_aeskeygenassist_si128(k2, 0);
    t = _mm_shuffle_epi32(t, 0xAA);
    k1 = _mm_xor_si128(k1, _mm_slli_si128(k1, 4));
    k1 = _mm_xor_si128(k1, _mm_slli_si128(k1, 4));
    k1 = _mm_xor_si128(k1, _mm_slli_si128(k1, 4));
    return _mm_xor_si128(k1, t);
}

struct AesNiKey { __m128i rk[15]; };

static void aesni_expand(const uint8_t key[32], AesNiKey& ak) {
    __m128i k0 = _mm_loadu_si128((const __m128i*)key);
    __m128i k1 = _mm_loadu_si128((const __m128i*)(key + 16));
    ak.rk[0] = k0; ak.rk[1] = k1;
    ak.rk[2] = aesni_expand_step(k0, _mm_aeskeygenassist_si128(k1, 0x01)); k0 = ak.rk[2];
    ak.rk[3] = aesni_expand_step2(k1, k0); k1 = ak.rk[3];
    ak.rk[4] = aesni_expand_step(k0, _mm_aeskeygenassist_si128(k1, 0x02)); k0 = ak.rk[4];
    ak.rk[5] = aesni_expand_step2(k1, k0); k1 = ak.rk[5];
    ak.rk[6] = aesni_expand_step(k0, _mm_aeskeygenassist_si128(k1, 0x04)); k0 = ak.rk[6];
    ak.rk[7] = aesni_expand_step2(k1, k0); k1 = ak.rk[7];
    ak.rk[8] = aesni_expand_step(k0, _mm_aeskeygenassist_si128(k1, 0x08)); k0 = ak.rk[8];
    ak.rk[9] = aesni_expand_step2(k1, k0); k1 = ak.rk[9];
    ak.rk[10] = aesni_expand_step(k0, _mm_aeskeygenassist_si128(k1, 0x10)); k0 = ak.rk[10];
    ak.rk[11] = aesni_expand_step2(k1, k0); k1 = ak.rk[11];
    ak.rk[12] = aesni_expand_step(k0, _mm_aeskeygenassist_si128(k1, 0x20)); k0 = ak.rk[12];
    ak.rk[13] = aesni_expand_step2(k1, k0); k1 = ak.rk[13];
    ak.rk[14] = aesni_expand_step(k0, _mm_aeskeygenassist_si128(k1, 0x40));
}
#endif

int pvacn_has_aesni() { return PVACN_AESNI; }

// Expand N AES-256 keys and emit lane-packed bitsliced round-key planes:
// out[1920, ceil(N/32)] uint32, plane order (r, p, b) with state byte
// p = 4c + k <- schedule word 4r + c, byte k (big-endian), bit b; lane n
// occupies bit n%32 of word n/32.
void pvacn_expand_keys_packed(const uint8_t* keys, uint64_t n_lanes,
                              uint32_t* out) {
    // Lane-packed round-key planes; threaded over 32-lane words (each
    // thread owns disjoint out columns) with a branch-free bit scatter —
    // this runs per PRF chunk on the host and was the top host cost of a
    // warm device-engine encryption batch.
    uint64_t nw = (n_lanes + 31) / 32;
    memset(out, 0, 1920 * nw * 4);
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 1;
    unsigned nt = (unsigned)(nw < hw ? (nw ? nw : 1) : hw);
    auto work = [&](uint64_t w0, uint64_t w1) {
        for (uint64_t w = w0; w < w1; w++) {
            uint64_t n0 = w * 32;
            uint64_t n1 = n0 + 32 < n_lanes ? n0 + 32 : n_lanes;
            for (uint64_t n = n0; n < n1; n++) {
                AesKey ak;
                aes_expand(keys + 32 * n, ak);
                uint32_t lane_bit = (uint32_t)(n % 32);
                uint32_t* col = out + w;
                for (int r = 0; r < 15; r++) {
                    for (int c = 0; c < 4; c++) {
                        uint32_t word = ak.w[4 * r + c];
                        // byte k (big-endian) feeds planes of state byte
                        // p = 4*c + k; plane index = (r*16+p)*8 + b
                        for (int k = 0; k < 4; k++) {
                            uint8_t byte = (uint8_t)(word >> (8 * (3 - k)));
                            uint64_t pb = (((uint64_t)r * 16 + 4 * c + k) * 8);
                            uint32_t* base = col + pb * nw;
                            for (int b = 0; b < 8; b++)
                                base[(uint64_t)b * nw] |=
                                    ((uint32_t)((byte >> b) & 1)) << lane_bit;
                        }
                    }
                }
            }
        }
    };
    if (nt <= 1) {
        work(0, nw);
        return;
    }
    std::vector<std::thread> ts;
    uint64_t per = (nw + nt - 1) / nt;
    for (unsigned t = 0; t < nt; t++) {
        uint64_t w0 = (uint64_t)t * per;
        uint64_t w1 = w0 + per < nw ? w0 + per : nw;
        if (w0 >= w1) break;
        ts.emplace_back(work, w0, w1);
    }
    for (auto& th : ts) th.join();
}

// keystream: for each lane, nblocks counter blocks -> out u64s
// [n_lanes, 2*nblocks] in stream order.
void pvacn_aes256_ctr(
    const uint8_t* keys /* [n_lanes, 32] */, const uint64_t* nonces,
    uint64_t n_lanes, uint64_t nblocks, uint64_t* out) {
#if PVACN_AESNI
    for (uint64_t l = 0; l < n_lanes; l++) {
        AesNiKey ak;
        aesni_expand(keys + 32 * l, ak);
        uint64_t ctr = nonces[l];
        uint64_t* o = out + l * 2 * nblocks;
        for (uint64_t b = 0; b < nblocks; b++) {
            __m128i x = _mm_set_epi64x(0, (long long)(ctr + b));
            x = _mm_xor_si128(x, ak.rk[0]);
            for (int r = 1; r < 14; r++) x = _mm_aesenc_si128(x, ak.rk[r]);
            x = _mm_aesenclast_si128(x, ak.rk[14]);
            _mm_storeu_si128((__m128i*)(o + 2 * b), x);
        }
    }
#else
    for (uint64_t l = 0; l < n_lanes; l++) {
        AesKey ak;
        aes_expand(keys + 32 * l, ak);
        uint64_t ctr = nonces[l];
        uint64_t* o = out + l * 2 * nblocks;
        for (uint64_t b = 0; b < nblocks; b++) {
            uint8_t in[16] = {0}, ob[16];
            uint64_t c = ctr + b;
            for (int i = 0; i < 8; i++) in[i] = (uint8_t)(c >> (8 * i));
            aes_encrypt_block(ak, in, ob);
            memcpy(o + 2 * b, ob, 16);
        }
    }
#endif
}

// ---------------------------------------------------------------------------
// F_p bucket reduction: values [n, 4] uint32 limbs summed per bucket id,
// reduced mod 2^127-1 -> out [n_buckets, 4].
// ---------------------------------------------------------------------------

typedef unsigned __int128 u128;

void pvacn_bucket_reduce_modp(
    const uint32_t* limbs, const int64_t* bucket, uint64_t n,
    uint64_t n_buckets, uint32_t* out) {
    // accumulate limb-wise in u64 (no overflow for n < 2^32)
    uint64_t* acc = (uint64_t*)calloc(n_buckets * 4, 8);
    for (uint64_t i = 0; i < n; i++) {
        int64_t b = bucket[i];
        for (int k = 0; k < 4; k++) acc[b * 4 + k] += limbs[i * 4 + k];
    }
    const u128 P = (((u128)1) << 127) - 1;
    for (uint64_t b = 0; b < n_buckets; b++) {
        u128 lo = (u128)acc[b * 4 + 0] + (((u128)acc[b * 4 + 1]) << 32);
        u128 hi = (u128)acc[b * 4 + 2] + (((u128)acc[b * 4 + 3]) << 32);
        // value = lo + hi*2^64 < 2^161.  2^127 == 1 (mod p):
        // hi*2^64 = hL*2^64 + hH*2^127 == hL*2^64 + hH with hL < 2^63.
        u128 t = (lo & P) + (lo >> 127);
        u128 hL = hi & ((((u128)1) << 63) - 1);
        u128 hH = hi >> 63;
        t += hL << 64;                  // < 2^128, fits
        t = (t & P) + (t >> 127);
        t += hH;
        while (t >= P) t -= P;
        out[b * 4 + 0] = (uint32_t)t;
        out[b * 4 + 1] = (uint32_t)(t >> 32);
        out[b * 4 + 2] = (uint32_t)(t >> 64);
        out[b * 4 + 3] = (uint32_t)(t >> 96);
    }
    free(acc);
}

// Reduce rows of u64 limb accumulators (weight 2^32k) to canonical Fp.
void pvacn_reduce_u64_limbs(const uint64_t* acc, uint64_t n, uint32_t* out) {
    const u128 P = (((u128)1) << 127) - 1;
    for (uint64_t i = 0; i < n; i++) {
        u128 lo = (u128)acc[i * 4 + 0] + (((u128)acc[i * 4 + 1]) << 32);
        u128 hi = (u128)acc[i * 4 + 2] + (((u128)acc[i * 4 + 3]) << 32);
        u128 t = (lo & P) + (lo >> 127);
        u128 hL = hi & ((((u128)1) << 63) - 1);
        u128 hH = hi >> 63;
        t += hL << 64;
        t = (t & P) + (t >> 127);
        t += hH;
        while (t >= P) t -= P;
        out[i * 4 + 0] = (uint32_t)t;
        out[i * 4 + 1] = (uint32_t)(t >> 32);
        out[i * 4 + 2] = (uint32_t)(t >> 64);
        out[i * 4 + 3] = (uint32_t)(t >> 96);
    }
}

// ---------------------------------------------------------------------------
// Batched sigma_from_H column XOR (matrix.hpp:267-303): per edge, XOR k
// selected H rows ([mw] u32 each) plus e single noise bits into out[E, mw].
// Streams H rows instead of materializing the [E, k, mw] numpy gather.
// ---------------------------------------------------------------------------

static void sigma_xor_range(
    const uint32_t* H, uint64_t n_bits, uint64_t mw,
    const int32_t* cols, uint64_t k,
    const int32_t* noise, uint64_t e,
    uint64_t e0, uint64_t e1, uint32_t* out) {
    // Loop inversion: the per-edge row picks are uniform over n_bits, so a
    // direct gather is DRAM-latency bound on H.  Bucket the (edge, row)
    // pairs by row, then stream H sequentially ONCE while the edge
    // accumulators stay cache-hot (the e1-e0 block is sized by the caller
    // so out fits in LLC).  XOR commutes, so ordering is irrelevant.
    uint64_t ne = e1 - e0;
    uint64_t entries = ne * k;
    uint32_t* cnt = (uint32_t*)calloc(n_bits + 1, 4);
    uint32_t* eid = (uint32_t*)malloc(entries * 4);
    if (!cnt || !eid) {  // fall back to the direct gather
        free(cnt); free(eid);
        for (uint64_t ed = e0; ed < e1; ed++) {
            uint32_t* dst = out + ed * mw;
            memset(dst, 0, mw * 4);
            const int32_t* c = cols + ed * k;
            for (uint64_t j = 0; j < k; j++) {
                const uint32_t* row = H + (uint64_t)c[j] * mw;
                for (uint64_t wI = 0; wI < mw; wI++) dst[wI] ^= row[wI];
            }
            const int32_t* nn = noise + ed * e;
            for (uint64_t j = 0; j < e; j++) {
                uint32_t r = (uint32_t)nn[j];
                dst[r >> 5] ^= 1u << (r & 31);
            }
        }
        return;
    }
    const int32_t* cblk = cols + e0 * k;
    for (uint64_t i = 0; i < entries; i++) cnt[cblk[i] + 1]++;
    for (uint64_t r = 0; r < n_bits; r++) cnt[r + 1] += cnt[r];
    for (uint64_t ed = 0; ed < ne; ed++)
        for (uint64_t j = 0; j < k; j++)
            eid[cnt[cblk[ed * k + j]]++] = (uint32_t)ed;
    // cnt[r] now ends one past row r's entries; entries for row r are
    // [r == 0 ? 0 : cnt[r-1], cnt[r])
    memset(out + e0 * mw, 0, ne * mw * 4);
    uint64_t start = 0;
    for (uint64_t r = 0; r < n_bits; r++) {
        uint64_t end = cnt[r];
        if (end != start) {
            const uint32_t* row = H + r * mw;
            for (uint64_t i = start; i < end; i++) {
                uint32_t* dst = out + (e0 + (uint64_t)eid[i]) * mw;
                for (uint64_t wI = 0; wI < mw; wI++) dst[wI] ^= row[wI];
            }
        }
        start = end;
    }
    free(cnt);
    free(eid);
    for (uint64_t ed = e0; ed < e1; ed++) {
        uint32_t* dst = out + ed * mw;
        const int32_t* nn = noise + ed * e;
        for (uint64_t j = 0; j < e; j++) {
            uint32_t r = (uint32_t)nn[j];
            dst[r >> 5] ^= 1u << (r & 31);
        }
    }
}

void pvacn_sigma_xor(
    const uint32_t* H, uint64_t n_bits, uint64_t mw,
    const int32_t* cols, uint64_t k,
    const int32_t* noise, uint64_t e,
    uint64_t E, uint32_t* out) {
    // Block edges so each block's accumulators (~block * mw * 4 bytes)
    // stay LLC-resident during the streamed H pass: 2048 edges x 1 KB =
    // 2 MB per block.
    const uint64_t BLK = 2048;
    unsigned hw = std::thread::hardware_concurrency();
    uint64_t nt = hw ? hw : 1;
    if (nt > (E + BLK - 1) / BLK) nt = (E + BLK - 1) / BLK;
    if (nt <= 1) {
        for (uint64_t e0 = 0; e0 < E; e0 += BLK) {
            uint64_t e1 = e0 + BLK < E ? e0 + BLK : E;
            sigma_xor_range(H, n_bits, mw, cols, k, noise, e, e0, e1, out);
        }
        return;
    }
    std::atomic<uint64_t> next(0);
    std::vector<std::thread> ts;
    for (uint64_t t = 0; t < nt; t++)
        ts.emplace_back([&]() {
            for (;;) {
                uint64_t e0 = next.fetch_add(BLK);
                if (e0 >= E) return;
                uint64_t e1 = e0 + BLK < E ? e0 + BLK : E;
                sigma_xor_range(H, n_bits, mw, cols, k, noise, e, e0, e1,
                                out);
            }
        });
    for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------------------
// ct_mul cross-product aggregation (semantics of arithmetic.hpp:72-87):
// per (A-edge, B-edge) pair, key = ((lidA*LB + lidB)*B + (idxA+idxB)%B)*2
// + (chA != chB); pair weights multiply in F_{2^127-1} and sum per key in a
// dense accumulator over the keyspace LA*LB*B*2.  Emits nonzero buckets in
// ascending key order (matching np.unique + nonzero-filter).  Returns the
// emitted count, or -1 if the keyspace exceeds the dense cap.
// ---------------------------------------------------------------------------

static inline u128 fp_mul127(uint64_t alo, uint64_t ahi,
                             uint64_t blo, uint64_t bhi) {
    const u128 P = (((u128)1) << 127) - 1;
    // 128x128 -> 256 via four 64x64 partials (ahi, bhi < 2^63)
    u128 p0 = (u128)alo * blo;
    u128 p1 = (u128)alo * bhi;
    u128 p2 = (u128)ahi * blo;
    u128 p3 = (u128)ahi * bhi;
    uint64_t r0 = (uint64_t)p0;
    u128 mid = (p0 >> 64) + (uint64_t)p1 + (uint64_t)p2;
    uint64_t r1 = (uint64_t)mid;
    u128 hi2 = (mid >> 64) + (p1 >> 64) + (p2 >> 64) + (uint64_t)p3;
    uint64_t r2 = (uint64_t)hi2;
    uint64_t r3 = (uint64_t)(hi2 >> 64) + (uint64_t)(p3 >> 64);
    // reduce: R = L + H*2^127 with L = low 127 bits, H = R >> 127 < 2^127
    // (r3 < 2^62 since p3 < 2^126), and 2^127 == 1 (mod p)
    u128 L = (u128)r0 | (((u128)(r1 & 0x7FFFFFFFFFFFFFFFULL)) << 64);
    u128 H = (u128)(r1 >> 63) | (((u128)r2) << 1) | (((u128)r3) << 65);
    u128 t = L + H;                     // < 2^128
    t = (t & P) + (t >> 127);
    if (t >= P) t -= P;
    return t;
}

static void cross_agg_range(
    const int32_t* lidA, const int32_t* idxA, const int8_t* chA,
    const uint32_t* wA, uint64_t nA,
    const int32_t* lidB, const int32_t* idxB, const int8_t* chB,
    const uint64_t* bw, uint64_t nB,
    uint64_t LB, uint64_t Bmod, uint64_t tmod, uint64_t tsel,
    u128* acc) {
    const u128 P = (((u128)1) << 127) - 1;
    for (uint64_t i = 0; i < nA; i++) {
        // partition the A side by layer id: the output key's top bits are
        // lidA, so threads with different (lidA % tmod) touch disjoint acc
        // entries and the accumulator can be shared lock-free.
        if ((uint64_t)lidA[i] % tmod != tsel) continue;
        uint64_t alo = (uint64_t)wA[i * 4] | ((uint64_t)wA[i * 4 + 1] << 32);
        uint64_t ahi = (uint64_t)wA[i * 4 + 2] | ((uint64_t)wA[i * 4 + 3] << 32);
        uint64_t rowk = (uint64_t)lidA[i] * LB;
        uint64_t ia = (uint64_t)idxA[i];
        int8_t ca = chA[i];
        for (uint64_t j = 0; j < nB; j++) {
            uint64_t idx = ia + (uint64_t)idxB[j];
            if (idx >= Bmod) idx -= Bmod;
            uint64_t key = (((rowk + (uint64_t)lidB[j]) * Bmod + idx) << 1)
                           | (uint64_t)(ca != chB[j]);
            u128 t = acc[key] + fp_mul127(alo, ahi, bw[2 * j], bw[2 * j + 1]);
            t = (t & P) + (t >> 127);
            if (t >= P) t -= P;
            acc[key] = t;
        }
    }
}

int64_t pvacn_mul_cross_agg(
    const int32_t* lidA, const int32_t* idxA, const int8_t* chA,
    const uint32_t* wA, uint64_t nA,
    const int32_t* lidB, const int32_t* idxB, const int8_t* chB,
    const uint32_t* wB, uint64_t nB,
    uint64_t LA, uint64_t LB, uint64_t Bmod,
    int64_t* out_keys, uint32_t* out_w) {
    uint64_t keyspace = LA * LB * Bmod * 2;
    if (keyspace == 0 || keyspace > (1ull << 24)) return -1;
    u128* acc = (u128*)calloc(keyspace, sizeof(u128));
    if (!acc) return -1;
    // precompute B-side (lo, hi) once; A-side per outer iteration
    uint64_t* bw = (uint64_t*)malloc(nB * 2 * 8);
    if (!bw) { free(acc); return -1; }
    for (uint64_t j = 0; j < nB; j++) {
        bw[2 * j] = (uint64_t)wB[j * 4] | ((uint64_t)wB[j * 4 + 1] << 32);
        bw[2 * j + 1] = (uint64_t)wB[j * 4 + 2] | ((uint64_t)wB[j * 4 + 3] << 32);
    }
    unsigned hw = std::thread::hardware_concurrency();
    uint64_t nt = hw ? hw : 1;
    if (nt > LA) nt = LA;
    if (nA * nB < (1ull << 22)) nt = 1;  // don't spawn for tiny products
    if (nt <= 1) {
        cross_agg_range(lidA, idxA, chA, wA, nA, lidB, idxB, chB, bw, nB,
                        LB, Bmod, 1, 0, acc);
    } else {
        std::vector<std::thread> ts;
        for (uint64_t t = 0; t < nt; t++)
            ts.emplace_back(cross_agg_range, lidA, idxA, chA, wA, nA,
                            lidB, idxB, chB, bw, nB, LB, Bmod, nt, t, acc);
        for (auto& th : ts) th.join();
    }
    free(bw);
    int64_t cnt = 0;
    for (uint64_t k = 0; k < keyspace; k++) {
        if (acc[k] == 0) continue;
        u128 t = acc[k];
        out_keys[cnt] = (int64_t)k;
        out_w[cnt * 4 + 0] = (uint32_t)t;
        out_w[cnt * 4 + 1] = (uint32_t)(t >> 32);
        out_w[cnt * 4 + 2] = (uint32_t)(t >> 64);
        out_w[cnt * 4 + 3] = (uint32_t)(t >> 96);
        cnt++;
    }
    free(acc);
    return cnt;
}

// ---------------------------------------------------------------------------
// .ct codec: wire format (tests/bounty2_test.cpp:17-126) <-> SoA arrays.
// Caller first asks for counts, then provides buffers.
// ---------------------------------------------------------------------------

struct CtReader {
    const uint8_t* p;
    uint64_t n;
    uint64_t off = 0;
    int fail = 0;
    uint64_t need(uint64_t k) {
        if (off + k > n) { fail = 1; return 0; }
        uint64_t o = off;
        off += k;
        return o;
    }
    uint8_t u8() { uint64_t o = need(1); return fail ? 0 : p[o]; }
    uint16_t u16() { uint64_t o = need(2); if (fail) return 0; uint16_t x; memcpy(&x, p + o, 2); return x; }
    uint32_t u32() { uint64_t o = need(4); if (fail) return 0; uint32_t x; memcpy(&x, p + o, 4); return x; }
    uint64_t u64() { uint64_t o = need(8); if (fail) return 0; uint64_t x; memcpy(&x, p + o, 8); return x; }
};

// Pass 1: scan a serialized Cipher at `offset`, report (n_layers, n_edges,
// sigma_nbits, end_offset).  Returns 0 on success.
int pvacn_ct_scan(const uint8_t* buf, uint64_t len, uint64_t offset,
                  uint64_t* n_layers, uint64_t* n_edges,
                  uint64_t* sigma_nbits, uint64_t* end_offset) {
    CtReader r{buf, len};
    r.off = offset;
    uint32_t nL = r.u32(), nE = r.u32();
    for (uint32_t i = 0; i < nL && !r.fail; i++) {
        uint8_t rule = r.u8();
        if (rule == 0) { r.need(24); }
        else if (rule == 1) { r.need(8); }
        else { r.need(24); }
    }
    uint64_t nbits = 0;
    for (uint32_t e = 0; e < nE && !r.fail; e++) {
        r.need(4 + 2 + 1 + 1 + 16);
        uint32_t nb = r.u32();
        if (e == 0) nbits = nb;
        else if (nb != nbits) { r.fail = 1; break; }
        r.need(8ull * ((nb + 63) / 64));
    }
    if (r.fail) return 1;
    *n_layers = nL;
    *n_edges = nE;
    *sigma_nbits = nbits;
    *end_offset = r.off;
    return 0;
}

// Pass 2: decode into caller buffers.
// layers: [nL, 5] u64  (rule, ztag, nonce_lo, nonce_hi, pa<<32|pb)
// edges: lid i32[nE], idx i32[nE], ch i8[nE], w u64[nE,2],
//        sigma u64[nE, (nbits+63)/64]
int pvacn_ct_decode(const uint8_t* buf, uint64_t len, uint64_t offset,
                    uint64_t* layers, int32_t* lid, int32_t* idx, int8_t* ch,
                    uint64_t* w, uint64_t* sigma) {
    CtReader r{buf, len};
    r.off = offset;
    uint32_t nL = r.u32(), nE = r.u32();
    for (uint32_t i = 0; i < nL && !r.fail; i++) {
        uint8_t rule = r.u8();
        layers[i * 5] = rule;
        if (rule == 0) {
            layers[i * 5 + 1] = r.u64();
            layers[i * 5 + 2] = r.u64();
            layers[i * 5 + 3] = r.u64();
            layers[i * 5 + 4] = 0;
        } else if (rule == 1) {
            uint32_t pa = r.u32(), pb = r.u32();
            layers[i * 5 + 1] = 0; layers[i * 5 + 2] = 0; layers[i * 5 + 3] = 0;
            layers[i * 5 + 4] = ((uint64_t)pa << 32) | pb;
        } else {
            r.u64(); r.u64(); r.u64();
            layers[i * 5 + 1] = 0; layers[i * 5 + 2] = 0; layers[i * 5 + 3] = 0;
            layers[i * 5 + 4] = 0;
        }
    }
    uint64_t nw = 0;
    for (uint32_t e = 0; e < nE && !r.fail; e++) {
        lid[e] = (int32_t)r.u32();
        idx[e] = r.u16();
        ch[e] = (int8_t)r.u8();
        r.u8();
        w[e * 2] = r.u64();
        w[e * 2 + 1] = r.u64();
        uint32_t nb = r.u32();
        nw = (nb + 63) / 64;
        uint64_t o = r.need(8 * nw);
        if (!r.fail) memcpy(sigma + e * nw, buf + o, 8 * nw);
    }
    return r.fail;
}

// Encode one Cipher (append to caller-managed buffer; caller sizes it via
// pvacn_ct_encoded_size).
uint64_t pvacn_ct_encoded_size(uint64_t nL, const uint64_t* layers,
                               uint64_t nE, uint64_t sigma_nbits) {
    uint64_t sz = 8;
    for (uint64_t i = 0; i < nL; i++)
        sz += 1 + ((layers[i * 5] == 1) ? 8 : 24);
    sz += nE * (4 + 2 + 1 + 1 + 16 + 4 + 8 * ((sigma_nbits + 63) / 64));
    return sz;
}

void pvacn_ct_encode(
    uint64_t nL, const uint64_t* layers, uint64_t nE, uint64_t sigma_nbits,
    const int32_t* lid, const int32_t* idx, const int8_t* ch,
    const uint64_t* w, const uint64_t* sigma, uint8_t* out) {
    uint8_t* p = out;
    auto put32 = [&](uint32_t x) { memcpy(p, &x, 4); p += 4; };
    auto put64 = [&](uint64_t x) { memcpy(p, &x, 8); p += 8; };
    put32((uint32_t)nL);
    put32((uint32_t)nE);
    for (uint64_t i = 0; i < nL; i++) {
        uint8_t rule = (uint8_t)layers[i * 5];
        *p++ = rule;
        if (rule == 0) {
            put64(layers[i * 5 + 1]); put64(layers[i * 5 + 2]); put64(layers[i * 5 + 3]);
        } else if (rule == 1) {
            put32((uint32_t)(layers[i * 5 + 4] >> 32));
            put32((uint32_t)layers[i * 5 + 4]);
        } else {
            put64(0); put64(0); put64(0);
        }
    }
    uint64_t nw = (sigma_nbits + 63) / 64;
    for (uint64_t e = 0; e < nE; e++) {
        put32((uint32_t)lid[e]);
        uint16_t ix = (uint16_t)idx[e];
        memcpy(p, &ix, 2); p += 2;
        *p++ = (uint8_t)ch[e];
        *p++ = 0;
        put64(w[e * 2]); put64(w[e * 2 + 1]);
        put32((uint32_t)sigma_nbits);
        memcpy(p, sigma + e * nw, 8 * nw);
        p += 8 * nw;
    }
}

}  // extern "C"
