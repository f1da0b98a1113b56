/* Native host-side Falcon primitives: SHAKE256 + batched hash-to-point.
 *
 * TPU-native-framework equivalent of the reference's native substrate
 * (falcon-rust wrapping the Falcon reference C, SURVEY.md section 2.3):
 * hash-to-point is inherently sequential rejection sampling per message and
 * lives on the host hot path of batched witness generation
 * (SURVEY.md section 7 "hard parts" item 4).  This file implements
 * Keccak-f[1600]/SHAKE256 from the FIPS 202 specification and the Falcon
 * HashToPoint loop (SHAKE256(nonce || msg); squeeze 16-bit big-endian
 * chunks t; accept t < 5*q; emit t mod q), batched with OpenMP when
 * available.
 *
 * Built as a shared library via falcon_r1cs_tpu/native/__init__.py (ctypes;
 * no pybind11 dependency).
 */

#include <stdint.h>
#include <string.h>

#define Q 12289
#define ACCEPT_BOUND (5 * Q) /* 61445 */
#define RATE 136             /* SHAKE256 rate in bytes */

typedef struct {
    uint64_t s[25];
    unsigned pos; /* squeeze offset into the current rate block */
} shake_ctx;

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

static inline uint64_t rotl64(uint64_t x, int n) {
    return (x << n) | (x >> (64 - n));
}

static void keccak_f1600(uint64_t s[25]) {
    /* rho rotation offsets and pi lane permutation, FIPS 202 */
    static const int rho[24] = {1,  3,  6,  10, 15, 21, 28, 36,
                                45, 55, 2,  14, 27, 41, 56, 8,
                                25, 43, 62, 18, 39, 61, 20, 44};
    static const int pi[24] = {10, 7,  11, 17, 18, 3,  5,  16,
                               8,  21, 24, 4,  15, 23, 19, 13,
                               12, 2,  20, 14, 22, 9,  6,  1};
    uint64_t bc[5], t;
    for (int round = 0; round < 24; round++) {
        /* theta */
        for (int i = 0; i < 5; i++)
            bc[i] = s[i] ^ s[i + 5] ^ s[i + 10] ^ s[i + 15] ^ s[i + 20];
        for (int i = 0; i < 5; i++) {
            t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
            for (int j = 0; j < 25; j += 5) s[j + i] ^= t;
        }
        /* rho + pi */
        t = s[1];
        for (int i = 0; i < 24; i++) {
            int j = pi[i];
            bc[0] = s[j];
            s[j] = rotl64(t, rho[i]);
            t = bc[0];
        }
        /* chi */
        for (int j = 0; j < 25; j += 5) {
            for (int i = 0; i < 5; i++) bc[i] = s[j + i];
            for (int i = 0; i < 5; i++)
                s[j + i] = bc[i] ^ ((~bc[(i + 1) % 5]) & bc[(i + 2) % 5]);
        }
        /* iota */
        s[0] ^= RC[round];
    }
}

static void shake256_init_absorb(shake_ctx *c, const uint8_t *data1,
                                 long len1, const uint8_t *data2, long len2) {
    memset(c->s, 0, sizeof(c->s));
    uint8_t block[RATE];
    unsigned fill = 0;
    const uint8_t *parts[2] = {data1, data2};
    long lens[2] = {len1, len2};
    for (int p = 0; p < 2; p++) {
        const uint8_t *d = parts[p];
        long len = lens[p];
        while (len > 0) {
            unsigned take = (unsigned)((len < (long)(RATE - fill))
                                           ? len
                                           : (long)(RATE - fill));
            memcpy(block + fill, d, take);
            fill += take;
            d += take;
            len -= take;
            if (fill == RATE) {
                for (int i = 0; i < RATE / 8; i++) {
                    uint64_t w;
                    memcpy(&w, block + 8 * i, 8);
                    c->s[i] ^= w; /* little-endian host assumed (x86/ARM) */
                }
                keccak_f1600(c->s);
                fill = 0;
            }
        }
    }
    /* pad: SHAKE domain 0x1F ... 0x80 */
    memset(block + fill, 0, RATE - fill);
    block[fill] ^= 0x1F;
    block[RATE - 1] ^= 0x80;
    for (int i = 0; i < RATE / 8; i++) {
        uint64_t w;
        memcpy(&w, block + 8 * i, 8);
        c->s[i] ^= w;
    }
    keccak_f1600(c->s);
    c->pos = 0;
}

static inline uint8_t shake_next_byte(shake_ctx *c) {
    if (c->pos == RATE) {
        keccak_f1600(c->s);
        c->pos = 0;
    }
    uint8_t b = (uint8_t)(c->s[c->pos >> 3] >> (8 * (c->pos & 7)));
    c->pos++;
    return b;
}

/* One message: hash_to_point(msg, nonce) -> n coefficients in [0, q). */
static void hash_to_point_one(const uint8_t *nonce, long nonce_len,
                              const uint8_t *msg, long msg_len,
                              int32_t *out, long n) {
    shake_ctx c;
    shake256_init_absorb(&c, nonce, nonce_len, msg, msg_len);
    long filled = 0;
    while (filled < n) {
        unsigned hi = shake_next_byte(&c);
        unsigned lo = shake_next_byte(&c);
        unsigned t = (hi << 8) | lo;
        if (t < ACCEPT_BOUND) out[filled++] = (int32_t)(t % Q);
    }
}

/* ------------------------------------------------------------------ */
/* 8-lane SIMD Keccak (GCC vector extensions: AVX-512 = one register,  */
/* AVX2 = two).  Eight messages advance through the permutation        */
/* simultaneously; the data-dependent rejection loop stays scalar per  */
/* lane over the squeezed buffers, with a scalar top-up continuation   */
/* for the (\~1e-20) case a lane exhausts its squeeze budget.          */
/* ------------------------------------------------------------------ */

typedef uint64_t v8u64 __attribute__((vector_size(64), aligned(64)));

#define VLANES 8

static inline v8u64 vrotl64(v8u64 x, int n) {
    return (x << n) | (x >> (64 - n));
}

static void keccak_f1600_x8(v8u64 s[25]) {
    static const int rho[24] = {1,  3,  6,  10, 15, 21, 28, 36,
                                45, 55, 2,  14, 27, 41, 56, 8,
                                25, 43, 62, 18, 39, 61, 20, 44};
    static const int pi[24] = {10, 7,  11, 17, 18, 3,  5,  16,
                               8,  21, 24, 4,  15, 23, 19, 13,
                               12, 2,  20, 14, 22, 9,  6,  1};
    v8u64 bc[5], t;
    for (int round = 0; round < 24; round++) {
        for (int i = 0; i < 5; i++)
            bc[i] = s[i] ^ s[i + 5] ^ s[i + 10] ^ s[i + 15] ^ s[i + 20];
        for (int i = 0; i < 5; i++) {
            t = bc[(i + 4) % 5] ^ vrotl64(bc[(i + 1) % 5], 1);
            for (int j = 0; j < 25; j += 5) s[j + i] ^= t;
        }
        t = s[1];
        for (int i = 0; i < 24; i++) {
            int j = pi[i];
            bc[0] = s[j];
            s[j] = vrotl64(t, rho[i]);
            t = bc[0];
        }
        for (int j = 0; j < 25; j += 5) {
            for (int i = 0; i < 5; i++) bc[i] = s[j + i];
            for (int i = 0; i < 5; i++)
                s[j + i] = bc[i] ^ ((~bc[(i + 1) % 5]) & bc[(i + 2) % 5]);
        }
        s[0] ^= RC[round]; /* scalar broadcasts across lanes */
    }
}

/* Rejection-sample n coefficients from a squeezed byte buffer.
 * Returns count filled (== n unless the buffer ran dry). */
static long reject_from_buf(const uint8_t *buf, long buf_len, int32_t *out,
                            long n) {
    long filled = 0;
    for (long i = 0; i + 1 < buf_len && filled < n; i += 2) {
        unsigned t = ((unsigned)buf[i] << 8) | buf[i + 1];
        if (t < ACCEPT_BOUND) out[filled++] = (int32_t)(t % Q);
    }
    return filled;
}

/* Scalar continuation for a lane whose budget ran dry: state is the
 * post-last-extraction Keccak state. */
static void h2p_topup(uint64_t s[25], int32_t *out, long filled, long n) {
    uint8_t block[RATE];
    while (filled < n) {
        keccak_f1600(s);
        memcpy(block, s, RATE); /* little-endian host */
        for (int i = 0; i + 1 < RATE && filled < n; i += 2) {
            unsigned t = ((unsigned)block[i] << 8) | block[i + 1];
            if (t < ACCEPT_BOUND) out[filled++] = (int32_t)(t % Q);
        }
    }
}

/* Eight single-absorb-block messages at once. blocks: 8 x RATE padded
 * absorb blocks.  squeeze_blocks chosen by the caller (>= 1). */
static void hash_to_point_x8(const uint8_t blocks[VLANES][RATE],
                             int32_t *outs[VLANES], long n,
                             long squeeze_blocks) {
    v8u64 s[25];
    memset(s, 0, sizeof(s));
    for (int w = 0; w < RATE / 8; w++) {
        for (int l = 0; l < VLANES; l++) {
            uint64_t word;
            memcpy(&word, blocks[l] + 8 * w, 8);
            s[w][l] ^= word;
        }
    }
    keccak_f1600_x8(s);
    /* squeeze into per-lane buffers */
    uint8_t buf[VLANES][64 * RATE]; /* squeeze_blocks <= 64 by budget rule */
    for (long b = 0; b < squeeze_blocks; b++) {
        if (b) keccak_f1600_x8(s);
        for (int w = 0; w < RATE / 8; w++) {
            for (int l = 0; l < VLANES; l++) {
                uint64_t word = s[w][l];
                memcpy(buf[l] + b * RATE + 8 * w, &word, 8);
            }
        }
    }
    for (int l = 0; l < VLANES; l++) {
        long filled =
            reject_from_buf(buf[l], squeeze_blocks * RATE, outs[l], n);
        if (filled < n) { /* astronomically rare */
            uint64_t sl[25];
            for (int w = 0; w < 25; w++) sl[w] = s[w][l];
            h2p_topup(sl, outs[l], filled, n);
        }
    }
}

/* Batched entry point.
 * msgs: concatenated message bytes; msg_offsets: batch+1 offsets.
 * nonces: batch * nonce_len bytes.  out: batch * n int32.
 *
 * Messages whose nonce+msg fits one absorb block (the Falcon case:
 * 40-byte nonce + short message) go through the 8-lane SIMD path in
 * groups of 8; everything else falls back to the scalar path.
 */
void hash_to_point_batch(const uint8_t *msgs, const int64_t *msg_offsets,
                         const uint8_t *nonces, long nonce_len, int32_t *out,
                         long batch, long n) {
    /* squeeze budget: expected bytes = 2n/0.9376 ~= 2.133n; 2.5n gives a
     * >10-sigma margin, topped up scalar-ly in the tail case */
    long squeeze_blocks = (5 * n / 2 + RATE - 1) / RATE + 1;
    if (squeeze_blocks > 64) squeeze_blocks = 64;
#pragma omp parallel for schedule(dynamic)
    for (long g = 0; g < (batch + VLANES - 1) / VLANES; g++) {
        long b0 = g * VLANES;
        long b1 = b0 + VLANES < batch ? b0 + VLANES : batch;
        int vec_ok = (b1 - b0) == VLANES;
        for (long b = b0; vec_ok && b < b1; b++)
            if (nonce_len + (msg_offsets[b + 1] - msg_offsets[b]) >= RATE)
                vec_ok = 0;
        if (vec_ok) {
            uint8_t blocks[VLANES][RATE];
            int32_t *outs[VLANES];
            for (long b = b0; b < b1; b++) {
                int l = (int)(b - b0);
                long mlen = msg_offsets[b + 1] - msg_offsets[b];
                memset(blocks[l], 0, RATE);
                memcpy(blocks[l], nonces + b * nonce_len, nonce_len);
                memcpy(blocks[l] + nonce_len, msgs + msg_offsets[b], mlen);
                blocks[l][nonce_len + mlen] ^= 0x1F;
                blocks[l][RATE - 1] ^= 0x80;
                outs[l] = out + b * n;
            }
            hash_to_point_x8(blocks, outs, n, squeeze_blocks);
        } else {
            for (long b = b0; b < b1; b++)
                hash_to_point_one(nonces + b * nonce_len, nonce_len,
                                  msgs + msg_offsets[b],
                                  msg_offsets[b + 1] - msg_offsets[b],
                                  out + b * n, n);
        }
    }
}

/* Raw SHAKE256 for tests: out_len bytes of SHAKE256(data). */
void shake256(const uint8_t *data, long len, uint8_t *out, long out_len) {
    shake_ctx c;
    shake256_init_absorb(&c, data, len, data, 0);
    for (long i = 0; i < out_len; i++) out[i] = shake_next_byte(&c);
}

/* ------------------------------------------------------------------ */
/* Wire codecs: 14-bit public-key packing and Golomb-Rice signature    */
/* compression, batched (the data-loader hot path of the pipeline).   */
/* Formats per falcon_r1cs_tpu/falcon/codec.py.                        */
/* ------------------------------------------------------------------ */

/* Decode one 14-bit-packed public key body (after the header byte).
 * Returns 0 on success, -1 on out-of-range coefficient or bad padding. */
int decode_pk_body(const uint8_t *body, long body_len, int32_t *out, long n) {
    uint32_t acc = 0;
    int acc_bits = 0;
    long pos = 0;
    for (long i = 0; i < n; i++) {
        while (acc_bits < 14) {
            if (pos >= body_len) return -1;
            acc = (acc << 8) | body[pos++];
            acc_bits += 8;
        }
        acc_bits -= 14;
        uint32_t c = (acc >> acc_bits) & 0x3FFF;
        if (c >= Q) return -1;
        out[i] = (int32_t)c;
    }
    if (acc & ((1u << acc_bits) - 1)) return -1;
    return 0;
}

/* Batched pk decode: bodies laid out contiguously, fixed stride. */
int decode_pk_batch(const uint8_t *bodies, long stride, int32_t *out,
                    long batch, long n) {
    int rc = 0;
#pragma omp parallel for schedule(static)
    for (long b = 0; b < batch; b++) {
        if (decode_pk_body(bodies + b * stride, stride, out + b * n, n))
#pragma omp atomic write
            rc = -1;
    }
    return rc;
}

/* Decode one compressed signature payload into signed coefficients.
 * Returns 0 on success, -1 on malformed stream. */
int decode_sig_body(const uint8_t *body, long body_len, int32_t *out,
                    long n) {
    long pos = 0;
    int bits = 0;
    uint32_t acc = 0;
#define GETBIT(dst)                        \
    do {                                   \
        if (bits == 0) {                   \
            if (pos >= body_len) return -1;\
            acc = body[pos++];             \
            bits = 8;                      \
        }                                  \
        bits--;                            \
        (dst) = (acc >> bits) & 1;         \
    } while (0)
    for (long i = 0; i < n; i++) {
        uint32_t sign, bit, mag = 0;
        GETBIT(sign);
        for (int k = 0; k < 7; k++) {
            GETBIT(bit);
            mag = (mag << 1) | bit;
        }
        uint32_t high = 0;
        for (;;) {
            GETBIT(bit);
            if (bit) break;
            if (++high > 16) return -1;
        }
        mag |= high << 7;
        if (sign && mag == 0) return -1;
        out[i] = sign ? -(int32_t)mag : (int32_t)mag;
    }
    /* remaining bits and bytes must be zero padding */
    if (acc & ((1u << bits) - 1)) return -1;
    for (; pos < body_len; pos++)
        if (body[pos]) return -1;
    return 0;
#undef GETBIT
}

int decode_sig_batch(const uint8_t *bodies, long stride, int32_t *out,
                     long batch, long n) {
    int rc = 0;
#pragma omp parallel for schedule(static)
    for (long b = 0; b < batch; b++) {
        if (decode_sig_body(bodies + b * stride, stride, out + b * n, n))
#pragma omp atomic write
            rc = -1;
    }
    return rc;
}
