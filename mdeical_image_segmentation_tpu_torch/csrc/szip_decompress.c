/* szip decompression for the port's HDF5 reader (utils/szip.py,
 * utils/hdf5.py): HDF5's szip filter (id 4) codes each chunk with the
 * adaptive Rice coder of CCSDS 121.0-B (Lossless Data Compression), as
 * libaec's szip interface (sz_compat.c) does.  Built with the host C
 * compiler at first use and called through ctypes, as
 * csrc/zstd_decompress.c is.
 *
 * The coded data set.  Samples of n bits (n = the filter's bits per pixel,
 * 8 where that is 32 or 64) are grouped in blocks of J (pixels per block)
 * and blocks in reference sample intervals (RSI) of r = ceil(pixels per
 * scanline / J) blocks.  Bits are read most significant first, without
 * byte alignment anywhere.  Each block opens with an option identifier of
 * 3 bits (n <= 8), 4 (n <= 16) or 5 (n <= 32):
 *   0, then one bit:  0 a run of zero blocks, 1 the second extension;
 *   all ones:         no compression, J samples of n bits;
 *   k + 1 otherwise:  the k-split option: J fundamental sequence codes
 *                     (m zeros then a one for m) of each sample's high
 *                     part, then the J low parts of k bits (k = 0 is the
 *                     fundamental sequence option).
 * With the NN preprocessor the first block of every RSI carries a
 * reference sample of n bits, after the identifier (and after the low
 * entropy bit), and codes J - 1 samples; a block without compression
 * holds the reference as its first raw sample.  A run of zero blocks
 * codes its length as a fundamental sequence code m: m + 1 blocks for
 * m < 4, m blocks for m > 4, and m = 4 the rest of the segment (64
 * blocks) or of the RSI, whichever ends first.  The second extension codes
 * pairs (a, b) as gamma = (a + b)(a + b + 1) / 2 + b, a fundamental
 * sequence code each; with a reference the first pair's a is left out.
 *
 * The NN preprocessor's inverse: the reference sample is output as it is
 * and each mapped residual d after it, with the previous output x as the
 * prediction and theta = min(x, xmax - x), gives x + d / 2 (d even) or
 * x - (d + 1) / 2 (d odd) where d <= 2 theta, else d (theta = x) or
 * xmax - d (theta = xmax - x); samples are unsigned, xmax = 2^n - 1.
 *
 * libaec's szip interface, which HDF5's filter calls: samples of 9-16 bits
 * take 2 bytes and of 17-32 bits 4 bytes of output, most significant byte
 * first with the MSB option, else least; 32- and 64-bit pixels are coded
 * as 8-bit samples of the byte planes (byte j of every pixel, plane after
 * plane); and where the scanline is not a whole number of blocks, every
 * scanline was padded to r * J samples before coding, and the padding is
 * dropped.  The stream codes whole scanlines; the output stops at out_len.
 *
 * tpuseg_szip_decompress(in, n, out, out_len, mask, ppb, bpp, pps) returns
 * out_len or a negative code:
 *   -1 the stream ends before out_len bytes are decoded
 *   -2 corrupt data (a code or a value out of range)
 *   -3 parameters this coder does not take
 *   -4 out of memory
 * Every read is checked against n and every write against out_len.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum { E_SHORT = -1, E_CORRUPT = -2, E_PARAMS = -3, E_NOMEM = -4 };

#define SZ_MSB_OPTION_MASK 16
#define SZ_NN_OPTION_MASK 32
#define SEGMENT_BLOCKS 64
#define ROS 5           /* the zero-block code for "the rest of the segment" */
#define SE_MAX 90       /* the largest second-extension code: a + b <= 12 */

typedef struct {
    const uint8_t *in;
    int64_t n, next;    /* input bytes, the next one to load */
    uint64_t acc;       /* the low `have` bits are the next bits, MSB first */
    int have;
} bits_t;

static void refill(bits_t *b)
{
    while (b->have <= 48 && b->next < b->n) {   /* at most 56 bits */
        b->acc = (b->acc << 8) | b->in[b->next++];
        b->have += 8;
    }
}

/* the next k bits (k <= 32); -1 past the end of the input */
static int64_t get_bits(bits_t *b, int k)
{
    if (k == 0)
        return 0;
    if (b->have < k) {
        refill(b);
        if (b->have < k)
            return -1;
    }
    b->have -= k;
    return (int64_t)((b->acc >> b->have) & ((UINT64_C(1) << k) - 1));
}

/* a fundamental sequence code: the zeros before the next one, at most
 * `limit`; -1 past the end of the input, -2 over the limit */
static int64_t get_fs(bits_t *b, uint64_t limit)
{
    uint64_t zeros = 0;
    for (;;) {
        if (b->have == 0) {
            refill(b);
            if (b->have == 0)
                return -1;
        }
        uint64_t x = b->acc & ((UINT64_C(1) << b->have) - 1);
        if (x == 0) {
            zeros += (uint64_t)b->have;
            b->have = 0;
        } else {
            int top = 63 - __builtin_clzll(x);
            zeros += (uint64_t)(b->have - 1 - top);
            b->have = top;
            return zeros > limit ? -2 : (int64_t)zeros;
        }
        if (zeros > limit)
            return -2;
    }
}

/* the second extension's pairs: sum[m] = a + b, base[m] = the code of
 * (a + b, 0) */
static void se_tables(uint8_t *sum, uint8_t *base)
{
    int m = 0;
    for (int s = 0; s <= 12; s++) {
        int first = m;
        for (int j = 0; j <= s; j++, m++) {
            sum[m] = (uint8_t)s;
            base[m] = (uint8_t)first;
        }
    }
}

/* Decode `count` samples of `bits` bits (blocks of `block`, RSIs of `rsi`
 * blocks, with the NN preprocessor where `nn`) into out[]; 0 or a
 * negative code. */
static int decode_samples(bits_t *b, uint32_t *out, int64_t count,
                          int bits, int block, int rsi, int nn)
{
    const int id_len = bits > 16 ? 5 : bits > 8 ? 4 : 3;
    const int64_t id_raw = (INT64_C(1) << id_len) - 1;
    const uint64_t xmax = (UINT64_C(1) << bits) - 1;
    uint8_t se_sum[SE_MAX + 1], se_base[SE_MAX + 1];
    uint32_t *v = malloc(sizeof(uint32_t) * (size_t)block * SEGMENT_BLOCKS);
    int64_t done = 0;
    int rc = 0;
    if (v == NULL)
        return E_NOMEM;
    se_tables(se_sum, se_base);
    while (done < count) {
        uint64_t last = 0;   /* the previous output sample of this RSI */
        for (int blk = 0; blk < rsi && done < count;) {
            const int ref = nn && blk == 0;
            int64_t n = 0;   /* samples of this code, into v[] */
            int64_t id = get_bits(b, id_len);
            if (id < 0) { rc = E_SHORT; goto out; }
            int blocks = 1;
            if (id == 0) {
                int64_t se = get_bits(b, 1);
                if (se < 0) { rc = E_SHORT; goto out; }
                if (ref) {
                    int64_t r = get_bits(b, bits);
                    if (r < 0) { rc = E_SHORT; goto out; }
                    v[n++] = (uint32_t)r;
                }
                if (se == 0) {   /* a run of zero blocks */
                    int64_t m = get_fs(b, SEGMENT_BLOCKS);
                    if (m < 0) { rc = m == -1 ? E_SHORT : E_CORRUPT; goto out; }
                    blocks = (int)m + 1;
                    if (blocks == ROS) {
                        int seg = SEGMENT_BLOCKS - blk % SEGMENT_BLOCKS;
                        blocks = rsi - blk < seg ? rsi - blk : seg;
                    } else if (blocks > ROS) {
                        blocks--;
                    }
                    if (blocks > rsi - blk) { rc = E_CORRUPT; goto out; }
                    int64_t zeros = (int64_t)blocks * block - ref;
                    memset(v + n, 0, sizeof(uint32_t) * (size_t)zeros);
                    n += zeros;
                } else {         /* the second extension */
                    for (int i = ref; i < block;) {
                        int64_t m = get_fs(b, SE_MAX);
                        if (m < 0) { rc = m == -1 ? E_SHORT : E_CORRUPT; goto out; }
                        uint32_t d1 = (uint32_t)(m - se_base[m]);
                        if ((i & 1) == 0) {
                            v[n++] = se_sum[m] - d1;
                            i++;
                        }
                        v[n++] = d1;
                        i++;
                    }
                }
            } else if (id == id_raw) {   /* no compression */
                for (int i = 0; i < block; i++) {
                    int64_t r = get_bits(b, bits);
                    if (r < 0) { rc = E_SHORT; goto out; }
                    v[n++] = (uint32_t)r;
                }
            } else {                      /* the k-split option */
                const int k = (int)id - 1;
                if (ref) {
                    int64_t r = get_bits(b, bits);
                    if (r < 0) { rc = E_SHORT; goto out; }
                    v[n++] = (uint32_t)r;
                }
                const uint64_t high = k >= bits ? 0 : xmax >> k;
                for (int i = ref; i < block; i++) {
                    int64_t m = get_fs(b, high);
                    if (m < 0) { rc = m == -1 ? E_SHORT : E_CORRUPT; goto out; }
                    v[n++] = (uint32_t)m;
                }
                if (k) {
                    for (int i = ref; i < block; i++) {
                        int64_t low = get_bits(b, k);
                        if (low < 0) { rc = E_SHORT; goto out; }
                        uint64_t x = ((uint64_t)v[i] << k) | (uint64_t)low;
                        if (x > xmax) { rc = E_CORRUPT; goto out; }
                        v[i] = (uint32_t)x;
                    }
                }
            }
            /* the preprocessor's inverse, then out[] */
            for (int64_t i = 0; i < n && done < count; i++) {
                uint64_t d = v[i];
                if (!nn) {
                    out[done++] = (uint32_t)d;
                    continue;
                }
                if (ref && i == 0) {
                    last = d;
                } else {
                    uint64_t theta = last < xmax - last ? last : xmax - last;
                    if (d <= 2 * theta)
                        last = (d & 1) ? last - (d + 1) / 2 : last + d / 2;
                    else if (theta == last)
                        last = d;
                    else
                        last = xmax - d;
                    if (last > xmax) { rc = E_CORRUPT; goto out; }
                }
                out[done++] = (uint32_t)last;
            }
            blk += blocks;
        }
    }
out:
    free(v);
    return rc;
}

int64_t tpuseg_szip_decompress(const uint8_t *in, int64_t in_len,
                               uint8_t *out, int64_t out_len, int32_t mask,
                               int32_t ppb, int32_t bpp, int32_t pps)
{
    if (in_len < 0 || out_len < 0 || ppb < 2 || ppb > 64 || ppb % 2
        || pps < 1 || pps > 1 << 20 || bpp < 1
        || (bpp > 32 && bpp != 64))
        return E_PARAMS;
    const int planes = bpp == 32 || bpp == 64 ? bpp / 8 : 0;
    const int bits = planes ? 8 : bpp;
    const int width = bits > 16 ? 4 : bits > 8 ? 2 : 1;   /* bytes a sample */
    const int msb = (mask & SZ_MSB_OPTION_MASK) != 0;
    const int nn = (mask & SZ_NN_OPTION_MASK) != 0;
    const int64_t rsi = ((int64_t)pps + ppb - 1) / ppb;
    const int64_t line = rsi * ppb;          /* coded samples a scanline */
    if (out_len % width || (planes && out_len % planes))
        return E_PARAMS;
    const int64_t samples = out_len / width;
    const int64_t lines = (samples + pps - 1) / pps;
    /* padded scanlines are coded whole; otherwise the stream is read up
     * to the last sample wanted */
    const int64_t count = line != pps ? lines * line : samples;
    uint32_t *s = malloc(sizeof(uint32_t) * (size_t)(count ? count : 1));
    uint8_t *planar = planes ? malloc((size_t)(out_len ? out_len : 1)) : NULL;
    int64_t rc = out_len;
    if (s == NULL || (planes && planar == NULL)) {
        rc = E_NOMEM;
        goto done;
    }
    bits_t b = {in, in_len, 0, 0, 0};
    int r = decode_samples(&b, s, count, bits, ppb, (int)rsi, nn);
    if (r < 0) {
        rc = r;
        goto done;
    }
    uint8_t *dst = planes ? planar : out;
    for (int64_t i = 0, o = 0; i < samples; i++, o += width) {
        uint32_t x = s[(i / pps) * line + i % pps];
        for (int j = 0; j < width; j++) {
            int shift = 8 * (msb ? width - 1 - j : j);
            dst[o + j] = (uint8_t)(x >> shift);
        }
    }
    if (planes) {   /* byte j of pixel i is planar[j * pixels + i] */
        const int64_t pixels = out_len / planes;
        for (int64_t i = 0; i < pixels; i++)
            for (int j = 0; j < planes; j++)
                out[i * planes + j] = planar[j * pixels + i];
    }
done:
    free(s);
    free(planar);
    return rc;
}
