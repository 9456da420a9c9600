/* The heavy loops of the port's JPEG reader (utils/jpeg.py): Huffman
 * entropy decoding of baseline, extended and progressive scans into
 * coefficient blocks, then dequantisation, the inverse DCT, upsampling and
 * colour conversion into 8-bit pixels.  Built with the host compiler at
 * first use and called through ctypes, as csrc/lzw_decode.c is.  Marker
 * parsing stays in Python.
 *
 * The arithmetic follows libjpeg-turbo 3.1 under PIL's defaults, to the
 * bit:
 *   - entropy decoding: jdhuff.c (sequential) and jdphuff.c (progressive:
 *     DC first and refinement, AC first with EOB runs, AC refinement with
 *     its correction-bit order); FF/00 stuffing, FF fill bytes, restart
 *     markers; the extra zig-zag entries that send a corrupt run to
 *     coefficient 63;
 *   - the inverse DCT: the islow IDCT as libjpeg-turbo's x86-64 SIMD code
 *     computes it (below, at idct_islow);
 *   - upsampling: jdsample.c's fancy h2v1 and h2v2 filters (the latter
 *     with the row above and below; the first and last real rows stand in
 *     past the image's edges, as jdmainct.c's context pointers make them),
 *     and plain replication where the component is at most 2 samples wide;
 *   - colour: jdcolor.c's YCbCr->RGB tables (SCALEBITS 16).
 *
 * Coefficient planes: int16 blocks of 64 in natural order, one plane per
 * component, `stride` blocks per row.  Scans write into them; the output
 * pass reads them.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define LOOK 9 /* Huffman lookahead bits */

enum {
    ERR_TRUNCATED = -1, /* a code needs bits past the scan's data */
    ERR_BAD_CODE = -2,  /* no Huffman code of 16 bits or fewer matches */
    ERR_RESTART = -3,   /* a restart marker is missing or out of order */
    ERR_TABLE = -4,     /* a Huffman table libjpeg refuses */
    ERR_DC = -5,        /* a DC prediction overflows */
    ERR_MEMORY = -6,
};

/* jpeg_natural_order, with libjpeg's 16 extra entries: a run past the
 * end of a corrupt block lands on coefficient 63 */
static const int natural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

/* -- Huffman tables (jdhuff.c's jpeg_make_d_derived_tbl) ----------------- */

typedef struct {
    int32_t maxcode[18]; /* largest code of each length, -1 if none */
    int32_t valoffset[18];
    int32_t count;
    uint8_t huffval[256];
    uint16_t look[1 << LOOK]; /* (length << 8) | symbol; 0 = longer */
} htable;

static int build_table(const uint8_t *counts, const uint8_t *values, int dc,
                       htable *t)
{
    uint8_t size[257];
    uint32_t code[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
        for (int i = 0; i < counts[l - 1]; i++) {
            if (p >= 256)
                return ERR_TABLE;
            size[p++] = (uint8_t)l;
        }
    size[p] = 0;
    t->count = p;
    uint32_t c = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
        while (size[p] == si)
            code[p++] = c++;
        if (c >= (1u << si))
            return ERR_TABLE;
        c <<= 1;
        si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
        if (counts[l - 1]) {
            t->valoffset[l] = p - (int32_t)code[p];
            p += counts[l - 1];
            t->maxcode[l] = (int32_t)code[p - 1];
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->valoffset[17] = 0;
    t->maxcode[17] = 0xFFFFF;
    memcpy(t->huffval, values, 256);
    memset(t->look, 0, sizeof t->look);
    p = 0;
    for (int l = 1; l <= LOOK; l++)
        for (int i = 0; i < counts[l - 1]; i++, p++) {
            uint32_t base = code[p] << (LOOK - l);
            for (uint32_t k = 0; k < (1u << (LOOK - l)); k++)
                t->look[base + k] = (uint16_t)((l << 8) | values[p]);
        }
    if (dc)
        for (int i = 0; i < t->count; i++)
            if (values[i] > 15)
                return ERR_TABLE;
    return 0;
}

/* -- the bit reader ---------------------------------------------------- */

typedef struct {
    const uint8_t *d;
    int64_t len, pos;   /* next byte to read */
    uint64_t acc;       /* `bits` bits, right-aligned */
    int bits, pad;      /* the lowest `pad` bits are zeros past the data */
    int hit;            /* reached a marker (or the end of the data) */
    int64_t marker_pos; /* its first FF */
} reader;

static void fill(reader *r)
{
    while (r->bits <= 56) {
        uint32_t b = 0;
        if (!r->hit) {
            if (r->pos >= r->len) {
                r->hit = 1;
                r->marker_pos = r->len;
            } else if (r->d[r->pos] != 0xFF) {
                b = r->d[r->pos++];
            } else {
                /* FF, any fill FFs, then 00 for a data byte, else a marker */
                int64_t q = r->pos + 1;
                while (q < r->len && r->d[q] == 0xFF)
                    q++;
                if (q < r->len && r->d[q] == 0) {
                    b = 0xFF;
                    r->pos = q + 1;
                } else {
                    r->hit = 1;
                    r->marker_pos = r->pos;
                }
            }
        }
        if (r->hit)
            r->pad += 8;
        r->acc = (r->acc << 8) | b;
        r->bits += 8;
    }
}

static inline int consume(reader *r, int n)
{
    r->bits -= n;
    return r->bits < r->pad ? ERR_TRUNCATED : 0;
}

static inline int get_bits(reader *r, int n, int *out)
{
    if (n == 0) {
        *out = 0;
        return 0;
    }
    if (r->bits < n)
        fill(r);
    *out = (int)((r->acc >> (r->bits - n)) & ((1u << n) - 1));
    return consume(r, n);
}

static inline int decode(reader *r, const htable *t, int *sym)
{
    if (r->bits < 16)
        fill(r);
    uint32_t peek = (uint32_t)(r->acc >> (r->bits - LOOK)) & ((1u << LOOK) - 1);
    uint16_t e = t->look[peek];
    if (e) {
        *sym = e & 0xFF;
        return consume(r, e >> 8);
    }
    int l = LOOK + 1;
    int32_t code = (int32_t)((r->acc >> (r->bits - l)) & ((1u << l) - 1));
    while (code > t->maxcode[l]) {
        if (++l > 16)
            return ERR_BAD_CODE;
        code = (int32_t)((r->acc >> (r->bits - l)) & ((1u << l) - 1));
    }
    int32_t idx = code + t->valoffset[l];
    if (idx < 0 || idx >= t->count)
        return ERR_BAD_CODE;
    *sym = t->huffval[idx];
    return consume(r, l);
}

static inline int extend(int v, int s)
{
    return v < (1 << (s - 1)) ? v + (int)(-1u << s) + 1 : v;
}

/* Skip to the next marker as libjpeg's next_marker does (non-FF bytes,
 * FF fill, FF/00 pairs); its code, or -1 at the end of the data. */
static int next_marker(reader *r)
{
    int64_t p = r->hit ? r->marker_pos : r->pos;
    for (;;) {
        while (p < r->len && r->d[p] != 0xFF)
            p++;
        while (p < r->len && r->d[p] == 0xFF)
            p++;
        if (p >= r->len)
            return -1;
        if (r->d[p] != 0) {
            r->pos = p + 1;
            return r->d[p];
        }
        p++;
    }
}

/* jdhuff.c's process_restart: drop the buffered bits, read RSTn */
static int restart(reader *r, int *next_rst)
{
    int m = next_marker(r);
    if (m != 0xD0 + (*next_rst & 7))
        return ERR_RESTART;
    *next_rst = (*next_rst + 1) & 7;
    r->acc = 0;
    r->bits = r->pad = 0;
    r->hit = 0;
    return 0;
}

/* -- scans --------------------------------------------------------------- */

/* scan[]: ncomp, Ss, Se, Ah, Al, progressive, restart interval, MCUs
 * across, MCUs down; then for each component of the scan: the offset of
 * its plane (blocks), its stride (blocks), h, v (blocks an MCU holds; 1 x
 * 1 in a non-interleaved scan), DC table, AC table (slots 0-3), its index
 * in the frame.  counts: 8 x 16 (DC slots 0-3, AC slots 4-7); values: 8 x
 * 256; the slots the scan reads are built here.  DC predictions, the EOB
 * run and the restart count start at 0 with each scan.  Returns the
 * position of the marker after the scan's data, or an error code below
 * 0. */
int64_t tpuseg_jpeg_scan(const uint8_t *data, int64_t len, int64_t pos,
                         const int32_t *scan, const uint8_t *counts,
                         const uint8_t *values, int16_t *coefs)
{
    const int ncomp = scan[0], Ss = scan[1], Se = scan[2], Ah = scan[3],
              Al = scan[4], progressive = scan[5], ri = scan[6],
              mcus_x = scan[7], mcus_y = scan[8];
    const int32_t *c = scan + 9;
    htable *tables = malloc(8 * sizeof(htable));
    if (!tables)
        return ERR_MEMORY;
    int rc = 0;
    /* the tables this scan reads, each built as libjpeg builds it */
    int dc_first = progressive ? (Ss == 0 && Ah == 0) : 1;
    int ac = progressive ? Ss > 0 : 1;
    for (int i = 0; i < ncomp && !rc; i++) {
        if (dc_first) {
            int s = c[7 * i + 4];
            rc = build_table(counts + 16 * s, values + 256 * s, 1, &tables[s]);
        }
        if (ac && !rc) {
            int s = 4 + c[7 * i + 5];
            rc = build_table(counts + 16 * s, values + 256 * s, 0, &tables[s]);
        }
    }
    reader r = {data, len, pos, 0, 0, 0, 0, 0};
    int last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0, next_rst = 0, togo = ri;
    const int p1 = 1 << Al, m1 = -1 * (1 << Al);
    for (int my = 0; my < mcus_y && !rc; my++)
        for (int mx = 0; mx < mcus_x && !rc; mx++) {
            if (ri) {
                if (togo == 0) {
                    if ((rc = restart(&r, &next_rst)))
                        break;
                    memset(last_dc, 0, sizeof last_dc);
                    eobrun = 0;
                    togo = ri;
                }
                togo--;
            }
            for (int i = 0; i < ncomp && !rc; i++) {
                const int32_t *ci = c + 7 * i;
                const int h = ci[2], v = ci[3];
                const htable *dct = &tables[ci[4]], *act = &tables[4 + ci[5]];
                for (int y = 0; y < v && !rc; y++)
                    for (int x = 0; x < h && !rc; x++) {
                        int16_t *blk = coefs + 64 * (ci[0] + (int64_t)(my * v + y)
                                                     * ci[1] + (mx * h + x));
                        int s, bits;
                        if (!progressive) {
                            if ((rc = decode(&r, dct, &s)))
                                break;
                            if ((rc = get_bits(&r, s, &bits)))
                                break;
                            int d = s ? extend(bits, s) : 0;
                            int prev = last_dc[i];
                            if ((prev >= 0 && d > INT32_MAX - prev) ||
                                (prev < 0 && d < INT32_MIN - prev)) {
                                rc = ERR_DC;
                                break;
                            }
                            last_dc[i] = prev + d;
                            blk[0] = (int16_t)last_dc[i];
                            for (int k = 1; k < 64; k++) {
                                if ((rc = decode(&r, act, &s)))
                                    break;
                                int run = s >> 4;
                                s &= 15;
                                if (s) {
                                    k += run;
                                    if ((rc = get_bits(&r, s, &bits)))
                                        break;
                                    blk[natural[k]] = (int16_t)extend(bits, s);
                                } else {
                                    if (run != 15)
                                        break;
                                    k += 15;
                                }
                            }
                        } else if (Ss == 0 && Ah == 0) { /* DC first */
                            if ((rc = decode(&r, dct, &s)))
                                break;
                            if ((rc = get_bits(&r, s, &bits)))
                                break;
                            int d = s ? extend(bits, s) : 0;
                            int prev = last_dc[i];
                            if ((prev >= 0 && d > INT32_MAX - prev) ||
                                (prev < 0 && d < INT32_MIN - prev)) {
                                rc = ERR_DC;
                                break;
                            }
                            last_dc[i] = prev + d;
                            blk[0] = (int16_t)((int64_t)last_dc[i] * (1 << Al));
                        } else if (Ss == 0) { /* DC refinement */
                            if ((rc = get_bits(&r, 1, &bits)))
                                break;
                            if (bits)
                                blk[0] |= (int16_t)p1;
                        } else if (Ah == 0) { /* AC first */
                            if (eobrun > 0) {
                                eobrun--;
                                continue;
                            }
                            for (int k = Ss; k <= Se; k++) {
                                if ((rc = decode(&r, act, &s)))
                                    break;
                                int run = s >> 4;
                                s &= 15;
                                if (s) {
                                    k += run;
                                    if ((rc = get_bits(&r, s, &bits)))
                                        break;
                                    blk[natural[k]] =
                                        (int16_t)(extend(bits, s) * (1 << Al));
                                } else if (run == 15) {
                                    k += 15;
                                } else {
                                    eobrun = 1 << run;
                                    if (run) {
                                        if ((rc = get_bits(&r, run, &bits)))
                                            break;
                                        eobrun += bits;
                                    }
                                    eobrun--;
                                    break;
                                }
                            }
                        } else { /* AC refinement */
                            int k = Ss;
                            if (eobrun == 0) {
                                for (; k <= Se; k++) {
                                    if ((rc = decode(&r, act, &s)))
                                        break;
                                    int run = s >> 4;
                                    s &= 15;
                                    if (s) {
                                        /* a size other than 1 is a warning
                                         * in libjpeg; it goes on */
                                        if ((rc = get_bits(&r, 1, &bits)))
                                            break;
                                        s = bits ? p1 : m1;
                                    } else if (run != 15) {
                                        eobrun = 1 << run;
                                        if (run) {
                                            if ((rc = get_bits(&r, run, &bits)))
                                                break;
                                            eobrun += bits;
                                        }
                                        break;
                                    }
                                    do {
                                        int16_t *t = blk + natural[k];
                                        if (*t != 0) {
                                            if ((rc = get_bits(&r, 1, &bits)))
                                                break;
                                            if (bits && (*t & p1) == 0)
                                                *t = (int16_t)(*t + (*t >= 0 ? p1 : m1));
                                        } else if (--run < 0) {
                                            break;
                                        }
                                        k++;
                                    } while (k <= Se);
                                    if (rc)
                                        break;
                                    if (s)
                                        blk[natural[k]] = (int16_t)s;
                                }
                            }
                            if (!rc && eobrun > 0) {
                                for (; k <= Se; k++) {
                                    int16_t *t = blk + natural[k];
                                    if (*t != 0) {
                                        if ((rc = get_bits(&r, 1, &bits)))
                                            break;
                                        if (bits && (*t & p1) == 0)
                                            *t = (int16_t)(*t + (*t >= 0 ? p1 : m1));
                                    }
                                }
                                eobrun--;
                            }
                        }
                    }
            }
        }
    free(tables);
    if (rc)
        return rc;
    return r.hit ? r.marker_pos : r.pos;
}

/* -- the output pass ----------------------------------------------------- */

/* The islow IDCT as libjpeg-turbo runs it on x86-64 (jidctint-avx2.asm,
 * as PIL uses it): jidctint.c's arithmetic (CONST_BITS 13, PASS1_BITS 2,
 * its FIX constants, regrouped so that every product is 16 x 16 bits),
 * with the SIMD code's 16-bit lanes where jidctint.c has wider ones: the
 * dequantised coefficients, in0 +- in4, in7 + in3 and in5 + in1 wrap to 16
 * bits; pass 1's outputs saturate to 16 bits; a block whose rows 1-7 are
 * all zero takes pass 1 as 16-bit (dc * q) << 2; the samples saturate to
 * 0..255 where jidctint.c's range-limit table wraps at +-512.  On every
 * block whose values stay inside those ranges (any block a JPEG encoder
 * writes) the two agree to the bit. */
#define F029 2446  /* FIX(0.298631336) */
#define F039 3196  /* FIX(0.390180644) */
#define F054 4433  /* FIX(0.541196100) */
#define F076 6270  /* FIX(0.765366865) */
#define F089 7373  /* FIX(0.899976223) */
#define F117 9633  /* FIX(1.175875602) */
#define F150 12299 /* FIX(1.501321110) */
#define F184 15137 /* FIX(1.847759065) */
#define F196 16069 /* FIX(1.961570560) */
#define F205 16819 /* FIX(2.053119869) */
#define F256 20995 /* FIX(2.562915447) */
#define F307 25172 /* FIX(3.072711026) */

static inline int32_t w16(int64_t x) { return (int16_t)(uint16_t)x; }
static inline int32_t w32(int64_t x) { return (int32_t)(uint32_t)x; }
static inline int32_t sat(int32_t x, int lo, int hi)
{
    return x < lo ? lo : x > hi ? hi : x;
}

/* One 1-D pass over in[0], in[step], ..., in[7 * step]: out[k] is the
 * k-th output before its descale by `shift` bits, rounded. */
static void dodct(const int16_t *in, int step, int shift, int32_t *out)
{
    int64_t i0 = in[0], i1 = in[step], i2 = in[2 * step], i3 = in[3 * step],
            i4 = in[4 * step], i5 = in[5 * step], i6 = in[6 * step],
            i7 = in[7 * step];
    int32_t tmp3 = w32(i2 * (F054 + F076) + i6 * F054);
    int32_t tmp2 = w32(i2 * F054 + i6 * (F054 - F184));
    int32_t tmp0 = w32((int64_t)w16(i0 + i4) * (1 << 13));
    int32_t tmp1 = w32((int64_t)w16(i0 - i4) * (1 << 13));
    int32_t tmp10 = w32((int64_t)tmp0 + tmp3), tmp13 = w32((int64_t)tmp0 - tmp3);
    int32_t tmp11 = w32((int64_t)tmp1 + tmp2), tmp12 = w32((int64_t)tmp1 - tmp2);
    int64_t z3 = w16(i7 + i3), z4 = w16(i5 + i1);
    int32_t z3n = w32(z3 * (F117 - F196) + z4 * F117);
    int32_t z4n = w32(z3 * F117 + z4 * (F117 - F039));
    int32_t o0 = w32(w32(i7 * (F029 - F089) + i1 * -F089) + (int64_t)z3n);
    int32_t o1 = w32(w32(i5 * (F205 - F256) + i3 * -F256) + (int64_t)z4n);
    int32_t o2 = w32(w32(i5 * -F256 + i3 * (F307 - F256)) + (int64_t)z3n);
    int32_t o3 = w32(w32(i7 * -F089 + i1 * (F150 - F089)) + (int64_t)z4n);
    const int64_t round = (int64_t)1 << (shift - 1);
    out[0] = w32((int64_t)tmp10 + o3 + round) >> shift;
    out[7] = w32((int64_t)tmp10 - o3 + round) >> shift;
    out[1] = w32((int64_t)tmp11 + o2 + round) >> shift;
    out[6] = w32((int64_t)tmp11 - o2 + round) >> shift;
    out[2] = w32((int64_t)tmp12 + o1 + round) >> shift;
    out[5] = w32((int64_t)tmp12 - o1 + round) >> shift;
    out[3] = w32((int64_t)tmp13 + o0 + round) >> shift;
    out[4] = w32((int64_t)tmp13 - o0 + round) >> shift;
}

/* One block of coefficients (natural order) into 8 rows of `out`. */
static void idct_islow(const int16_t *in, const int16_t *q, uint8_t *out,
                       int64_t stride)
{
    int16_t dq[64], ws[64];
    int32_t o[8];
    int ac = 0;
    for (int k = 8; k < 64; k++)
        ac |= in[k];
    if (!ac) {
        for (int c = 0; c < 8; c++) {
            int16_t v = (int16_t)w16((int64_t)w16((int64_t)in[c] * q[c]) * 4);
            for (int r = 0; r < 8; r++)
                ws[8 * r + c] = v;
        }
    } else {
        for (int k = 0; k < 64; k++)
            dq[k] = (int16_t)w16((int64_t)in[k] * q[k]);
        for (int c = 0; c < 8; c++) {
            dodct(dq + c, 8, 11, o);
            for (int r = 0; r < 8; r++)
                ws[8 * r + c] = (int16_t)sat(o[r], -32768, 32767);
        }
    }
    for (int r = 0; r < 8; r++) {
        dodct(ws + 8 * r, 1, 18, o);
        for (int c = 0; c < 8; c++)
            out[r * stride + c] = (uint8_t)(sat(o[c], -128, 127) + 128);
    }
}

static inline uint8_t clamp255(int v)
{
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

/* One component's samples upsampled to full size into plane `up`
 * (height x width): `s` holds dh x dw real samples, `stride` apart.
 * Returns 0, or ERR_MEMORY. */
static int upsample(const uint8_t *s, int64_t stride, int dw, int dh,
                    int fh, int fv, int width, int height, uint8_t *up)
{
    if (fh == 1 && fv == 1) {
        for (int y = 0; y < height; y++)
            memcpy(up + (int64_t)y * width, s + y * stride, width);
        return 0;
    }
    const int fancy = dw > 2; /* jdsample.c: downsampled_width > 2 */
    int *colsum = malloc(sizeof(int) * (size_t)dw);
    uint8_t *row = malloc((size_t)dw * 2);
    if (!colsum || !row) {
        free(colsum);
        free(row);
        return ERR_MEMORY;
    }
    for (int y = 0; y < height; y++) {
        uint8_t *o = up + (int64_t)y * width;
        int r = fv == 2 ? y >> 1 : y;
        const uint8_t *near = s + r * stride;
        if (!fancy) {
            for (int x = 0; x < width; x++)
                o[x] = near[x >> 1];
            continue;
        }
        if (fv == 1) { /* h2v1: 3/4 nearer + 1/4 further, biases 1 and 2 */
            for (int c = 0; c < dw; c++) {
                int v = near[c] * 3;
                int left = near[c > 0 ? c - 1 : 0];
                int right = near[c < dw - 1 ? c + 1 : dw - 1];
                row[2 * c] = (uint8_t)((v + left + 1) >> 2);
                row[2 * c + 1] = (uint8_t)((v + right + 2) >> 2);
            }
        } else { /* h2v2: the triangle filter, biases 8 and 7 */
            int fr = (y & 1) ? (r + 1 < dh ? r + 1 : dh - 1)
                             : (r > 0 ? r - 1 : 0);
            const uint8_t *far = s + fr * stride;
            for (int c = 0; c < dw; c++)
                colsum[c] = near[c] * 3 + far[c];
            for (int c = 0; c < dw; c++) {
                int v = colsum[c] * 3;
                int left = colsum[c > 0 ? c - 1 : 0];
                int right = colsum[c < dw - 1 ? c + 1 : dw - 1];
                row[2 * c] = (uint8_t)((v + left + 8) >> 4);
                row[2 * c + 1] = (uint8_t)((v + right + 7) >> 4);
            }
        }
        memcpy(o, row, width);
    }
    free(colsum);
    free(row);
    return 0;
}

/* comps[]: for each component: plane offset (blocks), stride (blocks), h,
 * v.  qt: 64 quantisation values per component in natural order, as
 * latched at its first scan (int16 as libjpeg's ISLOW_MULT_TYPE holds
 * them).  transform: 0 one grey component, 1 YCbCr -> RGB, 2 RGB as
 * stored.  out: height x width x ncomp.  Returns 0, or ERR_MEMORY. */
int tpuseg_jpeg_output(const int16_t *coefs, const int32_t *comps, int ncomp,
                       const int16_t *qt, int width, int height,
                       int transform, uint8_t *out)
{
    int maxh = 1, maxv = 1;
    for (int i = 0; i < ncomp; i++) {
        if (comps[4 * i + 2] > maxh)
            maxh = comps[4 * i + 2];
        if (comps[4 * i + 3] > maxv)
            maxv = comps[4 * i + 3];
    }
    const int64_t plane = (int64_t)width * height;
    uint8_t *full = malloc((size_t)(plane * ncomp));
    if (!full)
        return ERR_MEMORY;
    for (int i = 0; i < ncomp; i++) {
        const int32_t *c = comps + 4 * i;
        const int h = c[2], v = c[3];
        /* jdinput.c's downsampled size and blocks */
        const int dw = (int)(((int64_t)width * h + maxh - 1) / maxh);
        const int dh = (int)(((int64_t)height * v + maxv - 1) / maxv);
        const int bw = (dw + 7) / 8, bh = (dh + 7) / 8;
        const int64_t sstride = (int64_t)bw * 8;
        uint8_t *s = malloc((size_t)(sstride * bh * 8));
        if (!s) {
            free(full);
            return ERR_MEMORY;
        }
        for (int by = 0; by < bh; by++)
            for (int bx = 0; bx < bw; bx++)
                idct_islow(coefs + 64 * (c[0] + (int64_t)by * c[1] + bx),
                           qt + 64 * i, s + by * 8 * sstride + bx * 8, sstride);
        int rc = upsample(s, sstride, dw, dh, maxh / h, maxv / v, width,
                          height, full + plane * i);
        free(s);
        if (rc) {
            free(full);
            return rc;
        }
    }
    if (transform == 1) {
        /* jdcolor.c's build_ycc_rgb_table */
        int cr_r[256], cb_b[256];
        int64_t cr_g[256], cb_g[256];
        const int64_t half = (int64_t)1 << 15;
        for (int i = 0; i < 256; i++) {
            int64_t x = i - 128;
            cr_r[i] = (int)((91881 * x + half) >> 16);  /* FIX(1.40200) */
            cb_b[i] = (int)((116130 * x + half) >> 16); /* FIX(1.77200) */
            cr_g[i] = -46802 * x;                       /* FIX(0.71414) */
            cb_g[i] = -22554 * x + half;                /* FIX(0.34414) */
        }
        const uint8_t *Y = full, *Cb = full + plane, *Cr = full + 2 * plane;
        for (int64_t p = 0; p < plane; p++) {
            int y = Y[p], cb = Cb[p], cr = Cr[p];
            out[3 * p] = clamp255(y + cr_r[cr]);
            out[3 * p + 1] = clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
            out[3 * p + 2] = clamp255(y + cb_b[cb]);
        }
    } else {
        for (int64_t p = 0; p < plane; p++)
            for (int i = 0; i < ncomp; i++)
                out[ncomp * p + i] = full[plane * i + p];
    }
    free(full);
    return 0;
}
