/* Zstandard decompression (RFC 8878), for the port's orbax checkpoint
 * reader (utils/zstd.py, utils/ocdbt.py, utils/zarr2.py): tensorstore
 * compresses OCDBT B-tree nodes and zarr chunks as zstd frames.  Built with
 * the host C compiler at first use and called through ctypes, as
 * csrc/lzf_decompress.c is.
 *
 * Covered: the whole frame format except dictionaries -- frame headers with
 * and without a content size and single-segment flag, every window size,
 * skippable frames, frames back to back, raw / RLE / compressed blocks up to
 * 128 KiB, Huffman literals in 1 or 4 streams (weights given by FSE or
 * direct) and treeless literals reusing the previous table, FSE sequences in
 * predefined, RLE, compressed and repeat modes, the three repeat offsets
 * with the literal-length-0 shift, overlapping match copies, and the content
 * checksum (low 32 bits of XXH64), verified when the flag is set.
 *
 * The whole output is kept, so the window is the frame's output so far: a
 * match may reach back to the frame's first byte and no further.
 *
 * tpuseg_zstd_bound(in, n) gives an upper bound of the decoded size (each
 * frame's content size where stated, else 128 KiB per compressed block) and
 * tpuseg_zstd_decompress(in, n, out, cap) the number of bytes written; both
 * return a negative code on failure:
 *   -1 the output does not fit in cap (cap below the bound)
 *   -2 corrupt or truncated input
 *   -3 a frame needs a dictionary (a nonzero dictionary ID)
 *   -4 the content checksum does not match
 *   -5 a frame's output differs from its stated content size
 *   -6 not a zstd frame (unknown magic number)
 *   -7 a reserved bit is set
 *   -8 out of memory
 * Every read is checked against n and every write against cap.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
    E_SMALL = -1, E_CORRUPT = -2, E_DICT = -3, E_CHECKSUM = -4, E_SIZE = -5,
    E_MAGIC = -6, E_RESERVED = -7, E_NOMEM = -8
};

#define BLOCK_MAX (128 * 1024)
#define HUF_MAX_BITS 11
#define FSE_MAX_AL 9
#define MAGIC 0xFD2FB528u
#define SKIP_MAGIC 0x184D2A50u

static const uint32_t LL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 22,
    24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
    32768, 65536};
static const uint8_t LL_BITS[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41, 43,
    47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
    32771, 65539};
static const uint8_t ML_BITS[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10,
    11, 12, 13, 14, 15, 16};

/* the predefined distributions (RFC 8878 3.1.1.3.2.2) */
static const int16_t LL_DEFAULT[36] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1,
    -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    -1, -1, -1, -1, -1};

typedef struct {
    uint8_t symbol;
    uint8_t nbits;
    uint16_t base;
} fse_cell;

typedef struct {
    fse_cell cells[1 << FSE_MAX_AL];
    int al;
} fse_table;

typedef struct {
    uint8_t symbol[1 << HUF_MAX_BITS];
    uint8_t nbits[1 << HUF_MAX_BITS];
    int max_bits;
} huf_table;

enum { LL, OF, ML };
static const int MAX_SYM[3] = {35, 31, 52};
static const int MAX_AL[3] = {9, 8, 9};

typedef struct {
    fse_table predefined[3];
    fse_table stored[3];       /* RLE or compressed tables of this frame */
    const fse_table *last[3];  /* the previous block's, for repeat mode */
    huf_table huf;
    int huf_valid;
    uint64_t rep[3];
    uint8_t lit[BLOCK_MAX + 8];
} ctx;

static int hsb(uint32_t v) { return 31 - __builtin_clz(v); }

static uint32_t le16(const uint8_t *p) { return p[0] | (uint32_t)p[1] << 8; }
static uint32_t le24(const uint8_t *p) { return le16(p) | (uint32_t)p[2] << 16; }
static uint32_t le32(const uint8_t *p) { return le24(p) | (uint32_t)p[3] << 24; }
static uint64_t le64(const uint8_t *p)
{
    return le32(p) | (uint64_t)le32(p + 4) << 32;
}

/* bits [pos, pos + n) of s, little-endian; bytes past len read as 0;
 * 0 <= pos, n <= 32 */
static inline uint64_t load_bits(const uint8_t *s, int64_t len, int64_t pos,
                                 int n)
{
    int64_t b = pos >> 3;
    uint64_t v = 0;
    if (n == 0)
        return 0;
    if (b + 8 <= len) {
        v = le64(s + b);
    } else {
        int i;
        for (i = 0; i < 8 && b + i < len; i++)
            v |= (uint64_t)s[b + i] << (8 * i);
    }
    return (v >> (pos & 7)) & ((1ull << n) - 1);
}

/* ---- the backward bit stream of Huffman and FSE data ---------------- */

typedef struct {
    const uint8_t *s;
    int64_t len;
    int64_t pos;  /* bits left; below 0 once reads ran past the start */
} bwd;

static int bwd_init(bwd *r, const uint8_t *s, int64_t len)
{
    if (len < 1 || s[len - 1] == 0)
        return E_CORRUPT;  /* the last byte holds the padding's end mark */
    r->s = s;
    r->len = len;
    r->pos = (len - 1) * 8 + hsb(s[len - 1]);
    return 0;
}

/* n bits below the position; bits before the stream's start read as 0 */
static inline uint32_t bwd_read(bwd *r, int n)
{
    int64_t have;
    if (n == 0)
        return 0;
    r->pos -= n;
    if (r->pos >= 0)
        return (uint32_t)load_bits(r->s, r->len, r->pos, n);
    have = n + r->pos;
    if (have <= 0)
        return 0;
    return (uint32_t)(load_bits(r->s, r->len, 0, (int)have) << (n - have));
}

/* ---- FSE ---------------------------------------------------------- */

static int fse_build(fse_table *t, const int16_t *freq, int nsym, int al)
{
    int size = 1 << al, hi = size, pos = 0, s, i;
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    uint16_t next[256];
    for (s = 0; s < nsym; s++) {
        if (freq[s] == -1) {
            if (hi <= 0)
                return E_CORRUPT;
            t->cells[--hi].symbol = (uint8_t)s;
            next[s] = 1;
        }
    }
    for (s = 0; s < nsym; s++) {
        if (freq[s] <= 0)
            continue;
        for (i = 0; i < freq[s]; i++) {
            t->cells[pos].symbol = (uint8_t)s;
            do
                pos = (pos + step) & mask;
            while (pos >= hi);
        }
        next[s] = (uint16_t)freq[s];
    }
    if (pos != 0)
        return E_CORRUPT;
    for (i = 0; i < size; i++) {
        uint16_t d = next[t->cells[i].symbol]++;
        int nb = al - hsb(d);
        t->cells[i].nbits = (uint8_t)nb;
        t->cells[i].base = (uint16_t)((d << nb) - size);
    }
    t->al = al;
    return 0;
}

static void fse_rle(fse_table *t, uint8_t symbol)
{
    t->cells[0].symbol = symbol;
    t->cells[0].nbits = 0;
    t->cells[0].base = 0;
    t->al = 0;
}

/* a table description (RFC 8878 4.1.1); returns the bytes it took */
static int64_t fse_read(fse_table *t, const uint8_t *s, int64_t len,
                        int max_al, int max_sym)
{
    int16_t freq[256];
    int nsym = 0, al, err;
    int32_t remaining;
    int64_t pos = 4, used;
    if (len < 1)
        return E_CORRUPT;
    al = 5 + (s[0] & 15);
    if (al > max_al)
        return E_CORRUPT;
    remaining = 1 << al;
    while (remaining > 0 && nsym <= max_sym) {
        int bits = hsb((uint32_t)remaining + 1) + 1;
        uint32_t val = (uint32_t)load_bits(s, len, pos, bits);
        uint32_t lower = (1u << (bits - 1)) - 1;
        uint32_t threshold = (1u << bits) - 1 - ((uint32_t)remaining + 1);
        int32_t p;
        pos += bits;
        if ((val & lower) < threshold) {
            pos -= 1;
            val &= lower;
        } else if (val > lower) {
            val -= threshold;
        }
        p = (int32_t)val - 1;
        remaining -= p < 0 ? -p : p;
        freq[nsym++] = (int16_t)p;
        if (p == 0) {
            for (;;) {
                int rep = (int)load_bits(s, len, pos, 2), i;
                pos += 2;
                for (i = 0; i < rep; i++) {
                    if (nsym > max_sym)
                        return E_CORRUPT;
                    freq[nsym++] = 0;
                }
                if (rep != 3)
                    break;
            }
        }
    }
    used = (pos + 7) >> 3;
    if (remaining != 0 || used > len)
        return E_CORRUPT;
    err = fse_build(t, freq, nsym, al);
    return err ? err : used;
}

/* ---- Huffman ------------------------------------------------------ */

/* a Huffman tree description (RFC 8878 4.2.1); returns the bytes it took */
static int64_t huf_read(huf_table *h, const uint8_t *s, int64_t len)
{
    uint8_t w[256], bits[256];
    uint32_t rank_count[HUF_MAX_BITS + 1], rank_idx[HUF_MAX_BITS + 1];
    uint32_t total = 0, left, size;
    int nw = 0, i, max_bits;
    int64_t used;
    if (len < 1)
        return E_CORRUPT;
    if (s[0] >= 128) {
        nw = s[0] - 127;
        used = 1 + (nw + 1) / 2;
        if (used > len)
            return E_CORRUPT;
        for (i = 0; i < nw; i++)
            w[i] = (i & 1) ? s[1 + i / 2] & 15 : s[1 + i / 2] >> 4;
    } else {
        fse_table ft;
        bwd r;
        int64_t hl;
        uint32_t s1, s2;
        used = 1 + (int64_t)s[0];
        if (s[0] == 0 || used > len)
            return E_CORRUPT;
        hl = fse_read(&ft, s + 1, s[0], 6, 255);
        if (hl < 0)
            return hl;
        if (bwd_init(&r, s + 1 + hl, s[0] - hl))
            return E_CORRUPT;
        s1 = bwd_read(&r, ft.al);
        s2 = bwd_read(&r, ft.al);
        for (;;) {
            if (nw + 2 > 255)
                return E_CORRUPT;
            w[nw++] = ft.cells[s1].symbol;
            s1 = ft.cells[s1].base + bwd_read(&r, ft.cells[s1].nbits);
            if (r.pos < 0) {
                w[nw++] = ft.cells[s2].symbol;
                break;
            }
            w[nw++] = ft.cells[s2].symbol;
            s2 = ft.cells[s2].base + bwd_read(&r, ft.cells[s2].nbits);
            if (r.pos < 0) {
                w[nw++] = ft.cells[s1].symbol;
                break;
            }
        }
    }
    for (i = 0; i < nw; i++) {
        if (w[i] > HUF_MAX_BITS)
            return E_CORRUPT;
        if (w[i])
            total += 1u << (w[i] - 1);
    }
    if (total == 0)
        return E_CORRUPT;
    max_bits = hsb(total) + 1;
    if (max_bits > HUF_MAX_BITS)
        return E_CORRUPT;
    left = (1u << max_bits) - total;  /* the last weight, implied */
    if (left & (left - 1))
        return E_CORRUPT;
    w[nw++] = (uint8_t)(hsb(left) + 1);
    memset(rank_count, 0, sizeof rank_count);
    for (i = 0; i < nw; i++) {
        bits[i] = w[i] ? (uint8_t)(max_bits + 1 - w[i]) : 0;
        rank_count[bits[i]]++;
    }
    size = 1u << max_bits;
    rank_idx[max_bits] = 0;
    for (i = max_bits; i >= 1; i--) {
        rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1u << (max_bits - i));
        if (rank_idx[i - 1] > size)
            return E_CORRUPT;
        memset(h->nbits + rank_idx[i], i, rank_idx[i - 1] - rank_idx[i]);
    }
    if (rank_idx[0] != size)
        return E_CORRUPT;
    for (i = 0; i < nw; i++) {
        if (bits[i]) {
            uint32_t n = 1u << (max_bits - bits[i]);
            memset(h->symbol + rank_idx[bits[i]], i, n);
            rank_idx[bits[i]] += n;
        }
    }
    h->max_bits = max_bits;
    return used;
}

/* one Huffman stream of exactly n symbols */
static int huf_stream(const huf_table *h, const uint8_t *s, int64_t len,
                      uint8_t *out, int64_t n)
{
    bwd r;
    int mb = h->max_bits;
    uint32_t mask = (1u << mb) - 1, state;
    int64_t k = 0;
    if (bwd_init(&r, s, len))
        return E_CORRUPT;
    state = bwd_read(&r, mb);
    while (r.pos > -mb) {
        int nb;
        if (k >= n)
            return E_CORRUPT;
        out[k++] = h->symbol[state];
        nb = h->nbits[state];
        state = ((state << nb) + bwd_read(&r, nb)) & mask;
    }
    return (r.pos == -mb && k == n) ? 0 : E_CORRUPT;
}

/* ---- blocks ------------------------------------------------------- */

/* the literals section into c->lit; returns the bytes it took */
static int64_t read_literals(ctx *c, const uint8_t *s, int64_t len,
                             int64_t *nlit)
{
    int type, sf, hs, bits, err, i;
    uint64_t hv = 0;
    int64_t regen, comp, n;
    const uint8_t *p;
    if (len < 1)
        return E_CORRUPT;
    type = s[0] & 3;
    sf = (s[0] >> 2) & 3;
    if (type <= 1) {  /* raw or RLE */
        switch (sf) {
        case 1:
            hs = 2;
            break;
        case 3:
            hs = 3;
            break;
        default:
            hs = 1;
        }
        if (len < hs)
            return E_CORRUPT;
        n = hs == 1 ? s[0] >> 3 :
            hs == 2 ? (s[0] >> 4) + ((int64_t)s[1] << 4) :
            (s[0] >> 4) + ((int64_t)s[1] << 4) + ((int64_t)s[2] << 12);
        if (n > BLOCK_MAX)
            return E_CORRUPT;
        *nlit = n;
        if (type == 0) {
            if (hs + n > len)
                return E_CORRUPT;
            memcpy(c->lit, s + hs, n);
            return hs + n;
        }
        if (hs + 1 > len)
            return E_CORRUPT;
        memset(c->lit, s[hs], n);
        return hs + 1;
    }
    hs = sf < 2 ? 3 : sf + 2;
    bits = sf < 2 ? 10 : sf == 2 ? 14 : 18;
    if (len < hs)
        return E_CORRUPT;
    for (i = 0; i < hs; i++)
        hv |= (uint64_t)s[i] << (8 * i);
    regen = (hv >> 4) & ((1u << bits) - 1);
    comp = (hv >> (4 + bits)) & ((1u << bits) - 1);
    if (regen > BLOCK_MAX || hs + comp > len)
        return E_CORRUPT;
    p = s + hs;
    n = comp;
    if (type == 2) {  /* compressed: a new tree */
        int64_t t;
        c->huf_valid = 0;
        t = huf_read(&c->huf, p, n);
        if (t < 0)
            return t;
        c->huf_valid = 1;
        p += t;
        n -= t;
    } else if (!c->huf_valid) {  /* treeless: the previous block's tree */
        return E_CORRUPT;
    }
    if (sf == 0) {
        err = huf_stream(&c->huf, p, n, c->lit, regen);
    } else {
        int64_t sz[4], seg = (regen + 3) / 4, off = 6;
        if (n < 6)
            return E_CORRUPT;
        sz[0] = le16(p);
        sz[1] = le16(p + 2);
        sz[2] = le16(p + 4);
        sz[3] = n - 6 - sz[0] - sz[1] - sz[2];
        if (sz[3] < 0 || regen - 3 * seg < 0)
            return E_CORRUPT;
        err = 0;
        for (i = 0; i < 4 && !err; i++) {
            err = huf_stream(&c->huf, p + off, sz[i], c->lit + i * seg,
                             i < 3 ? seg : regen - 3 * seg);
            off += sz[i];
        }
    }
    if (err)
        return err;
    *nlit = regen;
    return hs + comp;
}

typedef struct {
    uint8_t *out;
    int64_t op;     /* bytes written */
    int64_t start;  /* the frame's first byte */
    int64_t lim;    /* the frame may not write past this */
    int sized;      /* lim is the frame's stated content size */
} sink;

static int sink_room(const sink *o, int64_t n)
{
    if (n <= o->lim - o->op)
        return 0;
    return o->sized ? E_SIZE : E_SMALL;
}

static int decode_sequences(ctx *c, const uint8_t *s, int64_t len,
                            const uint8_t *lit, int64_t nlit, sink *o)
{
    int64_t nseq, p, i, block_end;
    const fse_table *t[3];
    uint32_t st[3];
    bwd r;
    int k, err, modes;
    if (len < 1)
        return E_CORRUPT;
    if (s[0] < 128) {
        nseq = s[0];
        p = 1;
    } else if (s[0] < 255) {
        if (len < 2)
            return E_CORRUPT;
        nseq = ((int64_t)(s[0] - 128) << 8) + s[1];
        p = 2;
    } else {
        if (len < 3)
            return E_CORRUPT;
        nseq = s[1] + ((int64_t)s[2] << 8) + 0x7F00;
        p = 3;
    }
    block_end = o->op + BLOCK_MAX;
    if (nseq == 0) {
        if (p != len)
            return E_CORRUPT;
        if ((err = sink_room(o, nlit)))
            return err;
        memcpy(o->out + o->op, lit, nlit);
        o->op += nlit;
        return 0;
    }
    if (p >= len)
        return E_CORRUPT;
    modes = s[p];
    if (modes & 3)
        return E_RESERVED;
    for (k = 0; k < 3; k++) {
        int mode = (modes >> (6 - 2 * k)) & 3;
        if (mode == 0) {
            t[k] = &c->predefined[k];
        } else if (mode == 1) {
            if (p + 1 >= len || s[p + 1] > MAX_SYM[k])
                return E_CORRUPT;
            fse_rle(&c->stored[k], s[++p]);
            t[k] = &c->stored[k];
        } else if (mode == 2) {
            int64_t used = fse_read(&c->stored[k], s + p + 1, len - p - 1,
                                    MAX_AL[k], MAX_SYM[k]);
            c->last[k] = NULL;
            if (used < 0)
                return (int)used;
            p += used;
            t[k] = &c->stored[k];
        } else {
            if (!c->last[k])
                return E_CORRUPT;
            t[k] = c->last[k];
        }
        c->last[k] = t[k];
    }
    p++;
    if (bwd_init(&r, s + p, len - p))
        return E_CORRUPT;
    st[LL] = bwd_read(&r, t[LL]->al);
    st[OF] = bwd_read(&r, t[OF]->al);
    st[ML] = bwd_read(&r, t[ML]->al);
    for (i = 0; i < nseq; i++) {
        int ofc = t[OF]->cells[st[OF]].symbol;
        int llc = t[LL]->cells[st[LL]].symbol;
        int mlc = t[ML]->cells[st[ML]].symbol;
        uint64_t ofv, offset;
        int64_t ml, ll, j;
        if (ofc > 31 || llc > 35 || mlc > 52)
            return E_CORRUPT;
        ofv = (1ull << ofc) + bwd_read(&r, ofc);
        ml = ML_BASE[mlc] + bwd_read(&r, ML_BITS[mlc]);
        ll = LL_BASE[llc] + bwd_read(&r, LL_BITS[llc]);
        if (ofv > 3) {
            offset = ofv - 3;
            c->rep[2] = c->rep[1];
            c->rep[1] = c->rep[0];
            c->rep[0] = offset;
        } else {
            int idx = (int)ofv - 1 + (ll == 0);
            if (idx == 0) {
                offset = c->rep[0];
            } else {
                offset = idx == 3 ? c->rep[0] - 1 : c->rep[idx];
                if (offset == 0)
                    return E_CORRUPT;
                if (idx != 1)
                    c->rep[2] = c->rep[1];
                c->rep[1] = c->rep[0];
                c->rep[0] = offset;
            }
        }
        if (i + 1 < nseq) {
            for (k = 0; k < 3; k++) {
                int u = k == 0 ? LL : k == 1 ? ML : OF;
                const fse_cell *cell = &t[u]->cells[st[u]];
                st[u] = cell->base + bwd_read(&r, cell->nbits);
            }
        }
        if (ll > nlit)
            return E_CORRUPT;
        if (o->op + ll + ml > block_end)
            return E_CORRUPT;
        if ((err = sink_room(o, ll + ml)))
            return err;
        memcpy(o->out + o->op, lit, ll);
        lit += ll;
        nlit -= ll;
        o->op += ll;
        if (offset > (uint64_t)(o->op - o->start))
            return E_CORRUPT;
        {
            uint8_t *d = o->out + o->op;
            const uint8_t *m = d - offset;
            if (offset >= (uint64_t)ml)
                memcpy(d, m, ml);
            else
                for (j = 0; j < ml; j++)
                    d[j] = m[j];  /* overlapping: byte by byte */
        }
        o->op += ml;
    }
    if (r.pos != 0)
        return E_CORRUPT;
    if (o->op + nlit > block_end)
        return E_CORRUPT;
    if ((err = sink_room(o, nlit)))
        return err;
    memcpy(o->out + o->op, lit, nlit);
    o->op += nlit;
    return 0;
}

static int decode_block(ctx *c, const uint8_t *s, int64_t len, sink *o)
{
    int64_t nlit = 0, used = read_literals(c, s, len, &nlit);
    if (used < 0)
        return (int)used;
    return decode_sequences(c, s + used, len - used, c->lit, nlit, o);
}

/* ---- XXH64 -------------------------------------------------------- */

#define P1 11400714785074694791ull
#define P2 14029467366897019727ull
#define P3 1609587929392839161ull
#define P4 9650029242287828579ull
#define P5 2870177450012600261ull

static uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

static uint64_t xxh_round(uint64_t acc, uint64_t v)
{
    acc += v * P2;
    return rotl(acc, 31) * P1;
}

static uint64_t xxh_merge(uint64_t acc, uint64_t v)
{
    acc ^= xxh_round(0, v);
    return acc * P1 + P4;
}

static uint64_t xxh64(const uint8_t *p, int64_t len)
{
    const uint8_t *end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        while (end - p >= 32) {
            v1 = xxh_round(v1, le64(p));
            v2 = xxh_round(v2, le64(p + 8));
            v3 = xxh_round(v3, le64(p + 16));
            v4 = xxh_round(v4, le64(p + 24));
            p += 32;
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xxh_merge(h, v1);
        h = xxh_merge(h, v2);
        h = xxh_merge(h, v3);
        h = xxh_merge(h, v4);
    } else {
        h = P5;
    }
    h += (uint64_t)len;
    while (end - p >= 8) {
        h ^= xxh_round(0, le64(p));
        h = rotl(h, 27) * P1 + P4;
        p += 8;
    }
    if (end - p >= 4) {
        h ^= (uint64_t)le32(p) * P1;
        h = rotl(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= *p++ * P5;
        h = rotl(h, 11) * P1;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

/* ---- frames ------------------------------------------------------- */

typedef struct {
    int64_t header;    /* bytes up to the first block */
    uint64_t size;     /* the content size, where stated */
    int sized;
    int checksum;
} frame_header;

static int read_header(const uint8_t *s, int64_t len, frame_header *f)
{
    static const int DID_BYTES[4] = {0, 1, 2, 4};
    int64_t p = 5;
    int fcs_flag, single, did, fcs_bytes, i;
    uint32_t dict = 0;
    if (len < 5)
        return E_CORRUPT;
    fcs_flag = s[4] >> 6;
    single = (s[4] >> 5) & 1;
    if ((s[4] >> 3) & 1)
        return E_RESERVED;
    f->checksum = (s[4] >> 2) & 1;
    did = DID_BYTES[s[4] & 3];
    fcs_bytes = fcs_flag ? 1 << fcs_flag : single;
    if (!single)
        p++;  /* the window descriptor: any window, the output is kept */
    if (len < p + did + fcs_bytes)
        return E_CORRUPT;
    for (i = 0; i < did; i++)
        dict |= (uint32_t)s[p + i] << (8 * i);
    if (dict)
        return E_DICT;
    p += did;
    f->size = 0;
    for (i = 0; i < fcs_bytes; i++)
        f->size |= (uint64_t)s[p + i] << (8 * i);
    if (fcs_bytes == 2)
        f->size += 256;
    f->sized = fcs_bytes > 0;
    f->header = p + fcs_bytes;
    return 0;
}

/* the bytes of the frame or skippable frame at s, and (bound) an upper
 * bound of its output */
static int64_t frame_extent(const uint8_t *s, int64_t len, int64_t *bound)
{
    frame_header f;
    int64_t p, sum = 0;
    int err, last = 0;
    if (len < 4)
        return E_CORRUPT;
    if ((le32(s) & 0xFFFFFFF0u) == SKIP_MAGIC) {
        uint32_t n;
        if (len < 8)
            return E_CORRUPT;
        n = le32(s + 4);
        if (n > len - 8)
            return E_CORRUPT;
        *bound = 0;
        return 8 + (int64_t)n;
    }
    if (le32(s) != MAGIC)
        return E_MAGIC;
    if ((err = read_header(s, len, &f)))
        return err;
    p = f.header;
    while (!last) {
        uint32_t bh;
        int type;
        int64_t size;
        if (len - p < 3)
            return E_CORRUPT;
        bh = le24(s + p);
        last = bh & 1;
        type = (bh >> 1) & 3;
        size = bh >> 3;
        p += 3;
        if (type == 3)
            return E_CORRUPT;
        if (size > BLOCK_MAX)
            return E_CORRUPT;
        sum += type == 2 ? BLOCK_MAX : size;
        size = type == 1 ? 1 : size;
        if (len - p < size)
            return E_CORRUPT;
        p += size;
    }
    if (f.checksum) {
        if (len - p < 4)
            return E_CORRUPT;
        p += 4;
    }
    if (f.sized) {
        if (f.size > (uint64_t)sum)
            return E_SIZE;  /* more than its blocks can hold */
        sum = (int64_t)f.size;
    }
    *bound = sum;
    return p;
}

static int64_t decode_frame(ctx *c, const uint8_t *s, int64_t len, sink *o,
                            int64_t cap)
{
    frame_header f;
    int64_t p;
    int err, last = 0;
    if ((err = read_header(s, len, &f)))
        return err;
    p = f.header;
    o->start = o->op;
    o->sized = f.sized;
    if (f.sized) {
        if (f.size > (uint64_t)(cap - o->op))
            return E_SMALL;
        o->lim = o->op + (int64_t)f.size;
    } else {
        o->lim = cap;
    }
    c->rep[0] = 1;
    c->rep[1] = 4;
    c->rep[2] = 8;
    c->huf_valid = 0;
    c->last[0] = c->last[1] = c->last[2] = NULL;
    while (!last) {
        uint32_t bh;
        int type;
        int64_t size;
        if (len - p < 3)
            return E_CORRUPT;
        bh = le24(s + p);
        last = bh & 1;
        type = (bh >> 1) & 3;
        size = bh >> 3;
        p += 3;
        if (type == 3 || size > BLOCK_MAX)
            return E_CORRUPT;
        if (type == 1) {  /* RLE: one byte, size times */
            if (len - p < 1)
                return E_CORRUPT;
            if ((err = sink_room(o, size)))
                return err;
            memset(o->out + o->op, s[p], size);
            o->op += size;
            p += 1;
            continue;
        }
        if (len - p < size)
            return E_CORRUPT;
        if (type == 0) {
            if ((err = sink_room(o, size)))
                return err;
            memcpy(o->out + o->op, s + p, size);
            o->op += size;
        } else if ((err = decode_block(c, s + p, size, o))) {
            return err;
        }
        p += size;
    }
    if (f.sized && (uint64_t)(o->op - o->start) != f.size)
        return E_SIZE;
    if (f.checksum) {
        if (len - p < 4)
            return E_CORRUPT;
        if ((uint32_t)xxh64(o->out + o->start, o->op - o->start) !=
            le32(s + p))
            return E_CHECKSUM;
        p += 4;
    }
    return p;
}

int64_t tpuseg_zstd_bound(const uint8_t *in, int64_t n)
{
    int64_t ip = 0, total = 0;
    if (n < 4)
        return E_CORRUPT;
    while (ip < n) {
        int64_t bound, used = frame_extent(in + ip, n - ip, &bound);
        if (used < 0)
            return used;
        ip += used;
        total += bound;
    }
    return total;
}

int64_t tpuseg_zstd_decompress(const uint8_t *in, int64_t n, uint8_t *out,
                               int64_t cap)
{
    ctx *c;
    sink o;
    int64_t ip = 0;
    if (n < 4)
        return E_CORRUPT;
    c = (ctx *)malloc(sizeof(ctx));
    if (!c)
        return E_NOMEM;
    if (fse_build(&c->predefined[LL], LL_DEFAULT, 36, 6) ||
        fse_build(&c->predefined[ML], ML_DEFAULT, 53, 6) ||
        fse_build(&c->predefined[OF], OF_DEFAULT, 29, 5)) {
        free(c);
        return E_CORRUPT;
    }
    o.out = out;
    o.op = 0;
    while (ip < n) {
        int64_t used;
        if (n - ip < 4) {
            free(c);
            return E_CORRUPT;
        }
        if ((le32(in + ip) & 0xFFFFFFF0u) == SKIP_MAGIC) {
            int64_t bound;
            used = frame_extent(in + ip, n - ip, &bound);
        } else if (le32(in + ip) != MAGIC) {
            used = E_MAGIC;
        } else {
            used = decode_frame(c, in + ip, n - ip, &o, cap);
        }
        if (used < 0) {
            free(c);
            return used;
        }
        ip += used;
    }
    free(c);
    return o.op;
}
