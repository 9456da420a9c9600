/* LZW and PackBits decoding for the port's TIFF and GIF readers
 * (utils/tiff.py, utils/gif.py).  Built with the host compiler at first use
 * and called through ctypes, as csrc/png_unfilter.c is.
 *
 * Both LZW dialects share one dictionary walk:
 *   TIFF (compression 5): codes packed MSB-first, 256 = clear, 257 = end,
 *        9 bits wide at first, one bit wider as soon as the next free code
 *        reaches 2^bits - 1 ("early change", as libtiff reads it), 12 at most;
 *   GIF: codes packed LSB-first over the concatenated sub-blocks, clear =
 *        2^min_code_size, end = clear + 1, min_code_size + 1 bits wide at
 *        first, one bit wider once the next free code reaches 2^bits, 12 at
 *        most; a full table (4096 codes) stops growing until the next clear
 *        (the "deferred clear" encoders may use).
 * A code equal to the next free one is the KwKwK case: the previous string
 * and its own first byte.
 *
 * Every function returns the number of bytes written (decoding stops when
 * out_len bytes are written, at the end code or at the end of the input),
 * or -2 if the stream is corrupt (a code past the next free one, a string
 * code right after a clear).
 */
#include <stdint.h>

#define LZW_TABLE 4096

typedef struct {
    uint16_t prefix[LZW_TABLE];
    uint8_t suffix[LZW_TABLE];
    uint8_t first[LZW_TABLE];
    uint16_t length[LZW_TABLE];
} lzw_table;

/* Write the string of `code` at out[pos..), clipped to out_len; returns its
 * full length. */
static int64_t emit(const lzw_table *t, int code, uint8_t *out, int64_t pos,
                    int64_t out_len)
{
    int64_t len = t->length[code];
    int64_t end = pos + len;
    int c = code;
    for (int64_t i = end - 1; i >= pos; i--) {
        if (i < out_len)
            out[i] = t->suffix[c];
        c = t->prefix[c];
    }
    return len;
}

static int64_t lzw(const uint8_t *in, int64_t in_len, uint8_t *out,
                   int64_t out_len, int msb_first, int min_code_size)
{
    static __thread lzw_table t;
    const int clear = 1 << min_code_size, end = clear + 1;
    const int early = msb_first ? 1 : 0;
    int bits = min_code_size + 1, next = clear + 2, prev = -1;
    uint64_t acc = 0;
    int have = 0;
    int64_t ip = 0, op = 0;

    for (int c = 0; c < clear; c++) {
        t.prefix[c] = 0;
        t.suffix[c] = t.first[c] = (uint8_t)c;
        t.length[c] = 1;
    }
    while (op < out_len) {
        while (have < bits && ip < in_len) {
            if (msb_first)
                acc = (acc << 8) | in[ip++];
            else
                acc |= (uint64_t)in[ip++] << have;
            have += 8;
        }
        if (have < bits)
            break;
        int code;
        if (msb_first) {
            code = (int)((acc >> (have - bits)) & ((1u << bits) - 1));
        } else {
            code = (int)(acc & ((1u << bits) - 1));
            acc >>= bits;
        }
        have -= bits;
        if (code == clear) {
            bits = min_code_size + 1;
            next = clear + 2;
            prev = -1;
            continue;
        }
        if (code == end)
            break;
        if (prev < 0) {
            if (code >= clear)
                return -2;
            out[op++] = (uint8_t)code;
            prev = code;
            continue;
        }
        if (code > next || (code == next && next >= LZW_TABLE))
            return -2;
        uint8_t first = code == next ? t.first[prev] : t.first[code];
        if (next < LZW_TABLE) {
            t.prefix[next] = (uint16_t)prev;
            t.suffix[next] = first;
            t.first[next] = t.first[prev];
            t.length[next] = (uint16_t)(t.length[prev] + 1);
            next++;
            if (next + early >= (1 << bits) && bits < 12)
                bits++;
        }
        op += emit(&t, code, out, op, out_len);
        prev = code;
    }
    return op < out_len ? op : out_len;
}

int64_t tpuseg_tiff_lzw_decode(const uint8_t *in, int64_t in_len,
                               uint8_t *out, int64_t out_len)
{
    return lzw(in, in_len, out, out_len, 1, 8);
}

int64_t tpuseg_gif_lzw_decode(const uint8_t *in, int64_t in_len,
                              int64_t min_code_size, uint8_t *out,
                              int64_t out_len)
{
    if (min_code_size < 1 || min_code_size > 11)
        return -2;
    return lzw(in, in_len, out, out_len, 0, (int)min_code_size);
}

/* PackBits (TIFF compression 32773): a header byte n, as int8, then
 * n >= 0: n + 1 literal bytes; -127 <= n <= -1: the next byte 1 - n times;
 * n = -128: nothing. */
int64_t tpuseg_packbits_decode(const uint8_t *in, int64_t in_len,
                               uint8_t *out, int64_t out_len)
{
    int64_t ip = 0, op = 0;
    while (ip < in_len && op < out_len) {
        int n = (int8_t)in[ip++];
        if (n >= 0) {
            int64_t len = n + 1;
            if (len > in_len - ip)
                len = in_len - ip;
            for (int64_t i = 0; i < len && op < out_len; i++)
                out[op++] = in[ip + i];
            ip += len;
        } else if (n != -128) {
            if (ip >= in_len)
                break;
            uint8_t b = in[ip++];
            for (int i = 0; i < 1 - n && op < out_len; i++)
                out[op++] = b;
        }
    }
    return op;
}
