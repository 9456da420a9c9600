/* LZF decompression (liblzf's lzf_d.c format), for the port's HDF5 reader
 * (utils/hdf5.py): h5py's LZF filter (id 32000) stores each chunk as one
 * LZF block.  Built with the host compiler at first use and called through
 * ctypes, as csrc/png_unfilter.c is.
 *
 * The stream is a sequence of runs, each opened by a control byte c:
 *   c < 32:  a literal run of c + 1 bytes, copied from the input;
 *   c >= 32: a back reference of length (c >> 5) + 2 (a length field of 7
 *            takes one more byte, added to it) at distance
 *            ((c & 31) << 8) + next byte + 1 behind the output position.
 *
 * Returns the number of bytes written, -1 if out_len is too small (the
 * caller grows the buffer, as h5py's filter does) or -2 if the stream is
 * corrupt (a run past the end of the input, a reference before the start
 * of the output).
 */
#include <stdint.h>

int64_t tpuseg_lzf_decompress(const uint8_t *in, int64_t in_len,
                              uint8_t *out, int64_t out_len)
{
    const uint8_t *ip = in, *in_end = in + in_len;
    uint8_t *op = out, *out_end = out + out_len;

    while (ip < in_end) {
        unsigned ctrl = *ip++;
        if (ctrl < (1u << 5)) {
            int64_t len = (int64_t)ctrl + 1;
            if (len > out_end - op)
                return -1;
            if (len > in_end - ip)
                return -2;
            while (len--)
                *op++ = *ip++;
        } else {
            int64_t len = ctrl >> 5;
            const uint8_t *ref = op - ((ctrl & 0x1f) << 8) - 1;
            if (ip >= in_end)
                return -2;
            if (len == 7) {
                len += *ip++;
                if (ip >= in_end)
                    return -2;
            }
            ref -= *ip++;
            len += 2;
            if (len > out_end - op)
                return -1;
            if (ref < out)
                return -2;
            while (len--)  /* the runs may overlap: byte by byte */
                *op++ = *ref++;
        }
    }
    return op - out;
}
