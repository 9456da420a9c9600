/* n-bit decompression for the port's HDF5 reader (utils/hdf5.py): HDF5's
 * n-bit filter (id 5) keeps, of each element of an integer or float
 * datatype, only its `precision` significant bits (those from bit `offset`
 * up), most significant first, the elements' bits back to back in one bit
 * stream without padding (H5Znbit.c, an atomic datatype).  Built with the
 * host C compiler at first use and called through ctypes, as
 * csrc/lzf_decompress.c is.
 *
 * tpuseg_nbit_decompress(in, n, out, count, size, big_endian, precision,
 * offset) writes `count` elements of `size` bytes to out, each the value
 * shifted back to bit `offset` with every other bit 0, in the datatype's
 * byte order, and returns 0; -1 if the input holds fewer than count *
 * precision bits, -3 for a size, precision or offset out of range.  Every
 * read is checked against n.
 */
#include <stdint.h>

int64_t tpuseg_nbit_decompress(const uint8_t *in, int64_t in_len,
                               uint8_t *out, int64_t count, int32_t size,
                               int32_t big_endian, int32_t precision,
                               int32_t offset)
{
    if (size < 1 || size > 8 || precision < 1 || offset < 0
        || precision + offset > 8 * size || count < 0 || in_len < 0)
        return -3;
    if ((count * (int64_t)precision + 7) / 8 > in_len)
        return -1;
    const uint64_t mask = precision == 64 ? ~UINT64_C(0)
                                          : (UINT64_C(1) << precision) - 1;
    uint64_t acc = 0;   /* the low `have` bits are the next bits */
    int have = 0;
    int64_t next = 0;
    for (int64_t i = 0; i < count; i++) {
        uint64_t v;
        if (precision <= 56) {
            while (have < precision) {
                acc = (acc << 8) | in[next++];
                have += 8;
            }
            have -= precision;
            v = (acc >> have) & mask;
        } else {    /* two reads, the high bits first */
            int high = precision - 32;
            while (have < high) {
                acc = (acc << 8) | in[next++];
                have += 8;
            }
            have -= high;
            v = (acc >> have) & ((UINT64_C(1) << high) - 1);
            while (have < 32) {
                acc = (acc << 8) | in[next++];
                have += 8;
            }
            have -= 32;
            v = (v << 32) | ((acc >> have) & UINT64_C(0xFFFFFFFF));
        }
        v <<= offset;
        uint8_t *e = out + i * size;
        for (int j = 0; j < size; j++)
            e[big_endian ? size - 1 - j : j] = (uint8_t)(v >> (8 * j));
    }
    return 0;
}
