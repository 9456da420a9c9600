/* PNG row unfiltering (PNG specification, section 9.2), for the port's PNG
 * decoder (utils/png.py).  The JAX package decodes with PIL, in C; this is
 * the same recurrence in C, built with the host compiler at first use and
 * called through ctypes, so a Paeth or Average row costs what a row of
 * filter 0 costs.
 *
 * raw: h rows of 1 + stride bytes, each a filter type (0 None, 1 Sub, 2 Up,
 * 3 Average, 4 Paeth) followed by the filtered bytes; out: h rows of stride
 * bytes; bpp: bytes per complete pixel, rounded up to 1 for sub-byte depths.
 * Returns 0, or 1 + the index of the first row whose filter type is unknown.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static uint8_t paeth(int a, int b, int c)
{
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc)
        return (uint8_t)a;
    return (uint8_t)(pb <= pc ? b : c);
}

int64_t tpuseg_png_unfilter(const uint8_t *raw, uint8_t *out, int64_t h,
                            int64_t stride, int64_t bpp)
{
    static const uint8_t zeros[1] = {0};
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t *line = raw + r * (stride + 1) + 1;
        uint8_t *cur = out + r * stride;
        /* the row above the first is all zeros: read it through a stride-0
           pointer */
        const uint8_t *prev = r ? cur - stride : zeros;
        const int64_t step = r ? 1 : 0;
        int64_t i;
        switch (line[-1]) {
        case 0:
            memcpy(cur, line, (size_t)stride);
            break;
        case 1:
            for (i = 0; i < stride && i < bpp; ++i)
                cur[i] = line[i];
            for (; i < stride; ++i)
                cur[i] = (uint8_t)(line[i] + cur[i - bpp]);
            break;
        case 2:
            for (i = 0; i < stride; ++i)
                cur[i] = (uint8_t)(line[i] + prev[i * step]);
            break;
        case 3:
            for (i = 0; i < stride && i < bpp; ++i)
                cur[i] = (uint8_t)(line[i] + (prev[i * step] >> 1));
            for (; i < stride; ++i)
                cur[i] = (uint8_t)(line[i]
                                   + ((cur[i - bpp] + prev[i * step]) >> 1));
            break;
        case 4:
            for (i = 0; i < stride && i < bpp; ++i)  /* a = c = 0 */
                cur[i] = (uint8_t)(line[i] + prev[i * step]);
            for (; i < stride; ++i)
                cur[i] = (uint8_t)(line[i] + paeth(cur[i - bpp],
                                                   prev[i * step],
                                                   prev[(i - bpp) * step]));
            break;
        default:
            return r + 1;
        }
    }
    return 0;
}
