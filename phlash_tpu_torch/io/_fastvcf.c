/* Fast VCF genotype tokenizer.
 *
 * Replaces the per-record Python split/regex loop of the text VCF reader
 * (the only ingestion path whose cost grows with every variant record).
 * Given a block of VCF body text and the tab indices of the requested
 * sample columns, emits for each record:
 *   pos   : 1-based position (column 2)
 *   het   : per-sample int8 in {-1 missing, 0 hom, 1 het}
 *   nd    : number of derived (non-reference) alleles across samples
 *
 * Only the GT subfield (first colon-separated field by convention; the
 * FORMAT column is checked by the Python wrapper) of diploid calls is
 * inspected; '.' in either allele marks the sample missing.  A copy of
 * phlash_tpu/io/_fastvcf.c, compiled with the system toolchain at first use
 * (io/fastvcf.py) and bound via ctypes: no build-time Python dependency.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* Parse up to max_records records from buf[0..len).  Returns the number of
 * records parsed.  cols: 0-based tab-separated column indices of the
 * samples (ascending).  Outputs must be preallocated:
 *   pos_out[max_records], nd_out[max_records],
 *   het_out[max_records * n_samples]
 */
long phlash_parse_vcf(const char *buf, long len,
                      const char *contig, long contig_len,
                      const long *cols, long n_samples,
                      long *pos_out, int8_t *het_out, int32_t *nd_out,
                      long max_records) {
    long rec = 0;
    const char *p = buf;
    const char *end = buf + len;
    while (p < end && rec < max_records) {
        const char *line_end = memchr(p, '\n', (size_t)(end - p));
        if (!line_end) line_end = end;
        if (*p == '#') { p = line_end + 1; continue; }
        if (contig_len > 0) {
            /* column 0 must equal the requested contig */
            if (line_end - p <= contig_len || memcmp(p, contig, (size_t)contig_len) != 0
                || p[contig_len] != '\t') {
                p = line_end + 1;
                continue;
            }
        }

        /* walk the tab-separated columns once */
        long col = 0;
        const char *q = p;
        long pos = 0;
        long next_sample = 0;
        int32_t nd = 0;
        while (q < line_end && next_sample <= n_samples) {
            const char *tab = memchr(q, '\t', (size_t)(line_end - q));
            const char *field_end = tab ? tab : line_end;
            if (col == 1) {
                /* POS */
                for (const char *c = q; c < field_end; ++c) {
                    if (*c < '0' || *c > '9') { pos = -1; break; }
                    pos = pos * 10 + (*c - '0');
                }
            } else if (next_sample < n_samples && col == cols[next_sample]) {
                /* genotype field: GT is the leading subfield */
                const char *gt_end = memchr(q, ':', (size_t)(field_end - q));
                if (!gt_end) gt_end = field_end;
                /* expect a{/|}b with a, b allele indices or '.' */
                long a = -1, b = -1;
                const char *c = q;
                if (c < gt_end && *c == '.') { a = -1; ++c; }
                else { a = 0; while (c < gt_end && *c >= '0' && *c <= '9') { a = a * 10 + (*c - '0'); ++c; } }
                if (c < gt_end && (*c == '/' || *c == '|')) ++c;
                if (c < gt_end && *c == '.') { b = -1; ++c; }
                else if (c < gt_end) { b = 0; while (c < gt_end && *c >= '0' && *c <= '9') { b = b * 10 + (*c - '0'); ++c; } }
                int8_t h;
                if (a < 0 || b < 0) h = -1;
                else h = (a != b) ? 1 : 0;
                het_out[rec * n_samples + next_sample] = h;
                if (a > 0) ++nd;
                if (b > 0) ++nd;
                ++next_sample;
            }
            if (!tab) break;
            q = tab + 1;
            ++col;
        }
        /* records missing sample columns are skipped */
        if (pos > 0 && next_sample == n_samples) {
            pos_out[rec] = pos;
            nd_out[rec] = nd;
            ++rec;
        }
        p = line_end + 1;
    }
    return rec;
}
