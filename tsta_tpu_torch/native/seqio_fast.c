/* Native FASTA/FASTQ parser.
 *
 * TPU-native counterpart of the reference's C seqio layer (seqio.c, 759
 * LoC: buffered state-machine parser seqio.c:463-641, CRLF handling
 * seqio.c:454-456, format guess by first byte seqio.c:275-309).  This is
 * a fresh single-pass design over an in-memory buffer rather than a port
 * of the reference's chunked readUntil() machinery: the host feeds whole
 * (already gunzipped) file bytes and gets back an index of records plus
 * one compacted side buffer -- no per-line Python overhead, no record
 * copies beyond the one compaction pass.
 *
 * Semantics mirror tsta_tpu/io/seqio.py exactly (the Python parser stays
 * as the reference implementation and fallback); the parity contract is
 * enforced by tests/test_seqio.py fuzz.
 *
 * ABI: plain C, loaded with ctypes (no pybind11 in this image).
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    long n;          /* number of records */
    long cap;        /* internal: array capacity */
    long *name_off;  /* offsets into text */
    long *name_len;
    long *com_off;
    long *com_len;
    long *seq_off;
    long *seq_len;
    long *qual_off;  /* -1 for FASTA records */
    long *qual_len;
    unsigned char *text;  /* compacted names+comments+seqs+quals */
    long text_len;
    int is_fastq;
    char err[256];
} TstaSeqIndex;

/* bytes.split(None, ...) whitespace set */
static int is_ws(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v'
        || c == '\f';
}

static int grow(TstaSeqIndex *ix) {
    long cap = ix->cap ? ix->cap * 2 : 64;
    long **arrs[8] = {&ix->name_off, &ix->name_len, &ix->com_off,
                      &ix->com_len, &ix->seq_off, &ix->seq_len,
                      &ix->qual_off, &ix->qual_len};
    for (int i = 0; i < 8; i++) {
        long *p = (long *)realloc(*arrs[i], (size_t)cap * sizeof(long));
        if (!p) return -1;
        *arrs[i] = p;
    }
    ix->cap = cap;
    return 0;
}

void tsta_seqio_free(TstaSeqIndex *ix) {
    free(ix->name_off); free(ix->name_len);
    free(ix->com_off);  free(ix->com_len);
    free(ix->seq_off);  free(ix->seq_len);
    free(ix->qual_off); free(ix->qual_len);
    free(ix->text);
    char err[256];
    memcpy(err, ix->err, 256);      /* keep err readable after free */
    memset(ix, 0, sizeof(*ix));
    memcpy(ix->err, err, 256);
}

/* One line: [*pos, end) up to the next '\n' (consumed), with every
 * trailing '\r' stripped (Python rstrip(b"\r\n") on a '\n'-split line).
 * Returns 0 and leaves *pos == len at end of input. */
static int next_line(const unsigned char *buf, long len, long *pos,
                     long *lo, long *ln) {
    if (*pos >= len) return 0;
    long start = *pos, end = start;
    while (end < len && buf[end] != '\n') end++;
    *pos = (end < len) ? end + 1 : end;
    while (end > start && buf[end - 1] == '\r') end--;
    *lo = start;
    *ln = end - start;
    return 1;
}

/* Header after the marker byte: name = first whitespace-run-delimited
 * token, comment = remainder with leading whitespace stripped
 * (bytes.split(None, 1) semantics). */
static void split_header(const unsigned char *buf, long lo, long ln,
                         long *name_o, long *name_l,
                         long *com_o, long *com_l) {
    long p = lo, end = lo + ln;
    while (p < end && is_ws(buf[p])) p++;
    *name_o = p;
    while (p < end && !is_ws(buf[p])) p++;
    *name_l = p - *name_o;
    while (p < end && is_ws(buf[p])) p++;
    *com_o = p;
    *com_l = end - p;
}

static long emit(TstaSeqIndex *ix, const unsigned char *buf, long off,
                 long ln) {
    long at = ix->text_len;
    memcpy(ix->text + at, buf + off, (size_t)ln);
    ix->text_len += ln;
    return at;
}

/* Parse a whole FASTA/FASTQ buffer.  Returns 0 on success; on error
 * returns nonzero with ix->err set and the index still holding every
 * record COMPLETED before the error (the streaming Python parser yields
 * those records before raising -- consumers that stop early must see
 * them; caller frees either way). */
int tsta_seqio_parse(const unsigned char *buf, long len,
                     TstaSeqIndex *ix) {
    memset(ix, 0, sizeof(*ix));
    ix->text = (unsigned char *)malloc(len ? (size_t)len : 1);
    if (!ix->text) { snprintf(ix->err, 256, "out of memory"); return 1; }

    long pos = 0;
    /* skip leading whitespace bytes (Python's peek loop skips
     * " \t\r\n" one byte at a time before guessing the format) */
    while (pos < len && (buf[pos] == ' ' || buf[pos] == '\t'
                         || buf[pos] == '\r' || buf[pos] == '\n'))
        pos++;
    if (pos >= len) return 0;  /* empty input: zero records */
    unsigned char first = buf[pos];
    if (first != '>' && first != '@') {
        snprintf(ix->err, 256,
                 "unrecognised sequence format (first byte %c)", first);
        return 1;
    }
    ix->is_fastq = (first == '@');

    long lo, ln;
    if (!ix->is_fastq) {
        int have = 0;           /* a record is open */
        long seq_at = 0, seq_n = 0;
        while (next_line(buf, len, &pos, &lo, &ln)) {
            if (ln > 0 && buf[lo] == '>') {
                if (have) {
                    ix->seq_off[ix->n] = seq_at;
                    ix->seq_len[ix->n] = seq_n;
                    ix->n++;
                }
                if (ix->n >= ix->cap && grow(ix)) {
                    snprintf(ix->err, 256, "out of memory");
                    return 1;
                }
                long no, nl, co, cl;
                split_header(buf, lo + 1, ln - 1, &no, &nl, &co, &cl);
                ix->name_off[ix->n] = emit(ix, buf, no, nl);
                ix->name_len[ix->n] = nl;
                ix->com_off[ix->n] = emit(ix, buf, co, cl);
                ix->com_len[ix->n] = cl;
                ix->qual_off[ix->n] = -1;
                ix->qual_len[ix->n] = 0;
                seq_at = ix->text_len;
                seq_n = 0;
                have = 1;
            } else if (ln > 0) {
                if (!have) {
                    snprintf(ix->err, 256,
                             "sequence data before first FASTA header");
                    return 1;
                }
                emit(ix, buf, lo, ln);   /* appends contiguously */
                seq_n += ln;
            }
        }
        if (have) {
            ix->seq_off[ix->n] = seq_at;
            ix->seq_len[ix->n] = seq_n;
            ix->n++;
        }
        return 0;
    }

    /* FASTQ */
    while (next_line(buf, len, &pos, &lo, &ln)) {
        if (ln == 0) continue;   /* blank lines between records */
        if (buf[lo] != '@') {
            snprintf(ix->err, 256,
                     "malformed FASTQ: expected '@', got %c", buf[lo]);
            return 1;
        }
        if (ix->n >= ix->cap && grow(ix)) {
            snprintf(ix->err, 256, "out of memory");
            return 1;
        }
        long no, nl, co, cl;
        split_header(buf, lo + 1, ln - 1, &no, &nl, &co, &cl);
        ix->name_off[ix->n] = emit(ix, buf, no, nl);
        ix->name_len[ix->n] = nl;
        ix->com_off[ix->n] = emit(ix, buf, co, cl);
        ix->com_len[ix->n] = cl;
        long seq_at = ix->text_len, seq_n = 0;
        int plus_seen = 0;
        long qual_at = 0, qual_n = 0;
        while (next_line(buf, len, &pos, &lo, &ln)) {
            if (!plus_seen) {
                if (ln > 0 && buf[lo] == '+') {
                    plus_seen = 1;
                    qual_at = ix->text_len;
                } else {
                    emit(ix, buf, lo, ln);
                    seq_n += ln;
                }
            } else {
                emit(ix, buf, lo, ln);
                qual_n += ln;
                if (qual_n >= seq_n) break;
            }
        }
        if (!plus_seen) qual_at = ix->text_len;
        if (qual_n != seq_n) {
            snprintf(ix->err, 256,
                     "FASTQ record %.*s: quality length %ld != sequence "
                     "length %ld", (int)(nl > 100 ? 100 : nl),
                     (const char *)ix->text + ix->name_off[ix->n],
                     qual_n, seq_n);
            return 1;
        }
        ix->seq_off[ix->n] = seq_at;
        ix->seq_len[ix->n] = seq_n;
        ix->qual_off[ix->n] = qual_at;
        ix->qual_len[ix->n] = qual_n;
        ix->n++;
    }
    return 0;
}
