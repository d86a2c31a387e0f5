/* htshim: a from-scratch, plain-text-backed implementation of the htslib
 * API subset the upstream demuxlet sources use.
 *
 * Purpose: build the REFERENCE demuxlet binary (compiled unmodified from
 * /root/reference) without htslib, so the framework's outputs can be
 * diffed against goldens produced by the reference's own algorithm code
 * (cmd_cram_demuxlet.cpp, bcf_filtered_reader.cpp, PhredHelper.cpp, ...).
 * Supported inputs: plain-text SAM and VCF, BGZF/gzip-compressed text
 * (.vcf.gz, .sam.gz — inflated whole into a tmpfile at open), binary
 * BAM (plain or BGZF), and binary BCF2 (decoded to VCF text at open,
 * shim_bcf.cpp). Anything else — CRAM, indexes, regions, FASTA —
 * aborts loudly.
 *
 * This file is validation tooling, NOT part of the demuxlet-jax runtime.
 */

#include <cctype>
#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

#include "htslib/bgzf.h"
#include "htslib/faidx.h"
#include "htslib/hts.h"
#include "htslib/khash.h"
#include "htslib/kstring.h"
#include "htslib/sam.h"
#include "htslib/tbx.h"
#include "htslib/vcf.h"

extern "C" {

/* ---------------------------------------------------------------- misc */
uint32_t bcf_float_missing = 0x7F800001u;
uint32_t bcf_float_vector_end = 0x7F800002u;

const char seq_nt16_str[] = "=ACMGRSVTWYHKDBN";
const unsigned char seq_nt16_table[256] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    1,  2,  4,  8,  15, 15, 15, 15, 15, 15, 15, 15, 15, 0 /*=*/, 15, 15,
    15, 1 /*A*/, 14, 2 /*C*/, 13, 15, 15, 4 /*G*/, 11, 15, 15, 12, 15,
    3 /*M*/, 15 /*N*/, 15,
    15, 15, 5 /*R*/, 6 /*S*/, 8 /*T*/, 15, 7 /*V*/, 9 /*W*/, 15,
    10 /*Y*/, 15, 15, 15, 15, 15, 15,
    15, 1,  14, 2,  13, 15, 15, 4,  11, 15, 15, 12, 15, 3,  15, 15,
    15, 15, 5,  6,  8,  15, 7,  9,  15, 10, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
};

static void shim_die(const char *what) {
    fprintf(stderr, "[htshim] unsupported operation: %s\n", what);
    abort();
}

size_t hts_realloc_or_die(unsigned long n, unsigned long m,
                          unsigned long m_sz, unsigned long size_sz,
                          int clear, void **ptr, const char *func) {
    (void)m_sz;
    (void)func;
    if (n <= m) return m;
    unsigned long newm = m ? m : 16;
    while (newm < n) newm <<= 1;
    void *p = realloc(*ptr, newm * size_sz);
    if (!p) shim_die("realloc");
    if (clear) memset((char *)p + m * size_sz, 0, (newm - m) * size_sz);
    *ptr = p;
    return newm;
}

/* ---------------------------------------------------------------- hts */
struct hFILE {
    FILE *f;
};

htsFile *hts_open(const char *fn, const char *mode) {
    FILE *f = fopen(fn, mode[0] == 'w' ? "w" : "r");
    if (!f) return NULL;
    htsFile *fp = (htsFile *)calloc(1, sizeof(htsFile));
    fp->fn = strdup(fn);
    fp->shim_fp = f;
    fp->format.compression = no_compression;
    if (mode[0] == 'w') {
        fp->is_write = 1;
        fp->format.format = text_format;
        hFILE *h = (hFILE *)calloc(1, sizeof(hFILE));
        h->f = f;
        fp->fp.hfile = h;
        return fp;
    }
    /* sniff: BGZF/gzip → inflate the WHOLE file into a tmpfile and read
     * that (zlib's gzFile transparently concatenates BGZF members).
     * Validation-only tooling: simplicity over streaming. */
    int c0 = fgetc(f);
    int c1 = fgetc(f);
    rewind(f);
    if (c0 == 0x1f && c1 == 0x8b) {
        gzFile gz = gzopen(fn, "rb");
        if (!gz) shim_die("gzopen");
        FILE *tf = tmpfile();
        if (!tf) shim_die("tmpfile");
        char buf[1 << 16];
        int r;
        while ((r = gzread(gz, buf, sizeof buf)) > 0)
            if (fwrite(buf, 1, (size_t)r, tf) != (size_t)r)
                shim_die("tmpfile write");
        if (r < 0) shim_die("gzread (corrupt BGZF/gzip)");
        gzclose(gz);
        rewind(tf);
        fclose(f);
        f = tf;
        fp->format.compression = bgzf;
        c0 = fgetc(f);
        c1 = fgetc(f);
        rewind(f);
    }
    fp->shim_fp = f;
    /* binary-format magics on the (possibly inflated) stream */
    char magic[4] = {0, 0, 0, 0};
    if (fread(magic, 1, 4, f) == 4) {
        rewind(f);
        if (memcmp(magic, "BAM\1", 4) == 0) {
            fp->format.format = bam;
            fp->format.category = sequence_data;
            fp->is_bin = 1;
            return fp;
        }
        if (memcmp(magic, "BCF", 3) == 0) {
            /* binary BCF: decode the whole stream to VCF TEXT once
             * (shim_bcf.cpp) and run the existing text parser over it */
            extern FILE *shim_bcf_to_vcf_text(FILE *);
            FILE *tf = shim_bcf_to_vcf_text(f);
            fclose(f);
            f = tf;
            fp->shim_fp = f;
            fp->format.format = vcf;
            fp->format.category = variant_data;
            return fp;
        }
        if (memcmp(magic, "CRAM", 4) == 0) {
            /* CRAM: decode the whole stream to SAM TEXT once
             * (shim_cram.cpp; SHIM_CRAM_REF names the FASTA) and run the
             * existing text parser over it */
            extern FILE *shim_cram_to_sam_text(FILE *, const char *);
            FILE *tf = shim_cram_to_sam_text(f, fn);
            fclose(f);
            f = tf;
            fp->shim_fp = f;
            fp->format.format = sam;
            fp->format.category = sequence_data;
            return fp;
        }
    } else {
        rewind(f);
    }
    size_t n = strlen(fn);
    if (n >= 7 && strcmp(fn + n - 7, ".vcf.gz") == 0) {
        fp->format.format = vcf;
        fp->format.category = variant_data;
    } else if (n >= 4 && strcmp(fn + n - 4, ".vcf") == 0) {
        fp->format.format = vcf;
        fp->format.category = variant_data;
    } else if (n >= 4 && strcmp(fn + n - 4, ".sam") == 0) {
        fp->format.format = sam;
        fp->format.category = sequence_data;
    } else if (c0 == '#') {
        fp->format.format = vcf;
        fp->format.category = variant_data;
    } else if (c0 == '@') {
        fp->format.format = sam;
        fp->format.category = sequence_data;
    } else {
        fp->format.format = text_format;
    }
    return fp;
}

int hts_close(htsFile *fp) {
    if (!fp) return 0;
    if (fp->shim_fp) fclose(fp->shim_fp);
    free(fp->fn);
    free(fp->line.s);
    if (fp->is_write) free(fp->fp.hfile);
    free(fp);
    return 0;
}

int sam_close(htsFile *fp) { return hts_close(fp); }
int bcf_close(htsFile *fp) { return hts_close(fp); }

int hts_getline(htsFile *fp, int delimiter, kstring_t *str) {
    (void)delimiter; /* KS_SEP_LINE only */
    str->l = 0;
    int c;
    FILE *f = fp->shim_fp;
    while ((c = fgetc(f)) != EOF && c != '\n') kputc(c, str);
    if (c == EOF && str->l == 0) return -1;
    if (str->l && str->s[str->l - 1] == '\r') str->s[--str->l] = 0;
    if (!str->s) kputc(0, str), str->l = 0; /* ensure buffer */
    str->s[str->l] = 0;
    return (int)str->l;
}

int hts_set_fai_filename(htsFile *fp, const char *fn_aux) {
    (void)fp;
    (void)fn_aux;
    return 0;
}

ssize_t hwrite(struct hFILE *fp, const void *buffer, size_t nbytes) {
    return (ssize_t)fwrite(buffer, 1, nbytes, fp->f);
}

ssize_t bgzf_write(BGZF *fp, const void *data, size_t length) {
    return (ssize_t)fwrite(data, 1, length, fp->fp);
}
int bgzf_getc(BGZF *fp) { return fgetc(fp->fp); }
int bgzf_useek(BGZF *fp, long uoffset, int where) {
    return fseek(fp->fp, uoffset, where);
}

/* indexes / iterators: never valid in validation runs */
hts_idx_t *hts_idx_load(const char *fn, int fmt) {
    (void)fn;
    (void)fmt;
    return NULL;
}
void hts_idx_destroy(hts_idx_t *idx) { (void)idx; }
void hts_itr_destroy(hts_itr_t *itr) { (void)itr; }
hts_idx_t *sam_index_load(htsFile *fp, const char *fn) {
    (void)fp;
    (void)fn;
    return NULL;
}
hts_itr_t *sam_itr_querys(const hts_idx_t *idx, bam_hdr_t *hdr,
                          const char *region) {
    (void)idx;
    (void)hdr;
    (void)region;
    shim_die("sam_itr_querys (regions)");
    return NULL;
}
int sam_itr_next(htsFile *fp, hts_itr_t *itr, bam1_t *b) {
    (void)fp;
    (void)itr;
    (void)b;
    shim_die("sam_itr_next");
    return -1;
}
hts_idx_t *bcf_index_load(const char *fn) {
    (void)fn;
    return NULL;
}
hts_itr_t *bcf_itr_querys_shim(const hts_idx_t *idx, const bcf_hdr_t *hdr,
                               const char *region) {
    (void)idx;
    (void)hdr;
    (void)region;
    shim_die("bcf_itr_querys");
    return NULL;
}
int bcf_itr_next_shim(htsFile *fp, hts_itr_t *itr, bcf1_t *v) {
    (void)fp;
    (void)itr;
    (void)v;
    shim_die("bcf_itr_next");
    return -1;
}
tbx_t *tbx_index_load(const char *fn) {
    (void)fn;
    return NULL;
}
void tbx_destroy(tbx_t *tbx) { (void)tbx; }
hts_itr_t *tbx_itr_querys_shim(tbx_t *tbx, const char *s) {
    (void)tbx;
    (void)s;
    shim_die("tbx_itr_querys");
    return NULL;
}
int tbx_itr_next_shim(htsFile *fp, tbx_t *tbx, hts_itr_t *itr, void *data) {
    (void)fp;
    (void)tbx;
    (void)itr;
    (void)data;
    shim_die("tbx_itr_next");
    return -1;
}

/* faidx: never used by the validation runs */
faidx_t *fai_load(const char *fn) {
    (void)fn;
    shim_die("fai_load");
    return NULL;
}
int fai_build(const char *fn) {
    (void)fn;
    shim_die("fai_build");
    return -1;
}
void fai_destroy(faidx_t *fai) { (void)fai; }
char *faidx_fetch_seq(const faidx_t *fai, const char *c_name, int p_beg_i,
                      int p_end_i, int *len) {
    (void)fai;
    (void)c_name;
    (void)p_beg_i;
    (void)p_end_i;
    (void)len;
    shim_die("faidx_fetch_seq");
    return NULL;
}
int faidx_nseq(const faidx_t *fai) {
    (void)fai;
    shim_die("faidx_nseq");
    return 0;
}
const char *faidx_iseq(const faidx_t *fai, int i) {
    (void)fai;
    (void)i;
    shim_die("faidx_iseq");
    return NULL;
}
int faidx_seq_len(const faidx_t *fai, const char *seq) {
    (void)fai;
    (void)seq;
    shim_die("faidx_seq_len");
    return 0;
}

/* ---------------------------------------------------------------- sam */
static char *next_tok(char **p, char sep) {
    char *s = *p;
    if (!s) return NULL;
    char *e = strchr(s, sep);
    if (e) {
        *e = 0;
        *p = e + 1;
    } else {
        *p = NULL;
    }
    return s;
}

static int read_i32(FILE *f, int32_t *v) {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return -1;
    *v = (int32_t)((uint32_t)b[0] | ((uint32_t)b[1] << 8) |
                   ((uint32_t)b[2] << 16) | ((uint32_t)b[3] << 24));
    return 0;
}

static bam_hdr_t *bam_hdr_read_bin(FILE *f) {
    /* BAM spec §4.2: magic, l_text, text, n_ref, then per-ref
     * (l_name, name incl NUL, l_ref). */
    char magic[4];
    if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "BAM\1", 4))
        shim_die("bad BAM magic");
    bam_hdr_t *h = (bam_hdr_t *)calloc(1, sizeof(bam_hdr_t));
    int32_t l_text, n_ref;
    if (read_i32(f, &l_text) || l_text < 0) shim_die("BAM l_text");
    h->text = (char *)malloc((size_t)l_text + 1);
    if (fread(h->text, 1, (size_t)l_text, f) != (size_t)l_text)
        shim_die("BAM text");
    h->text[l_text] = 0;
    h->l_text = (uint32_t)l_text;
    if (read_i32(f, &n_ref) || n_ref < 0) shim_die("BAM n_ref");
    h->n_targets = n_ref;
    h->target_name = (char **)calloc((size_t)n_ref + 1, sizeof(char *));
    h->target_len = (uint32_t *)calloc((size_t)n_ref + 1, sizeof(uint32_t));
    for (int32_t i = 0; i < n_ref; ++i) {
        int32_t l_name, l_ref;
        if (read_i32(f, &l_name) || l_name <= 0) shim_die("BAM l_name");
        h->target_name[i] = (char *)malloc((size_t)l_name);
        if (fread(h->target_name[i], 1, (size_t)l_name, f) !=
            (size_t)l_name)
            shim_die("BAM ref name");
        if (read_i32(f, &l_ref)) shim_die("BAM l_ref");
        h->target_len[i] = (uint32_t)l_ref;
    }
    return h;
}

bam_hdr_t *sam_hdr_read(htsFile *fp) {
    if (fp->format.format == bam) return bam_hdr_read_bin(fp->shim_fp);
    bam_hdr_t *h = (bam_hdr_t *)calloc(1, sizeof(bam_hdr_t));
    kstring_t text = KS_INITIALIZE;
    std::vector<char *> names;
    std::vector<uint32_t> lens;
    kstring_t line = KS_INITIALIZE;
    long pos = ftell(fp->shim_fp);
    while (hts_getline(fp, KS_SEP_LINE, &line) >= 0) {
        if (line.l == 0 || line.s[0] != '@') {
            fseek(fp->shim_fp, pos, SEEK_SET);
            break;
        }
        kputsn(line.s, line.l, &text);
        kputc('\n', &text);
        if (strncmp(line.s, "@SQ", 3) == 0) {
            char *sn = NULL;
            uint32_t ln = 0;
            char *p = line.s;
            char *tok;
            while ((tok = next_tok(&p, '\t'))) {
                if (strncmp(tok, "SN:", 3) == 0) sn = strdup(tok + 3);
                if (strncmp(tok, "LN:", 3) == 0)
                    ln = (uint32_t)strtoul(tok + 3, NULL, 10);
            }
            if (sn) {
                names.push_back(sn);
                lens.push_back(ln);
            }
        }
        pos = ftell(fp->shim_fp);
    }
    free(line.s);
    h->n_targets = (int32_t)names.size();
    h->target_name = (char **)calloc(names.size() + 1, sizeof(char *));
    h->target_len = (uint32_t *)calloc(names.size() + 1, sizeof(uint32_t));
    for (size_t i = 0; i < names.size(); ++i) {
        h->target_name[i] = names[i];
        h->target_len[i] = lens[i];
    }
    h->text = text.s ? text.s : strdup("");
    h->l_text = (uint32_t)text.l;
    return h;
}

void bam_hdr_destroy(bam_hdr_t *h) {
    if (!h) return;
    for (int i = 0; i < h->n_targets; ++i) free(h->target_name[i]);
    free(h->target_name);
    free(h->target_len);
    free(h->text);
    free(h);
}

int bam_name2id(bam_hdr_t *h, const char *ref) {
    for (int i = 0; i < h->n_targets; ++i)
        if (strcmp(h->target_name[i], ref) == 0) return i;
    return -1;
}

bam1_t *bam_init1(void) { return (bam1_t *)calloc(1, sizeof(bam1_t)); }

void bam_destroy1(bam1_t *b) {
    if (!b) return;
    free(b->data);
    free(b);
}

static void bam_reserve(bam1_t *b, int n) {
    if ((uint32_t)n > b->m_data) {
        uint32_t m = b->m_data ? b->m_data : 64;
        while (m < (uint32_t)n) m <<= 1;
        b->data = (uint8_t *)realloc(b->data, m);
        b->m_data = m;
    }
}

static int bam_read1_bin(FILE *f, bam1_t *b) {
    /* BAM spec §4.2: block_size, then 8 fixed int32 words, then the
     * variable data section copied VERBATIM (qname|cigar|seq|qual|aux —
     * the bam1_t in-memory layout; l_extranul stays 0). */
    int32_t block_size;
    if (read_i32(f, &block_size)) return -1;
    if (block_size < 32) shim_die("BAM record block_size");
    int32_t w[8];
    for (int i = 0; i < 8; ++i)
        if (read_i32(f, &w[i])) shim_die("truncated BAM record");
    uint32_t bin_mq_nl = (uint32_t)w[2], flag_nc = (uint32_t)w[3];
    b->core.tid = w[0];
    b->core.pos = w[1];
    b->core.bin = (uint16_t)(bin_mq_nl >> 16);
    b->core.qual = (uint8_t)((bin_mq_nl >> 8) & 0xff);
    b->core.l_qname = (uint16_t)(bin_mq_nl & 0xff);
    b->core.l_extranul = 0;
    b->core.flag = (uint16_t)(flag_nc >> 16);
    b->core.n_cigar = flag_nc & 0xffff;
    b->core.l_qseq = w[4];
    b->core.mtid = w[5];
    b->core.mpos = w[6];
    b->core.isize = w[7];
    int ldata = block_size - 32;
    bam_reserve(b, ldata);
    if (fread(b->data, 1, (size_t)ldata, f) != (size_t)ldata)
        shim_die("truncated BAM record data");
    b->l_data = ldata;
    return 0;
}

int sam_read1(htsFile *fp, bam_hdr_t *h, bam1_t *b) {
    if (fp->format.format == bam) return bam_read1_bin(fp->shim_fp, b);
    kstring_t line = KS_INITIALIZE;
    int r;
    do {
        r = hts_getline(fp, KS_SEP_LINE, &line);
        if (r < 0) {
            free(line.s);
            return -1;
        }
    } while (line.l == 0 || line.s[0] == '@');

    char *p = line.s;
    char *qname = next_tok(&p, '\t');
    char *flag_s = next_tok(&p, '\t');
    char *rname = next_tok(&p, '\t');
    char *pos_s = next_tok(&p, '\t');
    char *mapq_s = next_tok(&p, '\t');
    char *cigar_s = next_tok(&p, '\t');
    char *rnext = next_tok(&p, '\t');
    char *pnext_s = next_tok(&p, '\t');
    char *tlen_s = next_tok(&p, '\t');
    char *seq_s = next_tok(&p, '\t');
    char *qual_s = next_tok(&p, '\t');
    if (!qual_s) shim_die("truncated SAM line");

    b->core.flag = (uint16_t)atoi(flag_s);
    b->core.tid = strcmp(rname, "*") ? bam_name2id(h, rname) : -1;
    b->core.pos = atoi(pos_s) - 1;
    b->core.qual = (uint8_t)atoi(mapq_s);
    b->core.mtid = strcmp(rnext, "*") == 0
                       ? -1
                       : (strcmp(rnext, "=") == 0 ? b->core.tid
                                                  : bam_name2id(h, rnext));
    b->core.mpos = atoi(pnext_s) - 1;
    b->core.isize = atoi(tlen_s);

    /* cigar */
    std::vector<uint32_t> cig;
    if (strcmp(cigar_s, "*") != 0) {
        uint32_t n = 0;
        for (char *c = cigar_s; *c; ++c) {
            if (isdigit((unsigned char)*c)) {
                n = n * 10 + (uint32_t)(*c - '0');
            } else {
                const char *ops = BAM_CIGAR_STR;
                const char *hit = strchr(ops, *c);
                if (!hit) shim_die("bad CIGAR op");
                cig.push_back(bam_cigar_gen(n, (uint32_t)(hit - ops)));
                n = 0;
            }
        }
    }
    b->core.n_cigar = (uint32_t)cig.size();

    int l_qseq = strcmp(seq_s, "*") ? (int)strlen(seq_s) : 0;
    b->core.l_qseq = l_qseq;
    int qlen = (int)strlen(qname);
    int extranul = (4 - (qlen + 1) % 4) % 4;
    b->core.l_extranul = (uint8_t)extranul;
    b->core.l_qname = (uint16_t)(qlen + 1 + extranul);

    int need = b->core.l_qname + 4 * (int)cig.size() + (l_qseq + 1) / 2 +
               l_qseq + 256;
    bam_reserve(b, need);
    uint8_t *d = b->data;
    memcpy(d, qname, qlen);
    memset(d + qlen, 0, (size_t)(1 + extranul));
    d += b->core.l_qname;
    memcpy(d, cig.data(), 4 * cig.size());
    d += 4 * cig.size();
    memset(d, 0, (size_t)((l_qseq + 1) / 2));
    for (int i = 0; i < l_qseq; ++i)
        d[i >> 1] |= seq_nt16_table[(unsigned char)seq_s[i]]
                     << ((~i & 1) << 2);
    d += (l_qseq + 1) / 2;
    if (strcmp(qual_s, "*") == 0) {
        memset(d, 0xff, (size_t)l_qseq);
    } else {
        for (int i = 0; i < l_qseq; ++i) d[i] = (uint8_t)(qual_s[i] - 33);
    }
    d += l_qseq;

    /* aux tags */
    char *tag;
    while ((tag = next_tok(&p, '\t'))) {
        if (strlen(tag) < 5 || tag[2] != ':' || tag[4] != ':') continue;
        int avail = (int)(d - b->data);
        int extra = (int)strlen(tag) + 16;
        if (avail + extra > (int)b->m_data) {
            int off = avail;
            bam_reserve(b, avail + extra);
            d = b->data + off;
        }
        *d++ = (uint8_t)tag[0];
        *d++ = (uint8_t)tag[1];
        char t = tag[3];
        const char *val = tag + 5;
        if (t == 'Z' || t == 'H') {
            *d++ = 'Z';
            size_t l = strlen(val);
            memcpy(d, val, l + 1);
            d += l + 1;
        } else if (t == 'A') {
            *d++ = 'A';
            *d++ = (uint8_t)val[0];
        } else if (t == 'i' || t == 'I' || t == 'c' || t == 'C' ||
                   t == 's' || t == 'S') {
            *d++ = 'i';
            int32_t x = atoi(val);
            memcpy(d, &x, 4);
            d += 4;
        } else if (t == 'f') {
            *d++ = 'f';
            float x = (float)atof(val);
            memcpy(d, &x, 4);
            d += 4;
        } /* B arrays: skipped (unused by demuxlet) */
    }
    b->l_data = (int)(d - b->data);
    free(line.s);
    return 0;
}

uint8_t *bam_aux_get(const bam1_t *b, const char tag[2]) {
    uint8_t *s = bam_get_aux((bam1_t *)b);
    uint8_t *end = b->data + b->l_data;
    while (s + 3 < end) {
        uint8_t t0 = s[0], t1 = s[1], typ = s[2];
        uint8_t *val = s + 3;
        size_t sz;
        if (typ == 'Z' || typ == 'H')
            sz = strlen((char *)val) + 1;
        else if (typ == 'A' || typ == 'c' || typ == 'C')
            sz = 1;
        else if (typ == 's' || typ == 'S')
            sz = 2;
        else if (typ == 'd')
            sz = 8;
        else if (typ == 'B') {
            /* sub-type byte + i32 count + count elements */
            uint8_t st = val[0];
            uint32_t cnt;
            memcpy(&cnt, val + 1, 4);
            size_t esz = (st == 'c' || st == 'C') ? 1
                         : (st == 's' || st == 'S') ? 2
                                                    : 4;
            sz = 5 + (size_t)cnt * esz;
        } else
            sz = 4;
        if (t0 == (uint8_t)tag[0] && t1 == (uint8_t)tag[1]) return s + 2;
        s = val + sz;
    }
    return NULL;
}

int64_t bam_aux2i(const uint8_t *s) {
    if (*s == 'i' || *s == 'I') {
        int32_t x;
        memcpy(&x, s + 1, 4);
        return x;
    }
    if (*s == 'c' || *s == 'C') return (int64_t)(int8_t)s[1];
    return 0;
}

char *bam_aux2Z(const uint8_t *s) {
    if (*s == 'Z' || *s == 'H') return (char *)(s + 1);
    return NULL;
}

int32_t bam_endpos(const bam1_t *b) {
    if (b->core.flag & BAM_FUNMAP || b->core.n_cigar == 0)
        return b->core.pos + 1;
    int32_t end = b->core.pos;
    const uint32_t *cig = bam_get_cigar(b);
    for (uint32_t i = 0; i < b->core.n_cigar; ++i) {
        int op = bam_cigar_op(cig[i]);
        if (op == BAM_CMATCH || op == BAM_CDEL || op == BAM_CREF_SKIP ||
            op == BAM_CEQUAL || op == BAM_CDIFF)
            end += (int32_t)bam_cigar_oplen(cig[i]);
    }
    return end;
}

} /* extern "C" */
