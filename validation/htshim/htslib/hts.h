/* Minimal API-compatible hts.h for the reference-validation build.
 *
 * Clean-room subset of the htslib 1.10 public interface, implemented in
 * validation/htshim/shim.c over plain-text SAM/VCF files. Only the
 * surface the upstream demuxlet sources touch is provided; everything
 * else is absent so misuse fails at compile/link time. Not part of
 * demuxlet-jax.
 */
#ifndef HTSHIM_HTS_H
#define HTSHIM_HTS_H

#include <limits.h>
#include <stdint.h>
#include <stdio.h>
#include <sys/types.h>

#include "htslib/kstring.h"

#ifdef __cplusplus
extern "C" {
#endif

struct BGZF;
struct hFILE;

enum htsFormatCategory {
    unknown_category,
    sequence_data,
    variant_data,
    index_file,
    region_list,
};

enum htsExactFormat {
    unknown_format,
    text_format,
    sam,
    bam,
    cram,
    vcf,
    bcf,
};

enum htsCompression {
    no_compression,
    gzip,
    bgzf,
    custom,
};

typedef struct htsFormat {
    enum htsFormatCategory category;
    enum htsExactFormat format;
    struct {
        short major, minor;
    } version;
    enum htsCompression compression;
} htsFormat;

typedef struct htsFile {
    unsigned is_write : 1, is_bin : 1;
    htsFormat format;
    char *fn;
    kstring_t line;
    union {
        struct BGZF *bgzf;
        struct hFILE *hfile;
        void *voidp;
    } fp;
    /* shim internals */
    FILE *shim_fp;
} htsFile;

/* iterator/index types: region iteration is NOT supported by the shim
 * (the validation runs stream whole files); the functions exist so the
 * upstream sources link, and abort if ever invoked. */
typedef struct hts_idx_t hts_idx_t;
typedef struct hts_itr_t hts_itr_t;

#define KS_SEP_LINE 2

htsFile *hts_open(const char *fn, const char *mode);
int hts_close(htsFile *fp);
int hts_getline(htsFile *fp, int delimiter, kstring_t *str);
int hts_set_fai_filename(htsFile *fp, const char *fn_aux);

hts_idx_t *hts_idx_load(const char *fn, int fmt);
void hts_idx_destroy(hts_idx_t *idx);
void hts_itr_destroy(hts_itr_t *itr);

extern const char seq_nt16_str[];
extern const unsigned char seq_nt16_table[256];

size_t hts_realloc_or_die(unsigned long n, unsigned long m,
                          unsigned long m_sz, unsigned long size_sz,
                          int clear, void **ptr, const char *func);

/* hFILE writing (hprintf's uncompressed path) */
ssize_t hwrite(struct hFILE *fp, const void *buffer, size_t nbytes);

#ifdef __cplusplus
}
#endif

#endif
