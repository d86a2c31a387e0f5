/* Minimal API-compatible vcf.h for the reference-validation build.
 * Clean-room subset of the htslib 1.10 public interface; records are
 * parsed from PLAIN-TEXT VCF by validation/htshim/shim_vcf.c. Field
 * names/semantics follow the public htslib API that the upstream
 * demuxlet sources program against. Not part of demuxlet-jax.
 */
#ifndef HTSHIM_VCF_H
#define HTSHIM_VCF_H

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "htslib/hts.h"
#include "htslib/kstring.h"

#ifdef __cplusplus
extern "C" {
#endif

/* header line / value types */
#define BCF_HL_FLT 0
#define BCF_HL_INFO 1
#define BCF_HL_FMT 2
#define BCF_HL_CTG 3
#define BCF_HL_STR 4
#define BCF_HL_GEN 5

#define BCF_HT_FLAG 0
#define BCF_HT_INT 1
#define BCF_HT_REAL 2
#define BCF_HT_STR 3

#define BCF_VL_FIXED 0
#define BCF_VL_VAR 1
#define BCF_VL_A 2
#define BCF_VL_G 3
#define BCF_VL_R 4

/* dictionaries */
#define BCF_DT_ID 0
#define BCF_DT_CTG 1
#define BCF_DT_SAMPLE 2

/* typed-value types */
#define BCF_BT_NULL 0
#define BCF_BT_INT8 1
#define BCF_BT_INT16 2
#define BCF_BT_INT32 3
#define BCF_BT_FLOAT 5
#define BCF_BT_CHAR 7

/* variant types */
#define VCF_REF 0
#define VCF_SNP 1
#define VCF_MNP 2
#define VCF_INDEL 4
#define VCF_OTHER 8

typedef htsFile vcfFile;

typedef struct bcf_hrec_t {
    int type;
    char *key;
    char *value;
    int nkeys;
    char **keys;
    char **vals;
} bcf_hrec_t;

typedef struct bcf_idinfo_t {
    uint64_t info[3];
    bcf_hrec_t *hrec[3];
    int id;
} bcf_idinfo_t;

typedef struct bcf_idpair_t {
    const char *key;
    const bcf_idinfo_t *val;
} bcf_idpair_t;

typedef struct bcf_hdr_t {
    int32_t n[3];
    bcf_idpair_t *id[3];
    void *dict[3]; /* khash vdict (ID/CTG/SAMPLE) */
    char **samples;
    bcf_hrec_t **hrec;
    int nhrec, dirty;
    int ntransl, *transl[2];
    int nsamples_ori;
    uint8_t *keep_samples;
    kstring_t mem;
    int32_t m[3];
} bcf_hdr_t;

typedef struct bcf_fmt_t {
    int id;
    int n, size, type;
    uint8_t *p;
    uint32_t p_len;
    uint32_t p_off : 31, p_free : 1;
} bcf_fmt_t;

typedef struct bcf_info_t {
    int key;
    int type;
    union {
        int64_t i;
        float f;
    } v1;
    uint8_t *vptr;
    uint32_t vptr_len;
    uint32_t vptr_off : 31, vptr_free : 1;
    int len;
} bcf_info_t;

typedef struct bcf_dec_t {
    int m_fmt, m_info, m_id, m_als, m_allele, m_flt;
    int n_flt;
    int *flt;
    char *id, *als;
    char **allele;
    bcf_info_t *info;
    bcf_fmt_t *fmt;
    int shared_dirty, indiv_dirty;
    kstring_t raw; /* shim: the raw VCF line the record was parsed from */
} bcf_dec_t;

#define BCF_ERR_CTG_UNDEF 1
#define BCF_ERR_TAG_UNDEF 2
#define BCF_ERR_NCOLS 4
#define BCF_ERR_LIMITS 8

typedef struct bcf1_t {
    int32_t rid;
    int32_t pos;
    int32_t rlen;
    float qual;
    uint32_t n_info : 16, n_allele : 16;
    uint32_t n_fmt : 8, n_sample : 24;
    kstring_t shared, indiv;
    bcf_dec_t d;
    int max_unpack;
    int unpacked;
    int unpack_size[3];
    int errcode;
} bcf1_t;

/* unpack levels */
#define BCF_UN_STR 1
#define BCF_UN_FLT 2
#define BCF_UN_INFO 4
#define BCF_UN_SHR (BCF_UN_STR | BCF_UN_FLT | BCF_UN_INFO)
#define BCF_UN_FMT 8
#define BCF_UN_IND BCF_UN_FMT
#define BCF_UN_ALL (BCF_UN_SHR | BCF_UN_FMT)

#define bcf_hdr_nsamples(hdr) (hdr)->n[BCF_DT_SAMPLE]

/* GT encoding */
#define bcf_gt_phased(idx) (((idx) + 1) << 1 | 1)
#define bcf_gt_unphased(idx) (((idx) + 1) << 1)
#define bcf_gt_missing 0
#define bcf_gt_is_phased(idx) ((idx)&1)
#define bcf_gt_allele(val) (((val) >> 1) - 1)

/* missing/vector-end sentinels */
#define bcf_int8_vector_end (INT8_MIN + 1)
#define bcf_int16_vector_end (INT16_MIN + 1)
#define bcf_int32_vector_end (INT32_MIN + 1)
#define bcf_str_vector_end 0
#define bcf_int8_missing INT8_MIN
#define bcf_int16_missing INT16_MIN
#define bcf_int32_missing INT32_MIN
#define bcf_str_missing 0x07

extern uint32_t bcf_float_vector_end;
extern uint32_t bcf_float_missing;

static inline void bcf_float_set(float *ptr, uint32_t value) {
    memcpy(ptr, &value, 4);
}
#define bcf_float_set_vector_end(x) bcf_float_set(&(x), bcf_float_vector_end)
#define bcf_float_set_missing(x) bcf_float_set(&(x), bcf_float_missing)
static inline int bcf_float_is_missing(float f) {
    uint32_t bits;
    memcpy(&bits, &f, 4);
    return bits == bcf_float_missing;
}
static inline int bcf_float_is_vector_end(float f) {
    uint32_t bits;
    memcpy(&bits, &f, 4);
    return bits == bcf_float_vector_end;
}

/* header/record API (implemented by the shim over plain-text VCF) */
bcf_hdr_t *bcf_hdr_init(const char *mode);
bcf_hdr_t *bcf_hdr_read(htsFile *fp);
void bcf_hdr_destroy(bcf_hdr_t *h);
int bcf_hdr_append(bcf_hdr_t *h, const char *line);
int bcf_hdr_sync(bcf_hdr_t *h);
int bcf_hdr_id2int(const bcf_hdr_t *hdr, int type, const char *id);
const char *bcf_hdr_int2id(const bcf_hdr_t *hdr, int type, int int_id);
int bcf_hdr_name2id(const bcf_hdr_t *hdr, const char *id);
const char *bcf_hdr_id2name(const bcf_hdr_t *hdr, int rid);
int bcf_hdr_write(htsFile *fp, bcf_hdr_t *h);

/* idinfo lookup macros (htslib encoding: info = len<<8 | type<<4 | coltype)
 */
#define bcf_hdr_id2length(hdr, type, int_id) \
    (((hdr)->id[BCF_DT_ID][int_id].val->info[type] >> 8) & 0xf)
#define bcf_hdr_id2number(hdr, type, int_id) \
    (((hdr)->id[BCF_DT_ID][int_id].val->info[type]) >> 12)
#define bcf_hdr_id2type(hdr, type, int_id) \
    (((hdr)->id[BCF_DT_ID][int_id].val->info[type] >> 4) & 0xf)
#define bcf_hdr_id2coltype(hdr, type, int_id) \
    (((hdr)->id[BCF_DT_ID][int_id].val->info[type]) & 0xf)
#define bcf_hdr_idinfo_exists(hdr, type, int_id)                          \
    ((int_id < 0 || bcf_hdr_id2coltype(hdr, type, int_id) == 0xf) ? 0 : 1)
#define bcf_hdr_id2hrec(hdr, dict_type, col_type, int_id)              \
    ((hdr)->id[(dict_type) == BCF_DT_CTG ? BCF_DT_CTG : BCF_DT_ID]     \
         [int_id]                                                      \
             .val->hrec[(dict_type) == BCF_DT_CTG ? 0 : (col_type)])

bcf_hrec_t *bcf_hdr_get_hrec(const bcf_hdr_t *hdr, int type,
                             const char *key, const char *value,
                             const char *str_class);
int bcf_hrec_find_key(bcf_hrec_t *hrec, const char *key);

bcf1_t *bcf_init(void);
void bcf_destroy(bcf1_t *v);
void bcf_clear(bcf1_t *v);
void bcf_empty(bcf1_t *v);
int bcf_read(htsFile *fp, const bcf_hdr_t *h, bcf1_t *v);
int bcf_unpack(bcf1_t *b, int which);
int bcf_write(htsFile *fp, bcf_hdr_t *h, bcf1_t *v);
int vcf_parse1(kstring_t *s, const bcf_hdr_t *h, bcf1_t *v);
int vcf_format(const bcf_hdr_t *h, const bcf1_t *v, kstring_t *s);
int bcf_get_variant_types(bcf1_t *rec);
int bcf_is_snp(bcf1_t *v);

int bcf_get_format_values(const bcf_hdr_t *hdr, bcf1_t *line,
                          const char *tag, void **dst, int *ndst, int type);
#define bcf_get_format_int32(hdr, line, tag, dst, ndst) \
    bcf_get_format_values(hdr, line, tag, (void **)(dst), ndst, BCF_HT_INT)
#define bcf_get_format_float(hdr, line, tag, dst, ndst) \
    bcf_get_format_values(hdr, line, tag, (void **)(dst), ndst, BCF_HT_REAL)
#define bcf_get_format_char(hdr, line, tag, dst, ndst) \
    bcf_get_format_values(hdr, line, tag, (void **)(dst), ndst, BCF_HT_STR)
#define bcf_get_genotypes(hdr, line, dst, ndst) \
    bcf_get_format_values(hdr, line, "GT", (void **)(dst), ndst, BCF_HT_INT)
int bcf_get_format_string(const bcf_hdr_t *hdr, bcf1_t *line,
                          const char *tag, char ***dst, int *ndst);

int bcf_update_format(const bcf_hdr_t *hdr, bcf1_t *line, const char *key,
                      const void *values, int n, int type);
#define bcf_update_format_string(hdr, line, key, values, n) \
    bcf_update_format_string_shim(hdr, line, key, values, n)
int bcf_update_format_string_shim(const bcf_hdr_t *hdr, bcf1_t *line,
                                  const char *key, const char **values,
                                  int n);
#define bcf_update_format_char(hdr, line, key, values, n) \
    bcf_update_format(hdr, line, key, (const void *)(values), (n), BCF_HT_STR)
int bcf_update_id(const bcf_hdr_t *hdr, bcf1_t *line, const char *id);

bcf_fmt_t *bcf_get_fmt(const bcf_hdr_t *hdr, bcf1_t *line, const char *key);

static inline int bcf_alleles2gt(int a, int b) {
    return a > b ? (a * (a + 1) / 2 + b) : (b * (b + 1) / 2 + a);
}
static inline void bcf_gt2alleles(int igt, int *a, int *b) {
    int k = 0, dk = 1;
    while (k < igt) {
        dk++;
        k += dk;
    }
    *b = dk - 1;
    *a = igt - k + *b;
}

/* region iteration (unsupported; aborts if used) */
hts_idx_t *bcf_index_load(const char *fn);
hts_itr_t *bcf_itr_querys_shim(const hts_idx_t *idx, const bcf_hdr_t *hdr,
                               const char *region);
#define bcf_itr_querys(idx, hdr, s) bcf_itr_querys_shim(idx, hdr, s)
int bcf_itr_next_shim(htsFile *fp, hts_itr_t *itr, bcf1_t *v);
#define bcf_itr_next(fp, itr, v) bcf_itr_next_shim(fp, itr, v)
int bcf_close(htsFile *fp);

#ifdef __cplusplus
}
#endif

#endif
