/* Minimal API-compatible sam.h for the reference-validation build.
 * Clean-room subset of the htslib 1.10 public interface; records are
 * parsed from PLAIN-TEXT SAM by validation/htshim/shim.c. Not part of
 * demuxlet-jax.
 */
#ifndef HTSHIM_SAM_H
#define HTSHIM_SAM_H

#include <stdint.h>

#include "htslib/hts.h"

#ifdef __cplusplus
extern "C" {
#endif

/* CIGAR */
#define BAM_CMATCH 0
#define BAM_CINS 1
#define BAM_CDEL 2
#define BAM_CREF_SKIP 3
#define BAM_CSOFT_CLIP 4
#define BAM_CHARD_CLIP 5
#define BAM_CPAD 6
#define BAM_CEQUAL 7
#define BAM_CDIFF 8
#define BAM_CBACK 9

#define BAM_CIGAR_STR "MIDNSHP=XB"
#define BAM_CIGAR_SHIFT 4
#define BAM_CIGAR_MASK 0xf

#define bam_cigar_op(c) ((c) & BAM_CIGAR_MASK)
#define bam_cigar_oplen(c) ((c) >> BAM_CIGAR_SHIFT)
#define bam_cigar_opchr(c) (BAM_CIGAR_STR[bam_cigar_op(c)])
#define bam_cigar_gen(l, o) ((l) << BAM_CIGAR_SHIFT | (o))

/* flags */
#define BAM_FPAIRED 1
#define BAM_FPROPER_PAIR 2
#define BAM_FUNMAP 4
#define BAM_FMUNMAP 8
#define BAM_FREVERSE 16
#define BAM_FMREVERSE 32
#define BAM_FREAD1 64
#define BAM_FREAD2 128
#define BAM_FSECONDARY 256
#define BAM_FQCFAIL 512
#define BAM_FDUP 1024
#define BAM_FSUPPLEMENTARY 2048

typedef htsFile samFile;

typedef struct bam_hdr_t {
    int32_t n_targets;
    uint32_t l_text;
    uint32_t *target_len;
    char **target_name;
    char *text;
    void *sdict;
} bam_hdr_t;

typedef struct bam1_core_t {
    int32_t tid;
    int32_t pos;
    uint16_t bin;
    uint8_t qual;
    uint8_t l_extranul;
    uint16_t flag;
    uint16_t l_qname;
    uint32_t n_cigar;
    int32_t l_qseq;
    int32_t mtid;
    int32_t mpos;
    int32_t isize;
} bam1_core_t;

typedef struct bam1_t {
    bam1_core_t core;
    int l_data;
    uint32_t m_data;
    uint8_t *data;
} bam1_t;

/* data layout (BAM spec): qname(l_qname incl NUL+extranul) | cigar
 * (n_cigar u32) | seq(4-bit) | qual | aux */
#define bam_get_qname(b) ((char *)(b)->data)
#define bam_get_cigar(b) ((uint32_t *)((b)->data + (b)->core.l_qname))
#define bam_get_seq(b) \
    ((b)->data + ((b)->core.n_cigar << 2) + (b)->core.l_qname)
#define bam_get_qual(b)                                                 \
    ((b)->data + ((b)->core.n_cigar << 2) + (b)->core.l_qname +         \
     (((b)->core.l_qseq + 1) >> 1))
#define bam_get_aux(b)                                                  \
    ((b)->data + ((b)->core.n_cigar << 2) + (b)->core.l_qname +         \
     (((b)->core.l_qseq + 1) >> 1) + (b)->core.l_qseq)
#define bam_get_l_aux(b)                                               \
    ((b)->l_data - ((b)->core.n_cigar << 2) - (b)->core.l_qname -      \
     (b)->core.l_qseq - (((b)->core.l_qseq + 1) >> 1))
#define bam_seqi(s, i) ((s)[(i) >> 1] >> ((~(i)&1) << 2) & 0xf)
#define bam_is_rev(b) (((b)->core.flag & BAM_FREVERSE) != 0)
#define bam_is_mrev(b) (((b)->core.flag & BAM_FMREVERSE) != 0)

bam_hdr_t *sam_hdr_read(htsFile *fp);
void bam_hdr_destroy(bam_hdr_t *h);
int sam_read1(htsFile *fp, bam_hdr_t *h, bam1_t *b);
bam1_t *bam_init1(void);
void bam_destroy1(bam1_t *b);
int bam_name2id(bam_hdr_t *h, const char *ref);
uint8_t *bam_aux_get(const bam1_t *b, const char tag[2]);
int32_t bam_endpos(const bam1_t *b);
int64_t bam_aux2i(const uint8_t *s);
char *bam_aux2Z(const uint8_t *s);

/* region iteration: unsupported by the shim (aborts if called) */
hts_idx_t *sam_index_load(htsFile *fp, const char *fn);
hts_itr_t *sam_itr_querys(const hts_idx_t *idx, bam_hdr_t *hdr,
                          const char *region);
int sam_itr_next(htsFile *fp, hts_itr_t *itr, bam1_t *b);
int sam_close(htsFile *fp);

#ifdef __cplusplus
}
#endif

#endif
