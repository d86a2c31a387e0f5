/* Minimal faidx.h for the reference-validation build: the demuxlet runs
 * never touch a FASTA, so every entry point aborts if invoked. Not part
 * of demuxlet-jax. */
#ifndef HTSHIM_FAIDX_H
#define HTSHIM_FAIDX_H
#ifdef __cplusplus
extern "C" {
#endif
typedef struct __faidx_t faidx_t;
faidx_t *fai_load(const char *fn);
int fai_build(const char *fn);
void fai_destroy(faidx_t *fai);
char *faidx_fetch_seq(const faidx_t *fai, const char *c_name, int p_beg_i,
                      int p_end_i, int *len);
int faidx_nseq(const faidx_t *fai);
const char *faidx_iseq(const faidx_t *fai, int i);
int faidx_seq_len(const faidx_t *fai, const char *seq);
#ifdef __cplusplus
}
#endif
#endif
