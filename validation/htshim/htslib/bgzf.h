/* Minimal bgzf.h for the reference-validation build (plain-FILE backed;
 * the validation runs use uncompressed text only). Not part of
 * demuxlet-jax. */
#ifndef HTSHIM_BGZF_H
#define HTSHIM_BGZF_H
#include <stdint.h>
#include <stdio.h>
#include <sys/types.h>
#ifdef __cplusplus
extern "C" {
#endif
typedef struct BGZF {
    FILE *fp;
} BGZF;
ssize_t bgzf_write(BGZF *fp, const void *data, size_t length);
int bgzf_getc(BGZF *fp);
int bgzf_useek(BGZF *fp, long uoffset, int where);
#ifdef __cplusplus
}
#endif
#endif
