/* Minimal API-compatible kstring for the reference-validation build.
 *
 * Clean-room subset of the htslib kstring interface (names/semantics per
 * the public API docs); used only to compile the upstream demuxlet
 * sources against validation/htshim so golden outputs can be produced
 * from the reference's own algorithm code. Not part of demuxlet-jax.
 */
#ifndef HTSHIM_KSTRING_H
#define HTSHIM_KSTRING_H

#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct kstring_t {
    size_t l, m;
    char *s;
} kstring_t;

#ifndef KS_INITIALIZE
#define KS_INITIALIZE { 0, 0, NULL }
#endif

static inline int ks_resize(kstring_t *s, size_t size) {
    if (s->m < size) {
        size_t m = size;
        m += m >> 1; /* growth factor */
        char *tmp = (char *)realloc(s->s, m);
        if (!tmp) return -1;
        s->s = tmp;
        s->m = m;
    }
    return 0;
}

static inline char *ks_str(kstring_t *s) { return s->s; }
static inline size_t ks_len(kstring_t *s) { return s->l; }

static inline char *ks_release(kstring_t *s) {
    char *p = s->s;
    s->l = s->m = 0;
    s->s = NULL;
    return p;
}

static inline int kputsn(const char *p, size_t l, kstring_t *s) {
    if (ks_resize(s, s->l + l + 2) < 0) return EOF;
    memcpy(s->s + s->l, p, l);
    s->l += l;
    s->s[s->l] = 0;
    return (int)l;
}

static inline int kputs(const char *p, kstring_t *s) {
    return kputsn(p, strlen(p), s);
}

static inline int kputc(int c, kstring_t *s) {
    if (ks_resize(s, s->l + 2) < 0) return EOF;
    s->s[s->l++] = (char)c;
    s->s[s->l] = 0;
    return c;
}

static inline int kputw(int c, kstring_t *s) {
    char buf[16];
    int n = snprintf(buf, sizeof(buf), "%d", c);
    return kputsn(buf, (size_t)n, s);
}

static inline int kputl(long c, kstring_t *s) {
    char buf[32];
    int n = snprintf(buf, sizeof(buf), "%ld", c);
    return kputsn(buf, (size_t)n, s);
}

static inline int kputd(double d, kstring_t *s) {
    char buf[64];
    int n = snprintf(buf, sizeof(buf), "%g", d);
    return kputsn(buf, (size_t)n, s);
}

static inline int kvsprintf(kstring_t *s, const char *fmt, va_list ap) {
    va_list args;
    va_copy(args, ap);
    int n = vsnprintf(NULL, 0, fmt, args);
    va_end(args);
    if (n < 0) return -1;
    if (ks_resize(s, s->l + (size_t)n + 2) < 0) return -1;
    va_copy(args, ap);
    vsnprintf(s->s + s->l, (size_t)n + 1, fmt, args);
    va_end(args);
    s->l += (size_t)n;
    return n;
}

static inline int ksprintf(kstring_t *s, const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    int n = kvsprintf(s, fmt, ap);
    va_end(ap);
    return n;
}

/* field splitting (used by tsv paths) */
static inline int *ksplit(kstring_t *s, int delimiter, int *n) {
    int max = 8, cnt = 0;
    int *offs = (int *)malloc(sizeof(int) * max);
    size_t i = 0;
    while (i < s->l) {
        while (i < s->l &&
               (delimiter == 0
                    ? (s->s[i] == ' ' || s->s[i] == '\t' || s->s[i] == '\n')
                    : s->s[i] == delimiter))
            s->s[i++] = 0;
        if (i >= s->l) break;
        if (cnt == max) {
            max *= 2;
            offs = (int *)realloc(offs, sizeof(int) * max);
        }
        offs[cnt++] = (int)i;
        while (i < s->l &&
               !(delimiter == 0
                     ? (s->s[i] == ' ' || s->s[i] == '\t' || s->s[i] == '\n')
                     : s->s[i] == delimiter))
            i++;
    }
    *n = cnt;
    return offs;
}

#endif
