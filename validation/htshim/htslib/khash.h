/* Minimal API-compatible khash for the reference-validation build.
 *
 * Clean-room generic open-addressing hash exposing the khash macro API
 * (KHASH_MAP_INIT_STR / kh_get / kh_put / kh_val / ...). Linear probing
 * over power-of-two capacity; deletion not supported (the validation
 * build never deletes). Not part of demuxlet-jax.
 */
#ifndef HTSHIM_KHASH_H
#define HTSHIM_KHASH_H

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef uint32_t khint_t;
typedef khint_t khiter_t;

static inline khint_t __hts_shim_str_hash(const char *s) {
    khint_t h = 2166136261u;
    for (; *s; ++s) h = (h ^ (unsigned char)*s) * 16777619u;
    return h;
}

#define __hts_shim_int_hash(key) ((khint_t)(key))

#define KHASH_INIT2(name, SCOPE, khkey_t, khval_t, kh_is_map, __hash_func, \
                    __hash_equal)                                          \
    typedef struct kh_##name##_s {                                         \
        khint_t n_buckets, size;                                           \
        unsigned char *used;                                               \
        khkey_t *keys;                                                     \
        khval_t *vals;                                                     \
    } kh_##name##_t;                                                       \
    SCOPE kh_##name##_t *kh_init_##name(void) {                            \
        return (kh_##name##_t *)calloc(1, sizeof(kh_##name##_t));          \
    }                                                                      \
    SCOPE void kh_destroy_##name(kh_##name##_t *h) {                       \
        if (h) {                                                           \
            free(h->used);                                                 \
            free(h->keys);                                                 \
            free(h->vals);                                                 \
            free(h);                                                       \
        }                                                                  \
    }                                                                      \
    SCOPE khint_t kh_get_##name(const kh_##name##_t *h, khkey_t key) {     \
        if (!h->n_buckets) return 0;                                       \
        khint_t mask = h->n_buckets - 1;                                   \
        khint_t i = __hash_func(key) & mask;                               \
        while (h->used[i]) {                                               \
            if (__hash_equal(h->keys[i], key)) return i;                   \
            i = (i + 1) & mask;                                            \
        }                                                                  \
        return h->n_buckets;                                               \
    }                                                                      \
    SCOPE void kh_resize_##name(kh_##name##_t *h, khint_t nb) {            \
        kh_##name##_t old = *h;                                            \
        h->n_buckets = nb;                                                 \
        h->used = (unsigned char *)calloc(nb, 1);                          \
        h->keys = (khkey_t *)calloc(nb, sizeof(khkey_t));                  \
        h->vals = (khval_t *)calloc(nb, sizeof(khval_t));                  \
        khint_t mask = nb - 1;                                             \
        for (khint_t i = 0; i < old.n_buckets; ++i) {                      \
            if (!old.used[i]) continue;                                    \
            khint_t j = __hash_func(old.keys[i]) & mask;                   \
            while (h->used[j]) j = (j + 1) & mask;                         \
            h->used[j] = 1;                                                \
            h->keys[j] = old.keys[i];                                      \
            h->vals[j] = old.vals[i];                                      \
        }                                                                  \
        free(old.used);                                                    \
        free(old.keys);                                                    \
        free(old.vals);                                                    \
    }                                                                      \
    SCOPE khint_t kh_put_##name(kh_##name##_t *h, khkey_t key, int *ret) { \
        if (h->size * 4 >= h->n_buckets * 3)                               \
            kh_resize_##name(h, h->n_buckets ? h->n_buckets * 2 : 16);     \
        khint_t mask = h->n_buckets - 1;                                   \
        khint_t i = __hash_func(key) & mask;                               \
        while (h->used[i]) {                                               \
            if (__hash_equal(h->keys[i], key)) {                           \
                *ret = 0;                                                  \
                return i;                                                  \
            }                                                              \
            i = (i + 1) & mask;                                            \
        }                                                                  \
        h->used[i] = 1;                                                    \
        h->keys[i] = key;                                                  \
        h->size++;                                                         \
        *ret = 1;                                                          \
        return i;                                                          \
    }                                                                      \
    SCOPE void kh_del_##name(kh_##name##_t *h, khint_t i) {                \
        (void)h;                                                           \
        (void)i; /* unused by the validation build */                      \
    }                                                                      \
    SCOPE void kh_clear_##name(kh_##name##_t *h) {                         \
        if (h->used) memset(h->used, 0, h->n_buckets);                     \
        h->size = 0;                                                       \
    }

#define __hts_shim_streq(a, b) (strcmp((a), (b)) == 0)
#define __hts_shim_inteq(a, b) ((a) == (b))

#define KHASH_MAP_INIT_STR(name, khval_t)                                \
    KHASH_INIT2(name, static inline, const char *, khval_t, 1,           \
                __hts_shim_str_hash, __hts_shim_streq)
#define KHASH_MAP_INIT_INT(name, khval_t)                             \
    KHASH_INIT2(name, static inline, khint_t, khval_t, 1,             \
                __hts_shim_int_hash, __hts_shim_inteq)
#define KHASH_SET_INIT_STR(name)                                       \
    KHASH_INIT2(name, static inline, const char *, char, 0,            \
                __hts_shim_str_hash, __hts_shim_streq)
#define KHASH_SET_INIT_INT(name)                                     \
    KHASH_INIT2(name, static inline, khint_t, char, 0,               \
                __hts_shim_int_hash, __hts_shim_inteq)

#define khash_t(name) kh_##name##_t
#define kh_init(name) kh_init_##name()
#define kh_destroy(name, h) kh_destroy_##name(h)
#define kh_clear(name, h) kh_clear_##name(h)
#define kh_get(name, h, k) kh_get_##name(h, k)
#define kh_put(name, h, k, r) kh_put_##name(h, k, r)
#define kh_del(name, h, i) kh_del_##name(h, i)
#define kh_exist(h, x) ((h)->used[x] != 0)
#define kh_key(h, x) ((h)->keys[x])
#define kh_val(h, x) ((h)->vals[x])
#define kh_value(h, x) ((h)->vals[x])
#define kh_begin(h) (khint_t)(0)
#define kh_end(h) ((h)->n_buckets)
#define kh_size(h) ((h)->size)

#endif
