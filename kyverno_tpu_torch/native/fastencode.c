/* Copied verbatim from kyverno_tpu/native/fastencode.c. */
/* fastencode — native resource->vocabulary encoder.
 *
 * C twin of kyverno_tpu/tpu/flatten.py encode_resources_vocab (the
 * parity oracle): walks resource dict trees with the CPython API and
 * produces the vocabulary batch form (row dedup + index tables).
 * The host encode is the scan pipeline's serial bottleneck — this
 * walk replaces ~7us/row of interpreter work with ~0.1us/row of C.
 *
 * Semantics are pinned to the Python encoder two ways:
 *  - the VALUE grammar (Go number/quantity/duration parsing, repr and
 *    sprint spellings — pattern.go:207-307 semantics) is NOT
 *    reimplemented: scalar-memo misses call back into Python
 *    _scalar_rec and the returned record is cached in C, so the hot
 *    path is native but the semantics come from one implementation;
 *  - paths/keys hash with the same tagged FNV-1a 64 stream
 *    (hashing.py), continued incrementally from the parent state.
 *
 * Process-lifetime memos (path edges, scalar records) mirror the
 * Python module-level memos; the row vocabulary is per call (per
 * tile), as in _finish_vocab.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* ---------------- FNV-1a 64 (hashing.py) ---------------- */

#define FNV_OFFSET 0xCBF29CE484222325ULL
#define FNV_PRIME 0x100000001B3ULL
#define PATH_SEP 0x1f /* "\x1f" */

static uint64_t fnv1a(const unsigned char *d, Py_ssize_t n, uint64_t h) {
    for (Py_ssize_t i = 0; i < n; i++) h = (h ^ d[i]) * FNV_PRIME;
    return h;
}

static uint64_t hash_tagged(char tag, const unsigned char *d, Py_ssize_t n) {
    uint64_t h = FNV_OFFSET;
    h = (h ^ (unsigned char)tag) * FNV_PRIME;
    return fnv1a(d, n, h);
}

/* mix for internal hash tables (not semantic hashes) */
static uint64_t mix64(uint64_t x) {
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33; return x;
}

/* ---------------- scalar records ---------------- */

typedef struct {
    uint32_t repr_hi, repr_lo, sprint_hi, sprint_lo;
    uint32_t num_hi, num_lo, qty_hi, qty_lo, dur_hi, dur_lo;
    float num_val, qty_val, dur_val;
    uint8_t type_tag, bool_val;
    uint8_t has_repr, has_qty, has_dur, has_num;
    uint8_t str_goint, str_gofloat, has_glob;
    PyObject *rep; /* owned; repr string or NULL */
} ScalarRec;

/* Memo entries are INDIVIDUALLY heap-allocated and never move: walk()
 * and the per-call row vocabulary hold PathEntry / ScalarRec pointers
 * across table growth, so the hash tables store stable pointers
 * (growing reallocates only the pointer array). Both memos mirror the
 * Python module-level memos' cap-and-clear (flatten.py
 * _SCALAR_MEMO_CAP, _PathMemo.CAP): when a memo exceeds MEMO_CAP it is
 * cleared wholesale at the START of the next encode_vocab call — no
 * in-flight pointers exist then, and long-lived servers stop pinning
 * unbounded memory. */

#define MEMO_CAP (1u << 20)

typedef struct {
    PyObject *key;   /* owned value object */
    PyTypeObject *tp;
    uint64_t hash;
    ScalarRec rec;
} ScalarEntry;

static ScalarEntry **scalar_tab = NULL; /* open-addressed; NULL = empty */
static size_t scalar_cap = 0, scalar_len = 0;

/* ---------------- path memo ---------------- */

typedef struct {
    uint64_t parent_state;
    char *seg; Py_ssize_t seg_len; /* owned copy */
    uint64_t state;      /* norm hash of the child path */
    uint64_t key_hash;   /* hash_str(seg, tag="k") */
    uint8_t key_glob;
} PathEntry;

static PathEntry **path_tab = NULL; /* open-addressed; NULL = empty */
static size_t path_cap = 0, path_len = 0;

static uint64_t ROOT_STATE; /* fnv1a64(b"p") */

/* ---------------- growable tables ---------------- */

static uint64_t path_hash(uint64_t parent_state, const char *seg, Py_ssize_t n) {
    return mix64(parent_state ^ fnv1a((const unsigned char *)seg, n, FNV_OFFSET));
}

static int path_grow(void) {
    size_t ncap = path_cap ? path_cap * 2 : 4096;
    PathEntry **nt = calloc(ncap, sizeof(PathEntry *));
    if (!nt) return -1;
    for (size_t i = 0; i < path_cap; i++) {
        PathEntry *e = path_tab[i];
        if (!e) continue;
        size_t j = path_hash(e->parent_state, e->seg, e->seg_len) & (ncap - 1);
        while (nt[j]) j = (j + 1) & (ncap - 1);
        nt[j] = e;
    }
    free(path_tab); path_tab = nt; path_cap = ncap;
    return 0;
}

static void path_clear(void) {
    for (size_t i = 0; i < path_cap; i++) {
        if (path_tab[i]) { free(path_tab[i]->seg); free(path_tab[i]); path_tab[i] = NULL; }
    }
    path_len = 0;
}

static PathEntry *path_child(uint64_t parent_state, const char *seg, Py_ssize_t n) {
    if (!path_cap || path_len * 4 >= path_cap * 3) {
        if (path_grow() < 0) return NULL;
    }
    uint64_t h = path_hash(parent_state, seg, n);
    size_t j = h & (path_cap - 1);
    while (path_tab[j]) {
        PathEntry *e = path_tab[j];
        if (e->parent_state == parent_state && e->seg_len == n &&
            memcmp(e->seg, seg, (size_t)n) == 0)
            return e;
        j = (j + 1) & (path_cap - 1);
    }
    PathEntry *e = malloc(sizeof(PathEntry));
    if (!e) return NULL;
    e->seg = malloc((size_t)n + 1);
    if (!e->seg) { free(e); return NULL; }
    memcpy(e->seg, seg, (size_t)n); e->seg[n] = 0;
    e->seg_len = n;
    e->parent_state = parent_state;
    /* continue the FNV stream: SEP + seg, except for root children */
    uint64_t st = parent_state;
    if (parent_state != ROOT_STATE) {
        unsigned char sep = PATH_SEP;
        st = fnv1a(&sep, 1, st);
    }
    st = fnv1a((const unsigned char *)seg, n, st);
    e->state = st;
    e->key_hash = hash_tagged('k', (const unsigned char *)seg, n);
    e->key_glob = 0;
    if (!(n == 2 && seg[0] == '[' && seg[1] == ']')) {
        for (Py_ssize_t i = 0; i < n; i++)
            if (seg[i] == '*' || seg[i] == '?') { e->key_glob = 1; break; }
    }
    path_tab[j] = e;
    path_len++;
    return e;
}

/* ---------------- scalar memo ---------------- */

static int scalar_grow(void) {
    size_t ncap = scalar_cap ? scalar_cap * 2 : 4096;
    ScalarEntry **nt = calloc(ncap, sizeof(ScalarEntry *));
    if (!nt) return -1;
    for (size_t i = 0; i < scalar_cap; i++) {
        ScalarEntry *e = scalar_tab[i];
        if (!e) continue;
        size_t j = e->hash & (ncap - 1);
        while (nt[j]) j = (j + 1) & (ncap - 1);
        nt[j] = e;
    }
    free(scalar_tab); scalar_tab = nt; scalar_cap = ncap;
    return 0;
}

static void scalar_clear(void) {
    for (size_t i = 0; i < scalar_cap; i++) {
        ScalarEntry *e = scalar_tab[i];
        if (e) {
            Py_DECREF(e->key);
            Py_XDECREF(e->rec.rep);
            free(e);
            scalar_tab[i] = NULL;
        }
    }
    scalar_len = 0;
}

/* parse the 24-tuple _scalar_rec returns into a ScalarRec.
 * Order: type_tag, bool_val, arr_len, has_repr, repr_hi, repr_lo,
 * sprint_hi, sprint_lo, has_num, num_hi, num_lo, num_val, has_qty,
 * qty_hi, qty_lo, qty_val, has_dur, dur_hi, dur_lo, dur_val,
 * str_goint, str_gofloat, has_glob, rep */
static int parse_rec(PyObject *t, ScalarRec *r) {
    if (!PyTuple_Check(t) || PyTuple_GET_SIZE(t) != 24) {
        PyErr_SetString(PyExc_TypeError, "scalar_cb must return a 24-tuple");
        return -1;
    }
#define U32(i) ((uint32_t)PyLong_AsUnsignedLongLong(PyTuple_GET_ITEM(t, (i))))
#define U8(i) ((uint8_t)PyLong_AsLong(PyTuple_GET_ITEM(t, (i))))
#define F32(i) ((float)PyFloat_AsDouble(PyTuple_GET_ITEM(t, (i))))
    r->type_tag = U8(0); r->bool_val = U8(1);
    r->has_repr = U8(3); r->repr_hi = U32(4); r->repr_lo = U32(5);
    r->sprint_hi = U32(6); r->sprint_lo = U32(7);
    r->has_num = U8(8); r->num_hi = U32(9); r->num_lo = U32(10); r->num_val = F32(11);
    r->has_qty = U8(12); r->qty_hi = U32(13); r->qty_lo = U32(14); r->qty_val = F32(15);
    r->has_dur = U8(16); r->dur_hi = U32(17); r->dur_lo = U32(18); r->dur_val = F32(19);
    r->str_goint = U8(20); r->str_gofloat = U8(21); r->has_glob = U8(22);
#undef U32
#undef U8
#undef F32
    PyObject *rep = PyTuple_GET_ITEM(t, 23);
    if (rep == Py_None) r->rep = NULL;
    else { Py_INCREF(rep); r->rep = rep; }
    if (PyErr_Occurred()) return -1;
    return 0;
}

static uint64_t scalar_hash(PyObject *v, int *hashable) {
    *hashable = 1;
    if (v == Py_None) return 0x9e3779b97f4a7c15ULL;
    if (PyBool_Check(v)) return v == Py_True ? 0xa5a5a5a5a5a5a5a5ULL : 0x5a5a5a5a5a5a5a5aULL;
    if (PyFloat_CheckExact(v)) {
        double d = PyFloat_AS_DOUBLE(v);
        uint64_t bits; memcpy(&bits, &d, 8);
        return mix64(bits ^ 0xf10a7);
    }
    Py_hash_t h = PyObject_Hash(v);
    if (h == -1) { PyErr_Clear(); *hashable = 0; return 0; }
    return mix64((uint64_t)h ^ ((uintptr_t)Py_TYPE(v) >> 4));
}

/* returns the memoized record for a scalar value, calling cb on miss.
 * On unhashable values, fills *tmp and returns tmp (not memoized). */
static ScalarRec *scalar_lookup(PyObject *v, PyObject *cb, ScalarRec *tmp) {
    int hashable;
    uint64_t h = scalar_hash(v, &hashable);
    size_t j = 0;
    if (hashable && scalar_cap) {
        j = h & (scalar_cap - 1);
        while (scalar_tab[j]) {
            ScalarEntry *e = scalar_tab[j];
            if (e->hash == h && e->tp == Py_TYPE(v)) {
                if (e->key == v) return &e->rec;
                if (PyFloat_CheckExact(v)) {
                    double a = PyFloat_AS_DOUBLE(v), b = PyFloat_AS_DOUBLE(e->key);
                    uint64_t ba, bb; memcpy(&ba, &a, 8); memcpy(&bb, &b, 8);
                    if (ba == bb) return &e->rec;
                } else {
                    int eq = PyObject_RichCompareBool(v, e->key, Py_EQ);
                    if (eq < 0) { PyErr_Clear(); }
                    else if (eq) return &e->rec;
                }
            }
            j = (j + 1) & (scalar_cap - 1);
        }
    }
    PyObject *t = PyObject_CallFunctionObjArgs(cb, v, NULL);
    if (!t) return NULL;
    ScalarRec rec;
    if (parse_rec(t, &rec) < 0) { Py_DECREF(t); return NULL; }
    Py_DECREF(t);
    if (!hashable) { *tmp = rec; return tmp; }
    if (!scalar_cap || scalar_len * 4 >= scalar_cap * 3) {
        if (scalar_grow() < 0) return NULL;
        j = h & (scalar_cap - 1);
        while (scalar_tab[j]) j = (j + 1) & (scalar_cap - 1);
    }
    ScalarEntry *e = malloc(sizeof(ScalarEntry));
    if (!e) { Py_XDECREF(rec.rep); PyErr_NoMemory(); return NULL; }
    Py_INCREF(v);
    e->key = v; e->tp = Py_TYPE(v); e->hash = h; e->rec = rec;
    scalar_tab[j] = e;
    scalar_len++;
    return &e->rec;
}

/* ---------------- per-call encode state ---------------- */

#define T_NULL 0
#define T_BOOL 1
#define T_NUM 2
#define T_STR 3
#define T_MAP 4
#define T_ARR 5

typedef struct {
    uint64_t norm, parent, keyh;
    float arr_len;
    int32_t scope1, scope2, byte_slot, key_byte_slot;
    uint8_t key_glob, s2_overflow, type_tag;
    ScalarRec *sc;   /* NULL for containers; identity = dedup key part */
    ScalarRec inl;   /* storage for unhashable scalars */
    uint8_t sc_inline; /* sc points at inl (compare by value not ptr) */
} TmpRow;

typedef struct {
    int64_t *vals; /* vocab row ids; mirrors vocab_rows list, id = idx+1 */
    uint64_t *hashes;
    size_t *idx_tab; size_t tab_cap;
    TmpRow *rows; size_t len, cap;
} Vocab;

typedef struct {
    PyObject *cb;
    const uint64_t *byte_paths; Py_ssize_t n_byte_paths;
    const uint64_t *key_byte_paths; Py_ssize_t n_key_byte_paths;
    int max_rows, max_instances, pool_slots, pool_width;
    /* per-resource */
    TmpRow *tmp; int row; int pool_used; int ok;
    int32_t *pool_sidx_row;
    /* pool string table (per call) */
    PyObject *pool_strs;       /* list[bytes]; id 0 = b"" */
    PyObject *pool_sid_map;    /* dict bytes -> int id */
    Vocab voc;
    int err;
} Enc;

static int binsearch(const uint64_t *a, Py_ssize_t n, uint64_t x) {
    Py_ssize_t lo = 0, hi = n;
    while (lo < hi) {
        Py_ssize_t mid = (lo + hi) / 2;
        if (a[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo < n && a[lo] == x;
}

/* assign a pool slot for utf8 bytes; returns slot or -1 (overflow ->
 * e->ok = 0, matching _FastEncoder._assign_pool) */
static int assign_pool(Enc *e, const char *data, Py_ssize_t n) {
    if (n > e->pool_width || e->pool_used >= e->pool_slots) { e->ok = 0; return -1; }
    int slot = e->pool_used++;
    PyObject *b = PyBytes_FromStringAndSize(data, n);
    if (!b) { e->err = 1; return -1; }
    PyObject *sid = PyDict_GetItem(e->pool_sid_map, b); /* borrowed */
    long id;
    if (sid) { id = PyLong_AsLong(sid); Py_DECREF(b); }
    else {
        id = (long)PyList_GET_SIZE(e->pool_strs);
        PyObject *idob = PyLong_FromLong(id);
        if (!idob || PyList_Append(e->pool_strs, b) < 0 ||
            PyDict_SetItem(e->pool_sid_map, b, idob) < 0) {
            Py_XDECREF(idob); Py_DECREF(b); e->err = 1; return -1;
        }
        Py_DECREF(idob); Py_DECREF(b);
    }
    e->pool_sidx_row[slot] = (int32_t)id;
    return slot;
}

/* walk: returns tmp-row index, or -1 when the row cap is hit */
static int walk(Enc *e, PyObject *node, PathEntry *pe, uint64_t state,
                uint64_t norm, uint64_t parent, uint64_t keyh, uint8_t kglob,
                int scope1, int scope2, int depth) {
    if (e->err) return -1;
    if (e->row >= e->max_rows) { e->ok = 0; return -1; }
    int r = e->row++;
    TmpRow *t = &e->tmp[r];
    memset(t, 0, sizeof(TmpRow));
    t->norm = norm; t->parent = parent; t->keyh = keyh; t->key_glob = kglob;
    t->scope1 = scope1; t->scope2 = scope2;
    t->byte_slot = -1; t->key_byte_slot = -1;

    if (PyDict_Check(node)) {
        t->type_tag = T_MAP;
        t->arr_len = (float)PyDict_GET_SIZE(node);
        int pool_keys = binsearch(e->key_byte_paths, e->n_key_byte_paths, norm);
        PyObject *k, *v; Py_ssize_t pos = 0;
        while (PyDict_Next(node, &pos, &k, &v)) {
            PyObject *ks = k;
            int dec = 0;
            if (!PyUnicode_CheckExact(k)) {
                ks = PyObject_Str(k);
                if (!ks) { e->err = 1; return r; }
                dec = 1;
            }
            Py_ssize_t sl; const char *sd = PyUnicode_AsUTF8AndSize(ks, &sl);
            if (!sd) { if (dec) Py_DECREF(ks); e->err = 1; return r; }
            PathEntry *ce = path_child(state, sd, sl);
            if (!ce) { if (dec) Py_DECREF(ks); e->err = 1; return r; }
            int cr = walk(e, v, ce, ce->state, ce->state, norm, ce->key_hash,
                          ce->key_glob, scope1, scope2, depth);
            if (e->err) { if (dec) Py_DECREF(ks); return r; }
            if (pool_keys && cr >= 0) {
                int slot = assign_pool(e, sd, sl);
                if (e->err) { if (dec) Py_DECREF(ks); return r; }
                if (slot >= 0) e->tmp[cr].key_byte_slot = slot;
                if (PyUnicode_Check(v) && e->tmp[cr].byte_slot < 0) {
                    Py_ssize_t vl; const char *vd = PyUnicode_AsUTF8AndSize(v, &vl);
                    if (!vd) { if (dec) Py_DECREF(ks); e->err = 1; return r; }
                    int vslot = assign_pool(e, vd, vl);
                    if (e->err) { if (dec) Py_DECREF(ks); return r; }
                    if (vslot >= 0) e->tmp[cr].byte_slot = vslot;
                }
            }
            if (dec) Py_DECREF(ks);
        }
    } else if (PyList_Check(node)) {
        Py_ssize_t n = PyList_GET_SIZE(node);
        t->type_tag = T_ARR;
        t->arr_len = (float)n;
        if (n > e->max_instances) {
            if (depth == 0) e->ok = 0;
            else if (depth == 1) t->s2_overflow = 1;
        }
        PathEntry *ce = path_child(state, "[]", 2);
        if (!ce) { e->err = 1; return r; }
        for (Py_ssize_t i = 0; i < n; i++) {
            int s1 = scope1, s2 = scope2;
            if (depth == 0) s1 = (int)i;
            else if (depth == 1) s2 = (int)i;
            walk(e, PyList_GET_ITEM(node, i), ce, ce->state, ce->state, norm,
                 ce->key_hash, ce->key_glob, s1, s2, depth + 1);
            if (e->err) return r;
        }
    } else {
        ScalarRec *sc = scalar_lookup(node, e->cb, &t->inl);
        if (!sc) { e->err = 1; return r; }
        t->sc = sc;
        t->sc_inline = (sc == &t->inl);
        t->type_tag = sc->type_tag;
        if (sc->has_repr && binsearch(e->byte_paths, e->n_byte_paths, norm)) {
            Py_ssize_t rl; const char *rd = PyUnicode_AsUTF8AndSize(sc->rep, &rl);
            if (!rd) { e->err = 1; return r; }
            int slot = assign_pool(e, rd, rl);
            if (slot >= 0) t->byte_slot = slot;
        }
    }
    return r;
}

/* ---------------- row vocabulary ---------------- */

static uint64_t row_hash(const TmpRow *t) {
    uint64_t h = t->norm;
    h = mix64(h ^ ((uint64_t)(uint32_t)t->scope1 | ((uint64_t)(uint32_t)t->scope2 << 32)));
    h = mix64(h ^ ((uint64_t)(uint32_t)t->byte_slot | ((uint64_t)(uint32_t)t->key_byte_slot << 32)));
    h ^= (uint64_t)t->s2_overflow << 7;
    if (t->sc) h = mix64(h ^ (t->sc_inline ? 0x51ed2705 : (uint64_t)(uintptr_t)t->sc));
    else {
        uint32_t al; memcpy(&al, &t->arr_len, 4);
        h = mix64(h ^ ((uint64_t)t->type_tag << 32) ^ al);
    }
    return h;
}

static int row_eq(const TmpRow *a, const TmpRow *b) {
    if (a->norm != b->norm || a->scope1 != b->scope1 || a->scope2 != b->scope2 ||
        a->s2_overflow != b->s2_overflow || a->byte_slot != b->byte_slot ||
        a->key_byte_slot != b->key_byte_slot || a->type_tag != b->type_tag)
        return 0;
    if (a->sc && b->sc) {
        if (a->sc_inline || b->sc_inline) return 0; /* unhashable: never dedup */
        return a->sc == b->sc;
    }
    if (a->sc || b->sc) return 0;
    return a->arr_len == b->arr_len;
}

static int voc_grow(Vocab *v) {
    size_t ncap = v->tab_cap ? v->tab_cap * 2 : 8192;
    size_t *nt = malloc(ncap * sizeof(size_t));
    if (!nt) return -1;
    memset(nt, 0xff, ncap * sizeof(size_t));
    for (size_t i = 0; i < v->tab_cap; i++) {
        size_t ri = v->idx_tab ? v->idx_tab[i] : (size_t)-1;
        if (ri == (size_t)-1) continue;
        size_t j = v->hashes[ri] & (ncap - 1);
        while (nt[j] != (size_t)-1) j = (j + 1) & (ncap - 1);
        nt[j] = ri;
    }
    free(v->idx_tab); v->idx_tab = nt; v->tab_cap = ncap;
    return 0;
}

static int64_t voc_intern(Vocab *v, const TmpRow *t) {
    if (!v->tab_cap || v->len * 4 >= v->tab_cap * 3) {
        if (voc_grow(v) < 0) return -1;
    }
    uint64_t h = row_hash(t);
    size_t j = h & (v->tab_cap - 1);
    int dedupable = !(t->sc && t->sc_inline);
    while (v->idx_tab[j] != (size_t)-1) {
        size_t ri = v->idx_tab[j];
        if (dedupable && v->hashes[ri] == h && row_eq(&v->rows[ri], t))
            return (int64_t)ri + 1;
        j = (j + 1) & (v->tab_cap - 1);
    }
    if (v->len >= v->cap) {
        size_t ncap = v->cap ? v->cap * 2 : 4096;
        TmpRow *nr = realloc(v->rows, ncap * sizeof(TmpRow));
        if (!nr) return -1;
        v->rows = nr;
        uint64_t *nh = realloc(v->hashes, ncap * sizeof(uint64_t));
        if (!nh) return -1;
        v->hashes = nh; v->cap = ncap;
    }
    size_t ri = v->len++;
    v->rows[ri] = *t;
    /* unhashable scalars carry an inline rec in the (reused) TmpRow;
     * the vocab copy needs its own heap-stable rec — v->rows itself
     * moves on realloc, so pointing into the array would dangle.
     * Ownership of rec.rep moves to the heap copy; freed (with a
     * rep decref) at encode teardown via the sc_inline marker. */
    if (t->sc && t->sc_inline) {
        ScalarRec *cp = malloc(sizeof(ScalarRec));
        if (!cp) { v->len--; return -1; }
        *cp = *t->sc;
        v->rows[ri].sc = cp;
    }
    v->hashes[ri] = h;
    v->idx_tab[j] = ri;
    return (int64_t)ri + 1;
}

/* build the 35-tuple for one vocab row (order documented in flatten.py
 * encode_resources_vocab native glue) */
static PyObject *row_tuple(const TmpRow *t) {
    ScalarRec z; memset(&z, 0, sizeof z);
    const ScalarRec *s = t->sc ? t->sc : &z;
    return Py_BuildValue(
        "(IIIIIIIIIIIIIIIIffffiiiibbbbbbbbbbb)",
        (unsigned)(t->norm >> 32), (unsigned)(t->norm & 0xffffffffu),
        (unsigned)(t->parent >> 32), (unsigned)(t->parent & 0xffffffffu),
        (unsigned)(t->keyh >> 32), (unsigned)(t->keyh & 0xffffffffu),
        (unsigned)s->repr_hi, (unsigned)s->repr_lo,
        (unsigned)s->qty_hi, (unsigned)s->qty_lo,
        (unsigned)s->dur_hi, (unsigned)s->dur_lo,
        (unsigned)s->num_hi, (unsigned)s->num_lo,
        (unsigned)s->sprint_hi, (unsigned)s->sprint_lo,
        (double)s->num_val, (double)s->qty_val, (double)s->dur_val,
        (double)t->arr_len,
        (int)t->scope1, (int)t->scope2, (int)t->byte_slot, (int)t->key_byte_slot,
        (int)t->type_tag, (int)s->bool_val, (int)s->has_repr, (int)s->has_qty,
        (int)s->has_dur, (int)s->has_num, (int)s->str_goint, (int)s->str_gofloat,
        (int)s->has_glob, (int)t->key_glob, (int)t->s2_overflow);
}

/* ---------------- entry point ---------------- */

static PyObject *encode_vocab(PyObject *self, PyObject *args) {
    PyObject *resources, *cb;
    int max_rows, max_instances, pool_slots, pool_width;
    Py_buffer bp_buf, kbp_buf, row_idx_buf, n_rows_buf, fb_buf, psx_buf;
    if (!PyArg_ParseTuple(args, "Oiiiiy*y*Ow*w*w*w*",
                          &resources, &max_rows, &max_instances, &pool_slots,
                          &pool_width, &bp_buf, &kbp_buf, &cb,
                          &row_idx_buf, &n_rows_buf, &fb_buf, &psx_buf))
        return NULL;
    /* cap-and-clear between calls (Python memo CAP semantics): no
     * in-flight pointers into the memos exist at call boundaries */
    if (scalar_len >= MEMO_CAP) scalar_clear();
    if (path_len >= MEMO_CAP) path_clear();
    PyObject *result = NULL;
    Enc e; memset(&e, 0, sizeof e);
    e.cb = cb;
    e.byte_paths = (const uint64_t *)bp_buf.buf;
    e.n_byte_paths = bp_buf.len / 8;
    e.key_byte_paths = (const uint64_t *)kbp_buf.buf;
    e.n_key_byte_paths = kbp_buf.len / 8;
    e.max_rows = max_rows; e.max_instances = max_instances;
    e.pool_slots = pool_slots; e.pool_width = pool_width;
    e.tmp = malloc((size_t)max_rows * sizeof(TmpRow));
    e.pool_strs = PyList_New(0);
    e.pool_sid_map = PyDict_New();
    PyObject *empty = PyBytes_FromStringAndSize("", 0);
    if (!e.tmp || !e.pool_strs || !e.pool_sid_map || !empty) goto done;
    {
        PyObject *zero = PyLong_FromLong(0);
        if (!zero || PyList_Append(e.pool_strs, empty) < 0 ||
            PyDict_SetItem(e.pool_sid_map, empty, zero) < 0) { Py_XDECREF(zero); goto done; }
        Py_DECREF(zero);
    }

    if (!PyList_Check(resources)) {
        PyErr_SetString(PyExc_TypeError, "resources must be a list");
        goto done;
    }
    Py_ssize_t n = PyList_GET_SIZE(resources);
    int32_t *row_idx = (int32_t *)row_idx_buf.buf;      /* (n, max_rows) */
    int32_t *n_rows = (int32_t *)n_rows_buf.buf;        /* (n,) */
    uint8_t *fallback = (uint8_t *)fb_buf.buf;          /* (n,) */
    int32_t *pool_sidx = (int32_t *)psx_buf.buf;        /* (n, pool_slots) */

    for (Py_ssize_t i = 0; i < n; i++) {
        e.row = 0; e.pool_used = 0; e.ok = 1;
        e.pool_sidx_row = pool_sidx + i * pool_slots;
        PyObject *res = PyList_GET_ITEM(resources, i);
        walk(&e, res, NULL, ROOT_STATE, ROOT_STATE, 0, 0, 0, -1, -1, 0);
        if (e.err || PyErr_Occurred()) goto done;
        n_rows[i] = e.row;
        fallback[i] = e.ok ? 0 : 1;
        int32_t *out = row_idx + i * max_rows;
        for (int r = 0; r < e.row; r++) {
            int64_t id = voc_intern(&e.voc, &e.tmp[r]);
            if (id < 0) { PyErr_NoMemory(); goto done; }
            out[r] = (int32_t)id;
        }
    }

    {
        PyObject *vrows = PyList_New((Py_ssize_t)e.voc.len);
        if (!vrows) goto done;
        for (size_t ri = 0; ri < e.voc.len; ri++) {
            PyObject *t = row_tuple(&e.voc.rows[ri]);
            if (!t) { Py_DECREF(vrows); goto done; }
            PyList_SET_ITEM(vrows, (Py_ssize_t)ri, t);
        }
        result = PyTuple_Pack(2, vrows, e.pool_strs);
        Py_DECREF(vrows);
    }

done:
    Py_XDECREF(empty);
    Py_XDECREF(e.pool_strs);
    Py_XDECREF(e.pool_sid_map);
    free(e.tmp);
    for (size_t ri = 0; ri < e.voc.len; ri++) {
        TmpRow *t = &e.voc.rows[ri];
        if (t->sc_inline && t->sc) { Py_XDECREF(t->sc->rep); free(t->sc); }
    }
    free(e.voc.rows); free(e.voc.hashes); free(e.voc.idx_tab);
    PyBuffer_Release(&bp_buf); PyBuffer_Release(&kbp_buf);
    PyBuffer_Release(&row_idx_buf); PyBuffer_Release(&n_rows_buf);
    PyBuffer_Release(&fb_buf); PyBuffer_Release(&psx_buf);
    if (!result && !PyErr_Occurred())
        PyErr_SetString(PyExc_RuntimeError, "fastencode internal error");
    return result;
}

static PyObject *memo_sizes(PyObject *self, PyObject *args) {
    return Py_BuildValue("(nn)", (Py_ssize_t)path_len, (Py_ssize_t)scalar_len);
}

static PyMethodDef methods[] = {
    {"encode_vocab", encode_vocab, METH_VARARGS,
     "encode_vocab(resources, max_rows, max_instances, pool_slots, pool_width, "
     "byte_paths_u64, key_byte_paths_u64, scalar_cb, row_idx, n_rows, fallback, "
     "pool_sidx) -> (vocab_rows, pool_strs)"},
    {"memo_sizes", memo_sizes, METH_NOARGS, "(path_memo_len, scalar_memo_len)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastencode", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit__fastencode(void) {
    unsigned char p = 'p';
    ROOT_STATE = fnv1a(&p, 1, FNV_OFFSET);
    return PyModule_Create(&moduledef);
}
