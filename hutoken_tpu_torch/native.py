"""ctypes binding to the native C++ host runtime (native/libhutoken_host.so).

The port's own copy of ``hutoken_tpu/native.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.

The native engine provides the host-side hot paths: parser splitting,
dedup+packing for the device, exact scalar BPE (fallback + low-latency
single-document encode), and batched decode — the capabilities the
reference implements in C (src/core.c, src/parser.c, src/taskqueue.c),
re-architected in C++17.

The library is optional: when the .so is missing (or ``HUTOKEN_TPU_NO_
NATIVE=1``), pure-Python equivalents are used.  Build with
``make -C native``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_probed = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _so_path() -> str:
    """Installed-package location first (built by setup.py into
    hutoken_tpu_torch/_native/), then the checkout's native/ directory,
    which the C++ library shares with the JAX package."""
    pkg_so = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "_native",
        "libhutoken_host.so",
    )
    if os.path.exists(pkg_so):
        return pkg_so
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "native",
        "libhutoken_host.so",
    )


def load_native() -> Optional[ctypes.CDLL]:
    global _lib, _probed
    if _probed:
        return _lib
    _probed = True
    if os.environ.get("HUTOKEN_TPU_NO_NATIVE") == "1":
        return None
    path = _so_path()
    if not os.path.exists(path):
        # try to build it (toolchain is available in dev environments)
        try:
            import subprocess

            subprocess.run(
                ["make", "-C", os.path.dirname(path)],
                capture_output=True,
                timeout=120,
                check=True,
            )
        except Exception:
            return None
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None

    lib.ht_create.restype = ctypes.c_void_p
    lib.ht_destroy.argtypes = [ctypes.c_void_p]
    lib.ht_set_vocab.argtypes = [
        ctypes.c_void_p, _u8p, _i64p, _i32p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.ht_set_merges.argtypes = [
        ctypes.c_void_p, _i32p, _i32p, _i32p, _i32p, ctypes.c_int64,
    ]
    lib.ht_set_special.argtypes = [
        ctypes.c_void_p, _u8p, _i64p, _i32p, ctypes.c_int64,
    ]
    lib.ht_set_options.argtypes = [
        ctypes.c_void_p, ctypes.c_int, _u8p, ctypes.c_int64,
    ]
    lib.ht_encode_batch.restype = ctypes.c_int64
    lib.ht_encode_batch.argtypes = [
        ctypes.c_void_p, _u8p, _i64p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(_i32p), ctypes.POINTER(_i64p),
    ]
    lib.ht_encode_words.restype = ctypes.c_int64
    lib.ht_encode_words.argtypes = [
        ctypes.c_void_p, _u8p, _i64p, _i32p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(_i32p), ctypes.POINTER(_i64p),
    ]
    lib.ht_decode_batch.restype = ctypes.c_int
    lib.ht_decode_batch.argtypes = [
        ctypes.c_void_p, _i32p, _i64p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(_u8p), ctypes.POINTER(_i64p),
    ]
    lib.ht_split_dedup_slices.restype = ctypes.c_int64
    lib.ht_split_dedup_slices.argtypes = [
        _u8p, _i64p, ctypes.c_int64,
        ctypes.POINTER(_i32p), ctypes.POINTER(_i64p),
        ctypes.POINTER(_i64p), ctypes.POINTER(_i32p),
    ]
    lib.ht_interner_create.restype = ctypes.c_void_p
    lib.ht_interner_destroy.argtypes = [ctypes.c_void_p]
    lib.ht_interner_count.restype = ctypes.c_int64
    lib.ht_interner_count.argtypes = [ctypes.c_void_p]
    lib.ht_interner_reset.argtypes = [ctypes.c_void_p]
    lib.ht_split_intern.restype = ctypes.c_int64
    lib.ht_split_intern.argtypes = [
        ctypes.c_void_p, _u8p, _i64p, ctypes.c_int64,
        ctypes.POINTER(_i32p), ctypes.POINTER(_i64p),
        ctypes.POINTER(_i64p), ctypes.POINTER(_i32p),
    ]
    lib.ht_split_intern_docs.restype = ctypes.c_int64
    lib.ht_split_intern_docs.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), _i64p,
        ctypes.c_int64,
        ctypes.POINTER(_i32p), ctypes.POINTER(_i64p),
        ctypes.POINTER(_u8p), ctypes.POINTER(_i32p),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ht_assemble.restype = ctypes.c_int64
    lib.ht_assemble.argtypes = [
        _i32p, ctypes.c_int64, _i64p, ctypes.c_int64,
        _i64p, _i64p, _i32p,
        ctypes.POINTER(_i32p), ctypes.POINTER(_i64p),
    ]
    lib.ht_assemble_counts.restype = ctypes.c_int64
    lib.ht_assemble_counts.argtypes = [
        _i32p, _i64p, ctypes.c_int64, _i64p, _i64p,
    ]
    lib.ht_assemble_fill.argtypes = [
        _i32p, _i64p, ctypes.c_int64, _i64p, _i32p, _i64p, _i32p,
    ]
    lib.ht_pack_rows.argtypes = [
        _u8p, _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, _u8p,
    ]
    lib.ht_free_i32.argtypes = [_i32p]
    lib.ht_free_i64.argtypes = [_i64p]
    lib.ht_free_u8.argtypes = [_u8p]
    _lib = lib
    return _lib


def split_dedup_slices(blob: np.ndarray, doc_offsets: np.ndarray):
    """Native parser split + word dedup over a document blob.

    Returns (word_refs int32 [total_words], doc_word_offsets int64
    [n_docs+1], uniq_offsets int64 [n_uniq], uniq_lens int32 [n_uniq]) or
    None when the native library is unavailable.
    """
    lib = load_native()
    if lib is None:
        return None
    n_docs = len(doc_offsets) - 1
    wr = _i32p()
    dwo = _i64p()
    uo = _i64p()
    ul = _i32p()
    n_uniq = lib.ht_split_dedup_slices(
        _np_u8p(blob), _np_i64p(doc_offsets), n_docs,
        ctypes.byref(wr), ctypes.byref(dwo), ctypes.byref(uo), ctypes.byref(ul),
    )
    dwo_np = np.ctypeslib.as_array(dwo, shape=(n_docs + 1,)).copy()
    total_words = int(dwo_np[-1])
    wr_np = np.ctypeslib.as_array(wr, shape=(max(total_words, 1),))[:total_words].copy()
    uo_np = np.ctypeslib.as_array(uo, shape=(max(n_uniq, 1),))[:n_uniq].copy()
    ul_np = np.ctypeslib.as_array(ul, shape=(max(n_uniq, 1),))[:n_uniq].copy()
    lib.ht_free_i32(wr)
    lib.ht_free_i64(dwo)
    lib.ht_free_i64(uo)
    lib.ht_free_i32(ul)
    return wr_np, dwo_np, uo_np, ul_np


class WordInterner:
    """Persistent word -> dense-gid map (native).  Gids are stable across
    calls, so a batch engine resolves each distinct word once per
    process instead of once per batch."""

    def __init__(self) -> None:
        lib = load_native()
        if lib is None:
            raise RuntimeError("native host library unavailable")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.ht_interner_create())

    def __del__(self):  # pragma: no cover
        try:
            if getattr(self, "_h", None):
                self._lib.ht_interner_destroy(self._h)
        except Exception:
            pass

    def count(self) -> int:
        return int(self._lib.ht_interner_count(self._h))

    def reset(self) -> None:
        self._lib.ht_interner_reset(self._h)

    def split_intern(self, blob: np.ndarray, doc_offsets: np.ndarray):
        """Split + intern a document blob.

        Returns (word_gids int32, doc_word_offsets int64, new_offsets
        int64, new_lens int32, prev_count): words first seen in this call
        are gids [prev_count, prev_count + len(new_lens)), with first
        occurrences at blob[new_offsets[i] : +new_lens[i]].
        """
        lib = self._lib
        n_docs = len(doc_offsets) - 1
        wg = _i32p()
        dwo = _i64p()
        no = _i64p()
        nl = _i32p()
        prev = lib.ht_split_intern(
            self._h, _np_u8p(blob), _np_i64p(doc_offsets), n_docs,
            ctypes.byref(wg), ctypes.byref(dwo),
            ctypes.byref(no), ctypes.byref(nl),
        )
        n_new = self.count() - prev
        dwo_np = np.ctypeslib.as_array(dwo, shape=(n_docs + 1,)).copy()
        total_words = int(dwo_np[-1])
        wg_np = np.ctypeslib.as_array(wg, shape=(max(total_words, 1),))[
            :total_words
        ].copy()
        no_np = np.ctypeslib.as_array(no, shape=(max(n_new, 1),))[:n_new].copy()
        nl_np = np.ctypeslib.as_array(nl, shape=(max(n_new, 1),))[:n_new].copy()
        lib.ht_free_i32(wg)
        lib.ht_free_i64(dwo)
        lib.ht_free_i64(no)
        lib.ht_free_i32(nl)
        return wg_np, dwo_np, no_np, nl_np, int(prev)

    def split_intern_docs(self, docs: list):
        """Split + intern per-document byte buffers (no concatenated
        blob).  Returns (word_gids int32, doc_word_offsets int64,
        new_blob uint8 np array, new_lens int32, prev_count): first-seen
        words are gids [prev, prev+len(new_lens)), their bytes packed
        back-to-back in new_blob.

        The caller must keep ``docs`` (bytes objects) alive for the
        duration of the call (ctypes passes their internal pointers).
        """
        lib = self._lib
        n_docs = len(docs)
        ptrs = (ctypes.c_char_p * max(n_docs, 1))(*docs)
        lens = np.fromiter(
            map(len, docs), dtype=np.int64, count=n_docs
        ) if n_docs else np.zeros(1, dtype=np.int64)
        wg = _i32p()
        dwo = _i64p()
        nb = _u8p()
        nl = _i32p()
        n_new_c = ctypes.c_int64(0)
        prev = lib.ht_split_intern_docs(
            self._h, ptrs, _np_i64p(lens), n_docs,
            ctypes.byref(wg), ctypes.byref(dwo),
            ctypes.byref(nb), ctypes.byref(nl), ctypes.byref(n_new_c),
        )
        n_new = int(n_new_c.value)
        dwo_np = np.ctypeslib.as_array(dwo, shape=(n_docs + 1,)).copy()
        total_words = int(dwo_np[-1])
        wg_np = np.ctypeslib.as_array(wg, shape=(max(total_words, 1),))[
            :total_words
        ].copy()
        nl_np = np.ctypeslib.as_array(nl, shape=(max(n_new, 1),))[:n_new].copy()
        blob_len = int(nl_np.sum()) if n_new else 0
        nb_np = np.ctypeslib.as_array(nb, shape=(max(blob_len, 1),))[
            :blob_len
        ].copy()
        lib.ht_free_i32(wg)
        lib.ht_free_i64(dwo)
        lib.ht_free_u8(nb)
        lib.ht_free_i32(nl)
        return wg_np, dwo_np, nb_np, nl_np, int(prev)


    def split_intern_strs(self, texts: list):
        """`split_intern_docs` over ``str`` documents without per-doc
        ``bytes`` copies: document pointers come from CPython's cached
        UTF-8 representation (``PyUnicode_AsUTF8AndSize``) — for ASCII
        strings that IS the string's own storage, so prep is pointer
        collection, not an O(corpus) encode+alloc pass.  The caller
        must keep ``texts`` alive for the duration of the call.

        Cost note: for NON-ASCII strings CPython materializes and caches
        a UTF-8 copy on the string object, which persists for the
        string's lifetime (~2x resident memory for such documents).  A
        NULL return (allocation failure) surfaces via ctypes' PyDLL
        error propagation before the native call runs.
        """
        lib = self._lib
        n_docs = len(texts)
        as_utf8 = _py_as_utf8()
        ptrs = (ctypes.c_void_p * max(n_docs, 1))()
        lens = np.zeros(max(n_docs, 1), dtype=np.int64)
        sz = ctypes.c_ssize_t(0)
        szref = ctypes.byref(sz)
        for i, t in enumerate(texts):
            ptrs[i] = as_utf8(t, szref)
            lens[i] = sz.value
        wg = _i32p()
        dwo = _i64p()
        nb = _u8p()
        nl = _i32p()
        n_new_c = ctypes.c_int64(0)
        prev = lib.ht_split_intern_docs(
            self._h, ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_char_p)),
            _np_i64p(lens), n_docs,
            ctypes.byref(wg), ctypes.byref(dwo),
            ctypes.byref(nb), ctypes.byref(nl), ctypes.byref(n_new_c),
        )
        n_new = int(n_new_c.value)
        dwo_np = np.ctypeslib.as_array(dwo, shape=(n_docs + 1,)).copy()
        total_words = int(dwo_np[-1])
        wg_np = np.ctypeslib.as_array(wg, shape=(max(total_words, 1),))[
            :total_words
        ].copy()
        nl_np = np.ctypeslib.as_array(nl, shape=(max(n_new, 1),))[:n_new].copy()
        blob_len = int(nl_np.sum()) if n_new else 0
        nb_np = np.ctypeslib.as_array(nb, shape=(max(blob_len, 1),))[
            :blob_len
        ].copy()
        lib.ht_free_i32(wg)
        lib.ht_free_i64(dwo)
        lib.ht_free_u8(nb)
        lib.ht_free_i32(nl)
        return wg_np, dwo_np, nb_np, nl_np, int(prev)


_as_utf8_fn = None


def _py_as_utf8():
    """``PyUnicode_AsUTF8AndSize`` via ctypes (no bytes-object copies).
    The returned pointer is owned by the str and cached on it."""
    global _as_utf8_fn
    if _as_utf8_fn is None:
        f = ctypes.pythonapi.PyUnicode_AsUTF8AndSize
        f.restype = ctypes.c_void_p
        f.argtypes = [ctypes.py_object, ctypes.POINTER(ctypes.c_ssize_t)]
        _as_utf8_fn = f
    return _as_utf8_fn


def assemble(
    word_refs: np.ndarray,
    doc_word_offsets: np.ndarray,
    span_start: np.ndarray,
    span_len: np.ndarray,
    pool: np.ndarray,
):
    """Native span-gather assembly: per doc-word reference, copy its
    unique-word token span from the pool.  Returns (flat_tokens int32,
    doc_token_offsets int64) or None when the library is unavailable.
    """
    lib = load_native()
    if lib is None:
        return None
    word_refs = np.ascontiguousarray(word_refs, dtype=np.int32)
    doc_word_offsets = np.ascontiguousarray(doc_word_offsets, dtype=np.int64)
    span_start = np.ascontiguousarray(span_start, dtype=np.int64)
    span_len = np.ascontiguousarray(span_len, dtype=np.int64)
    pool = np.ascontiguousarray(pool, dtype=np.int32)
    n_docs = len(doc_word_offsets) - 1
    n_spans = span_start.shape[0]
    # fast two-call ABI: packed spans, caller-allocated outputs, chunked
    # copies.  Fits when every span len < 2^24 and start < 2^39 (any
    # realistic pool; a single pathological >16M-token word falls back),
    # and requires 4 int32 of readable slack after the last pool byte.
    if (
        n_spans == 0
        or (
            int(span_len.max(initial=0)) < (1 << 24)
            and int(span_start.max(initial=0)) < (1 << 39)
        )
    ):
        ends = span_start + span_len
        if int(ends.max(initial=0)) + 4 > pool.shape[0]:
            pool = np.concatenate([pool, np.zeros(4, dtype=np.int32)])
        packed = (span_start << 24) | span_len
        offs = np.empty(n_docs + 1, dtype=np.int64)
        total = lib.ht_assemble_counts(
            _np_i32p(word_refs), _np_i64p(doc_word_offsets), n_docs,
            _np_i64p(packed), _np_i64p(offs),
        )
        toks = np.empty(max(int(total), 1), dtype=np.int32)
        lib.ht_assemble_fill(
            _np_i32p(word_refs), _np_i64p(doc_word_offsets), n_docs,
            _np_i64p(packed), _np_i32p(pool), _np_i64p(offs),
            _np_i32p(toks),
        )
        return toks[: int(total)], offs
    out_toks = _i32p()
    out_offs = _i64p()
    total = lib.ht_assemble(
        _np_i32p(word_refs), len(word_refs),
        _np_i64p(doc_word_offsets), n_docs,
        _np_i64p(span_start), _np_i64p(span_len), _np_i32p(pool),
        ctypes.byref(out_toks), ctypes.byref(out_offs),
    )
    offs = np.ctypeslib.as_array(out_offs, shape=(n_docs + 1,)).copy()
    toks = np.ctypeslib.as_array(out_toks, shape=(max(int(total), 1),))[
        : int(total)
    ].copy()
    lib.ht_free_i32(out_toks)
    lib.ht_free_i64(out_offs)
    return toks, offs


def _np_i64p(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


def _np_i32p(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


def _np_u8p(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


class NativeEngine:
    """Host engine instance bound to one tokenizer context."""

    def __init__(self, ctx) -> None:
        from .utils.mem import tune_allocator

        tune_allocator()
        lib = load_native()
        if lib is None:
            raise RuntimeError("native host library unavailable")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.ht_create())

        # vocab
        entries = list(ctx.vocab.str2id.items())
        blob = b"".join(k for k, _ in entries)
        offsets = np.zeros(len(entries) + 1, dtype=np.int64)
        pos = 0
        for i, (k, _) in enumerate(entries):
            offsets[i] = pos
            pos += len(k)
        offsets[len(entries)] = pos
        blob_np = np.frombuffer(blob, dtype=np.uint8).copy() if blob else np.zeros(1, np.uint8)
        ids = np.array([v for _, v in entries], dtype=np.int32)
        lib.ht_set_vocab(
            self._h, _np_u8p(blob_np), _np_i64p(offsets), _np_i32p(ids),
            len(entries), ctx.vocab.size,
        )

        # merges
        if ctx.merges is not None and ctx.merges.num_rules:
            rules = list(ctx.merges.rules.items())
            left = np.array([k[0] for k, _ in rules], dtype=np.int32)
            right = np.array([k[1] for k, _ in rules], dtype=np.int32)
            rank = np.array([v[0] for _, v in rules], dtype=np.int32)
            merged = np.array([v[1] for _, v in rules], dtype=np.int32)
            lib.ht_set_merges(
                self._h, _np_i32p(left), _np_i32p(right), _np_i32p(rank),
                _np_i32p(merged), len(rules),
            )

        # special chars
        sp = sorted(ctx.special_chars.items())
        if sp:
            blob = b"".join(v for _, v in sp)
            soff = np.zeros(len(sp) + 1, dtype=np.int64)
            pos = 0
            for i, (_, v) in enumerate(sp):
                soff[i] = pos
                pos += len(v)
            soff[len(sp)] = pos
            sblob = np.frombuffer(blob, dtype=np.uint8).copy()
            sidx = np.array([k for k, _ in sp], dtype=np.int32)
            lib.ht_set_special(
                self._h, _np_u8p(sblob), _np_i64p(soff), _np_i32p(sidx), len(sp)
            )

        prefix = ctx.prefix or b""
        pref_np = (
            np.frombuffer(prefix, dtype=np.uint8).copy()
            if prefix
            else np.zeros(1, np.uint8)
        )
        lib.ht_set_options(self._h, int(ctx.is_byte_encoder), _np_u8p(pref_np), len(prefix))
        # pattern-based splitting is host-regex territory; the native
        # engine only implements the default parser
        self.supports_pattern = ctx.compiled_pattern is None

    def __del__(self):  # pragma: no cover
        try:
            if getattr(self, "_h", None):
                self._lib.ht_destroy(self._h)
        except Exception:
            pass

    def encode_batch(self, texts: list[str], num_threads: int = 1) -> list[list[int]]:
        # the reference binding parses documents with PyArg_ParseTuple
        # "s", which rejects embedded nulls (src/lib.c:668-676)
        for t in texts:
            if "\x00" in t:
                raise ValueError("embedded null character")
        enc = [t.encode("utf-8") for t in texts]
        blob = b"".join(enc)
        doc_off = np.zeros(len(texts) + 1, dtype=np.int64)
        np.cumsum(
            np.fromiter(map(len, enc), dtype=np.int64, count=len(enc)),
            out=doc_off[1:],
        )
        blob_np = (
            np.frombuffer(blob, dtype=np.uint8).copy()
            if blob
            else np.zeros(1, np.uint8)
        )
        out_toks = _i32p()
        out_offs = _i64p()
        self._lib.ht_encode_batch(
            self._h, _np_u8p(blob_np), _np_i64p(doc_off), len(texts),
            int(num_threads), ctypes.byref(out_toks), ctypes.byref(out_offs),
        )
        offs = np.ctypeslib.as_array(out_offs, shape=(len(texts) + 1,)).copy()
        total = int(offs[-1])
        toks = np.ctypeslib.as_array(out_toks, shape=(max(total, 1),)).copy()
        self._lib.ht_free_i32(out_toks)
        self._lib.ht_free_i64(out_offs)
        return [
            toks[offs[i] : offs[i + 1]].tolist() for i in range(len(texts))
        ]

    def encode_words(
        self,
        blob: np.ndarray,
        offs: np.ndarray,
        lens: np.ndarray,
        num_threads: int = 2,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact scalar encode of standalone words (slices of ``blob``).

        Returns (flat_tokens int32, spans int64 [n_words+1]); word i's
        tokens are ``flat[spans[i]:spans[i+1]]``.
        """
        offs = np.ascontiguousarray(offs, dtype=np.int64)
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        n = len(lens)
        out_toks = _i32p()
        out_spans = _i64p()
        total = self._lib.ht_encode_words(
            self._h, _np_u8p(blob), _np_i64p(offs), _np_i32p(lens), n,
            int(num_threads), ctypes.byref(out_toks), ctypes.byref(out_spans),
        )
        toks = np.ctypeslib.as_array(out_toks, shape=(max(int(total), 1),))[
            : int(total)
        ].copy()
        spans = np.ctypeslib.as_array(out_spans, shape=(n + 1,)).copy()
        self._lib.ht_free_i32(out_toks)
        self._lib.ht_free_i64(out_spans)
        return toks, spans

    def decode_batch(self, token_lists: list[list[int]], num_threads: int = 1) -> list[str]:
        counts = np.fromiter(
            map(len, token_lists), dtype=np.int64, count=len(token_lists)
        )
        flat = (
            np.concatenate(
                [np.asarray(t, dtype=np.int32) for t in token_lists if t]
            )
            if counts.sum()
            else np.zeros(1, dtype=np.int32)
        )
        offs = np.zeros(len(token_lists) + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        data, roffs = self.decode_arrays(flat, offs, num_threads)
        return [
            data[roffs[i] : roffs[i + 1]].decode("utf-8")
            for i in range(len(token_lists))
        ]

    def decode_arrays(
        self, flat: np.ndarray, doc_offs: np.ndarray, num_threads: int = 2
    ) -> tuple[bytes, np.ndarray]:
        """Array-form decode: flat token ids + doc offsets -> (decoded
        byte blob, per-doc byte offsets)."""
        flat = np.ascontiguousarray(flat, dtype=np.int32)
        doc_offs = np.ascontiguousarray(doc_offs, dtype=np.int64)
        n_docs = len(doc_offs) - 1
        out_bytes = _u8p()
        out_offs = _i64p()
        rc = self._lib.ht_decode_batch(
            self._h, _np_i32p(flat), _np_i64p(doc_offs), n_docs,
            int(num_threads), ctypes.byref(out_bytes), ctypes.byref(out_offs),
        )
        if rc != 0:
            raise ValueError(
                "Element must be non-negative and less than vocab size."
            )
        roffs = np.ctypeslib.as_array(out_offs, shape=(n_docs + 1,)).copy()
        total = int(roffs[-1])
        data = bytes(np.ctypeslib.as_array(out_bytes, shape=(max(total, 1),))[:total])
        self._lib.ht_free_u8(out_bytes)
        self._lib.ht_free_i64(out_offs)
        return data, roffs


def pack_rows(blob: np.ndarray, offs: np.ndarray, lens: np.ndarray,
              sel, width: int) -> "np.ndarray | None":
    """Dense [k, width] uint8 rows from ragged blob words via the native
    per-word memcpy packer (None when the library is unavailable).

    ``sel`` selects (and orders) the words; pass None for all words.
    """
    lib = load_native()
    if lib is None:
        return None
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    if sel is None:
        k = len(lens)
        selp = None
    else:
        sel = np.ascontiguousarray(sel, dtype=np.int64)
        k = len(sel)
        selp = sel.ctypes.data_as(_i64p)
    out = np.empty((k, width), dtype=np.uint8)
    lib.ht_pack_rows(
        blob.ctypes.data_as(_u8p),
        offs.ctypes.data_as(_i64p),
        lens.ctypes.data_as(_i64p),
        selp, k, width,
        out.ctypes.data_as(_u8p),
    )
    return out
