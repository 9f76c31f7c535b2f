"""The port's own copies of the JAX package's host modules against the
originals, on the CPU, with the same inputs: file formats and contexts,
encoder tables, pre-tokenizer and oracle, the native engine binding,
the trainers, the Hugging Face import and morphology, and the engine's
host layer.  Plus the rule that makes the copies necessary: no module
of the port, and neither ``chip_smoke.py`` nor the tools of ``tools/``,
imports ``jax`` or ``hutoken_tpu``; and the environment variables they
read, eight and no more."""

import ast
import dataclasses
import inspect
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import fixture_tools as ft  # noqa: E402
import torch_parity as tp  # noqa: E402
import hutoken_tpu as J  # noqa: E402
import hutoken_tpu.engine as JE  # noqa: E402
import hutoken_tpu.hf_import as J_hf  # noqa: E402
import hutoken_tpu.morphology as J_morph  # noqa: E402
import hutoken_tpu.native as J_native  # noqa: E402
import hutoken_tpu.oracle as J_oracle  # noqa: E402
import hutoken_tpu.pretokenize as J_pre  # noqa: E402
import hutoken_tpu.tables as J_tables  # noqa: E402
import hutoken_tpu.train.bbpe as J_bbpe  # noqa: E402
import hutoken_tpu.train.bpe as J_bpe  # noqa: E402
import hutoken_tpu_torch as P  # noqa: E402
import hutoken_tpu_torch.engine as PE  # noqa: E402
import hutoken_tpu_torch.hf_import as P_hf  # noqa: E402
import hutoken_tpu_torch.morphology as P_morph  # noqa: E402
import hutoken_tpu_torch.native as P_native  # noqa: E402
import hutoken_tpu_torch.oracle as P_oracle  # noqa: E402
import hutoken_tpu_torch.pretokenize as P_pre  # noqa: E402
import hutoken_tpu_torch.tables as P_tables  # noqa: E402
import hutoken_tpu_torch.train.bbpe as P_bbpe  # noqa: E402
import hutoken_tpu_torch.train.bpe as P_bpe  # noqa: E402
from hutoken_tpu.context import TokenizerContext as JCtx  # noqa: E402
from hutoken_tpu_torch.context import TokenizerContext as PCtx  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "hutoken_tpu_torch")
CONFIGS = ("small", "charmode", "big-vocab", "big-merges", "wide-merges")
TEXTS = [
    ft.CORPUS,
    "A gyors barna róka átugrik a lusta kutya fölött.",
    " The quick brown fox jumps over the lazy dog",
    "Öt szűk ütközőpont: 0xFF! 3.14159\n\t  multiple   spaces",
    "Különböző írásrendszerek — például a kínai 中文 vagy az emoji 🙂",
    "",
]


@pytest.fixture(scope="module")
def wide_files(tmp_path_factory):
    return tp.write_wide_fixture(str(tmp_path_factory.mktemp("wide")))


def _args(name, wide_files):
    """(vocab, special, keyword arguments of TokenizerContext.load)."""
    if name == "small":
        v, s = ft.write_byte_level_fixture()
        return v, s, {"is_byte_encoder": True}
    if name == "charmode":
        v, s = ft.write_char_mode_fixture()
        return v, s, {"prefix": "▁", "is_byte_encoder": False}
    if name == "wide-merges":
        v, s, m = wide_files
        return v, s, {"is_byte_encoder": True, "merges_file_path": m}
    v, s = ft.write_big_vocab_fixture()
    m = ft.write_big_merges_fixture() if name == "big-merges" else None
    return v, s, {"is_byte_encoder": True, "merges_file_path": m}


def _as_dict(ctx):
    d = dataclasses.asdict(ctx)
    if ctx.compiled_pattern is not None:
        d["compiled_pattern"] = ctx.compiled_pattern.pattern
    return d


def _pair(name, wide_files, **extra):
    v, s, kw = _args(name, wide_files)
    kw.update(extra)
    return JCtx.load(v, s, **kw), PCtx.load(v, s, **kw)


# ------------------------------------------------------------ no imports


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    out += [os.path.join(REPO, "tools", f) for f in ("gather_ab.py", "compact_ab.py")]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_names(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    banned = [
        n for n in _imported_names(path)
        if n.split(".")[0] in ("jax", "jaxlib", "hutoken_tpu")
    ]
    assert not banned, banned


# the HUTOKEN_* variables the port and the smoke read: the facade's
# documented switches, the native library's, and the seams that the
# smoke and the subprocess tests set
ENV_VARS = {
    "HUTOKEN_TPU_BACKEND", "HUTOKEN_TPU_DECODE", "HUTOKEN_TPU_NO_NATIVE", "HUTOKEN_TPU_RAW",
    "HUTOKEN_TPU_RAW_C", "HUTOKEN_TPU_STRING_SCAN", "HUTOKEN_TPU_TRAIN_FORCE_CANDIDATES",
    "HUTOKEN_TPU_TRAIN_SELFCHECK",
}


def _environ_reads(path):
    """The HUTOKEN_* names a module reads from the environment:
    ``environ.get(name)``, ``getenv(name)``, ``environ[name]`` and
    ``name in environ``."""

    def is_environ(node):
        return (isinstance(node, ast.Attribute) and node.attr == "environ"
                or isinstance(node, ast.Name) and node.id == "environ")

    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        key = None
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.args:
            if node.func.attr == "getenv" or node.func.attr == "get" and is_environ(node.func.value):
                key = node.args[0]
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load) and is_environ(node.value):
            key = node.slice
        elif (isinstance(node, ast.Compare) and isinstance(node.ops[0], (ast.In, ast.NotIn))
              and is_environ(node.comparators[0])):
            key = node.left
        if isinstance(key, ast.Constant) and str(key.value).startswith("HUTOKEN_"):
            yield key.value


def _readme_env_vars():
    """The variables of the README's "Environment variables" table."""
    text = open(os.path.join(REPO, "README.md"), encoding="utf-8").read()
    section = text.split("### Environment variables", 1)[1].split("\n#", 1)[0]
    return {line.split("`")[1] for line in section.splitlines() if line.startswith("| `HUTOKEN_")}


@pytest.mark.parametrize("where", ["code", "README"])
def test_the_port_reads_eight_environment_variables(where):
    """Every environment variable is a configuration to test and measure,
    so the set does not grow unseen: the port's modules and the smoke
    read these eight, and the README lists the same eight."""
    if where == "code":
        got = {name for path in _port_sources() for name in _environ_reads(path)}
    else:
        got = _readme_env_vars()
    assert got == ENV_VARS


# ----------------------------------------------------- formats, context


@pytest.mark.parametrize("name", CONFIGS)
def test_context_parses_equal(name, wide_files):
    jctx, pctx = _pair(name, wide_files)
    assert _as_dict(pctx) == _as_dict(jctx)


def test_context_with_pattern_parses_equal():
    jctx, pctx = _pair("small", None, pattern=r"[a-z]+|[^a-z]")
    assert pctx.compiled_pattern is not None
    assert _as_dict(pctx) == _as_dict(jctx)


@pytest.mark.parametrize("name", CONFIGS)
def test_encoder_tables_equal(name, wide_files):
    jctx, pctx = _pair(name, wide_files)
    want, got = J_tables.build_encoder_tables(jctx), P_tables.build_encoder_tables(pctx)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name == "pair_table":
            for g in dataclasses.fields(a):
                x, y = getattr(a, g.name), getattr(b, g.name)
                assert (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y), g.name
            assert all(np.array_equal(x, y) for x, y in zip(a.packed_arrays(), b.packed_arrays()))
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("n,max_probe_len", [(0, 4), (1, 4), (3000, 4), (3000, 1), (20000, 16)])
def test_pair_table_build_equal(n, max_probe_len):
    """The port's faster pair-table build gives the original's table slot for slot,
    ids past 16 bits and capacities grown for the probe bound included."""
    rng = np.random.default_rng(n + max_probe_len)
    keys = rng.integers(0, 1 << 17, (n, 2))
    vals = rng.integers(0, 1 << 20, (n, 2))
    pairs = {(int(a), int(b)): (int(r), int(m)) for (a, b), (r, m) in zip(keys, vals)}
    want = J_tables.build_pair_table(pairs, max_probe_len)
    got = P_tables.build_pair_table(pairs, max_probe_len)
    for g in dataclasses.fields(want):
        x, y = getattr(want, g.name), getattr(got, g.name)
        assert (np.array_equal(x, y) and x.dtype == y.dtype if isinstance(x, np.ndarray) else x == y), g.name


# ------------------------------------------------ pretokenize, oracle


@pytest.mark.parametrize("name", CONFIGS[:4])
def test_pretokenize_and_oracle_agree_on_fixture_texts(name):
    jctx, pctx = _pair(name, None)
    for text in TEXTS:
        assert P_pre.split_words(text) == J_pre.split_words(text)
        assert P_pre.split_words_scalar(text) == J_pre.split_words_scalar(text)
        ids = J_oracle.encode(jctx, text)
        assert P_oracle.encode(pctx, text) == ids
        assert P_oracle.decode(pctx, ids) == J_oracle.decode(jctx, ids)


@settings(max_examples=60, deadline=None)
@given(st.text(alphabet=st.characters(blacklist_characters="\x00"), max_size=80))
def test_pretokenize_and_oracle_agree_on_any_text(text):
    jctx, pctx = _pair("small", None)
    assert P_pre.split_words(text) == J_pre.split_words(text)
    try:
        data = text.encode()
    except UnicodeEncodeError:
        # a lone surrogate (category Cs) has no UTF-8 form: there are no
        # bytes to remap, and both oracles refuse the text alike
        for oracle, ctx in ((P_oracle, pctx), (J_oracle, jctx)):
            with pytest.raises(UnicodeEncodeError):
                oracle.encode(ctx, text)
        return
    assert P_pre.encode_remap(data, pctx.special_chars, None, True) == J_pre.encode_remap(
        data, jctx.special_chars, None, True
    )
    assert P_oracle.encode(pctx, text) == J_oracle.encode(jctx, text)


# -------------------------------------------------------------- native


@pytest.mark.parametrize("name", ["small", "big-merges"])
def test_native_engine_encodes_and_decodes_equal(name):
    if J_native.load_native() is None:
        pytest.skip("the native host library is not built")
    jctx, pctx = _pair(name, None)
    assert P_native.load_native() is not None
    want = J_native.NativeEngine(jctx).encode_batch(TEXTS, 2)
    eng = P_native.NativeEngine(pctx)
    assert eng.encode_batch(TEXTS, 2) == want
    assert eng.decode_batch(want, 2) == J_native.NativeEngine(jctx).decode_batch(want, 2)
    flat = np.concatenate([np.asarray(t, dtype=np.int64) for t in want])
    offs = np.concatenate(([0], np.cumsum([len(t) for t in want]))).astype(np.int64)
    got_blob, got_offs = eng.decode_arrays(flat, offs)
    want_blob, want_offs = J_native.NativeEngine(jctx).decode_arrays(flat, offs)
    assert got_blob == want_blob and np.array_equal(got_offs, want_offs)


def test_native_library_path_prefers_the_ports_package():
    """The port looks in its own ``_native/`` first, then in the
    checkout's ``native/``, the library it shares with the JAX package."""
    path = P_native._so_path()
    assert path in (
        os.path.join(PKG, "_native", "libhutoken_host.so"),
        os.path.join(REPO, "native", "libhutoken_host.so"),
    )


# ------------------------------------------------------------ trainers


@pytest.mark.parametrize("which", ["bpe", "bbpe"])
def test_trainers_write_identical_vocab_files(which, tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    data = ft.CORPUS[:3000]
    jtrain, ptrain = (J_bpe.bpe_train, P_bpe.bpe_train) if which == "bpe" else (
        J_bbpe.bbpe_train, P_bbpe.bbpe_train
    )
    want = jtrain(data, 320, "jax.txt", verbose=False)
    got = ptrain(data, 320, "port.txt", verbose=False)
    assert open(got, "rb").read() == open(want, "rb").read()
    # both route mesh= to the device trainers, which take only the
    # port's DataMesh
    with pytest.raises(TypeError, match="DataMesh"):
        ptrain(data, 320, "mesh.txt", verbose=False, mesh=object())


# ------------------------------------------------ hf_import, morphology


def test_hf_import_writes_equal_files(tmp_path, monkeypatch):
    pytest.importorskip("transformers")
    model_dir = tmp_path / "testorg" / "gpt2like"
    model_dir.mkdir(parents=True)
    vocab = {ft.remapped_spelling(tok): idx for tok, idx in ft.build_ranks().items()}
    (model_dir / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (model_dir / "merges.txt").write_text(
        open(ft.write_merges_fixture(), encoding="utf-8").read(), encoding="utf-8"
    )
    (model_dir / "tokenizer_config.json").write_text(
        json.dumps({"tokenizer_class": "GPT2Tokenizer", "model_max_length": 1024})
    )
    monkeypatch.chdir(tmp_path)  # "<org>/<model>" resolves as a local dir
    out = {}
    for tag, mod in (("jax", J_hf), ("port", P_hf)):
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / tag))
        out[tag] = mod.import_hf_tokenizer("testorg/gpt2like")
    (jv, js, jp, jb, jm), (pv, ps, pp, pb, pm) = out["jax"], out["port"]
    assert (pp, pb) == (jp, jb)
    for a, b in ((jv, pv), (js, ps)):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert open(jm, "rb").read() == open(pm, "rb").read()
    # the port's facade goes through its own import and encodes as the
    # JAX oracle does on the same files
    P.initialize("testorg/gpt2like", backend="host", device="cpu")
    ctx = JCtx.load(jv, js, prefix=jp, is_byte_encoder=jb, merges_file_path=jm)
    for text in TEXTS[1:4]:
        assert P.encode(text) == J_oracle.encode(ctx, text)
    P._reset()


class _FakeFoma:
    """The libfoma calls morphology.py binds, replaying emMorph-shaped
    analyses (as tests/test_morphology.py does)."""

    ANALYSES = {
        "fejetlenséget": [
            "fejetlenség[/N]et[Acc]",
            "fejetlen[/Adj]ség[_Abs/N]et[Acc]",
            "fej[/N]etlen[_Priv/Adj]ség[_Abs/N]et[Acc]",
        ],
        "": [],
    }

    def __init__(self):
        self._iter = iter(())

    def fsm_read_binary_file(self, path):
        return 1234 if b"hu.foma.bin" in path else None

    def apply_init(self, net):
        return 5678

    def apply_up(self, handle, word):
        if word is not None:
            self._iter = iter(self.ANALYSES.get(word.decode("utf-8"), []))
        nxt = next(self._iter, None)
        return None if nxt is None else nxt.encode("utf-8")


def test_morphology_equal_on_a_fake_foma(monkeypatch):
    results = []
    for mod in (J_morph, P_morph):
        monkeypatch.setattr(mod, "_lib", _FakeFoma())
        monkeypatch.setattr(mod, "_probed", True)
        h = mod.initialize_foma()
        results.append([
            mod.look_up_word(h, w, longest)
            for w in ("fejetlenséget", "") for longest in (False, True)
        ] + [mod.split_analysis(s) for s in ("fej[/N]etlen[_Priv/Adj]", "fej[/N][Pl]", "")])
        with pytest.raises(FileNotFoundError):
            mod.initialize_foma("./bin/does-not-exist.bin")
    assert results[0] == results[1]
    monkeypatch.setattr(P_morph, "_lib", None)
    assert not P_morph.available()


# --------------------------------------------- engine host layer, code


HOST_METHODS = [
    "_pool_reserve", "_pool_append", "_pool_append_flat", "_split", "_prefix_token_run",
    "_seed_word", "_encode_word_host", "_split_dedup_py", "encode_batch_arrays", "_launch_byte_words", "_launch_id_words",
    "_resolve_generic", "_raw_probe", "_host_encode_text", "_host_chunk",
    "_native_word_encoder", "_encode_host_tail_parts", "_ensure_gid_capacity",
    "_launch_byte_blocks", "_assemble_np", "_build_decode_fast_path", "decode_batch",
    "_decode_batch_host", "_build_decode_general", "decode_batch_device",
    "_try_decode_batch_device", "_decode_chunks_tok", "_decode_batch_flat",
    "_decode_arrays_host_exact", "decode_arrays", "_reverse_remap_np",
]


def _code(obj):
    """The AST of a function without its docstring."""
    node = ast.parse(inspect.cleandoc("\n" + inspect.getsource(obj))).body[0]
    body = node.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        node.body = body[1:]
    return ast.dump(node)


@pytest.mark.parametrize("name", HOST_METHODS)
def test_engine_host_methods_are_copies(name):
    assert _code(getattr(PE.TorchTokenizer, name)) == _code(getattr(JE.TpuTokenizer, name))


def _output_case(case, tmp_path):
    """(the port's context, the JAX engine's or None, documents) of one
    kind of input to ``encode_batch``: enough first-seen words for full
    64-row blocks, so that the device path runs."""
    words = ft.CORPUS.split()
    docs = [" ".join(words[i : i + 40]) for i in range(0, len(words), 40)] + ["", "x"]
    if case == "byte-level":
        jctx, pctx = _pair("small", None)
        return pctx, jctx, docs + [f"q{i}x{'ab' * (i % 30)} z{i}" for i in range(200)]
    if case in ("char-mode", "prefix-run"):
        jctx, pctx = _pair("charmode", None)
        ascii_docs = [" ".join(w for w in d.split() if w.isascii()) for d in docs]
        if case == "prefix-run":
            ascii_docs = [" " + d for d in ascii_docs] + ["  two spaces", " "]
        return pctx, jctx, ascii_docs
    # ids 70,000 / 70,001 on 258 lines (tests/test_torch_quirk_vocab.py):
    # the JAX engine cuts ids past 16 bits on so few lines
    b2u = P.bytemaps.gpt2_bytes_to_unicode()
    id2str = {b: b2u[b].encode("utf-8") for b in range(256)}
    id2str[70000], id2str[70001] = "he".encode(), "hel".encode()
    vpath, spath = str(tmp_path / "holes-vocab.txt"), str(tmp_path / "holes-special.txt")
    P.formats.write_vocab_file(vpath, id2str)
    P.formats.write_special_chars_file(spath, P.bytemaps.gpt2_special_chars_table())
    rng = np.random.default_rng(0)
    letters = np.array(list("abcdefgxyz"))
    hel = ["hel" + "".join(rng.choice(letters, rng.integers(1, 9))) for _ in range(600)]
    return PCtx.load(vpath, spath, is_byte_encoder=True), None, [
        " ".join(hel[i : i + 30]) for i in range(0, 600, 30)
    ]


@pytest.mark.parametrize("case", ["byte-level", "char-mode", "prefix-run", "id-holes"])
def test_engine_encode_batch_output(case, tmp_path, monkeypatch):
    """``encode_batch`` is out of the copy rule: its lists take the id
    table's shared ints.  On each kind of input, with blocks cut to 64 /
    16 rows so that the device path runs, its lists equal the port's
    oracle, the native engine and, where the JAX engine takes the case,
    the JAX engine's, as lists of ``int``."""
    monkeypatch.setenv("HUTOKEN_TPU_PALLAS", "interpret")
    monkeypatch.setitem(PE.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(PE.ROW_BLOCKS, 128, 16)
    pctx, jctx, docs = _output_case(case, tmp_path)
    tok = PE.TorchTokenizer(pctx, device="cpu")
    got = tok.encode_batch(docs)
    want = [P_oracle.encode(pctx, d) for d in docs]
    assert got == want
    assert P_native.NativeEngine(pctx).encode_batch(docs, 2) == want
    if jctx is not None:
        assert JE.TpuTokenizer(jctx).encode_batch(docs) == want
    assert tok.stat_device_words > 0
    assert all(type(t) is list and all(type(x) is int for x in t) for t in got)
    if case == "prefix-run":
        run = tok._prefix_token_run()
        assert run and all(t[: len(run)] == run for t in got if t)
    if case == "id-holes":
        assert not tok._id_table.dense and any(70001 in t for t in got)


def _cache_state(tok):
    return {
        "dict": dict(tok._word_cache), "used": tok._cache_used,
        "pool": tok._cache_pool.tolist(),
        "interned": None if tok._interner is None else tok._interner.count(),
        "gid_start": tok._gid_start.tolist(), "gid_len": tok._gid_len.tolist(),
    }


@pytest.mark.parametrize("core", ["pipelined", "python"])
def test_reset_cache_empties_what_the_jax_engine_empties(core, monkeypatch):
    """``reset_cache`` is out of the copy rule (it opens the traced
    ``engine.reset_cache`` span): after an encode and a reset, the span
    pool, the dict cache, the interner and the gid arrays are empty as
    the JAX engine's are, and the next encode equals the JAX engine's and
    the oracle's."""
    monkeypatch.setenv("HUTOKEN_TPU_PALLAS", "interpret")
    ctx, _enc = tp.load("small")
    ptok, jtok = PE.TorchTokenizer(ctx, device="cpu"), JE.TpuTokenizer(ctx)
    if core == "python":
        ptok._native_split_ok = jtok._native_split_ok = False
    for tok in (ptok, jtok):
        tok.encode_batch(TEXTS)
        assert tok._cache_used > 0
        tok.reset_cache()
    state = _cache_state(ptok)
    assert state == _cache_state(jtok)
    assert state["dict"] == {} and state["used"] == 0 and state["interned"] in (None, 0)
    assert not any(state["pool"]) and set(state["gid_start"]) == {-1} and not any(state["gid_len"])
    docs = TEXTS[::-1] + [" reset and encoded again"]
    got = ptok.encode_batch(docs)
    assert got == jtok.encode_batch(docs)
    assert got == [J_oracle.encode(ctx, d) for d in docs]


def test_engine_constants_equal():
    for name in ("BUCKETS", "MAX_DEVICE_LEN", "GROUP_BYTES", "RAW_MIN_BYTES", "RAW_THRESH"):
        assert getattr(PE, name) == getattr(JE, name), name
    assert PE.ROW_BLOCKS == JE.ROW_BLOCKS_PALLAS
    assert (PE.TorchTokenizer.DEC_N_QUANTA, PE.TorchTokenizer.DEC_T_QUANTA) == (
        JE.TpuTokenizer.DEC_N_QUANTA, JE.TpuTokenizer.DEC_T_QUANTA
    )


# the functions whose copies differ on purpose: the pair-table build,
# which hashes once per build rather than once per pair and capacity
# (test_encoder_tables_equal and test_pair_table_build_equal hold its
# tables equal to the original's).  The trainers' mesh= branches are
# copies: they call the port's parallel.train, whose entries train on
# the port's DataMesh.
DIFFER = {"build_pair_table"}
MODULE_PAIRS = [
    ("utils/logging.py", "utils.logging"), ("utils/mem.py", "utils.mem"),
    ("bytemaps.py", "bytemaps"), ("pretokenize.py", "pretokenize"),
    ("formats.py", "formats"), ("context.py", "context"), ("native.py", "native"),
    ("oracle.py", "oracle"), ("train/common.py", "train.common"),
    ("train/bpe.py", "train.bpe"), ("train/bbpe.py", "train.bbpe"),
    ("hf_import.py", "hf_import"), ("morphology.py", "morphology"),
    ("tables.py", "tables"),
]


def _top_level(path):
    """name -> AST dump (docstrings dropped) of a module's top-level
    functions and classes."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.ClassDef)) and sub.body:
                    b0 = sub.body[0]
                    if isinstance(b0, ast.Expr) and isinstance(b0.value, ast.Constant):
                        sub.body = sub.body[1:] or [ast.Pass()]
            out[node.name] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel,mod", MODULE_PAIRS, ids=[r for r, _m in MODULE_PAIRS])
def test_copied_modules_define_the_same_code(rel, mod):
    """Every top-level function and class the copy shares with the
    original is the same code; the copy keeps all of the original's,
    except the R-matrix tables and the numpy probe the port never runs."""
    want = _top_level(os.path.join(REPO, "hutoken_tpu", rel))
    got = _top_level(os.path.join(PKG, rel))
    if rel == "tables.py":
        want = {k: v for k, v in want.items() if k in got}
        assert {"PairTable", "build_pair_table", "EncoderTables", "build_encoder_tables"} <= set(want)
    else:
        assert set(want) <= set(got)
    for name, code in want.items():
        if name not in DIFFER:
            assert got[name] == code, name


def test_facade_error_strings_and_trainers(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    for mod in (J, P):
        with pytest.raises(RuntimeError, match="vocab_size must be at least 256"):
            mod.bbpe_train("abc", 100, "v.txt")
    got = P.bbpe_train(ft.CORPUS[:2000], 300, "p.txt")
    want = J.bbpe_train(ft.CORPUS[:2000], 300, "j.txt")
    assert open(got, "rb").read() == open(want, "rb").read()
    assert "hutoken_tpu_torch" in sys.modules


# ------------------------------------------------- the smoke's copies


def test_smoke_inputs_are_copies():
    """The port's ``corpora`` module, which ``chip_smoke.py`` reads, keeps
    its own copies of the fixture text and of ``bench.py``'s corpus
    builders (which load the JAX package); the smoke reads the committed
    fixture files that ``fixture_tools`` writes."""
    import bench
    import chip_smoke
    from hutoken_tpu_torch import corpora as C

    assert C.BASE_TEXT == ft._BASE_TEXT and C.CORPUS == ft.CORPUS
    assert C.build_corpus(0.3) == bench.build_corpus(0.3)
    assert C.build_unique_corpus(0.3) == bench.build_unique_corpus(0.3)
    assert chip_smoke.build_corpus is C.build_corpus
    assert chip_smoke.fixture_paths("small") == (*ft.write_byte_level_fixture(), None)
    assert chip_smoke.fixture_paths("big-vocab") == (*ft.write_big_vocab_fixture(), None)
    assert chip_smoke.fixture_paths("big-merges") == (
        *ft.write_big_vocab_fixture(), ft.write_big_merges_fixture()
    )


def test_smoke_raw_chunk_takes_whole_documents_up_to_a_chunk(monkeypatch):
    """``chip_smoke.raw_chunk``, the chunk phase 3 times ``seg_merge``
    on: the corpus's first documents, whole, while their bytes fit
    ``RAW_CHUNK`` (the engine's raw chunk, ``HUTOKEN_TPU_RAW_C``'s
    default), and each document's end."""
    import chip_smoke
    from hutoken_tpu_torch import corpora as C

    assert chip_smoke.RAW_CHUNK == 1 << 22
    docs = C.build_unique_corpus(0.3)
    sizes = [len(d.encode()) for d in docs]
    monkeypatch.setattr(chip_smoke, "RAW_CHUNK", sum(sizes[:5]) + sizes[5] - 1)
    chunk, ends = chip_smoke.raw_chunk(docs)
    assert chunk.dtype == np.uint8 and ends.tolist() == np.cumsum(sizes[:5]).tolist()
    assert chunk.tobytes() == "".join(docs[:5]).encode()
    monkeypatch.setattr(chip_smoke, "RAW_CHUNK", sizes[0] - 1)
    chunk, ends = chip_smoke.raw_chunk(docs)
    assert chunk.size == 0 and ends.size == 0
