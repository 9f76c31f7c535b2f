"""The port's own copies of the JAX package's host modules against the
originals, on the CPU, with the same inputs: file formats and contexts,
encoder tables, pre-tokenizer and oracle, the native engine binding,
the trainers, the Hugging Face import and morphology, and the engine's
host layer.  Plus the rule that makes the copies necessary: no module
of the port, and neither ``chip_smoke.py`` nor ``tools/gather_ab.py``,
imports ``jax`` or ``hutoken_tpu``."""

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
    out = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tools", "gather_ab.py")]
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
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
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
    "_seed_word", "_encode_word_host", "_split_dedup_py", "encode_batch",
    "encode_batch_arrays", "reset_cache", "_launch_byte_words", "_launch_id_words",
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


def test_engine_constants_equal():
    for name in ("BUCKETS", "MAX_DEVICE_LEN", "GROUP_BYTES", "RAW_MIN_BYTES", "RAW_THRESH"):
        assert getattr(PE, name) == getattr(JE, name), name
    assert PE.ROW_BLOCKS == JE.ROW_BLOCKS_PALLAS
    assert (PE.TorchTokenizer.DEC_N_QUANTA, PE.TorchTokenizer.DEC_T_QUANTA) == (
        JE.TpuTokenizer.DEC_N_QUANTA, JE.TpuTokenizer.DEC_T_QUANTA
    )


# the functions whose copies differ on purpose: the trainers' mesh=
# branch (not ported), the native loader's docstring, and the pair-table
# build, which hashes once per build rather than once per pair and
# capacity (test_encoder_tables_equal and test_pair_table_build_equal
# hold its tables equal to the original's)
DIFFER = {"bpe_train", "bbpe_train", "build_pair_table"}
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
