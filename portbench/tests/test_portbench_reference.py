"""The plain reference against ids worked out by hand on a tiny
vocabulary, and against the port's oracle on the benchmark's own files,
each configuration with its own options."""

from __future__ import annotations

import pytest

from portbench import registry
from portbench.gen.files import load_sample
from portbench.harness import reference, vocab_files
from portbench.reference.bpe import Reference
from tiny import SAMPLE, port_context

# the configurations that ran before the reference took the options:
# both byte-encoder mode
BYTE_CONFIGS = ["codeparrot-py-32k", "deepseek-v3-128k-py"]

SPECIAL = {32: "Ġ", 10: "Ċ"}


def write(tmp_path, tokens, merges=None):
    vocab = tmp_path / "v.txt"
    vocab.write_text("".join(
        "".join(f"0x{b:02X}" for b in t.encode()) + f" == {i}\n" for i, t in enumerate(tokens)))
    special = tmp_path / "s.txt"
    special.write_text("".join(f"{b} == {c}\n" for b, c in SPECIAL.items()))
    m = None
    if merges is not None:
        m = tmp_path / "m.txt"
        m.write_text("#version\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return str(vocab), str(special), str(m) if m else None


def test_merge_rules_by_rank_leftmost_first(tmp_path):
    toks = ["a", "b", "c", "Ġ", "ab", "bc", "abc", "Ġa", "Ġab"]
    ids = {t: i for i, t in enumerate(toks)}
    ref = Reference(*write(tmp_path, toks, [("b", "c"), ("a", "b"), ("ab", "c"), ("Ġ", "a"),
                                            ("Ġa", "b"), ("x", "y")]))
    assert ref.encode("abc") == [ids["a"], ids["bc"]]  # (b, c) ranks first
    assert ref.encode("abab") == [ids["ab"], ids["ab"]]
    assert ref.encode("cab ab") == [ids["c"], ids["ab"], ids["Ġ"], ids["ab"]]  # (a, b) first
    assert ref.encode(" ac") == [ids["Ġa"], ids["c"]]
    assert ref.encode("bca") == [ids["bc"], ids["a"]]
    assert ref.encode("d") == [-1]  # a byte with no token
    # the control: ranks 0 and 1 tie at 8 fewer bits, and the leftmost wins
    low = Reference(*write(tmp_path, toks, [("b", "c"), ("a", "b"), ("ab", "c")]), rank_shift=8)
    assert low.encode("abc") == [ids["abc"]]


def test_rank_is_the_id_of_the_join_without_merges(tmp_path):
    toks = ["a", "b", "c", "Ġ", "bc", "ab", "abc"]
    ids = {t: i for i, t in enumerate(toks)}
    ref = Reference(*write(tmp_path, toks))
    # "bc" (id 4) merges before "ab" (5), then "abc" (6) joins a and bc
    assert ref.encode("abc") == [ids["abc"]]
    assert ref.encode("bca") == [ids["bc"], ids["a"]]
    assert ref.encode("ab c") == [ids["ab"], ids["Ġ"], ids["c"]]


def test_words_split_as_the_parser_does(tmp_path):
    toks = [chr(c) for c in range(97, 123)] + ["Ġ", "Ċ", "1", "2", ".", "Ã", "©"]
    ref = Reference(*write(tmp_path, toks))
    ids = {t: i for i, t in enumerate(toks)}
    assert ref.encode("a 12.b") == [ids["a"], ids["Ġ"], ids["1"], ids["2"], ids["."], ids["b"]]
    # é (0xC3 0xA9): each byte >= 0x80 becomes its 2-byte codepoint spelling
    assert ref.encode("é") == [ids["Ã"], ids["©"]]


def test_the_reference_refuses_a_mode_it_does_not_compute(tmp_path):
    files = write(tmp_path, ["a", "b", "Ġ"])
    assert Reference(*files, is_byte_encoder=True, token_id=-1).encode("ab") == [0, 1]
    for option in ({"is_byte_encoder": False}, {"prefix": "▁"}, {"pattern": "[a-z]+"}):
        with pytest.raises(ValueError, match=next(iter(option))):
            Reference(*files, **{"is_byte_encoder": True, **option})


def reference_equals_the_ports_oracle(cfg: dict, path: str, cache: str) -> None:
    """The configuration's reference gives the port's oracle's ids on 30
    documents, each with the configuration's options, and its control
    differs on more than half of them."""
    from hutoken_tpu_torch import oracle

    files = vocab_files(cfg, path, cache=cache)
    ctx = port_context(cfg, files)
    ref = reference(cfg, files)
    low = reference(cfg, files, rank_shift=8)
    docs = [d[:4000] for d in load_sample(SAMPLE)[::12]]
    for d in docs:
        assert ref.encode(d) == oracle.encode(ctx, d)
    assert sum(low.encode(d) != ref.encode(d) for d in docs) > len(docs) // 2


@pytest.mark.parametrize("name", [c["name"] for c in registry.load_benchmark()["configs"]])
def test_reference_equals_the_ports_oracle(tmp_path, name):
    cfg, path = registry.config(registry.load_benchmark(), name)
    reference_equals_the_ports_oracle(cfg, path, str(tmp_path))


@pytest.mark.parametrize("name", BYTE_CONFIGS)
def test_the_options_leave_the_byte_mode_reference_as_it_was(tmp_path, name):
    """Built by the harness with the configuration's options, the
    reference gives the ids it gave when it took the files alone."""
    cfg, path = registry.config(registry.load_benchmark(), name)
    assert cfg["initialize"] == {"is_byte_encoder": True}
    files = vocab_files(cfg, path, cache=str(tmp_path))
    built = reference(cfg, files)
    plain = Reference(files["vocab"], files["special"], files["merges"])
    docs = [d[:4000] for d in load_sample(SAMPLE)[::12]]
    assert [built.encode(d) for d in docs] == [plain.encode(d) for d in docs]
