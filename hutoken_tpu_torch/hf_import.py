"""Hugging Face tokenizer import -> hutoken-format files.

The port's own copy of ``hutoken_tpu/hf_import.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.

Reproduces the reference facade's HF branch (reference: hutoken.py:44-120):
download via ``AutoTokenizer``, write the vocab in hex format to
``~/.cache/hutoken/<org>/<model>/<model>.txt``, derive the prefix token by
tokenizing "hu", emit a ``*_special_chars.txt`` from the tokenizer's
``byte_encoder`` (or per-char tokenization), locate ``merges.txt``, and
auto-enable byte-encoder mode.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

from .bytemaps import SPECIAL_CHAR_BYTES


def import_hf_tokenizer(
    model_or_path: str,
) -> tuple[str, str, Optional[str], int, Optional[str]]:
    """Returns (vocab_file, special_chars_file, prefix, is_byte_encoder,
    merges_file_path)."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:  # pragma: no cover
        raise ValueError(
            f"Could not download Hugging Face tokenizer '{model_or_path}': {e}"
        )

    try:
        hf_tokenizer = AutoTokenizer.from_pretrained(model_or_path)
    except OSError as e:
        raise ValueError(
            f"Could not download Hugging Face tokenizer '{model_or_path}': {e}"
        )

    if not hasattr(hf_tokenizer, "vocab"):
        raise ValueError("Could not extract vocab from Hugging Face tokenizer.")

    target_dir = _cache_dir_for(model_or_path)
    os.makedirs(target_dir, exist_ok=True)
    model_name = model_or_path.split("/")[1]
    hf_tokenizer.save_pretrained(target_dir)

    vocab_file = os.path.join(target_dir, f"{model_name}.txt")
    _write_hex_vocab(vocab_file, hf_tokenizer.vocab)

    prefix = _detect_prefix(hf_tokenizer)

    # re-load without implicit prefix-space insertion so per-char
    # tokenization below reflects raw byte spellings
    slow = AutoTokenizer.from_pretrained(
        model_or_path,
        use_fast=False,
        add_prefix_space=False if prefix is not None else None,
    )
    special_chars_file = os.path.join(
        target_dir, f"{model_name}_special_chars.txt"
    )
    _write_special_map(special_chars_file, slow)

    merges_file_path: Optional[str] = os.path.join(target_dir, "merges.txt")
    if not os.path.isfile(merges_file_path):
        merges_file_path = None
        sys.stderr.write(
            f"No merges.txt found for '{model_or_path}'. "
            "Continuing without merge rules.\n"
        )

    byte_enc = getattr(slow, "byte_encoder", None)
    return (
        vocab_file,
        special_chars_file,
        prefix,
        1 if byte_enc is not None else 0,
        merges_file_path,
    )


def _cache_dir_for(model_or_path: str) -> str:
    base = os.getenv(
        "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache")
    )
    org, name = model_or_path.split("/")
    return os.path.join(base, "hutoken", org, name)


def _write_hex_vocab(path: str, vocab: dict) -> None:
    """hutoken hex vocab format: one '0xAA0xBB.. == id' line per token,
    id-ordered (byte-identical to the reference's export,
    hutoken.py:65-73)."""
    with open(path, "w", encoding="utf-8") as f:
        for spelling, token_id in sorted(vocab.items(), key=lambda kv: kv[1]):
            try:
                hexes = "".join(
                    f"0x{b:02X}" for b in spelling.encode("utf-8")
                )
                f.write(f"{hexes} == {token_id}\n")
            except Exception as e:  # pragma: no cover
                sys.stderr.write(f"Failed to process token '{spelling}': {e}")


def _detect_prefix(hf_tokenizer) -> Optional[str]:
    """SentencePiece-style tokenizers prepend a marker (e.g. '▁'): visible
    as the first char when tokenizing a short plain word."""
    pieces = hf_tokenizer.tokenize("hu")
    first = pieces[0] if pieces else "hu"
    return first[0] if first != "hu" else None


def _write_special_map(path: str, hf_tokenizer) -> None:
    """'<byte> == <replacement>' lines for each remapped byte, from the
    tokenizer's byte_encoder when it has one, else per-char tokenization
    (format: reference hutoken.py:88-101)."""
    byte_enc = getattr(hf_tokenizer, "byte_encoder", None)
    with open(path, "w", encoding="utf-8") as f:
        for b in SPECIAL_CHAR_BYTES:
            spelled = (
                byte_enc[b]
                if byte_enc is not None
                else "".join(hf_tokenizer.tokenize(chr(b)))
            )
            if spelled == b:
                continue
            f.write(f"{b} == {spelled}\n")
