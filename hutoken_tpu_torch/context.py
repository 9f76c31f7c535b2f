"""Tokenizer context: everything `initialize` loads, in one immutable-ish object.

The port's own copy of ``hutoken_tpu/context.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.

Plays the role of the reference's global ``EncodeContext``/``DecodeContext``
pair (reference: include/hutoken/taskqueue.h, src/lib.c:73-74,128-183) but as
a first-class object so multiple tokenizers can coexist; the module-level
facade keeps a single global one for API parity.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .formats import MergeRules, Vocab, parse_merges_file, parse_special_chars_file, parse_vocab_file
from .pretokenize import compile_user_pattern


@dataclass
class TokenizerContext:
    vocab: Vocab
    special_chars: dict[int, bytes] = field(default_factory=dict)
    prefix: Optional[bytes] = None
    is_byte_encoder: bool = False
    pattern: Optional[str] = None
    merges: Optional[MergeRules] = None
    # derived
    compiled_pattern: object = None
    max_special_char_len: int = 0

    @classmethod
    def load(
        cls,
        vocab_file_path: str,
        special_file_path: str,
        prefix: Optional[str] = None,
        is_byte_encoder: bool = False,
        pattern: Optional[str] = None,
        merges_file_path: Optional[str] = None,
    ) -> "TokenizerContext":
        """Load files the way ``p_initialize`` does (src/lib.c:185-666).

        ``special_file_path=None`` loads an empty replacement table — the
        reference README documents single-argument initialize
        (README.md:157) even though its C binding cannot take it.
        """
        vocab = parse_vocab_file(vocab_file_path)
        special_chars = (
            parse_special_chars_file(special_file_path)
            if special_file_path is not None
            else {}
        )
        merges = None
        if merges_file_path is not None:
            merges = parse_merges_file(merges_file_path, vocab)
        ctx = cls(
            vocab=vocab,
            special_chars=special_chars,
            prefix=prefix.encode("utf-8") if prefix else None,
            is_byte_encoder=bool(is_byte_encoder),
            pattern=pattern,
            merges=merges,
        )
        if pattern:
            ctx.compiled_pattern = compile_user_pattern(pattern)
        ctx.max_special_char_len = max(
            (len(v) for v in special_chars.values()), default=0
        )
        return ctx
