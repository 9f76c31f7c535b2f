"""A stand-in reference for a char-mode configuration, for the harness's
tests, copied into ``reference/`` of a copy of the harness.

It takes the port's own word split, remap and seeding
(``hutoken_tpu_torch/oracle.py``) on a context loaded with the
configuration's options, and merges by the ids of the joins itself, so
that ``rank_shift`` has something to shorten.  So it checks the
plumbing (that a configuration's options and the control's shift reach
the reference the configuration names), not char mode's semantics.  The
reference of a configuration that the benchmark runs is plain Python
that imports nothing of the port.
"""

from __future__ import annotations

from hutoken_tpu_torch import oracle
from hutoken_tpu_torch.context import TokenizerContext

_INF = 0x7FFFFFFF


class Reference:
    """The oracle's semantics on a vocabulary without merges."""

    def __init__(self, vocab: str, special: str, merges: str | None = None,
                 rank_shift: int = 0, *, is_byte_encoder: bool, prefix: str | None = None,
                 pattern: str | None = None, token_id: int | None = None):
        if merges is not None:
            raise ValueError("the stand-in ranks a pair by the id of its join: no merges file")
        self.ctx = TokenizerContext.load(vocab, special, prefix=prefix,
                                         is_byte_encoder=is_byte_encoder, pattern=pattern)
        self.rank_shift = rank_shift

    def merge(self, elems: list[bytes]) -> list[int]:
        """Join the adjacent pair whose join has the lowest id (shifted),
        the leftmost at equal rank, until no join is a token."""
        str2id, shift = self.ctx.vocab.str2id, self.rank_shift
        elems = list(elems)
        while len(elems) > 1:
            ranks = [str2id.get(a + b) for a, b in zip(elems, elems[1:])]
            ranks = [_INF if r is None else r >> shift for r in ranks]
            best = min(ranks)
            if best >= _INF:
                break
            i = ranks.index(best)
            elems[i : i + 2] = [elems[i] + elems[i + 1]]
        return [str2id.get(e, -1) for e in elems]

    def encode(self, text: str) -> list[int]:
        """``oracle.encode``'s prefix state machine: the prefix glued to
        the first word, or its own run first where the text starts with
        a space."""
        ctx = self.ctx
        if "\x00" in text:
            raise ValueError("embedded null character")
        if ctx.compiled_pattern is not None:
            words = oracle.split_words_pattern(text, ctx.compiled_pattern)
        else:
            words = oracle.split_words(text)
        glue = not text.startswith(" ")
        run = not glue and ctx.prefix is not None
        out: list[int] = []
        for word in words:
            wb = word.encode("utf-8")
            if not wb:
                continue
            if run:
                spelled = oracle.encode_remap(ctx.prefix, ctx.special_chars, None,
                                              ctx.is_byte_encoder)
                out += self.merge(oracle._seed_per_char(spelled))
                run = False
            spelled = oracle.encode_remap(wb, ctx.special_chars, ctx.prefix if glue else None,
                                          ctx.is_byte_encoder)
            out += self.merge(oracle.seed_elements_string_path(spelled))
            glue = False
        return out


class NoPrefix(Reference):
    """The stand-in with the configuration's prefix ignored: a reference
    that the per-configuration tests have to refuse."""

    def __init__(self, *args, prefix: str | None = None, **kwargs):
        super().__init__(*args, **kwargs)
