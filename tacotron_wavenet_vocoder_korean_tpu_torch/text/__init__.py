"""Text <-> id-sequence codec (reference: text/__init__.py:38-123).

Instead of the reference's mutable module-global symbol table (switched by
``convert_to_en_symbols``), the codec is an explicit object constructed per
cleaner pipeline; ``korean_cleaners`` uses the 80-symbol jamo table,
``english_cleaners`` the ASCII table.  Curly-brace ARPAbet escapes are kept.

The port keeps its own copy of the JAX package's ``text/`` (pure Python, no
JAX in it), so it imports nothing of that package; the two are held equal
id for id by ``tests/test_torch_text.py``.
"""
from __future__ import annotations

import re
from typing import List, Sequence, Union

import numpy as np

from .symbols import PAD, EOS, symbol_table
from .cleaners import get_cleaner
from .hangul import jamo_to_korean

__all__ = [
    "TextCodec", "text_to_sequence", "sequence_to_text", "PAD", "EOS",
    "jamo_to_korean",
]

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


class TextCodec:
    def __init__(self, cleaner_names: Union[str, Sequence[str]] = "korean_cleaners"):
        if isinstance(cleaner_names, str):
            cleaner_names = [x.strip() for x in cleaner_names.split(",")]
        self.cleaner_names = list(cleaner_names)
        language = "english" if "english_cleaners" in self.cleaner_names else "korean"
        self.symbols = symbol_table(language)
        self.symbol_to_id = {s: i for i, s in enumerate(self.symbols)}
        self.id_to_symbol = {i: s for i, s in enumerate(self.symbols)}

    @property
    def vocab_size(self) -> int:
        return len(self.symbols)

    def _clean(self, text: str):
        for name in self.cleaner_names:
            text = get_cleaner(name)(text)
        return text

    def _symbols_to_ids(self, syms) -> List[int]:
        # PAD/EOS in cleaned text are dropped; EOS is appended exactly once at
        # the end (reference text/__init__.py:114-123,70).
        return [self.symbol_to_id[s] for s in syms
                if s in self.symbol_to_id and s not in (PAD, EOS)]

    def _arpabet_to_ids(self, text: str) -> List[int]:
        return [self.symbol_to_id[s] for s in ("@" + t for t in text.split())
                if s in self.symbol_to_id]

    def encode(self, text: str, as_token: bool = False):
        sequence: List[int] = []
        while len(text):
            m = _curly_re.match(text)
            if not m:
                sequence += self._symbols_to_ids(self._clean(text))
                break
            sequence += self._symbols_to_ids(self._clean(m.group(1)))
            sequence += self._arpabet_to_ids(m.group(2))
            text = m.group(3)
        sequence.append(self.symbol_to_id[EOS])
        if as_token:
            return self.decode(sequence, combine_jamo=True)
        return np.asarray(sequence, dtype=np.int32)

    def decode(self, sequence, skip_eos_and_pad: bool = False,
               combine_jamo: bool = False) -> str:
        result = ""
        for sid in np.asarray(sequence).tolist():
            s = self.id_to_symbol.get(int(sid))
            if s is None:
                continue
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            if not skip_eos_and_pad or s not in (EOS, PAD):
                result += s
        result = result.replace("}{", " ")
        if combine_jamo:
            return jamo_to_korean(result)
        return result


_default_codec = None


def _get_default(cleaners: str = "korean_cleaners") -> TextCodec:
    global _default_codec
    if _default_codec is None or _default_codec.cleaner_names != [
            x.strip() for x in cleaners.split(",")]:
        _default_codec = TextCodec(cleaners)
    return _default_codec


def text_to_sequence(text: str, cleaners: str = "korean_cleaners",
                     as_token: bool = False):
    """Functional convenience wrapper over :class:`TextCodec`."""
    return _get_default(cleaners).encode(text, as_token=as_token)


def sequence_to_text(sequence, cleaners: str = "korean_cleaners",
                     skip_eos_and_pad: bool = False,
                     combine_jamo: bool = False) -> str:
    return _get_default(cleaners).decode(
        sequence, skip_eos_and_pad=skip_eos_and_pad, combine_jamo=combine_jamo)
