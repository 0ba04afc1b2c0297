"""Cleaner pipelines selectable by name (reference: text/cleaners.py:27-100)."""
from __future__ import annotations

import re

from .korean import tokenize as _korean_tokenize
from .english import normalize_numbers, to_ascii

_whitespace_re = re.compile(r"\s+")

_ABBREVIATIONS = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), full) for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"),
        ("st", "saint"), ("co", "company"), ("jr", "junior"),
        ("maj", "major"), ("gen", "general"), ("drs", "doctors"),
        ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
        ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
        ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _ABBREVIATIONS:
        text = regex.sub(replacement, text)
    return text


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


def korean_cleaners(text: str):
    """Korean pipeline: normalize + jamo decomposition; returns a token list
    ending with EOS (reference cleaners.py:27-30)."""
    return _korean_tokenize(text)


def english_cleaners(text: str) -> str:
    text = to_ascii(text)
    text = lowercase(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(to_ascii(text)))


CLEANERS = {
    "korean_cleaners": korean_cleaners,
    "english_cleaners": english_cleaners,
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
}


def get_cleaner(name: str):
    if name not in CLEANERS:
        raise KeyError(f"unknown cleaner: {name}")
    return CLEANERS[name]
