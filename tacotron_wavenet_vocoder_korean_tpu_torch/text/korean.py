"""Korean text normalization and jamo tokenization.

Pipeline parity with reference text/korean.py:140-308 — date/hanja stripping,
dictionary substitution, English handling, uppercase spelling, quote
normalization, and Sino/native-Korean number verbalization — reimplemented
without the jamo/nltk dependencies.  Golden cases from the reference's inline
harness (text/korean.py:316-322) live in tests/test_text.py.
"""
from __future__ import annotations

import re
from typing import List

from .hangul import hangul_to_jamo, jamo_to_korean  # re-export jamo_to_korean
from .symbols import EOS, KOREAN_SYMBOLS
from .dictionary import (
    ETC_DICTIONARY,
    ENGLISH_DICTIONARY,
    UPPER_TO_KOR,
    UNIT_TO_KOR_PRIMARY,
    UNIT_TO_KOR_SECONDARY,
)

_char_to_id = {c: i for i, c in enumerate(KOREAN_SYMBOLS)}
_id_to_char = {i: c for i, c in enumerate(KOREAN_SYMBOLS)}

# (13일)-style parenthesized dates and parenthesized hanja runs are dropped
# (reference text/korean.py:156-157).
_DATE_PAREN_RE = re.compile(r"\(\d+일\)")
_HANJA_PAREN_RE = re.compile(
    "\\([⺀-⺙⺛-⻳⼀-⿕々〇〡-〩〸-〺〻㐀-䶵一-鿃豈-鶴侮-頻並-龎]+\\)")

_QUOTE_RE = re.compile("""([`"'＂“‘])(.+?)([`"'＂”’])""")
_SENTENCE_SPLIT_RE = re.compile(r"(?<=[.!?])\s+")

NUMBER_PATTERN = r"([+-]?\d[\d,]*)[\.]?\d*"
COUNTER_PATTERN = (
    r"(시|명|가지|살|마리|포기|송이|수|톨|통|점|개|벌|척|채|다발|그루|자루|줄|"
    r"켤레|그릇|잔|마디|상자|사람|곡|병|판)"
)

DIGIT_TO_KOR = dict(zip("0123456789", "영일이삼사오육칠팔구"))
SINO_DIGITS = [""] + list("일이삼사오육칠팔구")
MYRIAD_UNITS = [""] + list("만억조경해")
SMALL_UNITS = [""] + list("십백천")
NATIVE_COUNT_DIGITS = [""] + ["한", "두", "세", "네", "다섯", "여섯", "일곱",
                              "여덟", "아홉"]
NATIVE_TENS = {
    "십": "열", "두십": "스물", "세십": "서른", "네십": "마흔",
    "다섯십": "쉰", "여섯십": "예순", "일곱십": "일흔", "여덟십": "여든",
    "아홉십": "아흔",
}


def _sub_dictionary(text: str, table: dict) -> str:
    """Longest-key-first literal substitution (reference korean.py:168-173)."""
    if not any(key in text for key in table):
        return text
    pattern = re.compile("|".join(
        re.escape(k) for k in sorted(table, key=len, reverse=True)))
    return pattern.sub(lambda m: table[m.group()], text)


_ENGLISH_PHRASES = {k: v for k in ENGLISH_DICTIONARY
                    if not re.fullmatch(r"[A-Za-z]+", k)
                    for v in [ENGLISH_DICTIONARY[k]]}


def _substitute_english_words(text: str) -> str:
    """Replace known English words with their Korean reading
    (reference korean.py:175-184).

    Deliberate fix over the reference: its multi-word english_dictionary
    entries ('Prime Minister', 'Pick me up', ...) can never match its
    single-token ``[A-Za-z]+`` regex, so they are dead data there.  Here the
    phrase entries are literal-substituted (longest first) before the
    per-word pass, making them functional."""
    if _ENGLISH_PHRASES:
        text = _sub_dictionary(text, _ENGLISH_PHRASES)

    def repl(m: re.Match) -> str:
        return ENGLISH_DICTIONARY.get(m.group(), m.group())
    return re.sub(r"[A-Za-z]+", repl, text)


def _spell_uppercase(text: str) -> str:
    """Spell an all-uppercase run letter-by-letter
    (reference korean.py:186-192)."""
    def repl(m: re.Match) -> str:
        word = m.group(0)
        if word.isupper():
            return "".join(UPPER_TO_KOR[c] for c in word)
        return word
    return re.sub(r"[a-zA-Z]+", repl, text)


def _split_sentences(text: str) -> List[str]:
    """Light sentence splitter standing in for nltk.sent_tokenize
    (reference korean.py:196-201)."""
    parts = [p for p in _SENTENCE_SPLIT_RE.split(text.strip()) if p]
    return parts or [text]


def _normalize_quotes(text: str) -> str:
    """Unify quote characters and split quoted multi-sentence spans
    (reference korean.py:194-204)."""
    def repl(m: re.Match) -> str:
        inner = m.group(0)[1:-1]
        return " ".join(f"'{s}'" for s in _split_sentences(inner))
    return _QUOTE_RE.sub(repl, text)


def number_to_korean(num_str: str, unit_str: str = "", is_count: bool = False) -> str:
    """Verbalize one number: Sino-Korean digits, or native count words when a
    counter follows (reference korean.py:239-308).

    ``num_str`` may carry a sign, commas, and a decimal part.
    """
    num_str = num_str.replace(",", "")
    if float(num_str) == 0:
        return "영" + unit_str

    parts = num_str.split(".")
    if len(parts) > 2:
        raise ValueError(f"malformed number: {num_str!r}")
    digit_str = parts[0]
    float_str = parts[1] if len(parts) == 2 else None
    if is_count and float_str is not None:
        raise ValueError("count numbers cannot be fractional")

    negative = digit_str.startswith("-")
    positive = digit_str.startswith("+")
    digit_str = digit_str.lstrip("+-")

    size = len(digit_str)
    kor = ""
    group: List[str] = []
    for i, ch in enumerate(digit_str, start=1):
        v = int(ch)
        if v != 0:
            group.append(NATIVE_COUNT_DIGITS[v] if is_count else SINO_DIGITS[v])
            group.append(SMALL_UNITS[(size - i) % 4])
        if (size - i) % 4 == 0 and group:
            kor += "".join(group)
            group = []
            kor += MYRIAD_UNITS[(size - i) // 4]

    if is_count:
        # '한십' -> '십', then native tens words: '두십'->'스물' etc.
        if kor.startswith("한") and len(kor) > 1:
            kor = kor[1:]
        if any(w in kor for w in NATIVE_TENS):
            kor = re.sub("|".join(NATIVE_TENS), lambda m: NATIVE_TENS[m.group()], kor)
    elif kor.startswith("일") and len(kor) > 1:
        kor = kor[1:]

    if float_str is not None:
        kor += "쩜 "
        kor += "".join(DIGIT_TO_KOR[c] for c in float_str)

    if positive:
        kor = "플러스 " + kor
    elif negative:
        kor = "마이너스 " + kor

    return kor + unit_str


def normalize_numbers(text: str) -> str:
    """Units then counted then bare numbers (reference korean.py:209-216)."""
    text = _sub_dictionary(text, UNIT_TO_KOR_PRIMARY)
    text = _sub_dictionary(text, UNIT_TO_KOR_SECONDARY)
    text = re.sub(
        NUMBER_PATTERN + COUNTER_PATTERN,
        lambda m: number_to_korean(m.group(1), m.group(2), is_count=True),
        text)
    text = re.sub(
        NUMBER_PATTERN,
        lambda m: number_to_korean(m.group(), is_count=False),
        text)
    return text


def normalize(text: str) -> str:
    """Full normalization pipeline (reference korean.py:153-166)."""
    text = text.strip()
    text = _DATE_PAREN_RE.sub("", text)
    text = _HANJA_PAREN_RE.sub("", text)
    text = _sub_dictionary(text, ETC_DICTIONARY)
    text = _substitute_english_words(text)
    text = _spell_uppercase(text)
    text = _normalize_quotes(text)
    text = normalize_numbers(text)
    return text


def tokenize(text: str, as_id: bool = False):
    """normalize -> jamo stream -> append EOS (reference korean.py:140-148)."""
    tokens = hangul_to_jamo(normalize(text))
    if as_id:
        return [_char_to_id[t] for t in tokens] + [_char_to_id[EOS]]
    return list(tokens) + [EOS]
