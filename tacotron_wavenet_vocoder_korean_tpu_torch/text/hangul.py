"""Hangul <-> jamo conversion from first principles (pure Unicode arithmetic).

Replaces the external ``jamo`` package the reference depends on
(reference: text/korean.py:8 imports hangul_to_jamo/h2j/j2h).  A precomposed
Hangul syllable U+AC00..U+D7A3 decomposes as::

    code - 0xAC00 == (lead * 21 + vowel) * 28 + tail

with 19 leads (U+1100..U+1112), 21 vowels (U+1161..U+1175) and 27 tails
(U+11A8..U+11C2, tail index 0 meaning "no tail").
"""
from __future__ import annotations

from typing import Iterable, List, Optional

SYLLABLE_BASE = 0xAC00
SYLLABLE_END = 0xD7A3
LEAD_BASE = 0x1100
VOWEL_BASE = 0x1161
TAIL_BASE = 0x11A8   # tail index 1 maps here
NUM_VOWELS = 21
NUM_TAILS = 28       # including "no tail" at index 0

JAMO_LEADS = "".join(chr(LEAD_BASE + i) for i in range(19))
JAMO_VOWELS = "".join(chr(VOWEL_BASE + i) for i in range(NUM_VOWELS))
JAMO_TAILS = "".join(chr(TAIL_BASE + i) for i in range(NUM_TAILS - 1))

# Compatibility jamo (U+3131..) used when displaying an isolated lead/vowel/tail.
_LEAD_TO_HCJ = "ㄱㄲㄴㄷㄸㄹㅁㅂㅃㅅㅆㅇㅈㅉㅊㅋㅌㅍㅎ"
_VOWEL_TO_HCJ = "ㅏㅐㅑㅒㅓㅔㅕㅖㅗㅘㅙㅚㅛㅜㅝㅞㅟㅠㅡㅢㅣ"
_TAIL_TO_HCJ = "ㄱㄲㄳㄴㄵㄶㄷㄹㄺㄻㄼㄽㄾㄿㅀㅁㅂㅄㅅㅆㅇㅈㅊㅋㅌㅍㅎ"


def is_hangul_syllable(ch: str) -> bool:
    return SYLLABLE_BASE <= ord(ch) <= SYLLABLE_END


def is_lead(ch: str) -> bool:
    return LEAD_BASE <= ord(ch) < LEAD_BASE + 19


def is_vowel(ch: str) -> bool:
    return VOWEL_BASE <= ord(ch) < VOWEL_BASE + NUM_VOWELS


def is_tail(ch: str) -> bool:
    return TAIL_BASE <= ord(ch) < TAIL_BASE + NUM_TAILS - 1


def decompose_syllable(ch: str) -> str:
    """One precomposed syllable -> its 2-3 conjoining jamo."""
    offset = ord(ch) - SYLLABLE_BASE
    lead, rem = divmod(offset, NUM_VOWELS * NUM_TAILS)
    vowel, tail = divmod(rem, NUM_TAILS)
    out = chr(LEAD_BASE + lead) + chr(VOWEL_BASE + vowel)
    if tail:
        out += chr(TAIL_BASE + tail - 1)
    return out


def hangul_to_jamo(text: Iterable[str]) -> List[str]:
    """Decompose every precomposed syllable; pass other chars through.

    Matches the behavior of ``jamo.hangul_to_jamo`` as used at
    reference text/korean.py:143.
    """
    out: List[str] = []
    for ch in text:
        if is_hangul_syllable(ch):
            out.extend(decompose_syllable(ch))
        else:
            out.append(ch)
    return out


def h2j(text: str) -> str:
    """String form of :func:`hangul_to_jamo` (reference's jamo.h2j)."""
    return "".join(hangul_to_jamo(text))


def compose_syllable(lead: str, vowel: str, tail: Optional[str] = None) -> str:
    """Conjoining jamo -> one precomposed syllable (reference's jamo.j2h)."""
    li = ord(lead) - LEAD_BASE
    vi = ord(vowel) - VOWEL_BASE
    ti = (ord(tail) - TAIL_BASE + 1) if tail else 0
    if not (0 <= li < 19 and 0 <= vi < NUM_VOWELS and 0 <= ti < NUM_TAILS):
        raise ValueError(f"not a composable jamo triple: {lead!r},{vowel!r},{tail!r}")
    return chr(SYLLABLE_BASE + (li * NUM_VOWELS + vi) * NUM_TAILS + ti)


def jamo_char_to_hcj(ch: str) -> str:
    """Isolated conjoining jamo -> compatibility jamo for display."""
    o = ord(ch)
    if is_lead(ch):
        return _LEAD_TO_HCJ[o - LEAD_BASE]
    if is_vowel(ch):
        return _VOWEL_TO_HCJ[o - VOWEL_BASE]
    if is_tail(ch):
        return _TAIL_TO_HCJ[o - TAIL_BASE]
    return ch


def jamo_to_korean(text: str) -> str:
    """Greedy recomposition of a jamo stream back into syllables.

    Mirrors the semantics of reference text/korean.py:56-82: accumulate
    (lead, vowel, tail) candidates; flush on a new lead or a non-jamo char.
    """
    stream = h2j(text)
    out: List[str] = []
    candidates: List[str] = []

    def flush():
        if not candidates:
            return
        if len(candidates) == 1:
            out.append(jamo_char_to_hcj(candidates[0]))
        else:
            out.append(compose_syllable(*candidates[:3]))
        candidates.clear()

    for ch in stream:
        if is_lead(ch):
            flush()
            candidates.append(ch)
        elif is_vowel(ch) or is_tail(ch):
            candidates.append(ch)
        else:
            flush()
            out.append(ch)
    flush()
    return "".join(out)
