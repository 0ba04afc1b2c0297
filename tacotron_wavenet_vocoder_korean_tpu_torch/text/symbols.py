"""Model symbol tables (reference: text/korean.py:12-25, text/symbols.py:14-16).

Korean table (80 symbols): PAD `_`, EOS `~`, 19 jamo leads, 21 vowels, 27
tails, punctuation, space.  PAD must stay at id 0 (its embedding row is pinned
to zero, reference tacotron/tacotron.py:53-56) and EOS at id 1.
"""
from .hangul import JAMO_LEADS, JAMO_VOWELS, JAMO_TAILS

PAD = "_"
EOS = "~"
PUNCTUATION = "!'(),-.:;?"
SPACE = " "

VALID_CHARS = JAMO_LEADS + JAMO_VOWELS + JAMO_TAILS + PUNCTUATION + SPACE
KOREAN_SYMBOLS = PAD + EOS + VALID_CHARS

ENGLISH_SYMBOLS = (
    PAD + EOS
    + "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
    + PUNCTUATION + SPACE
)

# Default table; the codec can be built for either language explicitly.
symbols = KOREAN_SYMBOLS

PAD_ID = 0
EOS_ID = 1


def symbol_table(language: str = "korean"):
    if language in ("korean", "ko"):
        return KOREAN_SYMBOLS
    if language in ("english", "en"):
        return ENGLISH_SYMBOLS
    raise ValueError(f"unknown language: {language}")
