"""English normalization: ASCII transliteration and number verbalization.

Covers what reference text/en_numbers.py:1-69 and text/cleaners.py:34-100 do,
without the inflect/unidecode dependencies: an integer/ordinal/currency
verbalizer is implemented from scratch.
"""
from __future__ import annotations

import re
import unicodedata

_UNITS = ["zero", "one", "two", "three", "four", "five", "six", "seven",
          "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
          "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
           (10 ** 3, "thousand"), (100, "hundred")]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _UNITS[n]
    tens, unit = divmod(n, 10)
    return _TENS[tens] + ("-" + _UNITS[unit] if unit else "")


def number_to_words(n: int) -> str:
    """Integer -> English words, no 'and' (inflect andword='' behavior)."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 100:
        return _two_digits(n)
    for scale, name in _SCALES:
        if n >= scale:
            head, rest = divmod(n, scale)
            out = number_to_words(head) + " " + name
            if rest:
                out += " " + number_to_words(rest)
            return out
    return _two_digits(n)


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ") if " " in words else ("", "", words)
    if "-" in last:
        tens, _, unit = last.partition("-")
        last = tens + "-" + _ordinalize_word(unit)
    else:
        last = _ordinalize_word(last)
    return (head + " " + last).strip()


def _ordinalize_word(w: str) -> str:
    if w in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[w]
    if w.endswith("y"):
        return w[:-1] + "ieth"
    return w + "th"


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"([0-9]+)(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1).replace(",", "")
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        return "%s %s, %s %s" % (
            dollars, "dollar" if dollars == 1 else "dollars",
            cents, "cent" if cents == 1 else "cents")
    if dollars:
        return "%s %s" % (dollars, "dollar" if dollars == 1 else "dollars")
    if cents:
        return "%s %s" % (cents, "cent" if cents == 1 else "cents")
    return "zero dollars"


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    # Year-style reading for 1000 < n < 3000 (reference en_numbers.py:46-57).
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        head, tail = divmod(num, 100)
        tail_words = "oh " + _UNITS[tail] if 0 < tail < 10 else _two_digits(tail)
        return _two_digits(head) + " " + tail_words
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(
        lambda m: m.group(1).replace(".", " point "), text)
    text = _ordinal_re.sub(lambda m: ordinal_to_words(int(m.group(1))), text)
    text = _number_re.sub(_expand_number, text)
    return text


def to_ascii(text: str) -> str:
    """Transliterate to ASCII by stripping diacritics (unidecode stand-in)."""
    decomposed = unicodedata.normalize("NFKD", text)
    return "".join(c for c in decomposed if ord(c) < 128)
