# -*- coding: utf-8 -*-
"""PyTorch port: its own copy of the Korean text frontend against the JAX
package's (ids and decoded text equal, exactly)."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from tacotron_wavenet_vocoder_korean_tpu import text as JT
from tacotron_wavenet_vocoder_korean_tpu.text import hangul as JH
from tacotron_wavenet_vocoder_korean_tpu.text import korean as JK
from tacotron_wavenet_vocoder_korean_tpu.text import symbols as JS
from tacotron_wavenet_vocoder_korean_tpu_torch import text as PT
from tacotron_wavenet_vocoder_korean_tpu_torch.text import hangul as PH
from tacotron_wavenet_vocoder_korean_tpu_torch.text import korean as PK
from tacotron_wavenet_vocoder_korean_tpu_torch.text import symbols as PS

# The golden strings of tests/test_text.py, and mixed Korean / digit /
# English sentences.
SENTENCES = [
    "존경하는 국민 여러분",
    "안녕하세요",
    "JTBC는 JTBCs를 DY는 A가 Absolute",
    "오늘(13일) 3,600마리 강아지가",
    "60.3%",
    '"저돌"(猪突) 입니다.',
    "지금은 -12.35%였고 종류는 5가지와 19가지, 그리고 55가지였다",
    "JTBC는 TH와 K 양이 2017년 9월 12일 오후 12시에 24살이 된다",
    '비대위원장이 “난 간다. 너도 간다” 했다',
    "그는 Prime Minister 라고 했다",
    "노래 Pick me up 는",
    "0.5",
    "2 30대와 20~30대, 1+1 행사",
    "KIA 공장에서 CAT 3대와 KOREA 팀 news",
    "15km를 2시간 30분에 달렸고 체중은 70kg, 키는 180cm다.",
    "제 2회 서울 Festival에 10만 명이 모였습니다!",
    "Hello World 12!",
    "그녀는 'Time flies like an arrow'라고 말했다.",
    "{HH AH0 L OW1} 안녕",
]


def test_symbol_tables_equal():
    assert PS.KOREAN_SYMBOLS == JS.KOREAN_SYMBOLS
    assert PS.ENGLISH_SYMBOLS == JS.ENGLISH_SYMBOLS
    assert (PS.PAD_ID, PS.EOS_ID) == (JS.PAD_ID, JS.EOS_ID) == (0, 1)


def test_golden_ids():
    """'존경하는' encodes to ids starting [14, 29, 45, 2, 27, 62, ...]."""
    ids = PT.text_to_sequence("존경하는")
    assert ids.dtype == np.int32
    assert ids[:6].tolist() == [14, 29, 45, 2, 27, 62]
    assert ids.tolist() == JT.text_to_sequence("존경하는").tolist()


@pytest.mark.parametrize("text", SENTENCES)
@pytest.mark.parametrize("cleaners", ["korean_cleaners", "english_cleaners"])
def test_codec_matches_jax(text, cleaners):
    port, ref = PT.TextCodec(cleaners), JT.TextCodec(cleaners)
    assert port.vocab_size == ref.vocab_size
    ids = port.encode(text)
    np.testing.assert_array_equal(ids, ref.encode(text))
    assert port.encode(text, as_token=True) == ref.encode(text, as_token=True)
    for skip in (False, True):
        for combine in (False, True):
            assert (port.decode(ids, skip_eos_and_pad=skip,
                                combine_jamo=combine)
                    == ref.decode(ids, skip_eos_and_pad=skip,
                                  combine_jamo=combine))


@pytest.mark.parametrize("text", SENTENCES[:9])
def test_normalize_matches_jax(text):
    assert PK.normalize(text) == JK.normalize(text)
    assert PK.tokenize(text) == JK.tokenize(text)


def test_reference_quirks_kept():
    assert PK.normalize("0.5") == "쩜 오"
    assert PK.number_to_korean("20", "살", is_count=True) == "스물살"
    assert PT.sequence_to_text(PT.text_to_sequence("존경하는 국민 여러분"),
                               skip_eos_and_pad=True,
                               combine_jamo=True) == "존경하는 국민 여러분"


_hangul = st.characters(min_codepoint=0xAC00, max_codepoint=0xD7A3)
_other = st.sampled_from(list(" .,!?'-0123456789") + ["A", "b", "Z"])


@settings(max_examples=200, deadline=None, database=None, derandomize=True)
@given(st.text(st.one_of(_hangul, _hangul, _other), min_size=1, max_size=24))
def test_codec_matches_jax_on_drawn_hangul(text):
    """Hypothesis-drawn Hangul strings (with punctuation, digits and a few
    Latin letters): encode ids equal, decode equal, jamo round trip equal."""
    port, ref = PT.TextCodec(), JT.TextCodec()
    ids = port.encode(text)
    np.testing.assert_array_equal(ids, ref.encode(text))
    assert port.decode(ids, combine_jamo=True) == ref.decode(
        ids, combine_jamo=True)
    assert PH.h2j(text) == JH.h2j(text)
    assert PH.jamo_to_korean(PH.h2j(text)) == JH.jamo_to_korean(JH.h2j(text))
    assert [PH.jamo_char_to_hcj(c) for c in PH.h2j(text)] == [
        JH.jamo_char_to_hcj(c) for c in JH.h2j(text)]
