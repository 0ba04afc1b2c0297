"""Substitution dictionaries for Korean text normalization.

Role matches reference text/ko_dictionary.py (etc_dictionary /
english_dictionary), but the tables here are curated rather than copied: plain
all-uppercase acronyms (JTBC, CNN, ...) do NOT need dictionary entries because
the normalizer's uppercase rule (korean.py `spell_uppercase`) already spells
them letter-by-letter.  Only words whose Korean reading is *not* a
letter-by-letter spelling are listed.
"""

# Ad-hoc phrase fixes applied before anything else
# (role of reference text/ko_dictionary.py:3-9).
ETC_DICTIONARY = {
    "2 30대": "이삼십대",
    "20~30대": "이삼십대",
    "20, 30대": "이십대 삼십대",
    "1+1": "원플러스원",
    "3에서 6개월인": "3개월에서 육개월인",
}

# English word -> Korean pronunciation, for words that are read as words
# (not spelled out).  Role of reference text/ko_dictionary.py:11-174.
ENGLISH_DICTIONARY = {
    # proper nouns / brand readings
    "KIA": "기아",
    "CAT": "캣",
    "KOREA": "코리아",
    "Santa": "산타",
    "francisco": "프란시스코",
    "Chaebol": "채벌",
    "Halmuny": "하모니",
    # common words
    "idol": "아이돌",
    "track": "트랙",
    "down": "다운",
    "up": "업",
    "bill": "빌",
    "shy": "",
    "ability": "어빌리티",
    "apology": "어폴로지",
    "humble": "험블",
    "Denial": "디나이얼",
    "Devsisters": "데브시스터즈",
    # single letters with non-default readings used by the corpora
    "N": "앤",
    "Z": "제트",
    "BC": "삐씨",
    "NO": "엔오",
    "STOP": "스탑",
    "PRESS": "프레스",
    # multi-word phrases kept for corpus parity
    "Prime Minister": "프라임 미니스터",
    "No joke": "노 조크",
    "Pick me up": "픽 미 업",
    "not to be": "낫 투비",
    "who are you": "후 얼 유",
    "so sorry": "쏘 쏘리",
    "I love America": "아이 러브 아메리카",
    "The Tenth Man": "더 텐쓰 맨",
    "the tenth man": "더 텐쓰 맨",
    "Nowhere Man": "노웨어 맨",
    "Big Endian": "빅 엔디안",
    "Small Endian": "스몰 엔디안",
    "Oh Captain My Captain": "오 캡틴 마이 캡틴",
    "Reflecting Absence": "리플렉팅 앱센스",
    "Swordline": "스워드라인",
    "Time flies like an arrow": "타임 플라이즈 라이크 언 애로우",
    "Content Attitude Timing": "컨텐트 애티튜드 타이밍",
    "trickle down effect": "트리클 다운 이펙트",
    "trickle up effect": "트리클 업 이펙트",
    "negative pressure": "네거티브 프레셔",
    "Drum being beaten by everyone": "드럼 빙 비튼 바이 에브리원",
    "The Devils Advocate": "더 데빌즈 어드보카트",
    "it was our sky": "잇 워즈 아워 스카이",
    "it is our sky": "잇 이즈 아워 스카이",
    "t worry be happy": " 워리 비 해피",
    "Don": "",
    "Que sais-je": "",
    "Rashomon Effect": "",
    "WHERETHEWILDTHINGSARE": "",
    "YSDJJPMB": "",
    # Common loanwords read as words (standard Korean transliterations), in
    # the broadcast/news register of the bundled corpora.  Curated breadth
    # matching the role of reference ko_dictionary.py:11-174 (that table's
    # long tail is corpus-specific; this one covers general news vocabulary).
    "news": "뉴스",
    "News": "뉴스",
    "anchor": "앵커",
    "camera": "카메라",
    "computer": "컴퓨터",
    "internet": "인터넷",
    "Internet": "인터넷",
    "smartphone": "스마트폰",
    "system": "시스템",
    "service": "서비스",
    "center": "센터",
    "energy": "에너지",
    "campaign": "캠페인",
    "brand": "브랜드",
    "design": "디자인",
    "digital": "디지털",
    "data": "데이터",
    "program": "프로그램",
    "project": "프로젝트",
    "team": "팀",
    "leader": "리더",
    "member": "멤버",
    "fan": "팬",
    "star": "스타",
    "drama": "드라마",
    "music": "뮤직",
    "concert": "콘서트",
    "festival": "페스티벌",
    "event": "이벤트",
    "interview": "인터뷰",
    "message": "메시지",
    "best": "베스트",
    "top": "탑",
    "one": "원",
    "two": "투",
    "three": "쓰리",
    "good": "굿",
    "happy": "해피",
    "love": "러브",
    "game": "게임",
    "goal": "골",
    "pass": "패스",
    "sports": "스포츠",
    "Olympic": "올림픽",
    "olympic": "올림픽",
    "World Cup": "월드컵",
    "Christmas": "크리스마스",
    "chocolate": "초콜릿",
    "coffee": "커피",
    "juice": "주스",
    "banana": "바나나",
    "orange": "오렌지",
    "hotel": "호텔",
    "taxi": "택시",
    "bus": "버스",
    "radio": "라디오",
    "television": "텔레비전",
    "piano": "피아노",
    "guitar": "기타",
}

# Uppercase letter -> Korean letter name (reference text/korean.py:108-135).
UPPER_TO_KOR = {
    "A": "에이", "B": "비", "C": "씨", "D": "디", "E": "이", "F": "에프",
    "G": "지", "H": "에이치", "I": "아이", "J": "제이", "K": "케이",
    "L": "엘", "M": "엠", "N": "엔", "O": "오", "P": "피", "Q": "큐",
    "R": "알", "S": "에스", "T": "티", "U": "유", "V": "브이",
    "W": "더블유", "X": "엑스", "Y": "와이", "Z": "지",
}

# Measurement units (reference text/korean.py:97-106); longer keys first.
UNIT_TO_KOR_PRIMARY = {
    "%": "퍼센트",
    "cm": "센치미터",
    "mm": "밀리미터",
    "km": "킬로미터",
    "kg": "킬로그람",
}
UNIT_TO_KOR_SECONDARY = {
    "m": "미터",
}
