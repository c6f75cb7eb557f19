"""Pure-Python English grapheme->IPA fallback (no espeak binary required).

The port's own copy of unitspeech_tpu/text/g2p.py (pure Python, no JAX), kept
equal to it by tests/test_torch_port_text.py.

The reference's text frontend shells into espeak-ng via the `phonemizer`
package (the reference's util.py:154-172); this repo wraps the
same binary (text/__init__.py). On air-gapped hosts where espeak-ng cannot
be installed, raw-text entry points were previously unusable (IPA input
only). This module provides a self-contained rule-based G2P so `--text`
CLI synthesis and the serving daemon's `"text"` field keep working
everywhere.

Algorithm: the public-domain NRL letter-to-sound rules (Elovitz, Johnson,
McHugh, Shore & Zue, "Automatic Translation of English Text to Phonetics
by Means of Letter-to-Sound Rules", NRL Report 7948, 1976) — ~330
context-sensitive rules of the form `left [letters] right -> phones`,
first match wins — composed with:

  * a small lexicon of high-frequency irregular words the rules mispredict
    (the NRL report itself recommends an exceptions dictionary),
  * integer/decimal/ordinal number expansion,
  * a deterministic ARPAbet -> espeak-flavored-IPA mapping whose output
    alphabet is a strict subset of text/symbols.py (locked by test),
  * primary-stress placement before the first vowel of content words
    (function words stay unstressed, like espeak's output).

DOCUMENTED DIVERGENCE vs espeak-ng: this is a fallback, not a parity
implementation. Rule-based G2P mispredicts a tail of English words
(espeak carries a large built-in lexicon), stress placement is first-vowel
only (espeak syllabifies), and secondary stress / vowel reduction are
approximated. Checkpoints trained on espeak phonemization should prefer
the espeak frontend when the binary exists; `get_phonemizer` only falls
back here when it does not.
"""

from __future__ import annotations

import re
from typing import List, Sequence

_VOWELS = frozenset("AEIOUY")
_CONSONANTS = frozenset("BCDFGHJKLMNPQRSTVWXZ")
_VOICED = frozenset("BDVGJLMNRWZ")
_FRONT = frozenset("EIY")
_SIBILANT1 = frozenset("SCGZXJ")  # '&' single letters (plus CH/SH digraphs)
_UINFL1 = frozenset("TSRDLZNJ")  # '@' single letters (plus TH/CH/SH digraphs)
# '%' suffix alternatives, longest first so "E" can't shadow "ELY"/"ED"/...
_SUFFIXES = ("ELY", "ING", "ER", "ES", "ED", "E")

# ---------------------------------------------------------------------------
# NRL rule table. Per first letter: (left, letters, right, ARPAbet phones).
# Notation (NRL Report 7948 §2): '#' one or more vowels, ':' zero or more
# consonants, '^' one consonant, '.' one voiced consonant, '+' one front
# vowel (e/i/y), '%' one of the suffixes above, '&' a sibilant, '@' a
# t/s/r/d/l/z/n/j (+ th/ch/sh) sound, ' ' a word boundary. First match wins;
# every letter ends in a bare default rule so scanning always advances.
# ---------------------------------------------------------------------------

_R = {
    "A": [
        (" ", "A", " ", "AX"),
        (" ", "ARE", " ", "AA R"),
        (" ", "AR", "O", "AX R"),
        ("", "AR", "#", "EH R"),
        (" ^", "AS", "#", "EY S"),
        ("", "A", "WA", "AX"),
        ("", "AW", "", "AO"),
        (" :", "ANY", "", "EH N IY"),
        ("", "A", "^+#", "EY"),
        ("#:", "ALLY", "", "AX L IY-"),
        (" ", "AL", "#", "AX L"),
        ("", "AGAIN", "", "AX G EH N"),
        ("#:", "AG", "E", "IH JH"),
        ("", "A", "^+:#", "AE"),
        (" :", "A", "^+ ", "EY"),
        ("", "A", "^%", "EY"),
        (" ", "ARR", "", "AX R"),
        ("", "ARR", "", "AE R"),
        (" :", "AR", " ", "AA R"),
        ("", "AR", " ", "ER"),
        ("", "AR", "", "AA R"),
        ("", "AIR", "", "EH R"),
        ("", "AI", "", "EY"),
        ("", "AY", "", "EY"),
        ("", "AU", "", "AO"),
        ("#:", "AL", " ", "AX L"),
        ("#:", "ALS", " ", "AX L Z"),
        ("", "ALK", "", "AO K"),
        ("", "AL", "^", "AO L"),
        (" :", "ABLE", "", "EY B AX L"),
        ("", "ABLE", "", "AX B AX L"),
        (" ", "A", "^#", "AX"),
        ("", "ANG", "+", "EY N JH"),
        ("", "A", "", "AE"),
    ],
    "B": [
        (" ", "BE", "^#", "B IH"),
        ("", "BEING", "", "B IY IH NG"),
        (" ", "BOTH", " ", "B OW TH"),
        (" ", "BUS", "#", "B IH Z"),
        ("", "BUIL", "", "B IH L"),
        ("", "B", "", "B"),
    ],
    "C": [
        (" ", "CH", "^", "K"),
        ("^E", "CH", "", "K"),
        ("", "CH", "", "CH"),
        (" S", "CI", "#", "S AY"),
        ("", "CI", "A", "SH"),
        ("", "CI", "O", "SH"),
        ("", "CI", "EN", "SH"),
        ("", "C", "+", "S"),
        ("", "CK", "", "K"),
        ("", "COM", "%", "K AH M"),
        ("", "C", "", "K"),
    ],
    "D": [
        ("#:", "DED", " ", "D IH D"),
        (".E", "D", " ", "D"),
        ("#^:E", "D", " ", "T"),
        (" ", "DE", "^#", "D IH"),
        (" ", "DO", " ", "D UW"),
        (" ", "DOES", "", "D AH Z"),
        (" ", "DOING", "", "D UW IH NG"),
        (" ", "DOW", "", "D AW"),
        ("", "DG", "", "JH"),
        ("", "DU", "A", "JH UW"),
        ("", "D", "", "D"),
    ],
    "E": [
        ("#:", "E", " ", ""),
        ("'^:", "E", " ", ""),
        (" :", "E", " ", "IY"),
        ("#", "ED", " ", "D"),
        ("#:", "E", "D ", ""),
        ("", "EV", "ER", "EH V"),
        ("", "E", "^%", "IY"),
        ("", "ERI", "#", "IY R IY"),
        ("", "ERI", "", "EH R IH"),
        ("#:", "ER", "#", "ER"),
        ("", "ER", "#", "EH R"),
        ("", "ER", "", "ER"),
        (" ", "EVEN", "", "IY V EH N"),
        ("#:", "E", "W", ""),
        ("@", "EW", "", "UW"),
        ("", "EW", "", "Y UW"),
        ("", "E", "O", "IY"),
        ("#:&", "ES", " ", "IH Z"),
        ("#:", "E", "S ", ""),
        ("#:", "ELY", " ", "L IY-"),
        ("#:", "EMENT", "", "M EH N T"),
        ("", "EFUL", "", "F UH L"),
        ("", "EE", "", "IY"),
        ("", "EARN", "", "ER N"),
        (" ", "EAR", "^", "ER"),
        ("", "EAD", "", "EH D"),
        ("#:", "EA", " ", "IY AX"),
        ("", "EA", "SU", "EH"),
        ("", "EA", "", "IY"),
        ("", "EIGH", "", "EY"),
        ("", "EI", "", "IY"),
        (" ", "EYE", "", "AY"),
        ("", "EY", "", "IY"),
        ("", "EU", "", "Y UW"),
        ("", "E", "", "EH"),
    ],
    "F": [
        ("", "FUL", "", "F UH L"),
        ("", "F", "", "F"),
    ],
    "G": [
        ("", "GIV", "", "G IH V"),
        (" ", "G", "I^", "G"),
        ("", "GE", "T", "G EH"),
        ("SU", "GGES", "", "G JH EH S"),
        ("", "GG", "", "G"),
        (" B#", "G", "", "G"),
        ("", "G", "+", "JH"),
        ("", "GREAT", "", "G R EY T"),
        ("#", "GH", "", ""),
        ("", "G", "", "G"),
    ],
    "H": [
        (" ", "HAV", "", "HH AE V"),
        (" ", "HERE", "", "HH IY R"),
        (" ", "HOUR", "", "AW ER"),
        ("", "HOW", "", "HH AW"),
        ("", "H", "#", "HH"),
        ("", "H", "", ""),
    ],
    "I": [
        (" ", "IN", "", "IH N"),
        (" ", "I", " ", "AY"),
        ("", "IN", "D", "AY N"),
        ("", "IER", "", "IY ER"),
        ("#:R", "IED", " ", "IY D"),
        ("", "IED", " ", "AY D"),
        ("", "IEN", "", "IY EH N"),
        ("", "IE", "T", "AY EH"),
        (" :", "I", "%", "AY"),
        ("", "I", "%", "IY"),
        ("", "IE", "", "IY"),
        ("", "I", "^+:#", "IH"),
        ("", "IR", "#", "AY R"),
        ("", "IZ", "%", "AY Z"),
        ("", "IS", "%", "AY Z"),
        ("", "I", "D%", "AY"),
        ("+^", "I", "^+", "IH"),
        ("", "I", "T%", "AY"),
        ("#^:", "I", "^+", "IH"),
        ("", "I", "^+", "AY"),
        ("", "IR", "", "ER"),
        ("", "IGH", "", "AY"),
        ("", "ILD", "", "AY L D"),
        ("", "IGN", " ", "AY N"),
        ("", "IGN", "^", "AY N"),
        ("", "IGN", "%", "AY N"),
        ("", "IQUE", "", "IY K"),
        ("", "I", "", "IH"),
    ],
    "J": [
        ("", "J", "", "JH"),
    ],
    "K": [
        (" ", "K", "N", ""),
        ("", "K", "", "K"),
    ],
    "L": [
        ("", "LO", "C#", "L OW"),
        ("L", "L", "", ""),
        ("#^:", "L", "%", "AX L"),
        ("", "LEAD", "", "L IY D"),
        ("", "L", "", "L"),
    ],
    "M": [
        ("", "MOV", "", "M UW V"),
        ("", "M", "", "M"),
    ],
    "N": [
        ("E", "NG", "+", "N JH"),
        ("", "NG", "R", "NG G"),
        ("", "NG", "#", "NG G"),
        ("", "NGL", "%", "NG G AX L"),
        ("", "NG", "", "NG"),
        ("", "NK", "", "NG K"),
        (" ", "NOW", " ", "N AW"),
        ("", "N", "", "N"),
    ],
    "O": [
        ("", "OF", " ", "AX V"),
        ("", "OROUGH", "", "ER OW"),
        ("#:", "OR", " ", "ER"),
        ("#:", "ORS", " ", "ER Z"),
        ("", "OR", "", "AO R"),
        (" ", "ONE", "", "W AH N"),
        ("", "OW", "", "OW"),
        (" ", "OVER", "", "OW V ER"),
        ("", "OV", "", "AH V"),
        ("", "O", "^%", "OW"),
        ("", "O", "^EN", "OW"),
        ("", "O", "^I#", "OW"),
        ("", "OL", "D", "OW L"),
        ("", "OUGHT", "", "AO T"),
        ("", "OUGH", "", "AH F"),
        (" ", "OU", "", "AW"),
        ("H", "OU", "S#", "AW"),
        ("", "OUS", "", "AX S"),
        ("", "OUR", "", "AO R"),
        ("", "OULD", "", "UH D"),
        ("^", "OU", "^L", "AH"),
        ("", "OUP", "", "UW P"),
        ("", "OU", "", "AW"),
        ("", "OY", "", "OY"),
        ("", "OING", "", "OW IH NG"),
        ("", "OI", "", "OY"),
        ("", "OOR", "", "AO R"),
        ("", "OOK", "", "UH K"),
        ("", "OOD", "", "UH D"),
        ("", "OO", "", "UW"),
        ("", "O", "E", "OW"),
        ("", "O", " ", "OW"),
        ("", "OA", "", "OW"),
        (" ", "ONLY", "", "OW N L IY"),
        (" ", "ONCE", "", "W AH N S"),
        ("", "ON'T", "", "OW N T"),
        ("C", "O", "N", "AA"),
        ("", "O", "NG", "AO"),
        (" ^:", "O", "N", "AH"),
        ("I", "ON", "", "AX N"),
        ("#:", "ON", " ", "AX N"),
        ("#^", "ON", "", "AX N"),
        ("", "O", "ST ", "OW"),
        ("", "OF", "^", "AO F"),
        ("", "OTHER", "", "AH DH ER"),
        ("", "OSS", " ", "AO S"),
        ("#^:", "OM", "", "AH M"),
        ("", "O", "", "AA"),
    ],
    "P": [
        ("", "PH", "", "F"),
        ("", "PEOP", "", "P IY P"),
        ("", "POW", "", "P AW"),
        ("", "PUT", " ", "P UH T"),
        ("", "P", "", "P"),
    ],
    "Q": [
        ("", "QUAR", "", "K W AO R"),
        ("", "QU", "", "K W"),
        ("", "Q", "", "K"),
    ],
    "R": [
        (" ", "RE", "^#", "R IY"),
        ("", "R", "", "R"),
    ],
    "S": [
        ("", "SH", "", "SH"),
        ("#", "SION", "", "ZH AX N"),
        ("", "SOME", "", "S AH M"),
        ("#", "SUR", "#", "ZH ER"),
        ("", "SUR", "#", "SH ER"),
        ("#", "SU", "#", "ZH UW"),
        ("#", "SSU", "#", "SH UW"),
        ("#", "SED", " ", "Z D"),
        ("#", "S", "#", "Z"),
        ("", "SAID", "", "S EH D"),
        ("^", "SION", "", "SH AX N"),
        ("", "S", "S", ""),
        (".", "S", " ", "Z"),
        ("#:.E", "S", " ", "Z"),
        ("#^:##", "S", " ", "Z"),
        ("#^:#", "S", " ", "S"),
        ("U", "S", " ", "S"),
        (" :#", "S", " ", "Z"),
        (" ", "SCH", "", "S K"),
        ("", "S", "C+", ""),
        ("#", "SM", "", "Z M"),
        ("#", "SN", "'", "Z AX N"),
        ("", "S", "", "S"),
    ],
    "T": [
        (" ", "THE", " ", "DH AX"),
        ("", "TO", " ", "T UW"),
        ("", "THAT", " ", "DH AE T"),
        (" ", "THIS", " ", "DH IH S"),
        (" ", "THEY", "", "DH EY"),
        (" ", "THERE", "", "DH EH R"),
        ("", "THER", "", "DH ER"),
        ("", "THEIR", "", "DH EH R"),
        (" ", "THAN", " ", "DH AE N"),
        (" ", "THEM", " ", "DH EH M"),
        ("", "THESE", " ", "DH IY Z"),
        (" ", "THEN", "", "DH EH N"),
        ("", "THROUGH", "", "TH R UW"),
        ("", "THOSE", "", "DH OW Z"),
        ("", "THOUGH", " ", "DH OW"),
        (" ", "THUS", "", "DH AH S"),
        ("", "TH", "", "TH"),
        ("#:", "TED", " ", "T IH D"),
        ("S", "TI", "#N", "CH"),
        ("", "TI", "O", "SH"),
        ("", "TI", "A", "SH"),
        ("", "TIEN", "", "SH AX N"),
        ("", "TUR", "#", "CH ER"),
        ("", "TU", "A", "CH UW"),
        (" ", "TWO", "", "T UW"),
        ("", "T", "", "T"),
    ],
    "U": [
        (" ", "UN", "I", "Y UW N"),
        (" ", "UN", "", "AH N"),
        (" ", "UPON", "", "AX P AO N"),
        ("@", "UR", "#", "ER"),
        ("", "UR", "#", "Y ER"),
        ("", "UR", "", "ER"),
        ("", "U", "^ ", "AH"),
        ("", "U", "^^", "AH"),
        ("", "UY", "", "AY"),
        (" G", "U", "#", ""),
        ("G", "U", "%", ""),
        ("G", "U", "#", "W"),
        ("#N", "U", "", "Y UW"),
        ("@", "U", "", "UW"),
        ("", "U", "", "Y UW"),
    ],
    "V": [
        ("", "VIEW", "", "V Y UW"),
        ("", "V", "", "V"),
    ],
    "W": [
        (" ", "WERE", "", "W ER"),
        ("", "WA", "S", "W AA"),
        ("", "WA", "T", "W AA"),
        ("", "WHERE", "", "WH EH R"),
        ("", "WHAT", "", "WH AA T"),
        ("", "WHOL", "", "HH OW L"),
        ("", "WHO", "", "HH UW"),
        ("", "WH", "", "WH"),
        ("", "WAR", "", "W AO R"),
        ("", "WOR", "^", "W ER"),
        ("", "WR", "", "R"),
        ("", "W", "", "W"),
    ],
    "X": [
        (" ", "X", "", "Z"),
        ("", "X", "", "K S"),
    ],
    "Y": [
        ("", "YOUNG", "", "Y AH NG"),
        (" ", "YOU", "", "Y UW"),
        (" ", "YES", "", "Y EH S"),
        (" ", "Y", "", "Y"),
        ("#^:", "Y", " ", "IY-"),
        ("#^:", "Y", "I", "IY"),
        (" :", "Y", " ", "AY"),
        (" :", "Y", "#", "AY"),
        (" :", "Y", "^+:#", "IH"),
        (" :", "Y", "^#", "AY"),
        ("", "Y", "", "IH"),
    ],
    "Z": [
        ("", "Z", "", "Z"),
    ],
}

# ARPAbet -> espeak-en-us-flavored IPA. Affricates are emitted untied
# ("tʃ"/"dʒ") exactly like the espeak wrapper after its U+0361 tie strip
# (text/__init__.py _espeak_ipa); every character below is in
# text/symbols.py (locked by tests/test_g2p.py).
_ARPA_TO_IPA = {
    "AA": "ɑː", "AE": "æ", "AH": "ʌ", "AO": "ɔː", "AW": "aʊ", "AX": "ə",
    "AY": "aɪ", "EH": "ɛ", "ER": "ɚ", "EY": "eɪ", "IH": "ɪ", "IX": "ᵻ",
    "IY": "iː", "IY-": "i", "OW": "oʊ", "OY": "ɔɪ", "UH": "ʊ", "UW": "uː",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "F": "f", "G": "ɡ",
    "HH": "h", "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n",
    "NG": "ŋ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ", "T": "t",
    "TH": "θ", "V": "v", "W": "w", "WH": "w", "Y": "j", "Z": "z",
    "ZH": "ʒ",
}
_VOWEL_PHONES = frozenset(
    p for p in _ARPA_TO_IPA
    if p[0] in "AEIOU" and p not in ("ER",)
) | {"ER"}

# Irregular words the rules mispredict (IPA stored directly, with stress;
# the NRL report pairs the rules with an exceptions dictionary — this is a
# deliberately small one covering high-frequency irregulars).
_LEXICON = {
    "woman": "wˈʊmən", "women": "wˈɪmᵻn", "busy": "bˈɪzi",
    "business": "bˈɪznəs", "pretty": "pɹˈɪti", "many": "mˈɛni",
    "says": "sˈɛz", "against": "əɡˈɛnst", "gone": "ɡˈɔːn",
    "done": "dˈʌn", "none": "nˈʌn", "month": "mˈʌnθ", "front": "fɹˈʌnt",
    "son": "sˈʌn", "won": "wˈʌn", "come": "kˈʌm", "love": "lˈʌv",
    "above": "əbˈʌv", "lose": "lˈuːz", "whose": "hˈuːz", "shoe": "ʃˈuː",
    "laugh": "lˈæf", "height": "hˈaɪt", "weird": "wˈɪɹd",
    "friend": "fɹˈɛnd", "beauty": "bjˈuːti", "beautiful": "bjˈuːtᵻfəl",
    "juice": "dʒˈuːs", "blood": "blˈʌd", "flood": "flˈʌd",
    "earth": "ˈɚθ", "early": "ˈɚli", "heard": "hˈɚd", "iron": "ˈaɪɚn",
    "island": "ˈaɪlənd", "answer": "ˈænsɚ", "often": "ˈɔːfən",
    "sure": "ʃˈʊɹ", "sugar": "ʃˈʊɡɚ", "colonel": "kˈɚnəl",
    "heart": "hˈɑːɹt", "subtle": "sˈʌtəl", "debt": "dˈɛt",
    "doubt": "dˈaʊt", "aisle": "ˈaɪl", "half": "hˈæf", "talk": "tˈɔːk",
    "water": "wˈɔːɾɚ", "world": "wˈɚld", "work": "wˈɚk",
    "word": "wˈɚd", "touch": "tˈʌtʃ", "enough": "ɪnˈʌf",
    "young": "jˈʌŋ", "country": "kˈʌntɹi", "cousin": "kˈʌzən",
    "because": "bɪkˈʌz", "eyes": "ˈaɪz", "live": "lˈɪv",
    "having": "hˈævɪŋ", "during": "djˈʊɹɪŋ", "minute": "mˈɪnɪt",
    "very": "vˈɛɹi", "city": "sˈɪɾi", "cities": "sˈɪɾiz",
    "down": "dˈaʊn", "town": "tˈaʊn", "brown": "bɹˈaʊn",
    "crown": "kɹˈaʊn", "crowd": "kɹˈaʊd", "knowledge": "nˈɑːlɪdʒ",
    "machine": "məʃˈiːn", "important": "ɪmpˈɔːɹtənt",
    "television": "tˈɛlɪvˌɪʒən", "different": "dˈɪfɹənt",
    "example": "ɛɡzˈæmpəl", "exact": "ɛɡzˈækt", "exist": "ɛɡzˈɪst",
    "error": "ˈɛɹɚ", "area": "ˈɛɹiə", "idea": "aɪdˈiə",
    "quality": "kwˈɑːlᵻɾi", "language": "lˈæŋɡwɪdʒ",
    "anything": "ˈɛnɪθˌɪŋ", "everything": "ˈɛvɹɪθˌɪŋ",
    "something": "sˈʌmθɪŋ", "nothing": "nˈʌθɪŋ",
    "problem": "pɹˈɑːbləm", "company": "kˈʌmpəni",
    "government": "ɡˈʌvɚnmənt", "boxes": "bˈɑːksᵻz",
}

# Function words espeak leaves unstressed.
_FUNCTION_WORDS = frozenset(
    "a an the of to and or in on at as is are was were be been being it its "
    "that this with for from by but not had has have he she we they you i "
    "his her their them us our your my me will would could should shall can "
    "may might must do does did so if than then there when what who whom "
    "how why where which am no nor up out into onto over under about after "
    "before while per via".split()
)

_ONES = ("zero one two three four five six seven eight nine ten eleven "
         "twelve thirteen fourteen fifteen sixteen seventeen eighteen "
         "nineteen").split()
_TENS = ("", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety")
_SCALES = ("", " thousand", " million", " billion", " trillion")
_ORDINAL_IRREG = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _int_to_words(n: int) -> str:
    if n < 0:
        return "minus " + _int_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + (" " + _ONES[r] if r else "")
    if n < 1000:
        h, r = divmod(n, 100)
        return _ONES[h] + " hundred" + (" " + _int_to_words(r) if r else "")
    if n >= 1000 * 10 ** (3 * (len(_SCALES) - 1)):
        # beyond trillions: read the original digits one by one
        return " ".join(_ONES[int(d)] for d in str(n))
    groups = []
    while n:
        n, g = divmod(n, 1000)
        groups.append(g)
    parts = [
        _int_to_words(g) + _SCALES[i]
        for i, g in enumerate(groups) if g
    ]
    return " ".join(reversed(parts))


def _ordinal_words(n: int) -> str:
    words = _int_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORDINAL_IRREG:
        last = _ORDINAL_IRREG[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last += "th"
    return (head + " " + last) if head else last


_NUM_RE = re.compile(
    r"(?<![\w.])(-?\d{1,3}(?:,\d{3})+|-?\d+)(\.\d+)?(st|nd|rd|th)?(?![\w])",
    re.IGNORECASE,
)


def expand_numbers(text: str) -> str:
    """Digits -> words: integers (with thousands commas), decimals read
    digit-by-digit after "point", and 1st/2nd/3rd/4th ordinals."""

    def repl(m: re.Match) -> str:
        whole = int(m.group(1).replace(",", ""))
        if m.group(3) and not m.group(2):
            return _ordinal_words(whole)
        out = _int_to_words(whole)
        if m.group(2):
            out += " point " + " ".join(_ONES[int(d)] for d in m.group(2)[1:])
        return out

    return _NUM_RE.sub(repl, text)


def _match_left(pat: str, w: str, pos: int) -> bool:
    """Match `pat` right-to-left against w[:pos] (w is space-padded).

    Backtracking on the variable-length classes (`:` zero-or-more
    consonants, `#` one-or-more vowels, digraph alternatives of `&`/`@`)
    so patterns like `#^:` match PEOPLE's "PEOP" (`:`=∅, `^`=P, `#`=EO) —
    a greedy scanner would eat P with `:` and fail `^` on the vowel O.
    Patterns are ≤5 chars, so the recursion is trivially cheap."""

    def rec(i: int, p: int) -> bool:
        if i < 0:
            return True
        c = pat[i]
        if c.isalpha() or c == "'":
            return p >= 0 and w[p] == c and rec(i - 1, p - 1)
        if c == " ":
            return (not (p >= 0 and (w[p].isalpha() or w[p] == "'"))
                    and rec(i - 1, p - 1))
        if c == "#":
            q = p
            while q >= 0 and w[q] in _VOWELS:
                q -= 1
                if rec(i - 1, q):
                    return True
            return False
        if c == ":":
            q = p
            while True:
                if rec(i - 1, q):
                    return True
                if q >= 0 and w[q] in _CONSONANTS:
                    q -= 1
                else:
                    return False
        if c == "^":
            return p >= 0 and w[p] in _CONSONANTS and rec(i - 1, p - 1)
        if c == ".":
            return p >= 0 and w[p] in _VOICED and rec(i - 1, p - 1)
        if c == "+":
            return p >= 0 and w[p] in _FRONT and rec(i - 1, p - 1)
        if c == "&":
            if p >= 0 and w[p] in _SIBILANT1 and rec(i - 1, p - 1):
                return True
            return (p >= 1 and w[p] == "H" and w[p - 1] in "CS"
                    and rec(i - 1, p - 2))
        if c == "@":
            if p >= 0 and w[p] in _UINFL1 and rec(i - 1, p - 1):
                return True
            return (p >= 1 and w[p] == "H" and w[p - 1] in "TCS"
                    and rec(i - 1, p - 2))
        raise ValueError(f"bad left-context char {c!r}")

    return rec(len(pat) - 1, pos - 1)


def _match_right(pat: str, w: str, pos: int) -> bool:
    """Match `pat` left-to-right against w[pos:], with the same
    backtracking as `_match_left` (plus `%` trying every suffix)."""
    n = len(w)

    def rec(i: int, p: int) -> bool:
        if i >= len(pat):
            return True
        c = pat[i]
        if c.isalpha() or c == "'":
            return p < n and w[p] == c and rec(i + 1, p + 1)
        if c == " ":
            return (not (p < n and (w[p].isalpha() or w[p] == "'"))
                    and rec(i + 1, p + 1))
        if c == "#":
            q = p
            while q < n and w[q] in _VOWELS:
                q += 1
                if rec(i + 1, q):
                    return True
            return False
        if c == ":":
            q = p
            while True:
                if rec(i + 1, q):
                    return True
                if q < n and w[q] in _CONSONANTS:
                    q += 1
                else:
                    return False
        if c == "^":
            return p < n and w[p] in _CONSONANTS and rec(i + 1, p + 1)
        if c == ".":
            return p < n and w[p] in _VOICED and rec(i + 1, p + 1)
        if c == "+":
            return p < n and w[p] in _FRONT and rec(i + 1, p + 1)
        if c == "%":
            return any(
                w[p:p + len(suf)] == suf and rec(i + 1, p + len(suf))
                for suf in _SUFFIXES
            )
        if c == "&":
            if p < n and w[p] in _SIBILANT1 and rec(i + 1, p + 1):
                return True
            return (p + 1 < n and w[p] in "CS" and w[p + 1] == "H"
                    and rec(i + 1, p + 2))
        if c == "@":
            if p < n and w[p] in _UINFL1 and rec(i + 1, p + 1):
                return True
            return (p + 1 < n and w[p] in "TCS" and w[p + 1] == "H"
                    and rec(i + 1, p + 2))
        raise ValueError(f"bad right-context char {c!r}")

    return rec(0, pos)


def word_to_arpabet(word: str) -> List[str]:
    """One word (letters/apostrophes) -> ARPAbet phones via the NRL rules."""
    w = " " + word.upper() + " "
    pos, out = 1, []
    while pos < len(w) - 1:
        ch = w[pos]
        rules = _R.get(ch)
        if rules is None:  # apostrophe or stray char: no sound
            pos += 1
            continue
        for left, mid, right, phones in rules:
            if w[pos:pos + len(mid)] != mid:
                continue
            if not _match_left(left, w, pos):
                continue
            if not _match_right(right, w, pos + len(mid)):
                continue
            if phones:
                out.extend(phones.split())
            pos += len(mid)
            break
        else:  # unreachable: every letter has a bare default rule
            pos += 1
    # Doubled-letter consonants (LITTLE, RUNNING, APPLE) emit twice under
    # letter-local rules; English never geminates inside a word, so
    # collapse adjacent identical consonant phones.
    return [
        p for i, p in enumerate(out)
        if not (i and p == out[i - 1] and p not in _VOWEL_PHONES)
    ]


def word_to_ipa(word: str, stress: bool = True) -> str:
    """One lowercase word -> espeak-flavored IPA (lexicon first, then
    rules; primary stress before the first vowel of content words)."""
    lex = _LEXICON.get(word)
    if lex is not None:
        return lex if stress else lex.replace("ˈ", "").replace("ˌ", "")
    phones = word_to_arpabet(word)
    # Primary stress before the first non-schwa vowel (schwa is never
    # stressed in English: "around" -> əɹˈaʊnd, not ˈəɹaʊnd); fall back to
    # the first vowel when every vowel is AX.
    stress_at = -1
    if stress and word not in _FUNCTION_WORDS:
        vowel_idx = [i for i, p in enumerate(phones) if p in _VOWEL_PHONES]
        non_ax = [i for i in vowel_idx if phones[i] != "AX"]
        if non_ax:
            stress_at = non_ax[0]
        elif vowel_idx:
            stress_at = vowel_idx[0]
    parts = []
    for i, p in enumerate(phones):
        if i == stress_at:
            parts.append("ˈ")
        parts.append(_ARPA_TO_IPA[p])
    return "".join(parts)


_word_re = re.compile(r"[a-z']+")


class RuleG2P:
    """Drop-in fallback for EspeakPhonemizer (same .phonemize contract:
    list-in/list-out, punctuation preserved in place, IPA words separated
    by spaces). English only."""

    def __init__(self, language: str = "en-us", with_stress: bool = True,
                 preserve_punctuation: bool = True):
        if not language.startswith("en"):
            raise ValueError(
                f"RuleG2P supports English only (got {language!r}); "
                "install espeak-ng for other languages."
            )
        self.language = language
        self.with_stress = with_stress
        self.preserve_punctuation = preserve_punctuation

    def _ipa(self, text: str) -> str:
        text = expand_numbers(text.lower())
        return " ".join(
            ipa for m in _word_re.finditer(text)
            if (ipa := word_to_ipa(m.group(), stress=self.with_stress))
        )

    def phonemize(self, texts: Sequence[str], strip: bool = True) -> List[str]:
        from unitspeech_tpu_torch.text import phonemize_chunks

        # numbers expand BEFORE punctuation chunking: '.'/',' are
        # punctuation marks, so "1,000"/"3.14" would otherwise be split
        # into digit fragments before expand_numbers could see them
        return [
            phonemize_chunks(self._ipa, expand_numbers(t.lower()),
                             self.preserve_punctuation, strip=strip)
            for t in texts
        ]
