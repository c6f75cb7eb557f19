"""Pure-Python Romanian grapheme->IPA fallback (no espeak binary required).

The port's own copy of unitspeech_tpu/text/g2p_ro.py (pure Python, no JAX), kept
equal to it by tests/test_torch_port_text.py.

The reference's SWARA-corpus path phonemizes Romanian through espeak-ng
(`get_phonemizer("ro")`, the reference's util.py:154-172 and
train_STEP1.py:83-100). Romanian orthography is shallow (near one-to-one
letter-sound correspondence), so unlike English a rule G2P is close to
faithful: the only systematic irregularities are the c/g palatalization
digraphs, the semivowel status of i/u next to vowels, word-final
post-consonantal -i as palatalization (ʲ), and lexical stress.

Rules implemented (standard Romanian phonology):
  * ă -> ə;  â, î -> ɨ;  ș -> ʃ;  ț -> ts;  j -> ʒ;  x -> ks
  * ce/ci -> tʃ;  ge/gi -> dʒ;  che/chi -> k;  ghe/ghi -> ɡ
  * word-final unstressed -i after a consonant -> ʲ (lupi -> lupʲ),
    kept syllabic after muta-cum-liquida clusters (codri -> kodri)
  * i/u adjacent to vowels -> semivowels j/w (iar -> jar, ziua -> ziwa)
  * word-initial e -> je in the personal pronouns / forms of "a fi"
    (el -> jel, este -> jeste) — the standard lexical set
  * stress heuristic: final vowel if the word ends in a consonant (or ʲ),
    else penultimate vowel; function words unstressed. Romanian stress is
    lexical, so this is the documented approximation (~85% of tokens).
  * integer expansion with Romanian numeral grammar (douăzeci și unu,
    două sute, douăzeci de mii, un milion / două milioane).

DOCUMENTED DIVERGENCE vs espeak-ng: espeak marks the ea/oa diphthongs
with the combining non-syllabic breve (e̯a / o̯a); the symbol table has no
U+032F, so the vowel pair is emitted plain (espeak's own IPA stream drops
to the same pair once untied marks are stripped). Stress placement is
heuristic where espeak's is lexicon-backed. Same fallback contract as the
English module (text/g2p.py): used only when the espeak binary is absent.
"""

from __future__ import annotations

import re
from typing import List, Sequence

_VOWELS = frozenset("aeiouăâî")

# letter -> IPA for everything outside the contextual rules below;
# every output character is in text/symbols.py (locked by tests/test_g2p.py)
_MAP = {
    "a": "a", "ă": "ə", "â": "ɨ", "î": "ɨ", "b": "b", "d": "d", "e": "e",
    "f": "f", "g": "ɡ", "h": "h", "i": "i", "j": "ʒ", "k": "k", "l": "l",
    "m": "m", "n": "n", "o": "o", "p": "p", "q": "k", "r": "r", "s": "s",
    "ș": "ʃ", "t": "t", "ț": "ts", "u": "u", "v": "v", "w": "v", "x": "ks",
    "y": "i", "z": "z", "c": "k",
}

# word-initial e -> je: personal pronouns and forms of "a fi"
_INITIAL_E_IOTIZED = frozenset(
    "el ea ei ele e este eram erai era eram erați erau ești".split()
)

# unstressed function words (espeak leaves clitics/prepositions unstressed)
_FUNCTION_WORDS = frozenset(
    "a al ai ale am ar aș au că ce cu de din după e fi i îi îl în îmi își "
    "la le li lor lui mai mă mi ne ni nu o pe prin peste până se să si și "
    "te ți un unei unor unui va vă vei voi vom vor".split()
)


def _word_to_phones(word: str) -> List[str]:
    """One lowercase Romanian word -> phone list (no stress yet)."""
    w = word.replace("ş", "ș").replace("ţ", "ț")  # legacy cedilla forms
    n = len(w)
    out: List[str] = []
    i = 0
    if w in _INITIAL_E_IOTIZED:
        out.append("j")
    while i < n:
        ch = w[i]
        nxt = w[i + 1] if i + 1 < n else ""
        if ch == "c":
            if nxt == "h" and i + 2 < n and w[i + 2] in "ei":
                out.append("k")
                i += 2  # the e/i is a real vowel: chi/che -> ki/ke
                continue
            if nxt and nxt in "ei":
                out.append("tʃ")
                i += 1
                continue
            out.append("k")
            i += 1
            continue
        if ch == "g":
            if nxt == "h" and i + 2 < n and w[i + 2] in "ei":
                out.append("ɡ")
                i += 2
                continue
            if nxt and nxt in "ei":
                out.append("dʒ")
                i += 1
                continue
            out.append("ɡ")
            i += 1
            continue
        if ch == "i":
            if i + 1 == n and i > 0 and w[i - 1] not in _VOWELS:
                # final post-consonantal -i: palatalization (lupi -> lupʲ),
                # EXCEPT after muta-cum-liquida (plosive/f + l/r) where it
                # stays syllabic (codri -> kodri) and in words with no other
                # vowel, where it is the nucleus (și -> ʃi, fi -> fi)
                if (i >= 2 and w[i - 1] in "lr"
                        and w[i - 2] in "bcdfgptv"):
                    out.append("i")
                elif not any(c in _VOWELS for c in w[:i]):
                    out.append("i")
                else:
                    out.append("ʲ")
            elif (nxt in _VOWELS and nxt != "i"
                  and not (nxt == "u" and i + 2 < n and w[i + 2] in _VOWELS)):
                # glide before a vowel (iarnă -> jarnə) — unless the u is
                # itself intervocalic and glides (ziua -> ziwa keeps i)
                out.append("j")
            elif nxt not in _VOWELS and i > 0 and w[i - 1] in _VOWELS:
                out.append("j")  # glide after a vowel: mai -> maj, copii -> kopij
            else:
                out.append("i")
            i += 1
            continue
        if ch == "u":
            # intervocalic u -> w (ziua -> ziwa, nouă -> nowə)
            if (0 < i < n - 1 and w[i - 1] in _VOWELS and w[i + 1] in _VOWELS):
                out.append("w")
                i += 1
                continue
            out.append("u")
            i += 1
            continue
        ipa = _MAP.get(ch)
        if ipa:
            out.append(ipa)
        i += 1
    return out


_VOWEL_PHONES = frozenset("aeiouəɨ")


def word_to_ipa_ro(word: str, stress: bool = True) -> str:
    phones = _word_to_phones(word)
    if not stress or word in _FUNCTION_WORDS:
        return "".join(phones)
    vowel_idx = [k for k, p in enumerate(phones) if p in _VOWEL_PHONES]
    if not vowel_idx:
        return "".join(phones)
    ends_open = phones[-1] in _VOWEL_PHONES
    # penultimate vowel for vowel-final words, else the last vowel
    at = vowel_idx[-2] if (ends_open and len(vowel_idx) >= 2) else vowel_idx[-1]
    return "".join(
        ("ˈ" + p) if k == at else p for k, p in enumerate(phones)
    )


# --- Romanian numeral grammar -----------------------------------------------

_ONES_RO = ("zero unu doi trei patru cinci șase șapte opt nouă zece "
            "unsprezece doisprezece treisprezece paisprezece cincisprezece "
            "șaisprezece șaptesprezece optsprezece nouăsprezece").split()
_TENS_RO = ("", "", "douăzeci", "treizeci", "patruzeci", "cincizeci",
            "șaizeci", "șaptezeci", "optzeci", "nouăzeci")


def _under_100_ro(n: int) -> str:
    if n < 20:
        return _ONES_RO[n]
    t, r = divmod(n, 10)
    return _TENS_RO[t] + (f" și {_ONES_RO[r]}" if r else "")


def _under_1000_ro(n: int) -> str:
    if n < 100:
        return _under_100_ro(n)
    h, r = divmod(n, 100)
    hund = {1: "o sută", 2: "două sute"}.get(h, f"{_ONES_RO[h]} sute")
    return hund + (f" {_under_100_ro(r)}" if r else "")


def _scaled_ro(n: int, one: str, two_plus: str) -> str:
    # "de" links numerals >=20 to the scale noun (douăzeci de mii)
    if n == 1:
        return one
    head = _under_1000_ro(n) if n < 1000 else _int_to_words_ro(n)
    if n == 2:
        head = "două"
    link = " de " if n >= 20 else " "
    return head + link + two_plus


def _int_to_words_ro(n: int) -> str:
    if n < 0:
        return "minus " + _int_to_words_ro(-n)
    if n < 1000:
        return _under_1000_ro(n)
    if n < 10**6:
        th, r = divmod(n, 1000)
        out = _scaled_ro(th, "o mie", "mii")
        return out + (f" {_under_1000_ro(r)}" if r else "")
    if n < 10**9:
        m, r = divmod(n, 10**6)
        out = _scaled_ro(m, "un milion", "milioane")
        return out + (f" {_int_to_words_ro(r)}" if r else "")
    b, r = divmod(n, 10**9)
    out = _scaled_ro(b, "un miliard", "miliarde")
    return out + (f" {_int_to_words_ro(r)}" if r else "")


_NUM_RE_RO = re.compile(
    r"(?<![\w.])(-?\d{1,3}(?:\.\d{3})+|-?\d+)(,\d+)?(?![\w])"
)


def expand_numbers_ro(text: str) -> str:
    """Romanian digit conventions: '.' groups thousands, ',' is the decimal
    mark ("virgulă"); decimals are read digit by digit."""

    def repl(m: re.Match) -> str:
        out = _int_to_words_ro(int(m.group(1).replace(".", "")))
        if m.group(2):
            out += " virgulă " + " ".join(
                _ONES_RO[int(d)] for d in m.group(2)[1:]
            )
        return out

    return _NUM_RE_RO.sub(repl, text)


_word_re = re.compile(r"[a-zăâîșțşţ']+")


class RomanianG2P:
    """Drop-in fallback for EspeakPhonemizer("ro") — same .phonemize
    contract (list-in/list-out, punctuation preserved in place)."""

    def __init__(self, language: str = "ro", with_stress: bool = True,
                 preserve_punctuation: bool = True):
        if not language.startswith("ro"):
            raise ValueError(f"RomanianG2P supports 'ro' only (got {language!r})")
        self.language = language
        self.with_stress = with_stress
        self.preserve_punctuation = preserve_punctuation

    def _ipa(self, text: str) -> str:
        text = expand_numbers_ro(text.lower())
        return " ".join(
            ipa for m in _word_re.finditer(text)
            if (ipa := word_to_ipa_ro(m.group(), stress=self.with_stress))
        )

    def phonemize(self, texts: Sequence[str], strip: bool = True) -> List[str]:
        from unitspeech_tpu_torch.text import phonemize_chunks

        # numbers expand BEFORE punctuation chunking ('.' thousands groups
        # and ',' decimals are punctuation marks and would be split apart)
        return [
            phonemize_chunks(self._ipa, expand_numbers_ro(t.lower()),
                             self.preserve_punctuation, strip=strip)
            for t in texts
        ]
