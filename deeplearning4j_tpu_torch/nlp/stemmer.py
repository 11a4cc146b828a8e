"""Porter stemmer — pure-Python implementation of Porter (1980).

Reference parity: ``text/annotator/StemmerAnnotator.java`` and
``text/tokenization/tokenizer/preprocessor/EndingPreProcessor`` give the
reference its stemming capability (via the snowball library).  This
module implements the classic Porter algorithm from its published rule
tables — no third-party dependency, suitable as a tokenizer
pre-processor or an annotator stage (see nlp/annotators.py).

Port of ``deeplearning4j_tpu/nlp/stemmer.py``: a copy (pure Python).
"""

from __future__ import annotations

_VOWELS = "aeiou"


def _is_consonant(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_consonant(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """m = number of VC sequences in [C](VC)^m[V]."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        vowel = not _is_consonant(stem, i)
        if prev_vowel and not vowel:
            m += 1
        prev_vowel = vowel
    return m


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_consonant(word, len(word) - 1))


def _ends_cvc(word: str) -> bool:
    """*o: stem ends cvc where the final c is not w, x or y."""
    if len(word) < 3:
        return False
    return (_is_consonant(word, len(word) - 3)
            and not _is_consonant(word, len(word) - 2)
            and _is_consonant(word, len(word) - 1)
            and word[-1] not in "wxy")


def _replace(word: str, suffix: str, repl: str, m_min: int) -> str | None:
    """If word ends with suffix and measure(stem) > m_min, replace."""
    if not word.endswith(suffix):
        return None
    stem = word[: len(word) - len(suffix)]
    if _measure(stem) > m_min:
        return stem + repl
    return word                                # matched but condition failed


class PorterStemmer:
    """``stem("relational") == "relat"`` etc.; stateless and reusable."""

    def stem(self, word: str) -> str:
        word = word.lower()
        if len(word) <= 2:
            return word
        word = self._step1a(word)
        word = self._step1b(word)
        word = self._step1c(word)
        word = self._step2(word)
        word = self._step3(word)
        word = self._step4(word)
        word = self._step5a(word)
        word = self._step5b(word)
        return word

    def __call__(self, word: str) -> str:
        return self.stem(word)

    # -- step 1: plurals and -ed/-ing ----------------------------------------
    @staticmethod
    def _step1a(w: str) -> str:
        if w.endswith("sses"):
            return w[:-2]
        if w.endswith("ies"):
            return w[:-2]
        if w.endswith("ss"):
            return w
        if w.endswith("s"):
            return w[:-1]
        return w

    def _step1b(self, w: str) -> str:
        if w.endswith("eed"):
            stem = w[:-3]
            return stem + "ee" if _measure(stem) > 0 else w
        flag = False
        if w.endswith("ed") and _contains_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _contains_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                return w + "e"
            if _ends_double_consonant(w) and w[-1] not in "lsz":
                return w[:-1]
            if _measure(w) == 1 and _ends_cvc(w):
                return w + "e"
        return w

    @staticmethod
    def _step1c(w: str) -> str:
        if w.endswith("y") and _contains_vowel(w[:-1]):
            return w[:-1] + "i"
        return w

    # -- step 2/3: derivational suffixes -------------------------------------
    _STEP2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
              ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
              ("alli", "al"), ("entli", "ent"), ("eli", "e"),
              ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
              ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
              ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
              ("iviti", "ive"), ("biliti", "ble")]

    _STEP3 = [("icate", "ic"), ("ative", ""), ("alize", "al"),
              ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", "")]

    def _step2(self, w: str) -> str:
        for suf, repl in self._STEP2:
            out = _replace(w, suf, repl, 0)
            if out is not None:
                return out
        return w

    def _step3(self, w: str) -> str:
        for suf, repl in self._STEP3:
            out = _replace(w, suf, repl, 0)
            if out is not None:
                return out
        return w

    # -- step 4: strip residual suffixes when m > 1 --------------------------
    _STEP4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant",
              "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
              "ive", "ize"]

    def _step4(self, w: str) -> str:
        for suf in self._STEP4:
            if w.endswith(suf):
                stem = w[: len(w) - len(suf)]
                if _measure(stem) > 1:
                    return stem
                return w
        if w.endswith("ion"):
            stem = w[:-3]
            if _measure(stem) > 1 and stem and stem[-1] in "st":
                return stem
        return w

    # -- step 5: tidy final e / double l -------------------------------------
    @staticmethod
    def _step5a(w: str) -> str:
        if w.endswith("e"):
            stem = w[:-1]
            m = _measure(stem)
            if m > 1 or (m == 1 and not _ends_cvc(stem)):
                return stem
        return w

    @staticmethod
    def _step5b(w: str) -> str:
        if _measure(w) > 1 and _ends_double_consonant(w) and w.endswith("l"):
            return w[:-1]
        return w


_DEFAULT = PorterStemmer()


def stem(word: str) -> str:
    """Module-level convenience using a shared stateless stemmer."""
    return _DEFAULT.stem(word)
