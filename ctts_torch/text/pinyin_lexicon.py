"""Generate the Mandarin pinyin → phone lexicon from segmentation rules
(ctts_tpu/text/pinyin_lexicon.py).

The reference ships this mapping as a data file
(lexicon/pinyin-lexicon-r.txt); it is fully rule-derived from standard
pinyin phonology, so we generate it: initial/final split, the apical vowels
(zhi/chi/shi/ri → iii, zi/ci/si → ii), the ü (v) series after j/q/x/y,
y/w zero-initial re-spelling, and erhua (trailing r → rr).
"""

from ctts_torch.text.pinyin import initials, _final_stems

# finals reachable as standalone syllables (zero initial, no re-spelling)
_STANDALONE = ["a", "ai", "an", "ang", "ao", "e", "ei", "en", "eng",
               "o", "ou"]

# y- syllable spellings → (initial y, true final)
_Y_MAP = {
    "yi": "i", "ya": "ia", "yan": "ian", "yang": "iang", "yao": "iao",
    "ye": "ie", "yin": "in", "ying": "ing", "yong": "iong", "you": "iou",
    "yu": "v", "yuan": "van", "yue": "ve", "yun": "vn",
    "yo": "iou",   # interjection yo folds onto iou in this phone set
}

# w- syllable spellings → (initial w, true final); weng reduces to uen in
# this phone set
_W_MAP = {
    "wu": "u", "wa": "ua", "wai": "uai", "wan": "uan", "wang": "uang",
    "wei": "uei", "wen": "uen", "weng": "uen", "wo": "uo",
}

# alternate ü spellings
_ALIASES = {"lue": ("l", "ve"), "nue": ("n", "ve")}

def _true_final(initial, spelled):
    """Surface final spelling → underlying final symbol."""
    if initial in ("j", "q", "x"):
        # ü written as u after j/q/x
        mapping = {"u": "v", "ue": "ve", "un": "vn", "uan": "van"}
        if spelled in mapping:
            return mapping[spelled]
    if spelled == "iu":
        return "iou"
    if spelled == "ui":
        return "uei"
    if spelled == "un" and initial not in ("j", "q", "x", "y"):
        return "uen"
    return spelled


def syllable_to_phones(syllable):
    """One toneless pinyin syllable (+tone digit appended by caller) →
    [initial?, final]. Returns None for unknown syllables."""
    s = syllable
    if s in _STANDALONE:
        return [None, s]
    if s == "er":
        # standalone er is e + erhua in this phone set ("er1" → e1 rr)
        return [None, "e"]
    if s in _Y_MAP:
        return ["y", _Y_MAP[s]]
    if s in _W_MAP:
        return ["w", _W_MAP[s]]
    if s in _ALIASES:
        return list(_ALIASES[s])
    if s in ("zhi", "chi", "shi", "ri"):
        return [s[:-1], "iii"]
    if s in ("zi", "ci", "si"):
        return [s[0], "ii"]
    # longest-match initial; the "er" final never follows an initial
    # ("ter" is erhua of "te", not t+er)
    for ini in sorted(initials, key=len, reverse=True):
        if s.startswith(ini) and len(s) > len(ini):
            fin = _true_final(ini, s[len(ini):])
            if fin in _final_stems and fin != "er":
                return [ini, fin]
    return None


def _all_syllables():
    """Enumerate valid pinyin syllables (surface spellings)."""
    sylls = (set(_STANDALONE) | set(_Y_MAP) | set(_W_MAP) | set(_ALIASES)
             | {"er"})
    sylls |= {"zhi", "chi", "shi", "ri", "zi", "ci", "si"}
    # initial + surface final combinations that resolve to a known final
    surface_finals = set(_final_stems) | {"iu", "ui", "un", "u", "ue",
                                          "uan"}
    for ini in initials:
        if ini in ("y", "w"):
            continue
        for fin in surface_finals:
            s = ini + fin
            if s in sylls:
                continue
            r = syllable_to_phones(s)
            if r is not None:
                sylls.add(s)
    return sorted(sylls)


def build_lexicon():
    """→ dict: toned syllable (e.g. "zhong1") → [phones] (e.g. zh ong1);
    plus erhua entries (syllable + "r" → phones + rr) and "r5" → er5."""
    lex = {}
    for s in _all_syllables():
        r = syllable_to_phones(s)
        if r is None:
            continue
        ini, fin = r
        erhua = s == "er"          # standalone er carries rr itself
        for tone in "12345":
            phones = ([ini] if ini else []) + [fin + tone]
            if erhua:
                lex[s + tone] = phones + ["rr"]
            else:
                lex[s + tone] = phones
                lex[s + "r" + tone] = phones + ["rr"]
    for tone in "12345":           # bare "r" syllable reads as er
        lex["r" + tone] = ["er" + tone]
    return lex
