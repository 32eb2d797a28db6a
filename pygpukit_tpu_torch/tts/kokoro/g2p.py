"""English grapheme-to-phoneme conversion for Kokoro (IPA output): the
port's copy of ``pygpukit_tpu/tts/kokoro/g2p.py``, pure Python, its
lexicon, rules and vocabulary held to the reference's bit for bit.

Reference: the upstream model consumes misaki/espeak IPA phoneme strings
(reference model.py: KokoroTokenizer.from_config(..., use_misaki=True)).
Neither phonemizer is installable here, so this module provides a real
lexicon + rule G2P path:

1. text normalisation (numbers, abbreviations, punctuation),
2. an exception lexicon of common English words -> IPA,
3. ordered context-sensitive letter-to-sound rules (NRL-style) for
   everything else,
4. IPA -> Kokoro vocab ids via the checkpoint's config.json vocab (a
   built-in fallback vocab covers offline use).

Pre-phonemized input bypasses all of this: ``encode(phonemes=...)``
accepts a raw IPA string for users driving misaki/espeak externally.
"""

from __future__ import annotations

import re

# ---------------------------------------------------------------- lexicon --

LEXICON: dict[str, str] = {
    "a": "ə", "an": "ən", "the": "ðə", "of": "əv", "to": "tu", "and": "ænd",
    "in": "ɪn", "is": "ɪz", "it": "ɪt", "you": "ju", "that": "ðæt",
    "he": "hi", "she": "ʃi", "was": "wəz", "for": "fɔɹ", "on": "ɑn",
    "are": "ɑɹ", "as": "æz", "with": "wɪð", "his": "hɪz", "her": "hɜɹ",
    "they": "ðeɪ", "at": "æt", "be": "bi", "this": "ðɪs", "have": "hæv",
    "from": "fɹəm", "or": "ɔɹ", "had": "hæd", "by": "baɪ", "but": "bət",
    "not": "nɑt", "what": "wət", "all": "ɔl", "were": "wɜɹ", "we": "wi",
    "when": "wɛn", "your": "jɔɹ", "can": "kæn", "said": "sɛd",
    "there": "ðɛɹ", "use": "juz", "each": "itʃ", "which": "wɪtʃ",
    "do": "du", "how": "haʊ", "their": "ðɛɹ", "if": "ɪf", "will": "wɪl",
    "up": "əp", "other": "əðɚ", "about": "əbaʊt", "out": "aʊt",
    "many": "mɛni", "then": "ðɛn", "them": "ðɛm", "these": "ðiz",
    "so": "soʊ", "some": "səm", "would": "wʊd", "make": "meɪk",
    "like": "laɪk", "him": "hɪm", "into": "ɪntu", "time": "taɪm",
    "has": "hæz", "look": "lʊk", "two": "tu", "more": "mɔɹ",
    "write": "ɹaɪt", "go": "ɡoʊ", "see": "si", "number": "nəmbɚ",
    "no": "noʊ", "way": "weɪ", "could": "kʊd", "people": "pipəl",
    "my": "maɪ", "than": "ðæn", "first": "fɜɹst", "water": "wɔtɚ",
    "been": "bɪn", "call": "kɔl", "who": "hu", "oil": "ɔɪl",
    "its": "ɪts", "now": "naʊ", "find": "faɪnd", "long": "lɔŋ",
    "down": "daʊn", "day": "deɪ", "did": "dɪd", "get": "ɡɛt",
    "come": "kəm", "made": "meɪd", "may": "meɪ", "part": "pɑɹt",
    "over": "oʊvɚ", "new": "nu", "sound": "saʊnd", "take": "teɪk",
    "only": "oʊnli", "little": "lɪtəl", "work": "wɜɹk", "know": "noʊ",
    "place": "pleɪs", "year": "jɪɹ", "live": "lɪv", "me": "mi",
    "back": "bæk", "give": "ɡɪv", "most": "moʊst", "very": "vɛɹi",
    "after": "æftɚ", "thing": "θɪŋ", "our": "aʊɚ", "just": "dʒəst",
    "name": "neɪm", "good": "ɡʊd", "sentence": "sɛntəns", "man": "mæn",
    "think": "θɪŋk", "say": "seɪ", "great": "ɡɹeɪt", "where": "wɛɹ",
    "help": "hɛlp", "through": "θɹu", "much": "mətʃ", "before": "bɪfɔɹ",
    "line": "laɪn", "right": "ɹaɪt", "too": "tu", "mean": "min",
    "old": "oʊld", "any": "ɛni", "same": "seɪm", "tell": "tɛl",
    "boy": "bɔɪ", "follow": "fɑloʊ", "came": "keɪm", "want": "wɑnt",
    "show": "ʃoʊ", "also": "ɔlsoʊ", "around": "ɚaʊnd", "form": "fɔɹm",
    "three": "θɹi", "small": "smɔl", "set": "sɛt", "put": "pʊt",
    "end": "ɛnd", "does": "dəz", "another": "ənəðɚ", "well": "wɛl",
    "large": "lɑɹdʒ", "must": "məst", "big": "bɪɡ", "even": "ivən",
    "such": "sətʃ", "because": "bɪkɔz", "turn": "tɜɹn", "here": "hɪɹ",
    "why": "waɪ", "ask": "æsk", "went": "wɛnt", "men": "mɛn",
    "read": "ɹid", "need": "nid", "land": "lænd", "different": "dɪfɹənt",
    "home": "hoʊm", "us": "əs", "move": "muv", "try": "tɹaɪ",
    "kind": "kaɪnd", "hand": "hænd", "picture": "pɪktʃɚ", "again": "əɡɛn",
    "change": "tʃeɪndʒ", "off": "ɔf", "play": "pleɪ", "spell": "spɛl",
    "air": "ɛɹ", "away": "əweɪ", "animal": "ænɪməl", "house": "haʊs",
    "point": "pɔɪnt", "page": "peɪdʒ", "letter": "lɛtɚ", "mother": "məðɚ",
    "answer": "ænsɚ", "found": "faʊnd", "study": "stədi", "still": "stɪl",
    "learn": "lɜɹn", "should": "ʃʊd", "world": "wɜɹld", "high": "haɪ",
    "hello": "həloʊ", "one": "wən", "once": "wəns", "word": "wɜɹd",
    "voice": "vɔɪs", "speech": "spitʃ", "language": "læŋɡwɪdʒ",
    "computer": "kəmpjutɚ", "model": "mɑdəl", "test": "tɛst",
    "example": "ɪɡzæmpəl", "quick": "kwɪk", "brown": "bɹaʊn",
    "fox": "fɑks", "jumps": "dʒəmps", "lazy": "leɪzi", "dog": "dɔɡ",
}

# ---------------------------------------------- letter-to-sound rule table --
# NRL-style ordered rules: (left context regex, grapheme, right context
# regex, phonemes). First match at the cursor wins; contexts are regexes
# over the raw word. '#' = one or more vowels, ':' = zero or more
# consonants, '^' = one consonant, '$' in right context = end of word.

_V = "[aeiouy]"
_C = "[bcdfghjklmnpqrstvwxz]"

RULES: list[tuple[str, str, str, str]] = [
    # digraphs & common clusters first (longest grapheme wins)
    ("", "tion", "", "ʃən"), ("", "sion", "", "ʒən"), ("", "ture", "$", "tʃɚ"),
    ("", "ought", "", "ɔt"), ("", "ight", "", "aɪt"), ("", "augh", "", "ɔ"),
    ("", "ough", "$", "oʊ"), ("", "eigh", "", "eɪ"),
    ("", "tch", "", "tʃ"), ("", "sch", "", "sk"),
    ("", "ch", "", "tʃ"), ("", "sh", "", "ʃ"), ("", "th", "", "θ"),
    ("", "ph", "", "f"), ("", "wh", "", "w"), ("", "gh", "", "ɡ"),
    ("", "ng", "$", "ŋ"), ("", "ng", "", "ŋɡ"), ("", "nk", "", "ŋk"),
    ("", "qu", "", "kw"), ("", "ck", "", "k"), ("", "kn", "", "n"),
    ("", "wr", "", "ɹ"), ("", "mb", "$", "m"), ("", "dge", "", "dʒ"),
    # vowel digraphs
    ("", "ee", "", "i"), ("", "ea", "", "i"), ("", "oo", "k", "ʊ"),
    ("", "oo", "", "u"), ("", "ou", "", "aʊ"), ("", "ow", "$", "oʊ"),
    ("", "ow", "", "aʊ"), ("", "oa", "", "oʊ"), ("", "oi", "", "ɔɪ"),
    ("", "oy", "", "ɔɪ"), ("", "ai", "", "eɪ"), ("", "ay", "", "eɪ"),
    ("", "au", "", "ɔ"), ("", "aw", "", "ɔ"), ("", "ew", "", "u"),
    ("", "ey", "$", "i"), ("", "ie", "$", "aɪ"), ("", "ie", "", "i"),
    ("", "ue", "", "u"), ("", "ui", "", "u"),
    # r-coloured vowels
    ("", "er", "$", "ɚ"), ("", "ar", "", "ɑɹ"), ("", "or", "", "ɔɹ"),
    ("", "er", "", "ɜɹ"), ("", "ir", "", "ɜɹ"), ("", "ur", "", "ɜɹ"),
    # magic-e long vowels: a_e, i_e, o_e, u_e
    ("", "a", f"{_C}e$", "eɪ"), ("", "i", f"{_C}e$", "aɪ"),
    ("", "o", f"{_C}e$", "oʊ"), ("", "u", f"{_C}e$", "ju"),
    # consonants with context
    ("", "c", "[eiy]", "s"), ("", "c", "", "k"),
    ("", "g", "[eiy]", "dʒ"), ("", "g", "", "ɡ"),
    ("", "s", "$", "z"), ("", "s", "", "s"),
    ("", "x", "", "ks"), ("", "j", "", "dʒ"),
    ("", "y", f"{_C}", "aɪ"), ("", "y", "$", "i"), ("", "y", "", "j"),
    # silent final e
    ("", "e", "$", ""),
    # default vowels (short)
    ("", "a", "", "æ"), ("", "e", "", "ɛ"), ("", "i", "", "ɪ"),
    ("", "o", "", "ɑ"), ("", "u", "", "ə"),
    # default consonants
    ("", "b", "", "b"), ("", "d", "", "d"), ("", "f", "", "f"),
    ("", "h", "", "h"), ("", "k", "", "k"), ("", "l", "", "l"),
    ("", "m", "", "m"), ("", "n", "", "n"), ("", "p", "", "p"),
    ("", "q", "", "k"), ("", "r", "", "ɹ"), ("", "t", "", "t"),
    ("", "v", "", "v"), ("", "w", "", "w"), ("", "z", "", "z"),
]

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]


def _num_to_words(n: int) -> str:
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + (" " + _ONES[r] if r else "")
    if n < 1000:
        h, r = divmod(n, 100)
        return _ONES[h] + " hundred" + (" " + _num_to_words(r) if r else "")
    if n < 1_000_000:
        k, r = divmod(n, 1000)
        return (_num_to_words(k) + " thousand"
                + (" " + _num_to_words(r) if r else ""))
    m, r = divmod(n, 1_000_000)
    return (_num_to_words(m) + " million"
            + (" " + _num_to_words(r) if r else ""))


def normalize(text: str) -> str:
    """Lowercase, expand integers, squeeze whitespace; keep , . ! ? ; :"""
    text = text.lower()
    text = re.sub(r"\d+", lambda m: _num_to_words(int(m.group())), text)
    text = re.sub(r"[^a-z,.!?;:'\s-]", " ", text)
    return re.sub(r"\s+", " ", text).strip()


def word_to_ipa(word: str) -> str:
    """Single lowercase word -> IPA via lexicon or letter-to-sound rules."""
    if word in LEXICON:
        return LEXICON[word]
    out = []
    i = 0
    n = len(word)
    while i < n:
        for left, graph, right, phon in RULES:
            if not word.startswith(graph, i):
                continue
            if left and not re.search(left + "$", word[:i]):
                continue
            rest = word[i + len(graph):]
            if right:
                # "$"-suffixed contexts must match the ENTIRE remainder;
                # others match at the start of it
                ok = (re.fullmatch(right[:-1], rest) if right.endswith("$")
                      else re.match(right, rest))
                if not ok and not (right == "$" and rest == ""):
                    continue
            out.append(phon)
            i += len(graph)
            break
        else:
            i += 1  # unknown char: skip
    return "".join(out)


def text_to_ipa(text: str) -> str:
    """Full text -> IPA phoneme string with punctuation + spaces kept."""
    text = normalize(text)
    out = []
    for token in re.findall(r"[a-z']+|[,.!?;:]|\s", text):
        if token.isspace():
            out.append(" ")
        elif re.fullmatch(r"[,.!?;:]", token):
            out.append(token)
        else:
            out.append(word_to_ipa(token.strip("'")))
    return "".join(out).strip()


# -------------------------------------------------------------- vocabulary --

#: The Kokoro-82M v1.0 phoneme vocabulary (hexgrad/Kokoro-82M config.json;
#: reference consumes it via misaki, src/pygpukit/tts/kokoro/text.py). Sparse
#: ids, max 177 => the checkpoint's 178-row symbol embedding. A checkpoint
#: config.json vocab still overrides this at load time, but the default now
#: matches the published checkpoint instead of a self-consistent stand-in.
KOKORO_VOCAB: dict[str, int] = {
    ";": 1, ":": 2, ",": 3, ".": 4, "!": 5, "?": 6, "—": 9,
    "…": 10, "\"": 11, "(": 12, ")": 13, "“": 14, "”": 15,
    " ": 16, "̃": 17, "ʣ": 18, "ʥ": 19, "ʦ": 20,
    "ʨ": 21, "ᵝ": 22, "ꭧ": 23, "A": 24, "I": 25, "O": 31,
    "Q": 33, "S": 35, "T": 36, "W": 39, "Y": 41, "ᵊ": 42, "a": 43,
    "b": 44, "c": 45, "d": 46, "e": 47, "f": 48, "h": 50, "i": 51, "j": 52,
    "k": 53, "l": 54, "m": 55, "n": 56, "o": 57, "p": 58, "q": 59, "r": 60,
    "s": 61, "t": 62, "u": 63, "v": 64, "w": 65, "x": 66, "y": 67, "z": 68,
    "ɑ": 69, "ɐ": 70, "ɒ": 71, "æ": 72, "β": 75,
    "ɔ": 76, "ɕ": 77, "ç": 78, "ɖ": 80, "ð": 81,
    "ʤ": 82, "ə": 83, "ɚ": 85, "ɛ": 86, "ɜ": 87,
    "ɟ": 90, "ɡ": 92, "ɥ": 99, "ɨ": 101, "ɪ": 102,
    "ʝ": 103, "ɯ": 110, "ɰ": 111, "ŋ": 112,
    "ɳ": 113, "ɲ": 114, "ɴ": 115, "ø": 116,
    "ɸ": 118, "θ": 119, "œ": 120, "ɹ": 123,
    "ɾ": 125, "ɻ": 126, "ʁ": 128, "ɽ": 129,
    "ʂ": 130, "ʃ": 131, "ʈ": 132, "ʧ": 133,
    "ʊ": 135, "ʋ": 136, "ʌ": 138, "ɣ": 139,
    "ɤ": 140, "χ": 142, "ʎ": 143, "ʒ": 147,
    "ʔ": 148, "ˈ": 156, "ˌ": 157, "ː": 158,
    "ʰ": 162, "ʲ": 164, "↓": 169, "→": 171,
    "↗": 172, "↘": 173, "ᵻ": 177,
}


def default_vocab() -> dict[str, int]:
    """The checkpoint-true Kokoro-82M vocab (see KOKORO_VOCAB). Kept as a
    function for backward compatibility; a config.json vocab passed to
    ``Phonemizer(vocab=...)``/``KokoroTokenizer`` still takes precedence."""
    return dict(KOKORO_VOCAB)


class Phonemizer:
    """IPA phonemizer + vocab encoder (reference: KokoroTokenizer)."""

    def __init__(self, vocab: dict[str, int] | None = None):
        self.vocab = vocab or default_vocab()

    def phonemize(self, text: str) -> str:
        return text_to_ipa(text)

    def encode(self, text: str | None = None,
               phonemes: str | None = None) -> list[int]:
        """Encode text (via G2P) or a raw IPA string to vocab ids.
        Multi-char affricates are split into vocab symbols greedily."""
        ps = phonemes if phonemes is not None else self.phonemize(text or "")
        # common digraph respellings to single vocab codepoints
        ps = (ps.replace("tʃ", "ʧ").replace("dʒ", "ʤ"))
        return [self.vocab[c] for c in ps if c in self.vocab]
