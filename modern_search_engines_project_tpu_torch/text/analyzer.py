"""Text analysis: normalization, tokenization, lemma-light stemming, counting.

TPU-native re-design of the reference's spaCy analysis pipeline
(reference ``indexer/bm25_indexer.py:16-54`` — lowercase + tübingen
normalization, 1M-char cap, lemma + stopword/punctuation/alpha filter,
term counting).  The reference runs spaCy (Cython) in a multiprocessing
pool; here the analyzer is a dependency-free deterministic pipeline with a
C++ route (``native/analyzer.cpp``, built with g++ at first use) so the
frozen term dictionary can be rebuilt bit-identically anywhere.  The C++
route is the default, as in the reference package; the two routes agree on
Latin-1 text and differ beyond it (the C++ case fold covers fewer code
points than ``str.lower()``: U+0130, U+1E9E, U+212A).

Output terms feed the term dictionary (``index/vocab.py``) whose ids are
what the device-side BM25 kernels consume — the analyzer itself is
host-side by design (SURVEY.md §7 "tokenization parity").
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Iterable, List

# --- normalization ----------------------------------------------------------

# The reference normalizes every spelling variant of the city name to one
# canonical token before tokenizing (bm25_indexer.py:32,
# search_api.py:158-162).  We canonicalize to the ASCII "tuebingen" so all
# downstream term ids are ASCII-stable.
_TUEBINGEN_RE = re.compile(r"t(?:ü|ue|u)binge[nr]s?", re.IGNORECASE)

_WS_RE = re.compile(r"\s+")

# Word tokens: letters (incl. German umlauts/ß) and digits, split on
# everything else.  This replaces spaCy's tokenizer; punctuation and
# non-alpha tokens are dropped at the filter stage like the reference's
# ``token.is_alpha`` check (bm25_indexer.py:41-47).
_TOKEN_RE = re.compile(r"[a-zA-ZäöüÄÖÜßàâéèêëíìîïóòôúùûñç]+")

MAX_DOC_CHARS = 1_000_000  # spaCy max-length analog, bm25_indexer.py:33


def normalize_text(text: str) -> str:
    """Lowercase + canonicalize Tübingen spellings + collapse whitespace."""
    text = text.lower()
    text = _TUEBINGEN_RE.sub("tuebingen", text)
    return text


# --- stopwords --------------------------------------------------------------

# Compact English stopword list (functional parity with spaCy's
# ``token.is_stop`` filter, bm25_indexer.py:44).  Kept deliberately small and
# frozen: changing it changes every term id.
STOPWORDS = frozenset(
    """a about above after again against all am an and any are aren as at be
    because been before being below between both but by can cannot could
    couldn did didn do does doesn doing don down during each few for from
    further had hadn has hasn have haven having he her here hers herself him
    himself his how i if in into is isn it its itself just ll m ma me
    mightn more most mustn my myself needn no nor not now o of off on once
    only or other our ours ourselves out over own re s same shan she should
    shouldn so some such t than that the their theirs them themselves then
    there these they this those through to too under until up ve very was
    wasn we were weren what when where which while who whom why will with
    won would wouldn y you your yours yourself yourselves""".split()
)

# --- lemma-light stemmer ----------------------------------------------------

# Irregular forms the suffix rules would mangle.  spaCy's lemmatizer is a
# lookup+rule hybrid; this is the "rule" half plus the highest-frequency
# lookups, enough for stable term statistics (parity is statistical, not
# token-exact — validated by the recall tests, SURVEY.md §7 "hard parts").
_IRREGULAR = {
    "is": "be", "was": "be", "are": "be", "were": "be", "been": "be",
    "am": "be", "being": "be",
    "has": "have", "had": "have", "having": "have",
    "does": "do", "did": "do", "done": "do", "doing": "do",
    "goes": "go", "went": "go", "gone": "go", "going": "go",
    "said": "say", "says": "say", "saying": "say",
    "made": "make", "making": "make",
    "took": "take", "taken": "take", "taking": "take",
    "came": "come", "coming": "come",
    "saw": "see", "seen": "see", "seeing": "see",
    "got": "get", "gotten": "get", "getting": "get",
    "gave": "give", "given": "give", "giving": "give",
    "found": "find", "finding": "find",
    "knew": "know", "known": "know", "knowing": "know",
    "thought": "think", "thinking": "think",
    "children": "child", "men": "man", "women": "woman", "people": "person",
    "feet": "foot", "teeth": "tooth", "mice": "mouse", "geese": "goose",
    "better": "good", "best": "good", "worse": "bad", "worst": "bad",
    "cities": "city", "universities": "university", "studies": "study",
    "lives": "life", "leaves": "leaf",
    # round-3 additions (real-prose divergence measurement,
    # docs/ANALYZER_DIVERGENCE.md): high-frequency irregulars whose base
    # form is unambiguous in retrieval ("bound"/"left"/"bit" stay as-is —
    # in technical prose they are usually the noun, and folding them to
    # bind/leave/bite would hurt)
    "built": "build", "written": "write", "wrote": "write",
    "sent": "send", "meant": "mean", "drawn": "draw", "drew": "draw",
    "hidden": "hide", "spent": "spend", "kept": "keep", "held": "hold",
    "brought": "bring", "bought": "buy", "taught": "teach",
    "caught": "catch", "ran": "run", "met": "meet",
    # round-5 additions (docs/ANALYZER_DIVERGENCE.md round-4 table):
    # unambiguous spaCy folds the suffix rules cannot reach
    "chose": "choose", "chosen": "choose", "choosing": "choose",
    "data": "datum", "media": "medium",
    "vertices": "vertex", "indices": "index", "matrices": "matrix",
    "axes": "axis", "analyses": "analysis", "hypotheses": "hypothesis",
    "criteria": "criterion", "maxima": "maximum", "minima": "minimum",
    "radii": "radius", "corpora": "corpus",
}

# Frozen e-restoration table: -ed/-ing stems that drop a final "e"
# ("provided" -> "provid").  Derived from measured disagreements with a
# full-lemmatization pipeline over real documentation prose
# (tools/analyzer_divergence.py evidence run, count >= ~25), plus the
# common short verbs the old heuristic guessed wrong ("reading" ->
# "reade").  A frozen table keeps the analyzer deterministic and
# dependency-free; it must match native/analyzer.cpp verbatim.
_E_RESTORE = frozenset(
    """provid defin encod bas creat includ enabl requir stor pars generat
    distribut shar rais introduc comput execut associat sampl advanc updat
    handl quantiz chang ignor produc compil deprecat reduc assum determin
    disabl indicat relat remov normaliz desir declar resolv decod
    initializ clos separat sav combin replac complet issu decorat cach
    deriv invok configur receiv captur multisampl rasteriz textur instanc
    mak tak writ com giv hav mov nam cod stat liv serv styl typ siz valu
    scal pag fil not merg manag invalidat iterat forc generaliz
    overrid notic referenc schedul prun validat evaluat acceler
    interpolat accumul propagat terminat enumerat instantiat concatenat
    serializ restor compar imag shap slic pip lin scop trac
    sourc featur measur releas packag encourag leverag integrat migrat
    consolidat
    tun delet populat retriev guarante shad rout escap
    observ prepar pickl templat acquir describ truncat
    rotat isolat travers activat negat locat dictat delegat
    navigat calibrat saturat annotat emulat
    improv achiev believ involv reserv preserv deserv
    compos expos propos suppos dispos purg surg dodg judg
    overwrit rewrit promot demot denot quot vot invit excit
    recit composit elevat motivat simulat stimulat translat
    relocat allocat deallocat duplicat replicat complicat
    communicat authenticat
    advis devis revis prais apprais exercis compris practis
    incorporat collaborat elaborat operat cooperat
    disput permut transmut pollut dilut persecut
    substitut constitut institut attribut contribut
    salut refut
    persuad evad invad upgrad degrad downgrad cascad
    subscrib prescrib transcrib inscrib
    consum resum presum subsum perfum
    oppos impos transpos juxtapos superpos predispos
    regenerat degenerat
    expir inspir aspir conspir perspir retir admir
    incit ignit unit reunit
    accommodat intimidat liquidat outdat mandat
    sedat elucidat erod explod corrod calculat exclud""".split()
)

# Doubled-"l" stems that undouble ("cancelled" -> "cancell" -> "cancel").
# The generic undoubling rule excludes final "l" (it would mangle
# "falling" -> "fal", "calling" -> "cal"); British-style l-doubling verbs
# are frozen here instead.  Derived, like _E_RESTORE, from the measured
# disagreement table (docs/ANALYZER_DIVERGENCE.md); must match
# native/analyzer.cpp verbatim.
_UNDOUBLE_LL = frozenset(
    "cancell labell modell travell controll compell signall equall".split()
)

_VOWELS = set("aeiouäöü")


def _strip_suffix(w: str) -> str:
    """Rule-based lemma-light stemming (conservative; keeps stems readable)."""
    n = len(w)
    if n <= 3:
        return w
    # plural / 3rd person
    if w.endswith("ies") and n > 4:
        return w[:-3] + "y"
    if w.endswith("sses"):
        return w[:-2]
    if w.endswith("xes") or w.endswith("zes") or w.endswith("ches") or w.endswith("shes"):
        return w[:-2]
    if w.endswith("s") and not w.endswith("ss") and not w.endswith("us") and not w.endswith("is"):
        return w[:-1]
    return w


def _restore_e(stem: str) -> str:
    """Frozen-table e-restoration: provid -> provide (see _E_RESTORE)."""
    return stem + "e" if stem in _E_RESTORE else stem


def _strip_verbal(w: str) -> str:
    n = len(w)
    if n <= 4:
        return w
    if w.endswith("ing") and n >= 6:
        stem = w[:-3]
        if len(stem) >= 3 and any(c in _VOWELS for c in stem):
            # doubled final consonant: running -> run.  Guard len >= 4:
            # "adding" -> "add" must NOT undouble to "ad"
            if len(stem) >= 4 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS and stem[-1] not in "ls":
                return stem[:-1]
            if stem in _UNDOUBLE_LL:
                return stem[:-1]
            # dropped 'e': making -> make — by frozen evidence table only
            # (the old CVC-length guess mangled short stems: reading ->
            # "reade"; docs/ANALYZER_DIVERGENCE.md)
            return _restore_e(stem)
    if w.endswith("ed") and n >= 5:
        stem = w[:-2]
        if any(c in _VOWELS for c in stem):
            if len(stem) >= 4 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS and stem[-1] not in "ls":
                return stem[:-1]
            if stem in _UNDOUBLE_LL:
                return stem[:-1]
            if stem.endswith("i"):
                return stem[:-1] + "y"
            return _restore_e(stem)
    return w


def lemmatize(word: str) -> str:
    """Lemma-light: irregular lookup, then plural, then verbal suffixes."""
    if word in _IRREGULAR:
        return _IRREGULAR[word]
    w = _strip_suffix(word)
    if w in _IRREGULAR:
        return _IRREGULAR[w]
    return _strip_verbal(w)


# --- analyzer ---------------------------------------------------------------


class Analyzer:
    """text -> filtered lemma terms.

    Pipeline (mirrors reference semantics, not implementation):
      1. truncate to 1M chars               (bm25_indexer.py:33,227)
      2. lowercase + tübingen normalization (bm25_indexer.py:30-32)
      3. regex word tokenization            (spaCy tokenizer analog)
      4. drop stopwords / len<2 / digits    (bm25_indexer.py:41-47)
      5. lemma-light stemming               (token.lemma_ analog)

    ``use_native=True`` (the default) runs it in C++ and raises if the
    library does not build; ``use_native=False`` runs the Python pipeline.
    """

    def __init__(self, use_native: bool = True):
        self._native = None
        if use_native:
            from modern_search_engines_project_tpu_torch.native import (
                native_analyzer,
            )

            self._native = native_analyzer.load()

    def tokens(self, text: str) -> List[str]:
        if len(text) > MAX_DOC_CHARS:
            text = text[:MAX_DOC_CHARS]
        if self._native is not None:
            return self._native.analyze(text)
        text = normalize_text(text)
        out = []
        for m in _TOKEN_RE.finditer(text):
            tok = m.group(0)
            if len(tok) < 2 or tok in STOPWORDS:
                continue
            lemma = lemmatize(tok)
            if len(lemma) < 2 or lemma in STOPWORDS:
                continue
            out.append(lemma)
        return out

    def count(self, text: str) -> Dict[str, int]:
        """Term -> frequency, as the reference's per-doc term counts
        (bm25_indexer.py:49-53)."""
        if self._native is not None:
            if len(text) > MAX_DOC_CHARS:
                text = text[:MAX_DOC_CHARS]
            return self._native.analyze_counts(text)
        return dict(Counter(self.tokens(text)))

    def analyze_batch(self, texts: Iterable[str]) -> List[Dict[str, int]]:
        return [self.count(t) for t in texts]
