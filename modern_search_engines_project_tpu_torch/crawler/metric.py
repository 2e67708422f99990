"""Crawl relevance metric: tueEngScore (reference C16, crawler/metric.py).

Scores how likely a page is Tübingen-related *and* English, steering the
frontier (only pages scoring > 0.5 have their links expanded,
frontierManagement.py:239-248).  Formula parity with metric.py:116-152:

  score = (0.6*text + 0.25*url + 0.1*min(1, incoming/3)) * depth_penalty
  depth_penalty = max(0.5, 1 - 0.1*max_depth); hard 0 beyond depth 5;
  +0.15 rescue when incoming-link evidence is strong.

The term lists are our own curated equivalents of the reference's five
weighted lists (tuebingen_terms.py) — city/landmarks, university/academic,
region, food/culture, and English-language markers — NOT copies.  Language
detection: the reference gates on langdetect; this build ships a
self-contained stopword-ratio English detector (langdetect is not in the
image), same gating role.

A copy of the reference package's ``crawler/metric.py``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional
from urllib.parse import urlparse

# --- curated term lists (weights follow the reference's list structure:
# city 0.25, university 0.16, region 0.16, culture 0.11, academic 0.32) ----

CITY_TERMS = [
    "tuebingen", "tubingen", "hohentübingen", "hohentuebingen", "neckarfront",
    "stocherkahn", "neckarbrücke", "neckarbruecke", "altstadt tübingen",
    "tübinger", "tuebinger",
]
UNIVERSITY_TERMS = [
    "eberhard karls", "university of tübingen", "universität tübingen",
    "universitaet tuebingen", "uni tübingen", "uni tuebingen",
    "max planck institute", "hertie institute", "cyber valley",
    "excellence strategy", "tübingen ai center", "machine learning cluster",
]
REGION_TERMS = [
    "baden-württemberg", "baden-wuerttemberg", "swabia", "swabian",
    "neckar", "schwäbische alb", "schwaebische alb", "stuttgart region",
    "reutlingen", "black forest",
]
CULTURE_TERMS = [
    "punting", "punt boat", "chocolart", "umbrisch-provenzalischer",
    "stiftskirche", "bebenhausen", "hölderlin", "hoelderlin", "marktplatz",
    "rathaus", "weinstube", "besenwirtschaft",
]
ACADEMIC_TERMS = [
    "research", "institute", "faculty", "department", "lecture", "seminar",
    "professor", "phd", "study program", "campus", "semester", "laboratory",
]

_LIST_WEIGHTS = [
    (CITY_TERMS, 0.25),
    (UNIVERSITY_TERMS, 0.16),
    (REGION_TERMS, 0.16),
    (CULTURE_TERMS, 0.11),
    (ACADEMIC_TERMS, 0.32),
]

# English function words for the language gate
_EN_STOP = set(
    "the and of to in is that for with as on it by this are was be at from "
    "or an have has not but they you we his her their which".split()
)
_DE_STOP = set(
    "der die das und ist nicht mit für von ein eine dem den des im zu auf "
    "als auch sich bei werden wird nach über aus".split()
)
_WORD_RE = re.compile(r"[a-zA-ZäöüÄÖÜß]+")


def english_score(
    text: str, sample_chars: int = 4000, inconclusive: float = 0.3
) -> float:
    """Self-contained EN-vs-DE detector: stopword-hit ratio in [0, 1].

    ``inconclusive`` is returned when no stopword evidence exists at all;
    gates with permissive thresholds (merge_crawls' 0.15) pass 0.0 here so
    evidence-free text can't slip through on the convention value."""
    words = _WORD_RE.findall(text[:sample_chars].lower())
    if len(words) < 5:
        return 0.0
    en = sum(1 for w in words if w in _EN_STOP)
    de = sum(1 for w in words if w in _DE_STOP)
    total = len(words)
    if en + de == 0:
        return inconclusive
    ratio = en / (en + de)
    coverage = min(1.0, (en + de) / (0.2 * total))
    return ratio * coverage


def is_english(text: str, threshold: float = 0.5) -> bool:
    return english_score(text) >= threshold


# --- second, independent language signal: character trigrams ---------------
# The reference's preprocessor gates on langdetect OR polyglot >= 0.15
# (preprocessor.ipynb cells 11-14) — two independent detectors OR'd so a
# page passing either survives.  The stopword detector above is signal 1;
# this frozen high-frequency-trigram model (character level, so it also
# works on stopword-poor text like listings or headlines) is signal 2.
# All entries are exactly 3 chars; trigrams frequent in BOTH classes are
# excluded from both sets.
_EN_TRIGRAMS = frozenset((
    "the", "and", "ing", "ion", "tio", "ent", "ati", "for", "hat", "tha",
    "ere", "his", "ith", "ted", "ers", "thi", "wit", "are", "was", "ect",
    "rea", "eve", "int", "ear", "ain", "one", "our", "iti", "all", "out",
    "has", "hav", "whi", "hic", "ill", "oul", "uld", "ave", "you", "ons",
    "ngs", "ght", "igh", "sho", "hou", "ack",
))
# evidence AGAINST English: high-frequency German trigrams plus hard
# Romance/other function words (whole-word regex below) — EN-vs-DE alone
# let French/Spanish pages through (their trigrams overlap English's)
_NON_EN_TRIGRAMS = frozenset((
    "der", "die", "und", "den", "ein", "ich", "sch", "che", "gen", "ung",
    "nde", "cht", "das", "ber", "nen", "ine", "eit", "ies", "ite", "ach",
    "end", "ige", "ken", "auf", "ebe", "ner", "mit", "aus", "als", "wir",
    "uer", "ueb", "wer", "wie", "ben", "zur", "vom", "bei", "hab", "ihr",
))
_NON_EN_CHARS = set("äöüßàâéèêëíìîïóòôúùûñçãõåøæœ¿¡")
_NON_EN_WORD_RE = re.compile(
    r"\b(?:le|la|les|des|une|est|que|qui|avec|pour|dans|sur|el|los|las|"
    r"una|del|para|por|como|pero|sin|di|il|per|che|della|nel|con|una|"
    r"het|een|van|aan|och|att|inte|jest|nie|się)\b"
)


def trigram_english_score(text: str, sample_chars: int = 4000) -> float:
    """Character-trigram English score in [0, 1] (independent of the
    stopword detector's evidence): EN trigram hits vs German trigrams,
    non-ASCII letters, and non-English function words."""
    low = " ".join(text[:sample_chars].lower().split())
    if len(low) < 12:
        return 0.0
    en = non_en = 0
    for i in range(len(low) - 2):
        tri = low[i : i + 3]
        if tri[0] in _NON_EN_CHARS or tri[1] in _NON_EN_CHARS or tri[2] in _NON_EN_CHARS:
            non_en += 1  # accents/umlauts are a hard non-English signal
        elif tri in _EN_TRIGRAMS:
            en += 1
        elif tri in _NON_EN_TRIGRAMS:
            non_en += 1
    # whole-word evidence for languages whose trigrams overlap English's
    non_en += 3 * len(_NON_EN_WORD_RE.findall(low))
    if en + non_en == 0:
        return 0.3  # inconclusive
    ratio = en / (en + non_en)
    coverage = min(1.0, (en + non_en) / (0.02 * len(low)))
    return ratio * coverage


def is_probably_english(text: str, threshold: float = 0.5) -> bool:
    """Dual-detector gate: pass if EITHER detector accepts (the reference's
    langdetect-OR-polyglot rule, preprocessor.ipynb cells 11-14)."""
    return (
        english_score(text) >= threshold
        or trigram_english_score(text) >= threshold
    )


def text_score(text: str) -> float:
    """Weighted term-list hit score (metric.py:61-108 role)."""
    if not text:
        return 0.0
    if not is_english(text):
        return 0.0
    low = text.lower()
    score = 0.0
    hit_lists = 0
    for terms, weight in _LIST_WEIGHTS:
        hits = sum(low.count(t) for t in terms)
        if hits > 0:
            hit_lists += 1
            score += weight * min(1.0, hits / 3.0)
    # synergy bonus: city + academic evidence together (metric.py synergy)
    if hit_lists >= 3:
        score += 0.1
    if "germany" in low or "deutschland" in low:
        score += 0.05
    return min(1.0, score)


def url_score(url: str) -> float:
    """URL keyword/path heuristics (metric.py:25-47 role)."""
    try:
        p = urlparse(url)
    except Exception:
        return 0.0
    s = 0.0
    host_path = (p.netloc + p.path).lower()
    if "tuebingen" in host_path or "tubingen" in host_path or "tübingen" in host_path:
        s += 0.6
    if re.search(r"/(en|english)(/|$)", p.path.lower()):
        s += 0.3
    if host_path.endswith(".de"):
        s += 0.05
    depth = max(0, len([x for x in p.path.split("/") if x]) - 1)
    s -= 0.05 * min(depth, 4)
    return max(0.0, min(1.0, s))


def incoming_score(incoming_scores: Iterable[float]) -> float:
    """Ancestor-evidence score: sum of parent scores (metric.py:7-20)."""
    return float(sum(incoming_scores))


def tue_eng_score(
    text: str,
    url: str,
    incoming: int = 0,
    linking_depth: int = 0,
    domain_depth: int = 0,
    incoming_total_score: float = 0.0,
) -> float:
    """Combined crawl-priority score (metric.py:116-152 parity)."""
    max_depth = max(linking_depth, domain_depth)
    if max_depth > 5:
        return 0.0
    ts = text_score(text)
    us = url_score(url)
    inc = min(1.0, incoming / 3.0)
    score = 0.6 * ts + 0.25 * us + 0.1 * inc
    # rescue: strong incoming evidence on a weak page (metric.py:142-146)
    if incoming_total_score > 1.5 and score < 0.5:
        score += 0.15
    depth_penalty = max(0.5, 1.0 - 0.1 * max_depth)
    return score * depth_penalty
