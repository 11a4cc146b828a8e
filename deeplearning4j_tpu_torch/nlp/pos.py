"""Part-of-speech tagging — averaged perceptron, trainable and bundled.

Reference parity: ``text/annotator/PoStagger.java`` (UIMA wrapper around
a pretrained OpenNLP maxent model) and
``text/tokenization/tokenizer/PosUimaTokenizer.java`` (keeps only tokens
whose tag is in an allow-list).  This environment is zero-egress, so
instead of shipping a 10 MB pretrained model the tagger is a compact
averaged perceptron (Collins 2002) trained on a bundled seed corpus at
first use — the same Penn-Treebank tag inventory, trainable on any
user-supplied tagged corpus, serializable to JSON.

Tags follow the PTB convention (NN, NNS, VB, VBD, JJ, DT, IN, ...).

Port of ``deeplearning4j_tpu/nlp/pos.py``: a copy; training draws from ``random.Random(seed)`` as the
reference does, so ``default_tagger()`` learns the same weights in both
packages.
"""

from __future__ import annotations

import json
import random
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

TaggedSentence = Sequence[Tuple[str, str]]


def _normalize(word: str) -> str:
    if any(c.isdigit() for c in word):
        return "!DIGITS" if word.isdigit() else "!MIXEDDIGITS"
    return word.lower()


def _features(i: int, word: str, context: List[str],
              prev: str, prev2: str) -> List[str]:
    """Feature templates: word identity, affixes, shape, neighbors, and
    the two previous predicted tags (the classic Collins set)."""
    w = context[i]
    feats = [
        "bias",
        f"w={w}",
        f"suf3={word[-3:]}",
        f"suf2={word[-2:]}",
        f"pre1={word[:1]}",
        f"p1={prev}",
        f"p2={prev2}",
        f"p1p2={prev}|{prev2}",
        f"p1w={prev}|{w}",
        f"w-1={context[i - 1]}",
        f"w-1suf3={context[i - 1][-3:]}",
        f"w-2={context[i - 2]}",
        f"w+1={context[i + 1]}",
        f"w+1suf3={context[i + 1][-3:]}",
        f"w+2={context[i + 2]}",
    ]
    if word and word[0].isupper():
        feats.append("shape=cap")
    if "-" in word:
        feats.append("shape=hyphen")
    return feats


class AveragedPerceptronTagger:
    """Greedy left-to-right tagger with averaged-perceptron weights.

    ``train`` on (word, tag) sentences; ``tag`` a token list.  Words seen
    unambiguously in training short-circuit through a tag dictionary
    (standard speedup + accuracy trick).
    """

    START = ["-START2-", "-START-"]
    END = ["-END-", "-END2-"]

    def __init__(self):
        self.weights: Dict[str, Dict[str, float]] = {}
        self.tagdict: Dict[str, str] = {}
        self.classes: List[str] = []

    # -- inference ----------------------------------------------------------
    def _score(self, feats: Sequence[str]) -> Dict[str, float]:
        scores: Dict[str, float] = defaultdict(float)
        for f in feats:
            for tag, w in self.weights.get(f, {}).items():
                scores[tag] += w
        return scores

    def _predict(self, feats: Sequence[str]) -> str:
        scores = self._score(feats)
        if not scores:
            return self.classes[0] if self.classes else "NN"
        # deterministic tie-break by tag name
        return max(self.classes, key=lambda t: (scores.get(t, 0.0), t))

    def tag(self, tokens: Sequence[str]) -> List[Tuple[str, str]]:
        prev, prev2 = self.START
        context = (self.START + [_normalize(t) for t in tokens] + self.END)
        out: List[Tuple[str, str]] = []
        for i, word in enumerate(tokens):
            guess = self.tagdict.get(_normalize(word))
            if guess is None:
                feats = _features(i + 2, word, context, prev, prev2)
                guess = self._predict(feats)
            out.append((word, guess))
            prev2, prev = prev, guess
        return out

    # -- training -----------------------------------------------------------
    def train(self, sentences: Iterable[TaggedSentence],
              n_iter: int = 8, seed: int = 7) -> "AveragedPerceptronTagger":
        sentences = [list(s) for s in sentences]
        self._build_tagdict(sentences)
        self.classes = sorted({t for s in sentences for _, t in s})

        totals: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        stamps: Dict[str, Dict[str, int]] = defaultdict(
            lambda: defaultdict(int))
        weights: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        self.weights = weights
        instant = 0
        rng = random.Random(seed)

        def upd(f: str, tag: str, delta: float) -> None:
            # lazily-averaged update: fold in elapsed time before changing
            totals[f][tag] += (instant - stamps[f][tag]) * weights[f][tag]
            stamps[f][tag] = instant
            weights[f][tag] += delta

        for _ in range(n_iter):
            rng.shuffle(sentences)
            for sent in sentences:
                tokens = [w for w, _ in sent]
                context = (self.START + [_normalize(t) for t in tokens]
                           + self.END)
                prev, prev2 = self.START
                for i, (word, gold) in enumerate(sent):
                    instant += 1
                    guess = self.tagdict.get(_normalize(word))
                    if guess is None:
                        feats = _features(i + 2, word, context, prev, prev2)
                        guess = self._predict(feats)
                        if guess != gold:
                            for f in feats:
                                upd(f, gold, +1.0)
                                upd(f, guess, -1.0)
                    prev2, prev = prev, guess
        # final average
        averaged: Dict[str, Dict[str, float]] = {}
        for f, tags in weights.items():
            row = {}
            for tag, w in tags.items():
                total = totals[f][tag] + (instant - stamps[f][tag]) * w
                avg = total / max(instant, 1)
                if abs(avg) > 1e-9:
                    row[tag] = round(avg, 6)
            if row:
                averaged[f] = row
        self.weights = averaged
        return self

    def _build_tagdict(self, sentences: Sequence[TaggedSentence],
                       freq_min: int = 3, ambiguity: float = 0.99) -> None:
        counts: Dict[str, Dict[str, int]] = defaultdict(
            lambda: defaultdict(int))
        for sent in sentences:
            for word, tag in sent:
                counts[_normalize(word)][tag] += 1
        self.tagdict = {}
        for word, tags in counts.items():
            tag, n = max(tags.items(), key=lambda kv: kv[1])
            total = sum(tags.values())
            if total >= freq_min and n / total >= ambiguity:
                self.tagdict[word] = tag
        # closed classes are enumerable: the lexicon always wins for them
        self.tagdict.update(CLOSED_CLASS)

    # -- persistence --------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"weights": self.weights, "tagdict": self.tagdict,
                           "classes": self.classes})

    @classmethod
    def from_json(cls, blob: str) -> "AveragedPerceptronTagger":
        d = json.loads(blob)
        t = cls()
        t.weights = d["weights"]
        t.tagdict = d["tagdict"]
        t.classes = d["classes"]
        return t


# ---------------------------------------------------------------------------
# Closed-class lexicon: determiners, prepositions, pronouns, conjunctions,
# modals, auxiliaries, wh-words and punctuation are finite sets — listing
# them beats learning them from a small corpus.
# ---------------------------------------------------------------------------

CLOSED_CLASS: Dict[str, str] = {
    **{w: "DT" for w in ("the", "a", "an", "this", "that", "these",
                         "those", "each", "every", "some", "any", "no",
                         "all", "both", "either", "neither", "another")},
    **{w: "IN" for w in ("of", "in", "on", "at", "by", "for", "with",
                         "about", "against", "between", "into", "through",
                         "during", "before", "after", "above", "below",
                         "from", "up", "down", "under", "over", "near",
                         "across", "behind", "beyond", "within", "without",
                         "toward", "towards", "upon", "since", "until",
                         "although", "because", "while", "whether", "if",
                         "than", "per")},
    **{w: "PRP" for w in ("i", "you", "he", "she", "it", "we", "they",
                          "me", "him", "her", "us", "them", "myself",
                          "himself", "herself", "itself", "themselves")},
    **{w: "PRP$" for w in ("my", "your", "his", "its", "our", "their")},
    **{w: "CC" for w in ("and", "or", "but", "nor", "yet", "so")},
    **{w: "MD" for w in ("can", "could", "may", "might", "must", "shall",
                         "should", "will", "would")},
    **{w: "WRB" for w in ("when", "where", "why", "how")},
    **{w: "WDT" for w in ("which", "whatever", "whichever")},
    **{w: "WP" for w in ("who", "whom", "what")},
    **{w: "EX" for w in ("there",)},
    **{w: "TO" for w in ("to",)},
    **{w: "RB" for w in ("not", "n't", "never", "also", "just", "only",
                         "very", "too", "then", "now", "here", "again",
                         "always", "often", "already")},
    **{w: "." for w in (".", "!", "?")},
    **{w: "," for w in (",",)},
    **{w: ":" for w in (":", ";")},
    **{w: "CD" for w in ("one", "two", "three", "four", "five", "six",
                         "seven", "eight", "nine", "ten", "zero")},
}


# ---------------------------------------------------------------------------
# Bundled seed corpus (hand-tagged, PTB tags) — enough signal for the
# suffix/context features to generalize to everyday text; users with a
# real treebank should train on it instead.
# ---------------------------------------------------------------------------

def _t(s: str) -> List[Tuple[str, str]]:
    return [tuple(p.rsplit("/", 1)) for p in s.split()]


SEED_CORPUS: List[List[Tuple[str, str]]] = [_t(s) for s in [
    "the/DT quick/JJ brown/JJ fox/NN jumps/VBZ over/IN the/DT lazy/JJ dog/NN ./.",
    "a/DT cat/NN sat/VBD on/IN the/DT mat/NN ./.",
    "dogs/NNS and/CC cats/NNS are/VBP friendly/JJ animals/NNS ./.",
    "she/PRP quickly/RB opened/VBD the/DT old/JJ wooden/JJ door/NN ./.",
    "he/PRP is/VBZ running/VBG to/TO the/DT store/NN ./.",
    "they/PRP have/VBP finished/VBN the/DT long/JJ report/NN ./.",
    "we/PRP will/MD build/VB a/DT new/JJ model/NN tomorrow/NN ./.",
    "the/DT children/NNS played/VBD happily/RB in/IN the/DT park/NN ./.",
    "my/PRP$ older/JJR brother/NN drives/VBZ a/DT red/JJ car/NN ./.",
    "this/DT is/VBZ the/DT best/JJS result/NN of/IN all/DT ./.",
    "john/NNP gave/VBD mary/NNP a/DT beautiful/JJ gift/NN ./.",
    "the/DT company/NN reported/VBD strong/JJ earnings/NNS yesterday/NN ./.",
    "researchers/NNS trained/VBD the/DT network/NN on/IN large/JJ datasets/NNS ./.",
    "the/DT model/NN learns/VBZ useful/JJ representations/NNS from/IN text/NN ./.",
    "it/PRP was/VBD raining/VBG heavily/RB when/WRB we/PRP arrived/VBD ./.",
    "can/MD you/PRP open/VB the/DT window/NN ,/, please/UH ?/.",
    "the/DT very/RB tall/JJ man/NN walked/VBD slowly/RB ./.",
    "birds/NNS fly/VBP south/RB in/IN the/DT winter/NN ./.",
    "she/PRP wrote/VBD three/CD papers/NNS about/IN neural/JJ networks/NNS ./.",
    "the/DT students/NNS are/VBP studying/VBG for/IN their/PRP$ exams/NNS ./.",
    "i/PRP think/VBP that/IN he/PRP knows/VBZ the/DT answer/NN ./.",
    "a/DT small/JJ boat/NN sailed/VBD across/IN the/DT calm/JJ lake/NN ./.",
    "the/DT weather/NN was/VBD cold/JJ and/CC windy/JJ ./.",
    "computers/NNS process/VBP information/NN faster/RBR than/IN humans/NNS ./.",
    "the/DT old/JJ library/NN contains/VBZ thousands/NNS of/IN books/NNS ./.",
    "he/PRP carefully/RB examined/VBD the/DT broken/JJ machine/NN ./.",
    "the/DT team/NN won/VBD the/DT final/JJ game/NN easily/RB ./.",
    "new/JJ ideas/NNS often/RB come/VBP from/IN simple/JJ questions/NNS ./.",
    "the/DT train/NN arrives/VBZ at/IN noon/NN every/DT day/NN ./.",
    "farmers/NNS grow/VBP wheat/NN in/IN these/DT fields/NNS ./.",
    "she/PRP has/VBZ been/VBN working/VBG here/RB for/IN ten/CD years/NNS ./.",
    "the/DT bright/JJ sun/NN melted/VBD the/DT snow/NN quickly/RB ./.",
    "good/JJ teachers/NNS explain/VBP difficult/JJ concepts/NNS clearly/RB ./.",
    "the/DT river/NN flows/VBZ through/IN the/DT green/JJ valley/NN ./.",
    "we/PRP visited/VBD an/DT ancient/JJ castle/NN in/IN scotland/NNP ./.",
    "the/DT price/NN of/IN oil/NN rose/VBD sharply/RB last/JJ week/NN ./.",
    "young/JJ children/NNS learn/VBP languages/NNS very/RB quickly/RB ./.",
    "the/DT musician/NN played/VBD a/DT beautiful/JJ song/NN ./.",
    "scientists/NNS discovered/VBD a/DT new/JJ species/NN of/IN frog/NN ./.",
    "the/DT engine/NN stopped/VBD suddenly/RB near/IN the/DT bridge/NN ./.",
    "many/JJ people/NNS enjoy/VBP reading/VBG mystery/NN novels/NNS ./.",
    "the/DT chef/NN prepared/VBD a/DT delicious/JJ meal/NN for/IN us/PRP ./.",
    "strong/JJ winds/NNS damaged/VBD several/JJ houses/NNS last/JJ night/NN ./.",
    "the/DT doctor/NN examined/VBD the/DT patient/NN carefully/RB ./.",
    "these/DT flowers/NNS bloom/VBP early/RB in/IN the/DT spring/NN ./.",
    "the/DT lawyer/NN presented/VBD convincing/JJ evidence/NN today/NN ./.",
    "tall/JJ buildings/NNS dominate/VBP the/DT city/NN skyline/NN ./.",
    "the/DT baby/NN slept/VBD peacefully/RB through/IN the/DT storm/NN ./.",
    "workers/NNS repaired/VBD the/DT damaged/VBN road/NN quickly/RB ./.",
    "the/DT artist/NN painted/VBD a/DT stunning/JJ portrait/NN ./.",
    "fresh/JJ vegetables/NNS taste/VBP better/JJR than/IN frozen/JJ ones/NNS ./.",
    "the/DT committee/NN approved/VBD the/DT new/JJ budget/NN ./.",
    "heavy/JJ rain/NN flooded/VBD the/DT lower/JJR streets/NNS ./.",
    "the/DT pilot/NN landed/VBD the/DT plane/NN safely/RB ./.",
    "curious/JJ tourists/NNS photographed/VBD the/DT famous/JJ statue/NN ./.",
    "the/DT software/NN runs/VBZ smoothly/RB on/IN older/JJR machines/NNS ./.",
    "loud/JJ music/NN annoyed/VBD the/DT sleeping/VBG neighbors/NNS ./.",
    "the/DT gardener/NN watered/VBD the/DT thirsty/JJ plants/NNS ./.",
    "brave/JJ firefighters/NNS rescued/VBD the/DT trapped/VBN family/NN ./.",
    "the/DT economy/NN grew/VBD steadily/RB during/IN the/DT decade/NN ./.",
    # no-trailing-punctuation forms so -END- context is not welded to "."
    "a/DT happy/JJ child/NN held/VBD a/DT shiny/JJ red/JJ balloon/NN",
    "the/DT hungry/JJ wolves/NNS followed/VBD the/DT snowy/JJ trail/NN",
    "sleepy/JJ travelers/NNS waited/VBD near/IN the/DT busy/JJ gate/NN",
    "she/PRP read/VBD an/DT interesting/JJ book/NN",
    "he/PRP bought/VBD an/DT expensive/JJ watch/NN",
    "an/DT angry/JJ customer/NN returned/VBD the/DT faulty/JJ toaster/NN",
    "tiny/JJ insects/NNS crawled/VBD across/IN the/DT dusty/JJ window/NN",
    "the/DT funny/JJ clown/NN made/VBD everyone/NN laugh/VB",
    "noisy/JJ trucks/NNS passed/VBD the/DT quiet/JJ village/NN",
    "several/JJ heavy/JJ boxes/NNS blocked/VBD the/DT narrow/JJ hallway/NN",
    "modern/JJ systems/NNS require/VBP careful/JJ testing/NN",
    "large/JJ models/NNS need/VBP fast/JJ accelerators/NNS",
    "the/DT compiler/NN optimizes/VBZ the/DT generated/VBN code/NN",
    "distributed/VBN training/NN uses/VBZ many/JJ devices/NNS",
    "a/DT cloudy/JJ sky/NN promised/VBD rainy/JJ weather/NN",
]]


_default_tagger: Optional[AveragedPerceptronTagger] = None


def default_tagger() -> AveragedPerceptronTagger:
    """Shared tagger trained once on the bundled seed corpus."""
    global _default_tagger
    if _default_tagger is None:
        _default_tagger = AveragedPerceptronTagger().train(SEED_CORPUS)
    return _default_tagger


def pos_tag(tokens: Sequence[str]) -> List[Tuple[str, str]]:
    """Tag a token list with the default tagger (PoStagger.java role)."""
    return default_tagger().tag(list(tokens))
