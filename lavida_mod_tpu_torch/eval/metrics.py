"""Evaluation metrics.

Self-contained implementations of the metric stack the reference gets from
vendored lmms-eval (eval/lmms_eval/api/metrics.py and per-task utils):
CIDEr-D (coco_cap), ANLS (docvqa/infovqa), relaxed accuracy (chartqa),
exact-match / multiple-choice accuracy (mmmu, mmbench, ai2d, scienceqa),
and MME's acc + acc+ scoring (mme/utils.py).

The port's copy of lavida_mod_tpu/eval/metrics.py (pure Python; that
package's eval/__init__.py imports JAX, so the port keeps its own).
tests/test_torch_eval.py holds it equal to the original.
"""

from __future__ import annotations

import math
import re
import string
from collections import Counter, defaultdict
from typing import Iterable, Sequence


# ---------------------------------------------------------------------------
# text normalization
# ---------------------------------------------------------------------------

_PUNCT = str.maketrans("", "", string.punctuation)


def normalize_caption(s: str) -> list[str]:
    """PTB-ish tokenization used by COCO caption eval: lowercase, strip
    punctuation, split on whitespace."""
    return s.lower().translate(_PUNCT).split()


def normalize_answer(s: str) -> str:
    return " ".join(s.lower().translate(_PUNCT).split())


# ---------------------------------------------------------------------------
# CIDEr-D  (Vedantam et al. 2015; pycocoevalcap semantics)
# ---------------------------------------------------------------------------

def _ngram_counts(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def cider_d(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    n_max: int = 4,
    sigma: float = 6.0,
) -> float:
    """Corpus CIDEr-D, pycocoevalcap `cider_scorer.py` semantics:

      - document frequency counts IMAGES whose reference set contains the
        n-gram; idf weight = log(#images) - log(max(1, df));
      - vectors use RAW term frequency x idf (no caption-length division —
        the min() clipping makes the score sensitive to per-vector
        rescaling, so this must match exactly);
      - per-n cosine with the candidate weight clipped at the reference
        weight (min(h, r) * r), zero if either norm is zero;
      - the Gaussian length penalty uses the difference in BIGRAM counts
        (counts2vec tracks `length` only at n==1 — a pycocoevalcap quirk
        preserved here);
      - per image: sum over refs, mean over n, / #refs, x10; corpus = mean.

    Divergence: pycocoevalcap tokenizes with the Stanford PTBTokenizer
    (java); we use lowercase+strip-punctuation+split.  Returned x100 to
    match the published-table convention (pycocoevalcap returns 0-10).
    Validated against an independent transcription of the pycocoevalcap
    algorithm on randomized corpora (tests/test_eval.py).
    """
    assert len(candidates) == len(references)
    N = max(len(candidates), 1)
    cand_toks = [normalize_caption(c) for c in candidates]
    ref_toks = [[normalize_caption(r) for r in refs] for refs in references]

    # df[n][gram] = number of images whose refs contain the gram
    df = [defaultdict(float) for _ in range(n_max)]
    for refs in ref_toks:
        for n in range(n_max):
            seen = set()
            for r in refs:
                seen |= set(_ngram_counts(r, n + 1).keys())
            for g in seen:
                df[n][g] += 1.0
    ref_len = math.log(float(N))

    def counts2vec(tokens):
        vec = [defaultdict(float) for _ in range(n_max)]
        norm = [0.0] * n_max
        length = 0
        for n in range(n_max):
            for g, tf in _ngram_counts(tokens, n + 1).items():
                w = float(tf) * (ref_len - math.log(max(1.0, df[n][g])))
                vec[n][g] = w
                norm[n] += w * w
                if n == 1:
                    length += tf
        return vec, [math.sqrt(x) for x in norm], length

    scores = []
    for ci, refs in zip(cand_toks, ref_toks):
        c_vec, c_norm, c_len = counts2vec(ci)
        s = 0.0
        for r in refs:
            r_vec, r_norm, r_len = counts2vec(r)
            delta = float(c_len - r_len)
            pen = math.exp(-(delta * delta) / (2 * sigma * sigma))
            for n in range(n_max):
                num = sum(
                    min(w, r_vec[n].get(g, 0.0)) * r_vec[n].get(g, 0.0)
                    for g, w in c_vec[n].items()
                )
                if c_norm[n] != 0 and r_norm[n] != 0:
                    s += pen * num / (c_norm[n] * r_norm[n]) / n_max
        scores.append(10.0 * s / max(len(refs), 1))
    return 100.0 * sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# BLEU (corpus, uniform 1..n weights) and ROUGE-L — the rest of the COCO
# caption metric list (coco2017_cap_val_lite.yaml:20-35); METEOR needs
# WordNet and is omitted (the reference's own SPICE is commented out too)
# ---------------------------------------------------------------------------

def bleu(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
) -> float:
    """Corpus BLEU-max_n with brevity penalty (x100)."""
    p_log_sum = 0.0
    c_len = 0
    r_len = 0
    clipped = [0] * max_n
    totals = [0] * max_n
    for cand, refs in zip(candidates, references):
        ct = normalize_caption(cand)
        rts = [normalize_caption(r) for r in refs]
        c_len += len(ct)
        r_len += min((abs(len(r) - len(ct)), len(r)) for r in rts)[1]
        for n in range(1, max_n + 1):
            cc = _ngram_counts(ct, n)
            max_ref = Counter()
            for rt in rts:
                rc = _ngram_counts(rt, n)
                for g, c in rc.items():
                    max_ref[g] = max(max_ref[g], c)
            clipped[n - 1] += sum(min(c, max_ref[g]) for g, c in cc.items())
            totals[n - 1] += max(sum(cc.values()), 0)
    for n in range(max_n):
        if totals[n] == 0 or clipped[n] == 0:
            return 0.0
        p_log_sum += math.log(clipped[n] / totals[n]) / max_n
    bp = 1.0 if c_len > r_len else math.exp(1 - r_len / max(c_len, 1))
    return 100.0 * bp * math.exp(p_log_sum)


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y
                       else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


def rouge_l(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    beta: float = 1.2,
) -> float:
    """Mean ROUGE-L F-beta over best reference (x100, pycocoevalcap
    convention)."""
    scores = []
    for cand, refs in zip(candidates, references):
        ct = normalize_caption(cand)
        best = 0.0
        for r in refs:
            rt = normalize_caption(r)
            lcs = _lcs_len(ct, rt)
            if lcs == 0:
                continue
            p = lcs / len(ct)
            rec = lcs / len(rt)
            best = max(best, (1 + beta**2) * p * rec /
                       (rec + beta**2 * p))
        scores.append(best)
    return 100.0 * sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# ANLS (docvqa)
# ---------------------------------------------------------------------------

def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls(prediction: str, answers: Iterable[str], threshold: float = 0.5) -> float:
    """ANLS, matched exactly to the reference (api/metrics.py:298-321,
    itself the Qwen-VL infographicsvqa_eval transcription; cross-checked
    in tests/test_metrics_vs_reference.py). Reference quirks preserved:
    internal whitespace collapses before the edit distance, but the
    normalizer uses the RAW string lengths, and the 0.5 threshold zeroes
    the FINAL best score (boundary kept at exactly 0.5)."""
    answers = list(answers)
    if not answers:
        return 0.0
    values = []
    det = " ".join(prediction.strip().lower().split())
    for a in answers:
        gt = " ".join(str(a).strip().lower().split())
        d = _levenshtein(gt, det)
        length = max(len(str(a)), len(prediction))
        values.append(0.0 if length == 0 else d / length)
    result = 1.0 - min(values)
    return 0.0 if result < threshold else result


# ---------------------------------------------------------------------------
# relaxed accuracy (chartqa): 5% numeric tolerance, exact otherwise
# ---------------------------------------------------------------------------

def relaxed_accuracy(prediction: str, target: str, tol: float = 0.05) -> float:
    """Official ChartQA relaxed correctness, matched to the reference
    exactly (tasks/chartqa/utils.py:25-63, cross-checked in
    tests/test_metrics_vs_reference.py): trailing '%' DIVIDES by 100
    ('14%' != '14'), no comma/whitespace normalization, and a zero (or
    unparseable) TARGET falls through to case-insensitive string
    equality — quirks included, they shape the published numbers."""
    def to_float(text: str):
        try:
            if text.endswith("%"):
                return float(text.rstrip("%")) / 100.0
            return float(text)
        except ValueError:
            return None

    pf = to_float(prediction)
    tf = to_float(target)
    if pf is not None and tf:
        return float(abs(pf - tf) / abs(tf) <= tol)
    return float(prediction.lower() == target.lower())


# ---------------------------------------------------------------------------
# multiple-choice / exact match
# ---------------------------------------------------------------------------

_CHOICE_RE = re.compile(r"\b([A-E])\b")


def parse_multi_choice(prediction: str, choices: Sequence[str] = ("A", "B", "C", "D", "E")) -> str:
    """Extract the chosen letter from a free-form answer (lmms-eval's
    multiple-choice filter behavior: first standalone letter; fall back to
    matching an option's text)."""
    m = _CHOICE_RE.search(prediction.upper())
    if m and m.group(1) in choices:
        return m.group(1)
    return prediction.strip().upper()[:1]


def exact_match(prediction: str, target: str) -> float:
    return float(normalize_answer(prediction) == normalize_answer(target))


def yes_no_match(prediction: str, target: str) -> float:
    p = normalize_answer(prediction)
    t = normalize_answer(target)
    p = "yes" if p.startswith("yes") else ("no" if p.startswith("no") else p)
    return float(p == t)


# ---------------------------------------------------------------------------
# MME aggregate: per-image acc ("acc") + both-questions-right bonus ("acc+"),
# summed over perception subtasks x 100 -> the familiar ~1400 scale
# ---------------------------------------------------------------------------

def mme_scores(rows: Sequence[dict]) -> dict:
    """rows: {"category", "image_id", "correct": 0/1}."""
    by_cat: dict[str, dict[str, list[int]]] = defaultdict(lambda: defaultdict(list))
    for r in rows:
        by_cat[r["category"]][r["image_id"]].append(int(r["correct"]))
    out = {}
    total = 0.0
    for cat, images in by_cat.items():
        flat = [c for v in images.values() for c in v]
        acc = sum(flat) / max(len(flat), 1)
        acc_plus = sum(
            1 for v in images.values() if len(v) >= 2 and all(v)
        ) / max(len(images), 1)
        score = (acc + acc_plus) * 100.0
        out[cat] = score
        total += score
    out["total"] = total
    return out


# ---------------------------------------------------------------------------
# VQA accuracy (vqav2 / okvqa / vizwiz / textvqa-official protocol)
# ---------------------------------------------------------------------------
# Normalization data from the official VQA evaluation (EvalAI processor,
# reference eval/lmms_eval/tasks/_task_utils/vqa_eval_metric.py:11-211 —
# itself from facebookresearch/mmf).  The maps are published golden
# semantics; scores only match the tables if they match exactly.

_VQA_CONTRACTIONS = dict(p.split("=", 1) for p in (
    "aint=ain't arent=aren't cant=can't couldve=could've couldnt=couldn't "
    "couldn'tve=couldn't've couldnt've=couldn't've didnt=didn't "
    "doesnt=doesn't dont=don't hadnt=hadn't hadnt've=hadn't've "
    "hadn'tve=hadn't've hasnt=hasn't havent=haven't hed=he'd "
    "hed've=he'd've he'dve=he'd've hes=he's howd=how'd howll=how'll "
    "hows=how's Id've=I'd've I'dve=I'd've Im=I'm Ive=I've isnt=isn't "
    "itd=it'd itd've=it'd've it'dve=it'd've itll=it'll let's=let's "
    "maam=ma'am mightnt=mightn't mightnt've=mightn't've "
    "mightn'tve=mightn't've mightve=might've mustnt=mustn't "
    "mustve=must've neednt=needn't notve=not've oclock=o'clock "
    "oughtnt=oughtn't ow's'at='ow's'at 'ows'at='ow's'at 'ow'sat='ow's'at "
    "shant=shan't shed've=she'd've she'dve=she'd've she's=she's "
    "shouldve=should've shouldnt=shouldn't shouldnt've=shouldn't've "
    "shouldn'tve=shouldn't've somebody'd=somebodyd "
    "somebodyd've=somebody'd've somebody'dve=somebody'd've "
    "somebodyll=somebody'll somebodys=somebody's someoned=someone'd "
    "someoned've=someone'd've someone'dve=someone'd've "
    "someonell=someone'll someones=someone's somethingd=something'd "
    "somethingd've=something'd've something'dve=something'd've "
    "somethingll=something'll thats=that's thered=there'd "
    "thered've=there'd've there'dve=there'd've therere=there're "
    "theres=there's theyd=they'd theyd've=they'd've they'dve=they'd've "
    "theyll=they'll theyre=they're theyve=they've twas='twas "
    "wasnt=wasn't wed've=we'd've we'dve=we'd've weve=we've "
    "werent=weren't whatll=what'll whatre=what're whats=what's "
    "whatve=what've whens=when's whered=where'd wheres=where's "
    "whereve=where've whod=who'd whod've=who'd've who'dve=who'd've "
    "wholl=who'll whos=who's whove=who've whyll=why'll whyre=why're "
    "whys=why's wont=won't wouldve=would've wouldnt=wouldn't "
    "wouldnt've=wouldn't've wouldn'tve=wouldn't've yall=y'all "
    "yall'll=y'all'll y'allll=y'all'll yall'd've=y'all'd've "
    "y'alld've=y'all'd've y'all'dve=y'all'd've youd=you'd "
    "youd've=you'd've you'dve=you'd've youll=you'll youre=you're "
    "youve=you've"
).split())

_VQA_NUMBERS = {"none": "0", "zero": "0", "one": "1", "two": "2",
                "three": "3", "four": "4", "five": "5", "six": "6",
                "seven": "7", "eight": "8", "nine": "9", "ten": "10"}
_VQA_ARTICLES = {"a", "an", "the"}
_VQA_PERIOD = re.compile(r"(?!<=\d)(\.)(?!\d)")
_VQA_COMMA = re.compile(r"(?<=\d)(\,)+(?=\d)")
_VQA_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+",
              "\\", "_", "-", ">", "<", "@", "`", ",", "?", "!"]


def _vqa_punct_digit(t: str) -> str:
    """process_punctuation + process_digit_article
    (vqa_eval_metric.py:183-208)."""
    out = t
    for p in _VQA_PUNCT:
        if (p + " " in t or " " + p in t) or _VQA_COMMA.search(t):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _VQA_PERIOD.sub("", out)
    words = []
    for w in out.lower().split():
        w = _VQA_NUMBERS.get(w, w)
        if w not in _VQA_ARTICLES:
            words.append(_VQA_CONTRACTIONS.get(w, w))
    return " ".join(words)


def vqa_normalize(text: str) -> str:
    """EvalAI answer normalization — the processor's full __call__
    (vqa_eval_metric.py:178-211): word_tokenize, newline strip, then
    punctuation + digit/article passes.  Cross-checked against the
    imported reference in tests/test_metrics_vs_reference.py."""
    t = text.lower().replace(",", "").replace("?", "").replace("'s", " 's")
    t = t.strip().replace("\n", " ").replace("\t", " ").strip()
    return _vqa_punct_digit(t)


def vqa_accuracy(prediction: str, answers: Sequence[str]) -> float:
    """Official VQA accuracy, matched to vqav2/utils.py:17-47 exactly:
    the PREDICTION goes through the full EvalAI processor ALWAYS; ground
    truths are newline-stripped, and only when annotators disagree do
    gts AND the prediction get the punctuation+digit/article passes;
    leave-one-annotator-out mean of min(1, matches/3)."""
    pred = vqa_normalize(prediction)
    answers = [a.replace("\n", " ").replace("\t", " ").strip()
               for a in answers]
    if len(set(answers)) > 1:
        answers = [_vqa_punct_digit(a) for a in answers]
        pred = _vqa_punct_digit(pred)
    accs = []
    for i in range(len(answers)):
        others = answers[:i] + answers[i + 1:]
        accs.append(min(1.0, sum(o == pred for o in others) / 3.0))
    return sum(accs) / max(len(accs), 1)


def pope_aggregate(rows: Sequence[dict]) -> dict:
    """POPE: accuracy + precision/recall/F1 with 'yes' as positive, and
    yes_ratio over the GROUND TRUTH labels (dataset balance), matching
    tasks/pope/utils.py:29-87 exactly (fn counts only explicit 'no'
    predictions on 'yes' gts, like the reference's elif)."""
    tp = sum(1 for r in rows if r["pred"] == "yes" and r["gt"] == "yes")
    fp = sum(1 for r in rows if r["pred"] == "yes" and r["gt"] == "no")
    fn = sum(1 for r in rows if r["pred"] == "no" and r["gt"] == "yes")
    acc = sum(1 for r in rows if r["pred"] == r["gt"]) / max(len(rows), 1)
    prec = tp / (tp + fp) if tp + fp > 0 else 0
    rec = tp / (tp + fn) if tp + fn > 0 else 0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0
    n_gt = sum(1 for r in rows if r["gt"] in ("yes", "no"))
    yes_ratio = (sum(1 for r in rows if r["gt"] == "yes") / n_gt
                 if n_gt > 0 else 0)
    return {"accuracy": acc, "precision": prec, "recall": rec, "f1": f1,
            "yes_ratio": yes_ratio}


# ---------------------------------------------------------------------------
# round-2 breadth metrics (squad-F1 / edit-similarity / jaccard / REC bbox)
# ---------------------------------------------------------------------------

def _squad_normalize(s: str) -> str:
    """SQuAD answer normalization: lowercase, strip punctuation AND the
    articles a/an/the (websrc/utils.py normalize_answer)."""
    words = normalize_answer(s).split()
    return " ".join(w for w in words if w not in ("a", "an", "the"))


def squad_f1(prediction: str, answers: Sequence[str]) -> float:
    """Token-level SQuAD F1 (reference tasks/websrc/utils.py
    squad_evaluate -> compute_f1): max over gold answers of the harmonic
    mean of token precision/recall after article/punct normalization."""
    def toks(s):
        return _squad_normalize(s).split()

    p = toks(prediction)
    best = 0.0
    for a in answers:
        g = toks(str(a))
        if not p or not g:
            best = max(best, float(p == g))
            continue
        common = Counter(p) & Counter(g)
        overlap = sum(common.values())
        if overlap == 0:
            continue
        prec, rec = overlap / len(p), overlap / len(g)
        best = max(best, 2 * prec * rec / (prec + rec))
    return best


def norm_edit_similarity(prediction: str, target: str) -> float:
    """1 - normalized Levenshtein distance over characters — the donut
    evaluator's per-sample score (reference tasks/synthdog/
    donut_evaluator.py cal_acc: 1 - edit_distance/max_len, floored at 0)."""
    a, b = prediction.strip(), str(target).strip()
    if not a and not b:
        return 1.0
    d = _levenshtein(a, b)
    return max(0.0, 1.0 - d / max(len(a), len(b), 1))


def jaccard_word(prediction: str, target: str) -> float:
    """Word-set Jaccard index (reference tasks/vcr_wiki scoring: the
    covered-text restoration is graded by token-set overlap)."""
    p = set(_squad_normalize(prediction).split())
    g = set(_squad_normalize(str(target)).split())
    if not p and not g:
        return 1.0
    return len(p & g) / max(len(p | g), 1)


def parse_bbox(text: str):
    """Extract the first [x1, y1, x2, y2] float box from generated text
    (reference tasks/screenspot/utils.py screenspot_rec_process_result
    regex over the model output). Returns None when unparseable."""
    import re

    m = re.search(
        r"\[?\s*(-?\d+\.?\d*)\s*,\s*(-?\d+\.?\d*)\s*,"
        r"\s*(-?\d+\.?\d*)\s*,\s*(-?\d+\.?\d*)\s*\]?", text)
    if not m:
        return None
    return tuple(float(m.group(i)) for i in range(1, 5))


def bbox_iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    ub = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    return inter / max(ua + ub - inter, 1e-9)


def center_in_bbox(pred, gt) -> float:
    """Screenspot REC point accuracy: predicted box center inside the gold
    box (reference screenspot utils: center-point hit rate)."""
    if pred is None:
        return 0.0
    cx, cy = (pred[0] + pred[2]) / 2, (pred[1] + pred[3]) / 2
    return float(gt[0] <= cx <= gt[2] and gt[1] <= cy <= gt[3])


def textvqa_accuracy(prediction: str, answers: Sequence[str]) -> float:
    """TextVQA accuracy (tasks/textvqa/utils.py:19-39, cross-checked vs
    the imported reference): like VQA leave-one-out but the FULL EvalAI
    processor applies to the prediction AND every ground truth
    unconditionally."""
    pred = vqa_normalize(prediction)
    norm = [vqa_normalize(a) for a in answers]
    accs = []
    for i in range(len(norm)):
        others = norm[:i] + norm[i + 1:]
        accs.append(min(1.0, sum(o == pred for o in others) / 3.0))
    return sum(accs) / max(len(accs), 1)
