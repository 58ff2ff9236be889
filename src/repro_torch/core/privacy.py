"""On-device privacy detector — paper Algorithm 2 (Sec. IV-A); the port's copy of ``repro/core/privacy.py``.

Stage 1: rule-based filter — regexes for numeric identifiers + a compact
named-entity keyword list (health / finance / location / family).
Stage 2: semantic back-off — embed the prompt with Γ (core/embedding.py)
and compare against five domain centroids; max cosine above τ flags it.
Sensitive prompts never reach the cloud LLM (serving/scheduler.py).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import embedding as E

# --------------------------------------------------------------------- rules

_REGEXES = [
    re.compile(r"\b\d{3}[-.\s]?\d{3,4}[-.\s]?\d{4}\b"),        # phone
    re.compile(r"\b(?:\d[ -]?){13,16}\b"),                     # credit card
    re.compile(r"\b\d{3}-\d{2}-\d{4}\b"),                      # SSN-style id
    re.compile(r"\b[\w.+-]+@[\w-]+\.[\w.]+\b"),                # email
    re.compile(r"\b\d{1,5}\s+\w+\s+(street|st|avenue|ave|road|rd|lane|ln|drive|dr)\b",
               re.I),                                          # street address
    re.compile(r"\b(passport|iban|swift)\s*(no|number|#)?\s*[:=]?\s*\w{6,}\b",
               re.I),
]

_NER_KEYWORDS = {
    "health": ["diagnosis", "prescription", "therapist", "medication",
               "symptom", "blood pressure", "diabetes", "hiv", "cancer",
               "my doctor", "medical record", "allergy", "insulin"],
    "finance": ["salary", "bank account", "credit score", "loan", "mortgage",
                "my savings", "tax return", "routing number", "debt",
                "net worth", "brokerage"],
    "location": ["my address", "my home", "where i live", "my apartment",
                 "my neighborhood", "gps", "my commute", "i live at"],
    "family": ["my wife", "my husband", "my daughter", "my son", "my mother",
               "my father", "my kids", "custody", "my family"],
    "profile": ["my password", "my username", "my birthday", "date of birth",
                "my age is", "my ssn", "my id number", "my account"],
}

# semantic centroids (Stage 2) — seed phrases per domain
_CENTROID_SEEDS: Dict[str, List[str]] = {
    "health": [
        "I have been feeling sick and my doctor prescribed medication",
        "my lab results show elevated glucose and the clinic called",
        "mental health therapy session notes about my anxiety",
        "my recent surgery recovery and physical therapy appointments",
        "the clinic called about the tests they ran on me last week",
        "results of the scans they did on me came back today",
    ],
    "finance": [
        "transfer money from my checking account to pay the mortgage",
        "my salary and yearly bonus compared to my monthly expenses",
        "my investment portfolio lost value and my broker emailed me",
        "paying off my credit card debt with a personal loan",
        "how much I owe on the house and what I get paid each year",
        "I get paid enough to cover what I owe, plan my budget",
    ],
    "legal": [
        "my lawyer filed the custody paperwork at the county court",
        "the settlement agreement I signed with my previous employer",
        "I was served a subpoena regarding my divorce case",
        "my immigration visa application and green card interview",
        "the judge set our hearing and we are separating, tell relatives",
    ],
    "location": [
        "directions from my home to my office on my daily commute",
        "the apartment I live in near the train station downtown",
        "my travel itinerary with hotel addresses for next week",
        "share my live location with the delivery driver",
        "the place where I sleep every night is near the station",
    ],
    "profile": [
        "update my account password and security questions",
        "my date of birth and identification number for the form",
        "my personal profile with username email and phone number",
        "reset the two factor authentication on my personal account",
        "the string I type to unlock my laptop and my login details",
        "the little one starts school monday, note for the teacher from me",
    ],
}


@dataclass
class PrivacyDetector:
    """Two-stage detector (Algorithm 2)."""
    tau: float = 0.35
    centroids: Dict[str, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        if not self.centroids:
            self.centroids = {k: E.centroid(v)
                              for k, v in _CENTROID_SEEDS.items()}
        self._cmat = np.stack(list(self.centroids.values()))
        self._cnames = list(self.centroids.keys())

    # Stage 1 ---------------------------------------------------------------
    def regex_match(self, x: str) -> bool:
        return any(r.search(x) for r in _REGEXES)

    def ner_match(self, x: str) -> bool:
        """Entity keyword + a personal-context cue.  Bare domain words in
        impersonal questions ("how do banks decide mortgage rates") must
        NOT trip Stage 1 — that asymmetry is what gives the paper-level
        precision (97.1%)."""
        low = x.lower()
        personal = any(f" {p} " in f" {low} "
                       for p in ("my", "me", "our", "mine", "i"))
        for kws in _NER_KEYWORDS.values():
            for kw in kws:
                if kw in low and (personal or kw.startswith("my ")):
                    return True
        return False

    # Stage 2 ---------------------------------------------------------------
    def semantic_scores(self, x: str) -> np.ndarray:
        return self._cmat @ E.embed_text(x)

    # Algorithm 2 -----------------------------------------------------------
    def detect(self, x: str) -> bool:
        """True => prompt must stay on-device."""
        if self.regex_match(x) or self.ner_match(x):
            return True                                   # Stage 1
        return bool(self.semantic_scores(x).max() > self.tau)  # Stage 2

    def explain(self, x: str) -> Dict[str, object]:
        s = self.semantic_scores(x)
        return {
            "regex": self.regex_match(x),
            "ner": self.ner_match(x),
            "semantic_max": float(s.max()),
            "semantic_domain": self._cnames[int(s.argmax())],
            "private": self.detect(x),
        }


def evaluate(detector: PrivacyDetector,
             labeled: Sequence[Tuple[str, bool]]) -> Dict[str, float]:
    """Sec. V-F metrics: precision / recall / F1 on labeled prompts."""
    tp = fp = fn = tn = 0
    for text, sensitive in labeled:
        pred = detector.detect(text)
        if pred and sensitive:
            tp += 1
        elif pred and not sensitive:
            fp += 1
        elif not pred and sensitive:
            fn += 1
        else:
            tn += 1
    prec = tp / max(1, tp + fp)
    rec = tp / max(1, tp + fn)
    f1 = 2 * prec * rec / max(1e-9, prec + rec)
    return {"precision": prec, "recall": rec, "f1": f1,
            "tp": tp, "fp": fp, "fn": fn, "tn": tn}
