"""Synthetic multi-task instruction suite (Flan-cluster stand-in, Sec. V-A2)
— the port's copy of ``repro/data/tasks.py``.

Ten task domains with (a) distinctive surface vocabulary — so the
embedding router / LoRA clustering behaves like the paper's Fig. 5
heatmap — and (b) deterministic, *learnable* input→output mappings so a
tiny model demonstrably improves with fine-tuning (Table III orderings).

Also generates the CoGenesis stand-in: labeled sensitive/non-sensitive
prompts for the privacy-detector evaluation (Sec. V-F).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

WORDS_POS = ["great", "wonderful", "excellent", "amazing", "lovely", "superb"]
WORDS_NEG = ["terrible", "awful", "horrible", "dreadful", "poor", "bad"]
COLORS = ["red", "blue", "green", "amber", "violet", "teal"]
ANIMALS = ["cat", "dog", "owl", "fox", "hen", "bee"]
FR = {"cat": "chat", "dog": "chien", "red": "rouge", "blue": "bleu",
      "green": "vert", "water": "eau", "bread": "pain", "house": "maison"}


@dataclass(frozen=True)
class Example:
    prompt: str
    answer: str
    task: str


def _arithmetic(rng) -> Example:
    a, b = rng.randint(0, 49), rng.randint(0, 49)
    op = rng.choice(["plus", "minus"])
    val = a + b if op == "plus" else a - b
    return Example(f"math: compute {a} {op} {b} =", str(val), "arithmetic")


def _sorting(rng) -> Example:
    xs = rng.sample(range(10, 99), 4)
    return Example(f"sort ascending: {' '.join(map(str, xs))} ->",
                   " ".join(map(str, sorted(xs))), "sorting")


def _copy(rng) -> Example:
    xs = [rng.choice(ANIMALS) for _ in range(3)]
    return Example(f"repeat exactly: {' '.join(xs)} ->", " ".join(xs), "copy")


def _reverse(rng) -> Example:
    xs = [rng.choice(COLORS) for _ in range(3)]
    return Example(f"reverse the list: {' '.join(xs)} ->",
                   " ".join(reversed(xs)), "reverse")


def _sentiment(rng) -> Example:
    pos = rng.random() < 0.5
    w = rng.choice(WORDS_POS if pos else WORDS_NEG)
    return Example(f"sentiment: the movie was {w} . label =",
                   "positive" if pos else "negative", "sentiment")


def _translation(rng) -> Example:
    en = rng.choice(list(FR))
    return Example(f"translate to french: {en} ->", FR[en], "translation")


def _boolean(rng) -> Example:
    a, b = rng.random() < 0.5, rng.random() < 0.5
    op = rng.choice(["and", "or"])
    v = (a and b) if op == "and" else (a or b)
    return Example(f"logic: {str(a).lower()} {op} {str(b).lower()} =",
                   str(v).lower(), "boolean")


def _counting(rng) -> Example:
    n = rng.randint(2, 6)
    a = rng.choice(ANIMALS)
    xs = [a] * n + [rng.choice(COLORS) for _ in range(rng.randint(1, 3))]
    rng.shuffle(xs)
    return Example(f"count the {a} tokens: {' '.join(xs)} =", str(n),
                   "counting")


def _succ(rng) -> Example:
    a = rng.randint(0, 98)
    return Example(f"sequence: next integer after {a} is", str(a + 1),
                   "succession")


def _compare(rng) -> Example:
    a, b = rng.sample(range(0, 99), 2)
    return Example(f"compare: which is larger {a} or {b} ?",
                   str(max(a, b)), "compare")


TASKS: Dict[str, Callable] = {
    "arithmetic": _arithmetic,
    "sorting": _sorting,
    "copy": _copy,
    "reverse": _reverse,
    "sentiment": _sentiment,
    "translation": _translation,
    "boolean": _boolean,
    "counting": _counting,
    "succession": _succ,
    "compare": _compare,
}

TASK_DOMAINS: Dict[str, List[str]] = {
    # representative public samples per domain (for Γ(φ), Eq. 9)
    "arithmetic": ["math: compute 3 plus 4 =", "math: compute 10 minus 2 ="],
    "sorting": ["sort ascending: 4 2 9 1 ->", "sort ascending: 33 11 77 ->"],
    "copy": ["repeat exactly: cat dog owl ->", "repeat exactly: bee fox ->"],
    "reverse": ["reverse the list: red blue ->", "reverse the list: teal amber ->"],
    "sentiment": ["sentiment: the movie was great . label =",
                  "sentiment: the movie was awful . label ="],
    "translation": ["translate to french: cat ->", "translate to french: water ->"],
    "boolean": ["logic: true and false =", "logic: false or true ="],
    "counting": ["count the cat tokens: cat cat red =",
                 "count the owl tokens: owl owl owl blue ="],
    "succession": ["sequence: next integer after 4 is"],
    "compare": ["compare: which is larger 3 or 9 ?"],
}


def sample_task(task: str, rng: random.Random) -> Example:
    return TASKS[task](rng)


def make_dataset(task: str, n: int, seed: int = 0) -> List[Example]:
    rng = random.Random(seed * 9_973 + hash(task) % 1_000)
    return [sample_task(task, rng) for _ in range(n)]


def make_mixed_dataset(tasks: Sequence[str], n: int, seed: int = 0
                       ) -> List[Example]:
    rng = random.Random(seed)
    return [sample_task(rng.choice(list(tasks)), rng) for _ in range(n)]


# ---------------------------------------------------------------------------
# CoGenesis stand-in: labeled privacy prompts (Sec. V-F)
# ---------------------------------------------------------------------------

_SENSITIVE_TEMPLATES = [
    "my phone number is {p} please call me about the order",
    "remind me that my password is {w}{n} for the portal",
    "I live at {n} maple street, schedule the delivery there",
    "my doctor said my blood pressure is {n} over {m}, summarize the risks",
    "transfer {n} dollars from my bank account ending {m}",
    "my daughter {name} has a custody hearing on monday, draft a note",
    "email me at {name}{n}@example.com with the tax return summary",
    "my salary is {n}000 and my mortgage payment is {m}00, plan a budget",
    "my ssn is {a}-{b}-{c}, fill in the benefits form",
    "book a ride from my home near {name} park to the clinic",
]
_GENERAL_TEMPLATES = [
    "explain how photosynthesis works in simple terms",
    "write a haiku about the changing seasons",
    "what is the capital of {name} country in europe",
    "summarize the plot of a famous science fiction novel",
    "compare bubble sort and merge sort complexity",
    "give three tips for improving public speaking",
    "translate the phrase good morning into spanish",
    "what year did the first moon landing happen",
    "outline the steps to brew a cup of green tea",
    "describe the water cycle for a school project",
]
_NAMES = ["alice", "bob", "carol", "david", "erin", "frank"]

# hard cases: paraphrased/implicit sensitivity (no regex/keyword hit) and
# domain-adjacent but non-personal prompts — these exercise Stage 2 and
# bound F1 below 100% like the paper's 94.3
_SENSITIVE_HARD = [
    "the place where I sleep every night is two blocks from the station",
    "the clinic called about the results of the tests they ran on me",
    "how much I owe on the house keeps me up at night, help me plan",
    "the little one starts kindergarten monday, write the teacher a note",
    "the string I type to unlock my laptop needs to be changed",
    "I get paid {n} grand a year, is that enough to move out",
    "the judge set our hearing for thursday, summarize what to expect",
    "my other half and I are separating, draft a message to relatives",
]
_GENERAL_HARD = [
    "what is a normal resting blood pressure for adults",
    "how do banks decide mortgage interest rates in general",
    "what documents does a typical passport application require",
    "explain how gps satellites determine a position",
    "what is the average salary of a software engineer globally",
    "how does two factor authentication work conceptually",
    "what happens at a custody hearing in general terms",
    "give an overview of how health insurance deductibles work",
]


def make_privacy_dataset(n: int = 3_000, seed: int = 0
                         ) -> List[Tuple[str, bool]]:
    rng = random.Random(seed)
    out: List[Tuple[str, bool]] = []
    for i in range(n):
        sensitive = rng.random() < 0.5
        hard = rng.random() < 0.2
        if hard:
            tpl = rng.choice(_SENSITIVE_HARD if sensitive
                             else _GENERAL_HARD)
        else:
            tpl = rng.choice(_SENSITIVE_TEMPLATES if sensitive
                             else _GENERAL_TEMPLATES)
        text = tpl.format(
            p=f"{rng.randint(200,999)}-{rng.randint(200,999)}-{rng.randint(1000,9999)}",
            w=rng.choice(_NAMES), n=rng.randint(10, 99),
            m=rng.randint(10, 99), a=rng.randint(100, 999),
            b=rng.randint(10, 99), c=rng.randint(1000, 9999),
            name=rng.choice(_NAMES))
        out.append((text, sensitive))
    return out
