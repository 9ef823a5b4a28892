"""Number-word utilities: the port's copy of
``clip_finegrained_alignment_tpu/data/numbers.py`` (same functions, same
results). Captions are parsed for their counts, and the counterfactual
captions are written, with these maps and regular expressions.
"""

from __future__ import annotations

import re
from typing import Optional

# 1..12 covers CountBench's range; the dataloaders use the 1..10 prefix.
NUMBER_WORDS = {
    1: "one", 2: "two", 3: "three", 4: "four", 5: "five", 6: "six",
    7: "seven", 8: "eight", 9: "nine", 10: "ten", 11: "eleven",
    12: "twelve",
}
WORD_NUMBERS = {w: n for n, w in NUMBER_WORDS.items()}

_WORD_RE = re.compile(
    r"\b(" + "|".join(NUMBER_WORDS.values()) + r")\b", re.IGNORECASE)
_DIGIT_RE = re.compile(r"\b(\d+)\b")


def to_word(n: int) -> str:
    """1 → 'one'; out-of-range falls back to the digit string."""
    return NUMBER_WORDS.get(n, str(n))


def parse_number_token(tok: str) -> Optional[int]:
    """'3' or 'three' → 3; None if neither."""
    tok = tok.strip().lower()
    if tok.isdigit():
        return int(tok)
    return WORD_NUMBERS.get(tok)


def find_first_number(text: str):
    """First number (digit or word) in ``text`` → (value, matched_str, span)
    or None — the caption parser of ``cb_eval.py:125-146`` /
    ``synthetic_dataloader.py:36-53``. Scans left-to-right over both digit
    and word matches and returns whichever occurs first."""
    candidates = []
    md = _DIGIT_RE.search(text)
    if md:
        candidates.append((md.start(), int(md.group(1)), md))
    mw = _WORD_RE.search(text)
    if mw:
        candidates.append((mw.start(), WORD_NUMBERS[mw.group(1).lower()], mw))
    if not candidates:
        return None
    start, value, match = min(candidates, key=lambda c: c[0])
    return value, match.group(0), match.span()


def replace_first_number(text: str, new_value: int,
                         fmt: str = "word") -> str:
    """Replace the first number occurrence with ``new_value`` rendered as
    ``'word'`` | ``'numeric'`` (``cb_eval.py:80-87,163-181``)."""
    found = find_first_number(text)
    if found is None:
        return text
    _, _, (s, e) = found
    rendered = str(new_value) if fmt == "numeric" else to_word(new_value)
    return text[:s] + rendered + text[e:]


def count_after_with(caption: str) -> Optional[int]:
    """Parse the count following the last ``'with '`` — the counterfactual
    dataloader's caption grammar (``count_dataloader.py:51-73``:
    ``"A photo of {...} with {N} {label}s"``)."""
    if "with " not in caption:
        return None
    tail = caption.rsplit("with ", 1)[1]
    first = tail.split(" ", 1)[0].rstrip(".,")
    return parse_number_token(first)


def pluralize(label: str, n: int) -> str:
    """The reference's pluralization heuristic: append 's' when n != 1
    (``gen_synthetic_data.py:272-273``, ``count_dataloader.py:66-69``)."""
    return label if n == 1 else label + "s"


def counterfactual_counts(gt: int, low: int = 1, high: int = 10):
    """All counts in [low, high] except gt — the 9 counterfactuals of
    ``count_dataloader.py:51-73``."""
    return [c for c in range(low, high + 1) if c != gt]


def counterfactual_caption(caption: str, new_count: int) -> str:
    """Rewrite the count after the last 'with' (digits or words) and fix
    pluralization, mirroring ``count_dataloader.py:60-73``."""
    if "with " not in caption:
        return caption
    head, tail = caption.rsplit("with ", 1)
    parts = tail.split(" ")
    old = parse_number_token(parts[0])
    if old is None:
        return caption
    parts[0] = to_word(new_count) if not parts[0].isdigit() else str(new_count)
    if len(parts) > 1:
        label = parts[1].rstrip(".,")
        suffix = parts[1][len(label):]
        if old != 1 and label.endswith("s"):
            label = label[:-1]
        parts[1] = pluralize(label, new_count) + suffix
    return head + "with " + " ".join(parts)
