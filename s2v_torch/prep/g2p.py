"""Grapheme-to-phoneme encoding (reference: third_part/emb/g2p.py — wraps
the g2p_en package, writes space-joined phonemes with '_' word separators;
s2v_tpu/prep/g2p.py).

The g2p_en package is optional; without it a deterministic rule-based
letter-to-sound fallback keeps the dataset tooling functional (same output
contract: list of phoneme strings with '_' separators).
"""

from __future__ import annotations

import re
import string
from typing import List


def _simple_letter_to_sound(word: str) -> List[str]:
    """Deterministic fallback G2P: digraph-aware letter mapping (NOT CMUdict
    quality; placeholder until a learned G2P checkpoint is converted)."""
    digraphs = {
        "ch": "CH", "sh": "SH", "th": "TH", "ph": "F", "ng": "NG",
        "qu": "K W", "ck": "K", "wh": "W", "ee": "IY", "oo": "UW",
        "ay": "EY", "ai": "EY", "ou": "AW", "ow": "AW", "oy": "OY",
    }
    vowels = {"a": "AE", "e": "EH", "i": "IH", "o": "AA", "u": "AH", "y": "IY"}
    consonants = {
        "b": "B", "c": "K", "d": "D", "f": "F", "g": "G", "h": "HH",
        "j": "JH", "k": "K", "l": "L", "m": "M", "n": "N", "p": "P",
        "r": "R", "s": "S", "t": "T", "v": "V", "w": "W", "x": "K S",
        "z": "Z",
    }
    word = word.lower()
    out: List[str] = []
    i = 0
    while i < len(word):
        pair = word[i : i + 2]
        if pair in digraphs:
            out.extend(digraphs[pair].split())
            i += 2
            continue
        ch = word[i]
        if ch in vowels:
            out.append(vowels[ch])
        elif ch in consonants:
            out.extend(consonants[ch].split())
        i += 1
    return out


def encode(text: str) -> List[str]:
    """emb/g2p.py:23-38 contract: phoneme tokens with '_' word separators."""
    try:
        from g2p_en import G2p  # optional dependency

        tokens = G2p()(text)
        return [t if t != " " else "_" for t in tokens if t.strip() or t == " "]
    except ImportError:
        pass

    words = re.findall(r"[a-zA-Z']+|[.,!?;]", text)
    out: List[str] = []
    for i, w in enumerate(words):
        if w in ".,!?;":
            out.append(w)
            continue
        if i > 0:
            out.append("_")
        out.extend(_simple_letter_to_sound(w))
    return out
