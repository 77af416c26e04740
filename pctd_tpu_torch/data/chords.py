"""Chord-symbol parsing (a copy of ``pctd_tpu/data/chords.py``): "C", "Am",
"G7", "F#m7b5", "C/E" -> 14-d chord rows [root pc, chroma (12), bass pc],
the raw per-beat row format that ``converter.expand_chord`` reads.
"""
from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np

_NOTE = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}

_QUALITIES = {
    "": (0, 4, 7),
    "maj": (0, 4, 7),
    "M": (0, 4, 7),
    "m": (0, 3, 7),
    "min": (0, 3, 7),
    "-": (0, 3, 7),
    "dim": (0, 3, 6),
    "o": (0, 3, 6),
    "aug": (0, 4, 8),
    "+": (0, 4, 8),
    "7": (0, 4, 7, 10),
    "dom7": (0, 4, 7, 10),
    "m7": (0, 3, 7, 10),
    "min7": (0, 3, 7, 10),
    "-7": (0, 3, 7, 10),
    "maj7": (0, 4, 7, 11),
    "M7": (0, 4, 7, 11),
    "mmaj7": (0, 3, 7, 11),
    "dim7": (0, 3, 6, 9),
    "o7": (0, 3, 6, 9),
    "m7b5": (0, 3, 6, 10),
    "ø": (0, 3, 6, 10),
    "6": (0, 4, 7, 9),
    "m6": (0, 3, 7, 9),
    "sus2": (0, 2, 7),
    "sus4": (0, 5, 7),
    "9": (0, 2, 4, 7, 10),
    "maj9": (0, 2, 4, 7, 11),
    "m9": (0, 2, 3, 7, 10),
}

_SYMBOL_RE = re.compile(r"^([A-G])([#b]?)(.*?)(?:/([A-G])([#b]?))?$")


def _pc(letter: str, accidental: str) -> int:
    pc = _NOTE[letter]
    if accidental == "#":
        pc += 1
    elif accidental == "b":
        pc -= 1
    return pc % 12


def parse_chord_symbol(symbol: str) -> np.ndarray:
    """One symbol -> 14-d row [root, chroma(12), bass]. Raises ValueError on
    an unknown symbol; "N"/"NC" (no chord) -> all zeros."""
    symbol = symbol.strip()
    if symbol.upper() in ("N", "NC", "N.C.", ""):
        return np.zeros(14)
    m = _SYMBOL_RE.match(symbol)
    if not m:
        raise ValueError(f"unparseable chord symbol: {symbol!r}")
    root_l, root_acc, quality, bass_l, bass_acc = m.groups()
    if quality not in _QUALITIES:
        raise ValueError(f"unknown chord quality {quality!r} in {symbol!r} "
                         f"(known: {sorted(_QUALITIES)})")
    root = _pc(root_l, root_acc)
    tones = [(root + i) % 12 for i in _QUALITIES[quality]]
    bass = _pc(bass_l, bass_acc) if bass_l else root
    row = np.zeros(14)
    row[0] = root
    row[1 + np.asarray(tones)] = 1.0
    row[13] = bass
    return row


def progression_to_chord_table(symbols: Sequence[str], n_beats: int,
                               beats_per_chord: int = 0) -> np.ndarray:
    """Chord symbols -> (n_beats, 14) table, each chord held for
    ``beats_per_chord`` beats (0 = divide n_beats evenly; the last chord
    absorbs any remainder)."""
    rows = [parse_chord_symbol(s) for s in symbols]
    if beats_per_chord <= 0:
        beats_per_chord = max(1, n_beats // max(len(rows), 1))
    table = np.zeros((n_beats, 14))
    for b in range(n_beats):
        table[b] = rows[min(b // beats_per_chord, len(rows) - 1)]
    return table


def split_progression(text: str) -> List[str]:
    """'C-Am-F-G' / 'C Am F G' / 'C,Am,F,G' -> symbol list."""
    return [s for s in re.split(r"[-,\s|]+", text.strip()) if s]
