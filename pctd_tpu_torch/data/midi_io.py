"""Minimal pure-Python Standard MIDI File reader/writer (a copy of
``pctd_tpu/data/midi_io.py``; the bytes it writes equal that module's).

Enough to read MIDI files (note on/off, tempo, time signatures, in seconds
or tick-exact in beats) and to write multi-track output files (format 1,
tempo + program + notes), without a MIDI library.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, NamedTuple

TICKS_PER_QUARTER = 480


class Note(NamedTuple):
    velocity: int
    pitch: int
    start: float   # seconds
    end: float     # seconds


@dataclass
class MidiTrack:
    name: str = ""
    program: int = 0
    notes: List[Note] = field(default_factory=list)
    is_drum: bool = False


@dataclass
class MidiFile:
    bpm: float = 120.0
    tracks: List[MidiTrack] = field(default_factory=list)

    # -- writing ---------------------------------------------------------------

    def write(self, fn: str):
        with open(fn, "wb") as f:
            f.write(self._render())

    def _render(self) -> bytes:
        chunks = [self._tempo_track()]
        for i, tr in enumerate(self.tracks):
            chunks.append(self._note_track(tr, channel=min(i, 15)))
        head = struct.pack(">4sIHHH", b"MThd", 6, 1, len(chunks),
                           TICKS_PER_QUARTER)
        return head + b"".join(chunks)

    def _sec_to_tick(self, sec: float) -> int:
        return max(0, int(round(sec * self.bpm / 60.0 * TICKS_PER_QUARTER)))

    def _tempo_track(self) -> bytes:
        usec_per_quarter = int(round(60_000_000 / self.bpm))
        ev = (_varlen(0) + bytes([0xFF, 0x51, 0x03]) +
              usec_per_quarter.to_bytes(3, "big"))
        ev += _varlen(0) + bytes([0xFF, 0x2F, 0x00])
        return struct.pack(">4sI", b"MTrk", len(ev)) + ev

    def _note_track(self, tr: MidiTrack, channel: int) -> bytes:
        events = []  # (tick, order, bytes)
        name = tr.name.encode("utf-8")[:127]
        events.append((0, 0, bytes([0xFF, 0x03, len(name)]) + name))
        events.append((0, 1, bytes([0xC0 | channel, tr.program & 0x7F])))
        for n in tr.notes:
            on, off = self._sec_to_tick(n.start), self._sec_to_tick(n.end)
            if off <= on:
                off = on + 1
            events.append((on, 3, bytes([0x90 | channel, n.pitch & 0x7F,
                                         max(1, min(127, int(n.velocity)))])))
            events.append((off, 2, bytes([0x80 | channel, n.pitch & 0x7F, 0])))
        events.sort(key=lambda e: (e[0], e[1]))
        out, prev = b"", 0
        for tick, _, data in events:
            out += _varlen(tick - prev) + data
            prev = tick
        out += _varlen(0) + bytes([0xFF, 0x2F, 0x00])
        return struct.pack(">4sI", b"MTrk", len(out)) + out

    # -- reading ---------------------------------------------------------------

    @staticmethod
    def read(fn: str) -> "MidiFile":
        with open(fn, "rb") as f:
            data = f.read()
        pos = 0
        magic, length, fmt, ntracks, division = struct.unpack_from(
            ">4sIHHH", data, pos)
        if magic != b"MThd":
            raise ValueError(f"{fn}: not a MIDI file")
        pos += 8 + length
        if division & 0x8000:
            raise ValueError("SMPTE time division not supported")

        raw_tracks = []
        for _ in range(ntracks):
            tmagic, tlen = struct.unpack_from(">4sI", data, pos)
            if tmagic != b"MTrk":
                raise ValueError("bad track chunk")
            pos += 8
            raw_tracks.append(_parse_track(data[pos:pos + tlen]))
            pos += tlen

        # tempo map: (tick, usec_per_quarter), default 120 bpm
        tempos = sorted([(t, v) for tr in raw_tracks
                         for (t, v) in tr["tempos"]])
        if not tempos or tempos[0][0] > 0:
            tempos.insert(0, (0, 500_000))

        def tick_to_sec(tick: int) -> float:
            sec, prev_tick, upq = 0.0, 0, tempos[0][1]
            for t, v in tempos:
                if t >= tick:
                    break
                sec += (t - prev_tick) * upq / (1e6 * division)
                prev_tick, upq = t, v
            return sec + (tick - prev_tick) * upq / (1e6 * division)

        mf = MidiFile(bpm=60_000_000 / tempos[0][1])
        for tr in raw_tracks:
            if not tr["notes"]:
                continue
            notes = [Note(v, p, tick_to_sec(on), tick_to_sec(off))
                     for (on, off, p, v) in tr["notes"]]
            notes.sort(key=lambda n: (n.start, n.pitch))
            mf.tracks.append(MidiTrack(name=tr["name"],
                                       program=tr["program"], notes=notes,
                                       is_drum=tr["is_drum"]))
        return mf


class BeatTrackData(NamedTuple):
    """One track's notes in musical (beat) time: rows of
    (start_beat, end_beat, pitch, velocity) floats."""
    name: str
    program: int
    is_drum: bool
    notes: List[tuple]


class BeatMidi(NamedTuple):
    """A MIDI file read in BEAT domain (tick / ticks-per-quarter — exact
    under tempo changes, unlike the seconds-domain ``MidiFile.read``).
    ``time_signatures`` rows are (beat, numerator, denominator)."""
    bpm: float
    tracks: List[BeatTrackData]
    time_signatures: List[tuple]


def read_beats(fn: str) -> BeatMidi:
    """Read an SMF with note times in quarter-note beats (tick-exact).

    This is the front door of the raw-MIDI ingestion pipeline
    (:mod:`pctd_tpu_torch.data.ingest`): quantization must happen in
    musical time, so seconds (which depend on the tempo map) are never
    materialized."""
    with open(fn, "rb") as f:
        data = f.read()
    pos = 0
    magic, length, fmt, ntracks, division = struct.unpack_from(
        ">4sIHHH", data, pos)
    if magic != b"MThd":
        raise ValueError(f"{fn}: not a MIDI file")
    pos += 8 + length
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")

    raw_tracks = []
    for _ in range(ntracks):
        tmagic, tlen = struct.unpack_from(">4sI", data, pos)
        if tmagic != b"MTrk":
            raise ValueError("bad track chunk")
        pos += 8
        raw_tracks.append(_parse_track(data[pos:pos + tlen]))
        pos += tlen

    tempos = sorted([(t, v) for tr in raw_tracks for (t, v) in tr["tempos"]])
    bpm = 60_000_000 / tempos[0][1] if tempos else 120.0
    timesigs = sorted([(t / division, num, den) for tr in raw_tracks
                       for (t, num, den) in tr["timesigs"]])

    tracks = []
    for tr in raw_tracks:
        if not tr["notes"]:
            continue
        notes = [(on / division, off / division, p, v)
                 for (on, off, p, v) in tr["notes"]]
        notes.sort()
        tracks.append(BeatTrackData(tr["name"], tr["program"],
                                    tr["is_drum"], notes))
    return BeatMidi(bpm, tracks, timesigs)


def _varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


def _read_varlen(data: bytes, pos: int):
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


def _parse_track(data: bytes) -> dict:
    pos, tick, status = 0, 0, 0
    name, program, is_drum = "", 0, False
    tempos, notes, timesigs = [], [], []
    active = {}  # (channel, pitch) -> (start_tick, velocity)
    while pos < len(data):
        delta, pos = _read_varlen(data, pos)
        tick += delta
        b = data[pos]
        if b & 0x80:
            status = b
            pos += 1
        ev = status & 0xF0
        ch = status & 0x0F
        if status == 0xFF:
            meta = data[pos]
            pos += 1
            mlen, pos = _read_varlen(data, pos)
            payload = data[pos:pos + mlen]
            pos += mlen
            if meta == 0x51:
                tempos.append((tick, int.from_bytes(payload, "big")))
            elif meta == 0x03 and not name:
                name = payload.decode("utf-8", "replace")
            elif meta == 0x58 and mlen >= 2:
                timesigs.append((tick, payload[0], 1 << payload[1]))
        elif status in (0xF0, 0xF7):
            mlen, pos = _read_varlen(data, pos)
            pos += mlen
        elif ev == 0x90:
            pitch, vel = data[pos], data[pos + 1]
            pos += 2
            if vel > 0:
                active[(ch, pitch)] = (tick, vel)
            else:
                st = active.pop((ch, pitch), None)
                if st:
                    notes.append((st[0], tick, pitch, st[1]))
        elif ev == 0x80:
            pitch = data[pos]
            pos += 2
            st = active.pop((ch, pitch), None)
            if st:
                notes.append((st[0], tick, pitch, st[1]))
        elif ev == 0xC0:
            program = data[pos]
            if ch == 9:
                is_drum = True
            pos += 1
        elif ev == 0xD0:
            pos += 1
        elif ev in (0xA0, 0xB0, 0xE0):
            pos += 2
        else:
            raise ValueError(f"unexpected status byte {status:#x}")
    # close dangling notes at track end
    for (ch, pitch), (st, vel) in active.items():
        notes.append((st, tick, pitch, vel))
    notes.sort()
    return {"name": name, "program": program, "tempos": tempos,
            "notes": notes, "is_drum": is_drum, "timesigs": timesigs}
