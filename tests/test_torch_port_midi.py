"""The port's MIDI front end against the JAX package (CPU): the MIDI writer's
bytes, the seconds- and beat-domain readers, chord symbols, the converter's
note and duration-matrix functions, score export and the demo writer.
Every input is made in-process from a numpy seed."""
import struct

import numpy as np
import pytest

from pctd_tpu.data import chords as jchords
from pctd_tpu.data import converter as jconv
from pctd_tpu.data import demo as jdemo
from pctd_tpu.data import midi_io as jmidi
from pctd_tpu_torch.data import chords as tchords
from pctd_tpu_torch.data import converter as tconv
from pctd_tpu_torch.data import demo as tdemo
from pctd_tpu_torch.data import midi_io as tmidi
from pctd_tpu_torch.data.synthetic import synthetic_song


def _tracks(mod, seed, n_tracks=3):
    """Random tracks of ``mod``'s MidiTrack/Note: overlapping notes, odd
    names (one over 127 bytes), programs and velocities out of range."""
    rng = np.random.RandomState(seed)
    tracks = []
    for i in range(n_tracks):
        notes = []
        for _ in range(rng.randint(0, 40)):
            s = float(rng.rand() * 8)
            notes.append(mod.Note(int(rng.randint(-5, 140)),
                                  int(rng.randint(0, 128)), s,
                                  s + float(rng.rand()) * rng.randint(0, 2)))
        name = ["", "melody", "acc ü", "x" * 200][rng.randint(0, 4)]
        tracks.append(mod.MidiTrack(name=name,
                                    program=int(rng.randint(0, 200)),
                                    notes=notes))
    return tracks


@pytest.mark.parametrize("seed,bpm", [(0, 120.0), (1, 80.0), (2, 93.7),
                                      (3, 61.0)])
def test_written_bytes_equal_jax(tmp_path, seed, bpm):
    mine = tmidi.MidiFile(bpm=bpm, tracks=_tracks(tmidi, seed))
    theirs = jmidi.MidiFile(bpm=bpm, tracks=_tracks(jmidi, seed))
    assert mine._render() == theirs._render()
    a, b = tmp_path / "a.mid", tmp_path / "b.mid"
    mine.write(str(a))
    theirs.write(str(b))
    assert a.read_bytes() == b.read_bytes()
    # and both readers read the file back alike
    ra, rb = tmidi.MidiFile.read(str(a)), jmidi.MidiFile.read(str(a))
    assert ra.bpm == rb.bpm
    assert [(t.name, t.program, t.is_drum, [tuple(n) for n in t.notes])
            for t in ra.tracks] == \
        [(t.name, t.program, t.is_drum, [tuple(n) for n in t.notes])
         for t in rb.tracks]


def _tempo_and_meter_file(path):
    """One track at 480 ticks a quarter: 120 bpm, 60 bpm from beat 2, 4/4
    then 3/4 from beat 4, a running status note, a controller and a
    dangling note closed at the end of the track."""
    division = 480

    def meta(kind, payload):
        return bytes([0xFF, kind, len(payload)]) + payload

    events = [(0, meta(0x51, (500_000).to_bytes(3, "big"))),
              (0, meta(0x58, bytes([4, 2, 24, 8]))),
              (2 * division, meta(0x51, (1_000_000).to_bytes(3, "big"))),
              (4 * division, meta(0x58, bytes([3, 2, 24, 8]))),
              (0, meta(0x03, b"piano")), (0, bytes([0xC0, 5])),
              (division, bytes([0xB0, 7, 100]))]
    for beat in range(7):
        on, off = beat * division + 7 * beat, (beat + 1) * division
        events.append((on, bytes([0x90, 60 + beat, 90 + beat])))
        events.append((off, bytes([0x80, 60 + beat, 0])))
    events.append((3 * division, bytes([0x90, 72, 0])))   # vel 0: an off
    events.append((5 * division, bytes([0x90, 40, 70])))  # never released
    events.sort(key=lambda e: e[0])
    track, prev = b"", 0
    for tick, data in events:
        track += tmidi._varlen(tick - prev) + data
        prev = tick
    track += tmidi._varlen(division) + bytes([0xFF, 0x2F, 0x00])
    data = (struct.pack(">4sIHHH", b"MThd", 6, 0, 1, division)
            + struct.pack(">4sI", b"MTrk", len(track)) + track)
    with open(path, "wb") as f:
        f.write(data)


def test_readers_equal_jax_under_tempo_change_and_3_4(tmp_path):
    fn = str(tmp_path / "tempo_meter.mid")
    _tempo_and_meter_file(fn)
    mine, theirs = tmidi.read_beats(fn), jmidi.read_beats(fn)
    assert mine.bpm == theirs.bpm == 120.0
    assert mine.time_signatures == theirs.time_signatures == \
        [(0.0, 4, 4), (4.0, 3, 4)]
    assert [tuple(t) for t in mine.tracks] == [tuple(t) for t in theirs.tracks]
    assert mine.tracks[0].notes[1][:2] == (487 / 480, 2.0)
    secs = tmidi.MidiFile.read(fn)
    want = jmidi.MidiFile.read(fn)
    assert [tuple(n) for n in secs.tracks[0].notes] == \
        [tuple(n) for n in want.tracks[0].notes]


SYMBOLS = ["C", "Am", "G7", "F#m7b5", "C/E", "Bb", "Ebmaj7", "Dm9", "Gsus4",
           "Fdim7", "Caug", "A-7", "Db+", "E/G#", "Cb", "B#m", "F6", "Gm6",
           "Cmmaj7", "Bø", "N", "NC", "n.c.", "", " Am ", "H", "Cfoo", "c",
           "C/H", "Am/", "G13"]


@pytest.mark.parametrize("symbol", SYMBOLS)
def test_parse_chord_symbol_equals_jax(symbol):
    try:
        want = jchords.parse_chord_symbol(symbol)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tchords.parse_chord_symbol(symbol)
        assert str(got.value) == str(e)
        return
    got = tchords.parse_chord_symbol(symbol)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("text,n_beats,per", [
    ("C-Am-F-G", 16, 0), ("Am D7 G", 16, 0), ("C,F|G  C", 24, 3),
    ("Bb-Gm7-Eb/G", 7, 0), ("C-Am-F-G", 8, 5), ("Dm", 8, 2)])
def test_progression_table_equals_jax(text, n_beats, per):
    assert tchords.split_progression(text) == jchords.split_progression(text)
    syms = tchords.split_progression(text)
    np.testing.assert_array_equal(
        tchords.progression_to_chord_table(syms, n_beats, per),
        jchords.progression_to_chord_table(syms, n_beats, per))


@pytest.mark.parametrize("seed", [0, 1])
def test_converter_notes_and_durations_equal_jax(seed):
    rng = np.random.RandomState(seed)
    starts = rng.randint(0, 28, 20) + rng.rand(20).round(2)
    nmat = np.stack([starts, starts + 0.25 + rng.rand(20) * 3,
                     rng.randint(0, 128, 20), rng.randint(0, 128, 20)], 1)
    assert tconv.bpm_to_rate(75.0) == jconv.bpm_to_rate(75.0)
    for start, bpm in ((0.0, 120.0), (3.5, 77.0)):
        got = tconv.nmat_to_notes(nmat, start, bpm)
        want = jconv.nmat_to_notes(nmat, start, bpm)
        assert [tuple(n) for n in got] == [tuple(n) for n in want]
    pr = rng.choice([0, 0, 0, 1, 2], size=(3, 32, 128))
    onehot = tconv.pr_to_onehot_pr(pr)
    np.testing.assert_array_equal(onehot, jconv.pr_to_onehot_pr(pr))
    got = tconv.piano_roll_to_target(onehot)
    want = jconv.piano_roll_to_target(onehot)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_score_midi_export_equals_jax(tmp_path):
    from pctd_tpu.data.score import PolyphonicMusic as JMusic

    music = synthetic_song(np.random.RandomState(4), n_bars=6)
    music.track_name_list = ["melody", "bridge", "piano"]
    jm = JMusic([t.copy() for t in music.tracks],
                music.beat_track.beat_table.copy(),
                music.chord_table.copy(), [70, 0, 0],
                ["melody", "bridge", "piano"])
    for kw in ({}, {"track_ids": [2], "start": 1.5, "bpm": 90.0}):
        a, b = tmp_path / "a.mid", tmp_path / "b.mid"
        music.write_midi(str(a), **kw)
        jm.write_midi(str(b), **kw)
        assert a.read_bytes() == b.read_bytes()
    got = music.convert_track_to_notes(0, 2.0, 100.0)
    assert [tuple(n) for n in got] == \
        [tuple(n) for n in jm.convert_track_to_notes(0, 2.0, 100.0)]


def _grids(seed, n=3, K=16):
    """Decoded-grid-like (n, 32, K, 6) arrays: pitches 0..129 with eos
    (129) somewhere in most steps, random duration bits."""
    rng = np.random.RandomState(seed)
    g = np.zeros((n, 32, K, 6), np.int32)
    g[..., 0] = rng.randint(0, 131, (n, 32, K))
    g[..., 0][rng.rand(n, 32, K) < 0.15] = 129
    g[..., 1:] = rng.randint(0, 2, (n, 32, K, 5))
    return g


@pytest.mark.parametrize("K,bpm,max_notes", [(15, 60.0, None),
                                             (16, 80.0, None),
                                             (15, 97.3, 10)])
def test_grid_notes_and_demo_bytes_equal_jax(tmp_path, K, bpm, max_notes):
    grids = _grids(K, K=K)
    segs_t, segs_j = [], []
    for g in grids:
        pr_t, n_t = tdemo.grid_to_pr_and_notes(g, bpm=bpm, start=0.5,
                                               max_notes=max_notes)
        pr_j, n_j = jdemo.grid_to_pr_and_notes(g, bpm=bpm, start=0.5,
                                               max_notes=max_notes)
        np.testing.assert_array_equal(pr_t, pr_j)
        assert [tuple(n) for n in n_t] == [tuple(n) for n in n_j]
        segs_t.append(n_t)
        segs_j.append(n_j)
        np.testing.assert_array_equal(
            [tuple(n) for n in tdemo.pr_matrix_to_notes(pr_t, bpm, 1.0)],
            [tuple(n) for n in jdemo.pr_matrix_to_notes(pr_j, bpm, 1.0)])
    mel = np.zeros((32, 130))
    mel[:, 129] = 1
    mel[[0, 5, 9], [60, 62, 64]] = 1
    mel[[0, 5, 9], 129] = 0
    mel[[1, 2, 6], 128] = 1
    mel[[1, 2, 6], 129] = 0
    assert [tuple(n) for n in tdemo.mel_pr_to_notes(mel, bpm)] == \
        [tuple(n) for n in jdemo.mel_pr_to_notes(mel, bpm)]
    a, b = tmp_path / "a.mid", tmp_path / "b.mid"
    tdemo.write_demo(str(a), [segs_t, segs_t[::-1]], ["x", "y"], bpm=bpm,
                     shift_beat=8)
    jdemo.write_demo(str(b), [segs_j, segs_j[::-1]], ["x", "y"], bpm=bpm,
                     shift_beat=8)
    assert a.read_bytes() == b.read_bytes()
