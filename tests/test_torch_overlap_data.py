"""The port's overlap-training data vs the JAX package, on files the tests
write: mixture synthesis, the xlsx/csv label readers, the PNG decoder and
the image dataset; and the CLI's ``synth-corpus`` and ``overlap-train``
(default width, a 24-window corpus) with the checkpoint served by
``overlap-run --weights``.

Synthesis, labels and decoded images are exact.  PNGs are built here,
every row filter at 151 columns, and where ``cv2`` is installed (the JAX
loader needs it) also written by it; the port never imports ``cv2``.
"""

import csv
import zipfile
import zlib

import numpy as np
import pytest
import torch

from mmla_audio_tpu import cli as jax_cli
from mmla_audio_tpu.data import datasets as jax_datasets
from mmla_audio_tpu.data import synth as jax_synth
from mmla_audio_torch import cli
from mmla_audio_torch.data import datasets, synth
from mmla_audio_torch.data.wavio import read_wav, write_wav
from tests.conftest import synth_speech_i16
from tests.test_torch_speaker_post import _flags

torch.set_num_threads(1)


# -- synthesis -----------------------------------------------------------------
def _clip(sp, sm):
    rng = np.random.RandomState(sp * 100 + sm)
    n = rng.randint(12000, 40000)
    return (rng.randn(n) * 9000).astype(np.int16)


CLIPS = {(sp, sm): _clip(sp, sm) for sp in range(7) for sm in range(3)}


def _loader(sp, sm):
    return CLIPS[sp, sm], f"S{sp}"


@pytest.mark.parametrize("n_mixtures", [40, 6300])
def test_synthesize_corpus_matches_jax(n_mixtures, tmp_path):
    """Plan and mixtures bit-equal at 40 mixtures (the proportional
    schedule) and at the reference's 6,300 (its absolute thresholds
    3150/5040/5985), loud clips so that overlays saturate."""
    got, ref = {}, {}
    kw = dict(n_mixtures=n_mixtures, n_speakers=7, clips_per_speaker=3,
              seed=3)
    plan = synth.synthesize_corpus(_loader, sink=got.__setitem__, **kw)
    jplan = jax_synth.synthesize_corpus(_loader, sink=ref.__setitem__, **kw)
    assert [(e.index, e.speaker_ids, e.label) for e in plan] == \
        [(e.index, e.speaker_ids, e.label) for e in jplan]
    assert sorted(got) == list(range(n_mixtures))
    assert all(np.array_equal(got[i], ref[i]) for i in ref)
    counts = [len(e.speaker_ids) for e in plan]
    assert counts == [jax_synth.speaker_count_for_index(i, n_mixtures)
                      for i in range(n_mixtures)]
    assert set(counts) == {2, 3, 4, 5}
    assert any((m == 32767).any() or (m == -32768).any()
               for m in got.values())
    if n_mixtures == 40:                    # the WAV files as well
        synth.synthesize_corpus(_loader, out_dir=tmp_path / "a", **kw)
        jax_synth.synthesize_corpus(_loader, out_dir=tmp_path / "b", **kw)
        for i in range(n_mixtures):
            assert (tmp_path / "a" / f"Overlap{i}.wav").read_bytes() == \
                (tmp_path / "b" / f"Overlap{i}.wav").read_bytes()


@pytest.mark.parametrize("position", [0, 50, 99, 100, 150])
def test_overlay_and_mixture_match_jax(position):
    """Saturation both ways, truncation at the canvas end, a position past
    it; ``make_mixture`` on the same RandomState."""
    canvas = np.tile(np.int16([20000, -20000, 5]), 34)[:100]
    sound = np.tile(np.int16([20000, -20000, -7]), 70)[:200]
    got = synth.overlay(canvas, sound, position)
    ref = jax_synth.overlay(canvas, sound, position)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    clips = [CLIPS[1, position % 3], CLIPS[2, 1], CLIPS[3, 2]]
    np.testing.assert_array_equal(
        synth.make_mixture(clips, np.random.RandomState(position)),
        jax_synth.make_mixture(clips, np.random.RandomState(position)))


# -- labels ---------------------------------------------------------------------
def _write_xlsx(path, header, rows):
    """A minimal xlsx: shared strings, numbers, booleans, a skipped cell."""
    strings = []

    def cell(r, c, v):
        ref = f"{chr(ord('A') + c)}{r + 1}"
        if isinstance(v, bool):
            return f'<c r="{ref}" t="b"><v>{int(v)}</v></c>'
        if isinstance(v, str):
            strings.append(v)
            return f'<c r="{ref}" t="s"><v>{len(strings) - 1}</v></c>'
        return f'<c r="{ref}"><v>{v}</v></c>'

    ns = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    body = "".join(f'<row r="{r + 1}">' + "".join(
        cell(r, c, v) for c, v in enumerate(row) if v is not None) + "</row>"
        for r, row in enumerate([header] + rows))
    sst = "".join(f"<si><t>{s}</t></si>" for s in strings)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("xl/worksheets/sheet1.xml", f"<worksheet {ns}><sheetData>"
                    f"{body}</sheetData></worksheet>")
        zf.writestr("xl/sharedStrings.xml", f"<sst {ns}>{sst}</sst>")


def test_xlsx_and_csv_labels_match_jax(tmp_path):
    """``read_xlsx`` (a skipped cell, a boolean, floats), the sorted one-hot
    of ``load_labels_xlsx`` with a blank row dropped, ``load_labels_csv``
    and ``one_hot``."""
    rows = [["s1", 3, 2, True], ["s0", 2, 1, None], ["s1", 1, 1, False],
            ["s0", 10, 2, 0.5], ["s2", 1, None, 1.25]]
    path = tmp_path / "Train.xlsx"
    _write_xlsx(path, ["Sessions", "Segments", "Overlap", "Extra"], rows)
    assert datasets.read_xlsx(path) == jax_datasets.read_xlsx(path)
    got = datasets.load_labels_xlsx(path)
    np.testing.assert_array_equal(got, jax_datasets.load_labels_xlsx(path))
    assert got.shape == (4, 2)
    labels = tmp_path / "labels.csv"
    with open(labels, "w", newline="") as f:
        csv.writer(f).writerows([("image_file_name", "overlap_degree"),
                                 ("b.png", 2), ("a.png", 1), ("c.png", 2)])
    assert datasets.load_labels_csv(labels) == \
        jax_datasets.load_labels_csv(labels)
    for lab, n in (([0, 2, 1], None), ([1, 0], 4)):
        np.testing.assert_array_equal(datasets.one_hot(lab, n),
                                      jax_datasets.one_hot(lab, n))
    for bad in ([-1, 0], [3]):
        with pytest.raises(ValueError):
            datasets.one_hot(bad, 3)


# -- PNG ------------------------------------------------------------------------
def _chunk(kind: bytes, body: bytes) -> bytes:
    return (len(body).to_bytes(4, "big") + kind + body
            + zlib.crc32(kind + body).to_bytes(4, "big"))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def write_png(path, img: np.ndarray, filters=(0, 1, 2, 3, 4)) -> None:
    """An 8-bit gray (H, W), RGB or RGBA (H, W, C) PNG whose row r is
    written with filter ``filters[r % len(filters)]``."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 3: 2, 4: 6}[bpp]
    rows = img.reshape(h, w * bpp).astype(np.int64)
    raw = bytearray()
    for r in range(h):
        kind = filters[r % len(filters)]
        cur = rows[r]
        up = rows[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        pred = {0: 0 * cur, 1: left, 2: up, 3: (left + up) // 2,
                4: np.array([_paeth(*t) for t in zip(left, up, ul)],
                            np.int64)}[kind]
        raw.append(kind)
        raw.extend(((cur - pred) % 256).astype(np.uint8).tobytes())
    header = w.to_bytes(4, "big") + h.to_bytes(4, "big") + \
        bytes([8, color, 0, 0, 0])
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                     + _chunk(b"IDAT", zlib.compress(bytes(raw)))
                     + _chunk(b"IEND", b""))


def _feature_like(h=12, w=151, seed=0):
    """Smooth rows and noise, so every filter has work to do."""
    rng = np.random.RandomState(seed)
    ramp = np.linspace(0, 255, w)[None, :, None] + 40 * np.arange(h)[
        :, None, None]
    return ((ramp + rng.randint(0, 30, (h, w, 3))) % 256).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_every_filter(tmp_path, channels):
    """Hand-built PNGs, each filter on its own rows and all five mixed: the
    decoder gives the pixels back (gray in all three channels, alpha
    dropped) and, where ``cv2`` is installed, what ``cv2.imread(...)[...,
    ::-1]`` gives."""
    img = _feature_like(seed=channels)
    img = img[..., 0] if channels == 1 else np.concatenate(
        [img, img[..., :1] // 2], axis=2)[..., :channels]
    want = np.repeat(img[..., None], 3, 2) if channels == 1 else \
        img[..., :3]
    for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
        path = tmp_path / f"f{''.join(map(str, filters))}.png"
        write_png(path, img, filters)
        got = datasets.read_png(path)
        assert got.dtype == np.uint8 and got.shape == (12, 151, 3)
        np.testing.assert_array_equal(got, want)
        try:
            import cv2
        except ImportError:
            continue
        np.testing.assert_array_equal(got, cv2.imread(str(path))[..., ::-1])


def test_png_decoder_matches_cv2_written_files(tmp_path):
    """PNGs that OpenCV writes (libpng's own filter choice), gray, RGB and
    RGBA."""
    cv2 = pytest.importorskip("cv2")
    img = _feature_like(h=128, seed=5)
    for name, arr in (("gray", img[..., 0]), ("bgr", img),
                      ("bgra", np.concatenate([img, img[..., :1]], 2))):
        path = tmp_path / f"{name}.png"
        cv2.imwrite(str(path), arr)
        np.testing.assert_array_equal(datasets.read_png(path),
                                      cv2.imread(str(path))[..., ::-1])


@pytest.mark.parametrize("depth,color,interlace,reason", [
    (16, 2, 0, "bit depth 16"), (8, 3, 0, "colour type 3"),
    (8, 4, 0, "colour type 4"), (8, 2, 1, "interlaced")])
def test_png_decoder_refuses_other_pngs(tmp_path, depth, color, interlace,
                                        reason):
    path = tmp_path / "odd.png"
    header = (4).to_bytes(4, "big") + (2).to_bytes(4, "big") + \
        bytes([depth, color, 0, 0, interlace])
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                     + _chunk(b"IDAT", zlib.compress(bytes(64)))
                     + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=f"odd.png.*{reason}"):
        datasets.read_png(path)
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        datasets.read_png(path)


def test_load_image_dataset_matches_jax(tmp_path):
    """A directory of hand-built PNGs (every filter) and its labels CSV at
    the reference's 1/2 coding: images, one-hot labels and names equal the
    JAX loader's (``cv2.imread``, flipped to RGB)."""
    pytest.importorskip("cv2")
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rows = [("image_file_name", "overlap_degree")]
    for i in range(5):
        write_png(imgs / f"seg{i}.png", _feature_like(seed=10 + i),
                  filters=(i, (i + 2) % 5))
        rows.append((f"seg{i}.png", 1 + i % 2))
    labels = tmp_path / "labels.csv"
    with open(labels, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    got = datasets.load_image_dataset(imgs, labels, label_offset=-1)
    ref = jax_datasets.load_image_dataset(imgs, labels, label_offset=-1)
    assert got[0].dtype == np.float32 and got[0].shape == (5, 12, 151, 3)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


# -- CLI ------------------------------------------------------------------------
def _flat_wavs(d, n_speakers=4, clips=3):
    for s in range(n_speakers):
        for c in range(clips):
            write_wav(d / f"spk{s}_{c}.wav",
                      synth_speech_i16(20000 + 3000 * c, seed=10 * s + c))


def test_cli_synth_corpus_matches_jax(tmp_path, capsys):
    """Both CLIs over the same flat WAV directory: the same mixtures and
    labels CSV."""
    _flat_wavs(tmp_path / "wavs")
    for main, out in ((cli.main, "a"), (jax_cli.main, "b")):
        main(["synth-corpus", "--wav-dir", str(tmp_path / "wavs"),
              "--out-dir", str(tmp_path / out), "--n-mixtures", "12",
              "--seed", "2"])
    assert "[INFO] wrote 12 mixtures" in capsys.readouterr().out
    names = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == names
    assert len(names) == 13 and "augmented_labels.csv" in names
    for name in names:
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()


def test_cli_new_commands_take_jax_defaults(monkeypatch):
    """Every flag both parsers share has the JAX default."""
    ours, theirs = _flags(cli.main, monkeypatch), \
        _flags(jax_cli.main, monkeypatch)
    for cmd in ("synth-corpus", "overlap-train"):
        for flag in set(ours[cmd]) & set(theirs[cmd]):
            assert ours[cmd][flag].default == theirs[cmd][flag].default, flag


def test_cli_overlap_train_serves_its_checkpoint(tmp_path, capsys):
    """``synth-corpus`` then ``overlap-train --device cpu --epochs 1`` at the
    default width on 12 singles and 12 mixtures: the JAX command's
    ``[RESULT]`` lines, the best checkpoint, and ``overlap-run --weights``
    serving it."""
    _flat_wavs(tmp_path / "singles")
    cli.main(["synth-corpus", "--wav-dir", str(tmp_path / "singles"),
              "--out-dir", str(tmp_path / "mix"), "--n-mixtures", "12"])
    out_dir = tmp_path / "model"
    cli.main(["overlap-train", "--single-dir", str(tmp_path / "singles"),
              "--overlap-dir", str(tmp_path / "mix"), "--out", str(out_dir),
              "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[TIME] featurize:" in out and "(24 windows)" in out
    assert "epoch 0: loss=" in out
    assert "[RESULT] test accuracy: " in out
    assert "[RESULT] confusion:\n[[" in out
    assert f"[INFO] best checkpoint at {out_dir}" in out
    assert '"epoch": 0' in (out_dir / "metadata.json").read_text()
    wav = tmp_path / "singles" / "spk0_0.wav"
    assert len(read_wav(wav)[0]) >= 4000
    cli.main(["overlap-run", "-f", str(wav), "--device", "cpu",
              "--weights", str(out_dir / "variables.npz")])
    out = capsys.readouterr().out
    assert f"[INFO] weights: {out_dir / 'variables.npz'}" in out
    assert "[RESULT] spk0_0.wav: " in out
