"""Image-dataset loading for reference-generated training corpora
(counterpart of ``mmla_audio_tpu.data.datasets``).

The reference trains the overlap detector from a directory of feature PNGs +
an xlsx/csv label table (`overlap_detector.py:23-59` images_loader /
labels_loader; `data_augmentation.py` writes `augmented_labels.csv`,
`overlap_detector.py:281-309` __split_train_test writes Train/Test xlsx).
This loader ingests both on-disk formats so corpora produced by the original
scripts train directly here.  xlsx is parsed with a dependency-free reader
(an .xlsx file is a zip of XML; stdlib zipfile + ElementTree suffice — no
openpyxl/pandas needed), and PNGs with a small decoder on ``zlib`` and
NumPy (``read_png``).
"""

from __future__ import annotations

import csv
import re
import zipfile
import zlib
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple
from xml.etree import ElementTree

import numpy as np

__all__ = ["load_images", "read_png", "load_labels_csv",
           "load_image_dataset", "one_hot", "read_xlsx", "load_labels_xlsx"]


def load_images(images_dir, names: Sequence[str] | None = None
                ) -> Tuple[np.ndarray, List[str]]:
    """Decode PNGs -> float32 0..255 ``(B, H, W, 3)`` in RGB order, what the
    JAX package's ``cv2.imread`` loader gives after its BGR -> RGB flip
    (the reference decodes with ``tf.image.decode_png``).  ``read_png``
    decodes; every image must have the same size."""
    images_dir = Path(images_dir)
    if names is None:
        names = sorted(p.name for p in images_dir.glob("*.png"))
    arrs = [read_png(images_dir / name).astype(np.float32) for name in names]
    return np.stack(arrs), list(names)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}       # gray, RGB, RGBA


def _unfilter(raw: bytes, height: int, width: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth) ->
    ``(height, width * bpp)`` uint8."""
    stride = width * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        kind, filt = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            cur = filt.copy()
        elif kind == 1:
            cur = (np.cumsum(filt.reshape(width, bpp), axis=0, dtype=np.int64)
                   % 256).astype(np.uint8).reshape(stride)
        elif kind == 2:
            cur = filt + prior                   # uint8 arithmetic wraps
        elif kind in (3, 4):
            f, b = filt.tolist(), prior.tolist()
            c = bytearray(stride)
            for i in range(stride):
                left = c[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + b[i]) >> 1
                else:
                    up_left = b[i - bpp] if i >= bpp else 0
                    p = left + b[i] - up_left
                    pa, pb, pc = abs(p - left), abs(p - b[i]), abs(p - up_left)
                    pred = left if pa <= pb and pa <= pc else \
                        b[i] if pb <= pc else up_left
                c[i] = (f[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(c), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[r] = cur
        prior = cur
    return out


def read_png(path) -> np.ndarray:
    """A PNG -> ``(H, W, 3)`` uint8 RGB, with ``zlib`` and NumPy alone (the
    card's machine has neither OpenCV nor Pillow).  Takes 8-bit gray (its
    value in all three channels), RGB and RGBA (the alpha dropped, as
    ``cv2.imread``'s colour mode does), non-interlaced, every row filter;
    refuses any other PNG, naming the file and the reason."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = int.from_bytes(data[pos + 8 + length:pos + 12 + length], "big")
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        if kind == b"IHDR":
            header = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height = (int.from_bytes(header[i:i + 4], "big") for i in (0, 4))
    depth, color, _, _, interlace = header[8:13]
    if depth != 8:
        raise ValueError(f"{path}: unsupported PNG: bit depth {depth} "
                         f"(8 only)")
    if color not in _PNG_CHANNELS:
        raise ValueError(f"{path}: unsupported PNG: colour type {color} "
                         f"(gray, RGB or RGBA only; palette and gray+alpha "
                         f"are refused)")
    if interlace:
        raise ValueError(f"{path}: unsupported PNG: interlaced")
    bpp = _PNG_CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (width * bpp + 1):
        raise ValueError(f"{path}: PNG data holds {len(raw)} bytes, want "
                         f"{height * (width * bpp + 1)}")
    img = _unfilter(raw, height, width, bpp).reshape(height, width, bpp)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def load_labels_csv(labels_csv, name_col: str = "image_file_name",
                    label_col: str = "overlap_degree") -> dict:
    """-> {image_file_name: int label} from an augmented_labels-style CSV."""
    out = {}
    with open(labels_csv) as f:
        for row in csv.DictReader(f):
            out[row[name_col]] = int(row[label_col])
    return out


def one_hot(labels: Sequence[int], n_classes: int | None = None) -> np.ndarray:
    labels = np.asarray(labels, np.int64)
    if len(labels) and labels.min() < 0:
        # negative indexing would silently one-hot the LAST class (e.g. an
        # unexpected overlap_degree 0 under label_offset=-1)
        raise ValueError(f"negative label after offset: {labels.min()}")
    n = n_classes or int(labels.max()) + 1
    if len(labels) and labels.max() >= n:
        raise ValueError(f"label {labels.max()} >= n_classes {n}")
    y = np.zeros((len(labels), n), np.float32)
    y[np.arange(len(labels)), labels] = 1.0
    return y


_SSML = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_CELL_REF = re.compile(r"([A-Z]+)([0-9]+)")


def _col_index(ref: str) -> int:
    """Cell reference column letters -> 0-based index ('A'->0, 'AB'->27)."""
    n = 0
    for ch in ref:
        n = n * 26 + (ord(ch) - ord("A") + 1)
    return n - 1


def read_xlsx(path, sheet: int = 0) -> Tuple[List[str], List[List[Any]]]:
    """Minimal .xlsx reader -> (header row, data rows).

    Handles the cell types the reference's writers emit (pandas
    to_excel / openpyxl, `overlap_detector.py:281-309`): shared strings
    (t="s"), inline strings (t="inlineStr"/t="str"), booleans (t="b") and
    numbers (ints returned as int, else float).  Sparse rows (skipped
    cells) are densified via each cell's r= reference.
    """
    with zipfile.ZipFile(path) as zf:
        shared: List[str] = []
        try:
            root = ElementTree.fromstring(zf.read("xl/sharedStrings.xml"))
            for si in root.iter(f"{_SSML}si"):
                shared.append("".join(t.text or "" for t in si.iter(f"{_SSML}t")))
        except KeyError:
            pass
        # numeric sort: lexicographic order puts sheet10 before sheet2
        sheets = sorted(
            (n for n in zf.namelist()
             if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n)),
            key=lambda n: int(re.search(r"(\d+)\.xml$", n).group(1)))
        if not sheets:
            raise ValueError(f"no worksheets in {path}")
        root = ElementTree.fromstring(zf.read(sheets[sheet]))

    rows: List[List[Any]] = []
    for row_el in root.iter(f"{_SSML}row"):
        cells: Dict[int, Any] = {}
        next_col = 0
        for c in row_el.iter(f"{_SSML}c"):
            ref = c.get("r")
            col = _col_index(_CELL_REF.match(ref).group(1)) if ref else next_col
            next_col = col + 1
            ctype = c.get("t", "n")
            v = c.find(f"{_SSML}v")
            is_el = c.find(f"{_SSML}is")
            if ctype == "s":
                cells[col] = shared[int(v.text)]
            elif ctype == "inlineStr":
                cells[col] = "".join(t.text or "" for t in is_el.iter(f"{_SSML}t")) if is_el is not None else ""
            elif ctype == "str":
                cells[col] = v.text if v is not None else ""
            elif ctype == "b":
                cells[col] = bool(int(v.text))
            elif v is not None and v.text is not None:
                f = float(v.text)
                cells[col] = int(f) if f == int(f) else f
            else:
                cells[col] = None
        if cells:
            width = max(cells) + 1
            rows.append([cells.get(i) for i in range(width)])
    if not rows:
        return [], []
    header = [str(h) if h is not None else "" for h in rows[0]]
    width = len(header)
    data = [r + [None] * (width - len(r)) for r in rows[1:]]
    return header, data


def load_labels_xlsx(label_path, *, sort_by: Sequence[str] = ("Sessions", "Segments"),
                     label_col: str = "Overlap") -> np.ndarray:
    """labels_loader (`overlap_detector.py:46-59`): read the Train/Test xlsx,
    sort rows by (Sessions, Segments) ascending, one-hot encode the Overlap
    column with sklearn-OneHotEncoder semantics (categories = sorted unique
    values).  -> float32 (B, n_classes)."""
    header, rows = read_xlsx(label_path)
    col = {name: i for i, name in enumerate(header)}
    missing = [c for c in (*sort_by, label_col) if c not in col]
    if missing:
        raise KeyError(f"{label_path}: missing columns {missing}; has {header}")
    # blank cells read as None (pandas/openpyxl omit empty cells); drop
    # those rows rather than crash comparing int with None in the sort
    key_cols = [col[c] for c in (*sort_by, label_col)]
    rows = [r for r in rows if all(r[i] is not None for i in key_cols)]
    rows.sort(key=lambda r: tuple(r[col[c]] for c in sort_by))
    labels = [r[col[label_col]] for r in rows]
    cats = sorted(set(labels))
    index = {c: i for i, c in enumerate(cats)}
    y = np.zeros((len(labels), len(cats)), np.float32)
    y[np.arange(len(labels)), [index[l] for l in labels]] = 1.0
    return y


def load_image_dataset(images_dir, labels_csv, *, n_classes: int | None = None,
                       label_offset: int = 0,
                       name_col: str = "image_file_name",
                       label_col: str = "overlap_degree"
                       ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Join PNGs with CSV labels -> (x (B,H,W,3) 0..255, y one-hot, names).

    ``label_offset`` maps the reference's 1/2 coding (1 = single, 2 =
    overlapped, `data_augmentation.py:91-92`) onto 0-based classes with -1.
    """
    label_map = load_labels_csv(labels_csv, name_col, label_col)
    names = sorted(label_map)
    x, names = load_images(images_dir, names)
    labels = [label_map[n] + label_offset for n in names]
    return x, one_hot(labels, n_classes), names
