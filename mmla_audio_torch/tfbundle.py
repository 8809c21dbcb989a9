"""Dependency-free reader for TensorFlow TensorBundle checkpoints (the
port's own copy of ``mmla_audio_tpu.tfbundle``: stdlib and numpy only).

A TF ``variables`` checkpoint (what a SavedModel ships under
``variables/variables.index`` + ``variables.data-NNNNN-of-MMMMM``) is a
*TensorBundle*: the ``.index`` file is an SSTable-style table mapping
checkpoint keys to BundleEntryProto values (dtype, shape, shard, byte range),
and the ``.data`` shards hold the raw row-major tensor bytes.  The reference
ships exactly these artifacts for its pretrained models
(`OverlapDetection/timit/models/timit2.0/variables/variables.index`,
`SpeakerIdentification/timit/model/variables/variables.index`), so loading
them must not require TensorFlow — this module parses the format directly
with stdlib + numpy.

Format notes (verified byte-for-byte against the shipped index files):

* The file ends with a 48-byte footer: varint64 BlockHandles
  (offset, size) for the metaindex and index blocks, zero padding, and the
  8-byte little-endian magic ``0xdb4775248b80fb57``.
* A block is a sequence of prefix-compressed entries
  ``varint32 shared, varint32 non_shared, varint32 value_len, key_suffix,
  value`` followed by a uint32 restart array; on disk each block is followed
  by a 1-byte compression type (0 = raw) and a masked crc32c.
* The index block maps the last key of each data block to that block's
  BlockHandle; data-block entries map checkpoint keys to BundleEntryProto:
  ``1: dtype, 2: TensorShapeProto{2: Dim{1: size}}, 3: shard_id, 4: offset,
  5: size, 6: crc32c (fixed32)``.  The empty key holds the
  BundleHeaderProto (``1: num_shards``).
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

__all__ = ["BundleEntry", "read_index", "read_bundle", "list_variables",
           "keras_weight_list"]

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_SIZE = 48

# tensorflow DataType enum -> numpy dtype (the subset a Keras checkpoint can
# contain; DT_STRING entries like the object graph are returned as raw bytes).
_DTYPES = {
    1: np.dtype(np.float32), 2: np.dtype(np.float64), 3: np.dtype(np.int32),
    4: np.dtype(np.uint8), 5: np.dtype(np.int16), 6: np.dtype(np.int8),
    9: np.dtype(np.int64), 10: np.dtype(np.bool_), 17: np.dtype(np.uint16),
    19: np.dtype(np.float16), 22: np.dtype(np.uint32), 23: np.dtype(np.uint64),
}
_DT_STRING = 7
_DT_BFLOAT16 = 14


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Decode one LEB128 varint at ``pos`` -> (value, next_pos)."""
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Iterate (key, value) over one restart-array block."""
    if len(block) < 4:
        return
    n_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 - 4 * n_restarts
    if data_end < 0:
        raise ValueError("corrupt block: restart array larger than block")
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        value_len, pos = _varint(block, pos)
        if shared > len(key):
            raise ValueError("corrupt block: shared prefix exceeds prior key")
        key = key[:shared] + block[pos: pos + non_shared]
        pos += non_shared
        value = block[pos: pos + value_len]
        pos += value_len
        yield key, value


def _read_block(buf: bytes, offset: int, size: int) -> bytes:
    """Fetch one block, honouring the 1-byte compression-type trailer."""
    block = buf[offset: offset + size]
    if len(block) < size:
        raise ValueError(f"index truncated: block at {offset}+{size}")
    ctype = buf[offset + size] if offset + size < len(buf) else 0
    if ctype == 0:
        return block
    raise NotImplementedError(
        f"compressed table block (type {ctype}); TF writes checkpoint "
        "indexes uncompressed — is this really a variables.index?")


def _proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Walk top-level protobuf fields -> (field_number, wire_type, value)."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val = struct.unpack("<Q", buf[pos: pos + 8])[0]
            pos += 8
        elif wire == 2:
            ln, pos = _varint(buf, pos)
            val = buf[pos: pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack("<I", buf[pos: pos + 4])[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    """TensorShapeProto: field 2 = repeated Dim{1: size}."""
    dims: List[int] = []
    for field, _, val in _proto_fields(buf):
        if field == 2:
            size = 0
            for f2, _, v2 in _proto_fields(val):
                if f2 == 1:
                    size = v2
            dims.append(size)
    return tuple(dims)


@dataclass(frozen=True)
class BundleEntry:
    dtype_enum: int
    shape: Tuple[int, ...]
    shard_id: int
    offset: int
    size: int
    crc32c: int

    @property
    def numpy_dtype(self) -> np.dtype:
        if self.dtype_enum == _DT_BFLOAT16:
            # raw uint16 bits; widened to f32 by read_bundle
            return np.dtype(np.uint16)
        try:
            return _DTYPES[self.dtype_enum]
        except KeyError:
            raise NotImplementedError(f"DataType enum {self.dtype_enum}")


def _parse_entry(buf: bytes) -> BundleEntry:
    dtype = shard = offset = size = crc = 0
    shape: Tuple[int, ...] = ()
    for field, _, val in _proto_fields(buf):
        if field == 1:
            dtype = val
        elif field == 2:
            shape = _parse_shape(val)
        elif field == 3:
            shard = val
        elif field == 4:
            offset = val
        elif field == 5:
            size = val
        elif field == 6:
            crc = val
    return BundleEntry(dtype, shape, shard, offset, size, crc)


def read_index(index_path) -> Tuple[int, Dict[str, BundleEntry]]:
    """Parse a ``variables.index`` -> (num_shards, {key: BundleEntry}).

    The pseudo-entries (empty key = header, ``_CHECKPOINTABLE_OBJECT_GRAPH``
    = serialized object graph) are excluded from the returned dict.
    """
    buf = Path(index_path).read_bytes()
    if len(buf) < _FOOTER_SIZE:
        raise ValueError(f"{index_path}: too small to be a table file")
    footer = buf[-_FOOTER_SIZE:]
    magic = struct.unpack("<Q", footer[-8:])[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{index_path}: bad table magic {magic:#x}")
    pos = 0
    _meta_off, pos = _varint(footer, pos)
    _meta_size, pos = _varint(footer, pos)
    index_off, pos = _varint(footer, pos)
    index_size, pos = _varint(footer, pos)

    num_shards = 1
    entries: Dict[str, BundleEntry] = {}
    index_block = _read_block(buf, index_off, index_size)
    for _last_key, handle in _block_entries(index_block):
        off, p = _varint(handle, 0)
        size, _ = _varint(handle, p)
        for key, value in _block_entries(_read_block(buf, off, size)):
            name = key.decode("utf-8")
            if name == "":
                for field, _, val in _proto_fields(value):
                    if field == 1:
                        num_shards = val
                continue
            entry = _parse_entry(value)
            if name == "_CHECKPOINTABLE_OBJECT_GRAPH":
                continue
            entries[name] = entry
    return num_shards, entries


def _masked_crc32c(data: bytes) -> int:
    """TF's masked crc32c (Castagnoli), for optional integrity checks."""
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


_CRC32C_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        poly = 0x82F63B78
        table = np.zeros(256, np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (poly if c & 1 else 0)
            table[i] = c
        _CRC32C_TABLE = table
    crc = np.uint32(0xFFFFFFFF)
    tbl = _CRC32C_TABLE
    arr = np.frombuffer(data, np.uint8)
    # vectorless loop is fine: weight blobs are checked in MB-sized chunks
    for b in arr:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def _shard_path(prefix: Path, shard: int, num_shards: int) -> Path:
    return prefix.with_name(
        f"{prefix.name}.data-{shard:05d}-of-{num_shards:05d}")


def read_bundle(prefix, *, verify_crc: bool = False) -> Dict[str, np.ndarray]:
    """Load every tensor of a checkpoint -> {checkpoint_key: array}.

    ``prefix`` is the path *without* extension, e.g.
    ``.../variables/variables`` (the ``.index`` / ``.data-*`` siblings are
    derived from it).  String-typed entries are skipped.
    """
    prefix = Path(prefix)
    num_shards, entries = read_index(prefix.with_name(prefix.name + ".index"))
    shards: Dict[int, bytes] = {}
    out: Dict[str, np.ndarray] = {}
    for name, e in sorted(entries.items()):
        if e.dtype_enum == _DT_STRING:
            continue
        if e.shard_id not in shards:
            path = _shard_path(prefix, e.shard_id, num_shards)
            if not path.exists():
                raise FileNotFoundError(
                    f"{path} (referenced by '{name}'; the reference repo "
                    "ships index files with the data blobs stripped — a "
                    "full checkpoint is required to load values)")
            shards[e.shard_id] = path.read_bytes()
        raw = shards[e.shard_id][e.offset: e.offset + e.size]
        if len(raw) != e.size:
            raise ValueError(f"'{name}': shard truncated")
        if verify_crc and e.crc32c and _masked_crc32c(raw) != e.crc32c:
            raise ValueError(f"'{name}': crc32c mismatch")
        arr = np.frombuffer(raw, e.numpy_dtype).reshape(e.shape)
        if e.dtype_enum == _DT_BFLOAT16:
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out


def list_variables(index_path) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """-> {checkpoint_key: (shape, dtype_enum)} without touching data shards
    (works on the reference's stripped artifacts)."""
    _, entries = read_index(index_path)
    return {k: (e.shape, e.dtype_enum) for k, e in entries.items()}


# --- Keras get_weights() ordering -----------------------------------------

# model.get_weights() returns layer.weights concatenated over model.layers
# (topological graph order — the same order that assigns layer_with_weights-N
# numbers); within one layer, weights appear in creation order.  These ranks
# reproduce that per-layer order for the layer types the reference models
# contain: Conv/Dense [kernel, bias], BN [gamma, beta, moving_mean,
# moving_variance], LSTM [kernel, recurrent_kernel, bias]; Bidirectional
# contributes forward_layer then backward_layer.
_ATTR_RANK = {
    "kernel": 0, "depthwise_kernel": 0, "gamma": 0,
    "recurrent_kernel": 1, "beta": 1,
    "bias": 2,
    "moving_mean": 3,
    "moving_variance": 4,
}
_VAR_KEY = re.compile(
    r"^layer_with_weights-(\d+)/(.*?)\.ATTRIBUTES/VARIABLE_VALUE$")
_ORPHAN_KEY = re.compile(
    r"^(?:trainable_)?variables/(\d+)/\.ATTRIBUTES/VARIABLE_VALUE$")


def _order_key(name: str):
    m = _VAR_KEY.match(name)
    if not m:
        return None
    layer = int(m.group(1))
    inner = m.group(2).rstrip("/")
    parts = inner.split("/") if inner else []
    attr = parts[-1] if parts else ""
    # forward_layer (0) before backward_layer (1) inside Bidirectional
    direction = 0
    if "backward_layer" in parts:
        direction = 1
    return (layer, direction, _ATTR_RANK.get(attr, 9), inner)


def keras_weight_list(tensors: Dict[str, np.ndarray]) -> List[np.ndarray]:
    """Order checkpoint tensors like ``model.get_weights()`` so they feed
    straight into :mod:`mmla_audio_torch.convert`'s re-nesting converters.

    Two key families participate (verified against the shipped reference
    checkpoints):

    * ``layer_with_weights-N/**/.ATTRIBUTES/VARIABLE_VALUE`` — attribute-
      attached weights, ordered by (N, per-layer attribute rank).
    * ``variables/N`` / ``trainable_variables/N`` — *orphan* weights TF could
      not attach as attributes.  Both reference models store their
      Bidirectional-LSTM weights this way (`timit2.0`: ``variables/116-121``;
      SI ``timit/model``: ``trainable_variables/82-87``), and in both the LSTM
      is the single gap in the layer_with_weights numbering — so orphans are
      assigned, in N order, to the missing layer slot.

    Optimizer slots (``.OPTIMIZER_SLOT``), metrics and the object graph are
    ignored.
    """
    keyed = []
    orphan_families: Dict[str, list] = {}
    layers_present = set()
    for name, arr in tensors.items():
        if ".OPTIMIZER_SLOT" in name:
            continue
        k = _order_key(name)
        if k is not None:
            keyed.append((k, arr))
            layers_present.add(k[0])
            continue
        m = _ORPHAN_KEY.match(name)
        if m:
            fam = ("trainable_variables" if name.startswith("trainable_")
                   else "variables")
            orphan_families.setdefault(fam, []).append((int(m.group(1)), arr))
    if orphan_families:
        # The two families carry INDEPENDENT numberings (and `variables/` is
        # the canonical superset when both exist) — sorting them together
        # would interleave unrelated indices and, because the six BiLSTM
        # arrays share shapes, silently permute weights.  Use one family.
        fam = ("variables" if "variables" in orphan_families
               else "trainable_variables")
        orphans = sorted(orphan_families[fam], key=lambda t: t[0])
        max_layer = max(layers_present, default=-1)
        missing = sorted(set(range(max_layer + 1)) - layers_present)
        if len(missing) != 1:
            raise ValueError(
                f"cannot place {len(orphans)} orphan variables: expected "
                f"exactly one layer_with_weights gap, found {missing}")
        slot = missing[0]
        for i, (_, arr) in enumerate(orphans):
            keyed.append(((slot, 0, 0, f"~orphan{i:04d}"), arr))
    keyed.sort(key=lambda kv: kv[0])
    return [arr for _, arr in keyed]
