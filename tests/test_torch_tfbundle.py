"""The port's TensorBundle reader (``mmla_audio_torch.tfbundle``) on
synthetic bundles written by ``tests/golden/tfbundle_writer.py`` (numpy
only, independent of both readers): round-trips of every dtype, several
shards, bfloat16 widening, CRC checks and the error messages, each read
also by ``mmla_audio_tpu.tfbundle`` and equal to it; the Keras ordering of
``keras_weight_list``.  The tests that read the reference's shipped
checkpoint indexes skip without them, as the JAX package's do.
"""

import struct

import numpy as np
import pytest

from mmla_audio_tpu import tfbundle as jax_tfbundle
from mmla_audio_torch.tfbundle import (_proto_fields, keras_weight_list,
                                       list_variables, read_bundle,
                                       read_index)
from tests.golden.tfbundle_writer import write_bundle
# the reference's shipped speaker index, where it is mounted (as the JAX
# suite reads it)
from tests.test_tfbundle import _REF_SPEAKER


def _random_tensors(rng, spec):
    return {name: rng.standard_normal(shape).astype(dtype)
            if np.issubdtype(np.dtype(dtype), np.floating)
            else rng.integers(0, 100, shape).astype(dtype)
            for name, (shape, dtype) in spec.items()}


def _same_as_jax(prefix, out, **kw):
    ref = jax_tfbundle.read_bundle(prefix, **kw)
    assert sorted(ref) == sorted(out)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
        assert out[k].dtype == ref[k].dtype, k


def test_roundtrip_single_shard(tmp_path):
    rng = np.random.default_rng(0)
    tensors = _random_tensors(rng, {
        "a/kernel": ((3, 4), np.float32),
        "a/bias": ((4,), np.float32),
        "counts": ((7,), np.int64),
        "flag": ((), np.bool_),
        "half": ((2, 5), np.float16),
        "wide": ((2, 2), np.float64),
        "small": ((3,), np.int8),
    })
    write_bundle(tmp_path / "variables", tensors)
    out = read_bundle(tmp_path / "variables", verify_crc=True)
    assert sorted(out) == sorted(tensors)
    for k in tensors:
        np.testing.assert_array_equal(out[k], tensors[k], err_msg=k)
        assert out[k].dtype == tensors[k].dtype, k
    _same_as_jax(tmp_path / "variables", out, verify_crc=True)


def test_roundtrip_multi_shard(tmp_path):
    rng = np.random.default_rng(1)
    tensors = {f"v{i}": rng.standard_normal((i + 1, 3)).astype(np.float32)
               for i in range(7)}
    write_bundle(tmp_path / "variables", tensors, num_shards=3)
    num_shards, entries = read_index(tmp_path / "variables.index")
    assert num_shards == 3
    assert {e.shard_id for e in entries.values()} == {0, 1, 2}
    out = read_bundle(tmp_path / "variables")
    for k in tensors:
        np.testing.assert_array_equal(out[k], tensors[k], err_msg=k)
    _same_as_jax(tmp_path / "variables", out)


def test_bfloat16_widening(tmp_path):
    x = np.asarray([[1.5, -2.25], [1024.0, 3e-5]], np.float32)
    write_bundle(tmp_path / "variables", {"w": x}, bf16_keys=("w",))
    out = read_bundle(tmp_path / "variables")
    assert out["w"].dtype == np.float32
    expect = ((x.view(np.uint32) >> 16) << 16).view(np.float32)
    np.testing.assert_array_equal(out["w"], expect)
    _same_as_jax(tmp_path / "variables", out)


def test_corrupt_data_crc_detected(tmp_path):
    write_bundle(tmp_path / "variables",
                 {"w": np.ones((4, 4), np.float32)})
    data = tmp_path / "variables.data-00000-of-00001"
    raw = bytearray(data.read_bytes())
    raw[5] ^= 0xFF
    data.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        read_bundle(tmp_path / "variables", verify_crc=True)
    read_bundle(tmp_path / "variables")         # unchecked read goes on


@pytest.mark.parametrize("corrupt,error,match", [
    ("magic", ValueError, "magic"),
    ("tiny", ValueError, "too small"),
    ("no_shard", FileNotFoundError, "stripped"),
    ("truncated", ValueError, "shard truncated")])
def test_error_messages_match_jax(tmp_path, corrupt, error, match):
    write_bundle(tmp_path / "variables", {"w": np.ones((64,), np.float32)})
    idx = tmp_path / "variables.index"
    data = tmp_path / "variables.data-00000-of-00001"
    if corrupt == "magic":
        raw = bytearray(idx.read_bytes())
        raw[-1] ^= 0x01
        idx.write_bytes(bytes(raw))
    elif corrupt == "tiny":
        idx.write_bytes(b"tiny")
    elif corrupt == "no_shard":
        data.unlink()
    else:
        data.write_bytes(data.read_bytes()[:40])
    for reader in (read_bundle, jax_tfbundle.read_bundle):
        with pytest.raises(error, match=match):
            reader(tmp_path / "variables")


def test_proto_walker_wire_types_and_guard():
    buf = (bytes([1 << 3 | 0, 5])
           + bytes([2 << 3 | 1]) + struct.pack("<Q", 7)
           + bytes([3 << 3 | 2, 2]) + b"hi"
           + bytes([4 << 3 | 5]) + struct.pack("<I", 9))
    assert list(_proto_fields(buf)) == [
        (1, 0, 5), (2, 1, 7), (3, 2, b"hi"), (4, 5, 9)]
    with pytest.raises(ValueError, match="unsupported wire type"):
        list(_proto_fields(bytes([1 << 3 | 3])))


def test_list_variables_without_data(tmp_path):
    write_bundle(tmp_path / "variables",
                 {"a": np.zeros((2, 3), np.float32),
                  "b": np.zeros((5,), np.int32)})
    (tmp_path / "variables.data-00000-of-00001").unlink()
    got = list_variables(tmp_path / "variables.index")
    assert got == {"a": ((2, 3), 1), "b": ((5,), 3)}
    assert got == jax_tfbundle.list_variables(tmp_path / "variables.index")


def test_keras_weight_list_orphan_placement():
    """Orphan (trainable_)variables/N tensors slot into the single
    layer_with_weights gap in N order; optimizer slots are dropped."""
    t = {
        "layer_with_weights-0/kernel/.ATTRIBUTES/VARIABLE_VALUE":
            np.full((1,), 0.0),
        "layer_with_weights-0/bias/.ATTRIBUTES/VARIABLE_VALUE":
            np.full((1,), 1.0),
        "variables/2/.ATTRIBUTES/VARIABLE_VALUE": np.full((1,), 2.0),
        "variables/3/.ATTRIBUTES/VARIABLE_VALUE": np.full((1,), 3.0),
        "trainable_variables/9/.ATTRIBUTES/VARIABLE_VALUE":
            np.full((1,), 9.0),
        "layer_with_weights-2/kernel/.ATTRIBUTES/VARIABLE_VALUE":
            np.full((1,), 4.0),
        "layer_with_weights-2/bias/.ATTRIBUTES/VARIABLE_VALUE":
            np.full((1,), 5.0),
        "layer_with_weights-0/kernel/.OPTIMIZER_SLOT/optimizer/rms/"
        ".ATTRIBUTES/VARIABLE_VALUE": np.full((1,), 99.0),
    }
    flat = keras_weight_list(t)
    assert [float(a[0]) for a in flat] == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    assert [float(a[0]) for a in jax_tfbundle.keras_weight_list(t)] == \
        [float(a[0]) for a in flat]


def test_keras_weight_list_ambiguous_gaps_raise():
    t = {
        "layer_with_weights-0/kernel/.ATTRIBUTES/VARIABLE_VALUE": np.zeros(1),
        "layer_with_weights-3/kernel/.ATTRIBUTES/VARIABLE_VALUE": np.zeros(1),
        "variables/1/.ATTRIBUTES/VARIABLE_VALUE": np.zeros(1),
    }
    with pytest.raises(ValueError, match="gap"):
        keras_weight_list(t)


@pytest.mark.skipif(not _REF_SPEAKER.exists(), reason="reference not mounted")
def test_list_variables_reference():
    vars_ = list_variables(_REF_SPEAKER)
    assert vars_["layer_with_weights-42/kernel/.ATTRIBUTES/VARIABLE_VALUE"] \
        == ((512, 630), 1)
