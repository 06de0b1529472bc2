"""``ecm_torch.data.tfrecord`` (no TensorFlow): CRC32C, the record framing
and ``tf.train.Example``, held against ``ecm_tpu.data.tfrecord`` (which
writes and reads through TensorFlow) in both directions. A file of its own:
TensorFlow takes seconds to import."""

import os

import numpy as np
import pytest

from ecm_torch.data import tfrecord
from ecm_torch.data.synthetic import make_pair

KEYS = ("left", "right", "disparity")


@pytest.fixture
def samples():
    rng = np.random.default_rng(3)
    return [make_pair(rng, 24, 32, max_disp=8.0) for _ in range(5)]


def assert_same(want, got):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        for k in KEYS:
            assert b[k].dtype == np.float32 and b[k].shape == a[k].shape
            np.testing.assert_array_equal(b[k], a[k])


def test_crc32c_check_value():
    assert tfrecord.crc32c(b"123456789") == 0xE3069283
    assert tfrecord.crc32c_bytewise(b"123456789") == 0xE3069283
    assert tfrecord.crc32c(b"") == 0


@pytest.mark.parametrize("n", (255, 256, 259, 64 * 33, 64 * 32 + 5, 100_003))
def test_crc32c_lanes_equal_the_byte_loop(n):
    """Lengths below and at the lane path's threshold, whole and ragged
    chunk counts, odd join levels."""
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tfrecord.crc32c(data) == tfrecord.crc32c_bytewise(data)


def test_example_decoder_takes_unpacked_int64_and_skips_unknown_fields():
    def tag(num, wire):
        return tfrecord._varint(num << 3 | wire)

    unpacked = tag(1, 0) + tfrecord._varint(7) + tag(1, 0) + tfrecord._varint(-2)
    feature = tag(3, 2) + tfrecord._varint(len(unpacked)) + unpacked
    entry = b"".join(tfrecord._field(1, [b"shape"]) + tfrecord._field(2, [feature]))
    features = b"".join(tfrecord._field(1, [entry])) + tag(9, 5) + b"\0\0\0\0"
    example = b"".join(tfrecord._field(1, [features])) + tag(4, 0) + tfrecord._varint(5)
    assert tfrecord.decode_example(example) == {"shape": [7, -2]}


def test_write_shards_names_and_round_trip(tmp_path, samples):
    paths = tfrecord.write_shards(iter(samples), str(tmp_path), samples_per_shard=2)
    assert paths == [str(tmp_path / f"stereo-{i:05d}.tfrecord") for i in range(3)]
    assert_same(samples, list(tfrecord.read_shards(paths)))


def test_port_writes_tensorflow_reads(tmp_path, samples):
    pytest.importorskip("tensorflow")
    from ecm_tpu.data import tfrecord as ref

    paths = tfrecord.write_shards(iter(samples), str(tmp_path), samples_per_shard=2)
    assert_same(samples, list(ref.read_shards(paths)))


def test_tensorflow_writes_port_reads(tmp_path, samples):
    pytest.importorskip("tensorflow")
    from ecm_tpu.data import tfrecord as ref

    paths = ref.write_shards(iter(samples), str(tmp_path), samples_per_shard=2)
    assert [os.path.basename(p) for p in paths] == [f"stereo-{i:05d}.tfrecord" for i in range(3)]
    assert_same(samples, list(tfrecord.read_shards(paths)))


@pytest.mark.parametrize("where", ("length", "payload"))
def test_corrupted_record_raises(tmp_path, samples, where):
    (path,) = tfrecord.write_shards(iter(samples[:1]), str(tmp_path))
    raw = bytearray(open(path, "rb").read())
    raw[3 if where == "length" else 12 + len(raw) // 2] ^= 0x10
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC mismatch"):
        list(tfrecord.read_shards([path]))


def test_truncated_file_raises(tmp_path, samples):
    (path,) = tfrecord.write_shards(iter(samples[:2]), str(tmp_path))
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-7])
    with pytest.raises(ValueError, match="truncated"):
        list(tfrecord.read_shards([path]))


def test_shuffle_is_a_seed_stable_permutation(tmp_path, monkeypatch):
    """With a buffer smaller than the stream (as 1024 is for a SceneFlow
    shard set), and with one that holds it all."""
    rng = np.random.default_rng(0)
    stream = [make_pair(rng, 4, 4, max_disp=2.0) for _ in range(23)]
    for i, s in enumerate(stream):
        s["disparity"][0, 0] = i
    paths = tfrecord.write_shards(iter(stream), str(tmp_path), samples_per_shard=5)
    order = {}
    for buffer in (4, tfrecord.SHUFFLE_BUFFER):
        monkeypatch.setattr(tfrecord, "SHUFFLE_BUFFER", buffer)
        runs = [[int(s["disparity"][0, 0]) for s in tfrecord.read_shards(paths, shuffle=True, seed=seed)]
                for seed in (1, 1, 2)]
        assert sorted(runs[0]) == list(range(23))
        assert runs[0] == runs[1] and runs[0] != runs[2] and runs[0] != list(range(23))
        order[buffer] = runs[0]
    assert order[4] != order[tfrecord.SHUFFLE_BUFFER]


def test_record_at_sceneflow_crop_round_trips(tmp_path):
    """One 256x512 crop: a 3.67 MB record through the lane-parallel CRC."""
    s = make_pair(np.random.default_rng(5), 256, 512, max_disp=60.0)
    paths = tfrecord.write_shards(iter([s]), str(tmp_path))
    assert os.path.getsize(paths[0]) > 256 * 512 * 7 * 4
    assert_same([s], list(tfrecord.read_shards(paths)))
