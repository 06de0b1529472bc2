"""TFRecord packing and reading of stereo samples (port of
``ecm_tpu/data/tfrecord.py``), with no TensorFlow: the record framing, the
``tf.train.Example`` protobuf and CRC32C are written here with the standard
library and numpy, so the files are TensorFlow's and either package reads
what the other wrote.

Record schema (all bytes features), as the reference's:
  left, right: float32 [H, W, 3] ImageNet-normalized, raw little-endian
  disparity:   float32 [H, W]
  shape:       int64 [2] (H, W)

A record is ``uint64 length``, ``uint32 masked_crc32c(length)``, the
payload, ``uint32 masked_crc32c(payload)``, all little-endian; the reader
checks both CRCs and raises on a mismatch, as TensorFlow's does.

``read_shards(shuffle=True)`` draws from a buffer of 1024 records with
``numpy.random.default_rng(seed)``: a permutation of the stream, the same for
the same seed, but not ``tf.data``'s order (an intended difference).
"""

from __future__ import annotations

import os
import struct
from collections.abc import Iterable, Iterator

import numpy as np

SHUFFLE_BUFFER = 1024  # the reference's tf.data shuffle buffer

_POLY = 0x82F63B78  # CRC32C (Castagnoli), reflected
_MASK_DELTA = 0xA282EAD8
_CHUNK = 64  # bytes of one lane of crc32c
_SHORT = 256  # inputs below this many bytes take the byte loop


def _byte_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(_POLY), table >> 1).astype(np.uint32)
    return table


_TABLE = _byte_table()
_TABLE_LIST = _TABLE.tolist()


def crc32c_bytewise(data: bytes) -> int:
    """CRC32C of ``data``, one byte at a time (the reference for
    ``crc32c``; fast enough for a record's 8-byte length)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE_LIST[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _advance(regs: np.ndarray, n: int) -> np.ndarray:
    """Registers ``regs`` advanced over ``n`` zero bytes."""
    for _ in range(n):
        regs = _TABLE[regs & 0xFF] ^ (regs >> 8)
    return regs


def _square(cols: list[int]) -> list[int]:
    """The columns of M^2 from those of the GF(2) matrix M (column j: what
    M makes of bit j)."""
    out = []
    for c in cols:
        v, j = 0, 0
        while c:
            if c & 1:
                v ^= cols[j]
            c >>= 1
            j += 1
        out.append(v)
    return out


def _tables(cols: list[int], width: int) -> np.ndarray:
    """The matrix of columns ``cols`` as 32 / ``width`` tables of 2^width
    entries, one per ``width``-bit digit of the register it multiplies."""
    bits = (np.arange(1 << width, dtype=np.uint32)[:, None] >> np.arange(width, dtype=np.uint32)) & 1
    c = np.array(cols, dtype=np.uint32).reshape(32 // width, width)
    return np.bitwise_xor.reduce(bits[None] * c[:, None, :], axis=2)


_UNIT = np.uint32(1) << np.arange(32, dtype=np.uint32)
# a register r and the next four bytes w (little-endian) step to
# _WORD[0][x & 0xFFFF] ^ _WORD[1][x >> 16], x = r ^ w
_WORD = _tables(_advance(_UNIT, 4).tolist(), 16)
# _JOIN[k]: (tables, columns) of the matrix that advances a register over
# _CHUNK * 2^k zero bytes; grown on demand
_JOIN: list[tuple[np.ndarray, list[int]]] = []


def _join_tables(level: int) -> np.ndarray:
    if not _JOIN:
        cols = _advance(_UNIT, _CHUNK).tolist()
        _JOIN.append((_tables(cols, 8), cols))
    while len(_JOIN) <= level:
        cols = _square(_JOIN[-1][1])
        _JOIN.append((_tables(cols, 8), cols))
    return _JOIN[level][0]


def crc32c(data: bytes | memoryview) -> int:
    """CRC32C of ``data`` (``crc32c(b"123456789") == 0xE3069283``).

    numpy, lane-parallel: the input, its first four bytes complemented
    (which is the register's initial all-ones) and zeros put in front (which
    leave a zero register at zero), is cut into chunks of ``_CHUNK`` bytes;
    every chunk's register steps four bytes at a time from zero, all chunks
    at once; then neighbours are joined pairwise, ``reg(A + B) =
    Z^len(B) reg(A) ^ reg(B)`` with ``Z`` the matrix that advances a register
    over one zero byte, until one register is left."""
    n = len(data)
    if n < _SHORT:
        return crc32c_bytewise(bytes(data))
    lanes = -(-n // _CHUNK)
    pad = lanes * _CHUNK - n
    full = np.zeros(lanes * _CHUNK, dtype=np.uint8)
    full[pad:] = np.frombuffer(data, dtype=np.uint8)
    full[pad : pad + 4] ^= 0xFF
    words = np.ascontiguousarray(full.view("<u4").reshape(lanes, _CHUNK // 4).T)
    lo, hi = _WORD
    reg = np.zeros(lanes, dtype=np.uint32)
    for w in words:
        x = reg ^ w
        reg = lo[x & 0xFFFF] ^ hi[x >> 16]
    level = 0
    while len(reg) > 1:
        if len(reg) % 2:
            reg = np.concatenate([np.zeros(1, dtype=np.uint32), reg])
        t = _join_tables(level)
        a, b = reg[0::2], reg[1::2]
        reg = t[0][a & 0xFF] ^ t[1][(a >> 8) & 0xFF] ^ t[2][(a >> 16) & 0xFF] ^ t[3][a >> 24] ^ b
        level += 1
    return int(reg[0]) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes | memoryview) -> int:
    """TFRecord's masked CRC32C of ``data``."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# -- the protobuf wire format of tf.train.Example -----------------------------
# Example{1: Features}; Features{1: map<string, Feature>} (entry: key 1,
# value 2); Feature{1: BytesList, 3: Int64List}; BytesList{1: repeated
# bytes}; Int64List{1: repeated int64}.


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # a negative int64 is its two's complement, 10 bytes
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _field(num: int, parts: list) -> list:
    """A length-delimited field holding the concatenation of ``parts``, as
    parts: a message is joined once, at the end."""
    return [_varint(num << 3 | 2), _varint(sum(len(p) for p in parts)), *parts]


def _feature_bytes(value: bytes) -> list:
    return _field(1, _field(1, [value]))  # Feature.bytes_list, BytesList.value


def _feature_int64(values: Iterable[int]) -> list:
    packed = b"".join(_varint(int(v)) for v in values)
    return _field(3, _field(1, [packed]))  # Feature.int64_list, Int64List.value packed


def encode_example(features: dict[str, list]) -> bytes:
    """A serialized ``tf.train.Example`` of ``features`` (name -> the parts
    of a serialized ``Feature``)."""
    entries = []
    for key, feature in features.items():  # Features.feature, a map entry each
        entries += _field(1, _field(1, [key.encode()]) + _field(2, feature))
    return b"".join(_field(1, entries))  # Example.features


def _read_varint(buf: memoryview, i: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated varint in a tf.train.Example")
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, i
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than 10 bytes in a tf.train.Example")


def _fields(buf: memoryview) -> Iterator[tuple[int, int, int | memoryview]]:
    """(field number, wire type, value) of each field of a message: an int
    for varint and fixed-width fields, a view for length-delimited ones."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 2:
            size, i = _read_varint(buf, i)
            if i + size > len(buf):
                raise ValueError("truncated field in a tf.train.Example")
            value, i = buf[i : i + size], i + size
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            value, i = int.from_bytes(buf[i : i + size], "little"), i + size
        else:
            raise ValueError(f"wire type {wire} in a tf.train.Example")
        yield num, wire, value


def _embedded(buf: memoryview, num: int) -> Iterator[memoryview]:
    """The length-delimited values of field ``num`` of a message."""
    for n, wire, value in _fields(buf):
        if n == num:
            if wire != 2:
                raise ValueError(f"field {num} of wire type {wire} in a tf.train.Example")
            yield value


def _int64s(buf: memoryview) -> list[int]:
    """Int64List.value, packed or not."""
    out = []
    for num, wire, value in _fields(buf):
        if num != 1:
            continue
        if wire == 2:  # packed
            j = 0
            while j < len(value):
                v, j = _read_varint(value, j)
                out.append(v)
        elif wire == 0:
            out.append(value)
        else:
            raise ValueError(f"Int64List value of wire type {wire}")
    return [v - (1 << 64) if v >= 1 << 63 else v for v in out]


def decode_example(payload: bytes | memoryview) -> dict[str, list]:
    """The features of a serialized ``tf.train.Example``: name -> a list of
    views (``bytes_list``) or of ints (``int64_list``); unknown fields are
    skipped."""
    out = {}
    for features in _embedded(memoryview(payload), 1):  # Example.features
        for entry in _embedded(features, 1):  # Features.feature map entries
            keys, values = list(_embedded(entry, 1)), []
            for feature in _embedded(entry, 2):
                for num, wire, lst in _fields(feature):
                    if num == 1 and wire == 2:  # bytes_list
                        values += _embedded(lst, 1)
                    elif num == 3 and wire == 2:  # int64_list
                        values += _int64s(lst)
            out[bytes(keys[-1]).decode() if keys else ""] = values
    return out


# -- records ------------------------------------------------------------------


def _write_record(f, payload: bytes) -> None:
    length = struct.pack("<Q", len(payload))
    f.write(length + struct.pack("<I", masked_crc32c(length)))
    f.write(payload)
    f.write(struct.pack("<I", masked_crc32c(payload)))


def read_records(path: str) -> Iterator[memoryview]:
    """The payloads of the records of one TFRecord file, each CRC checked."""
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) != 12:
                raise ValueError(f"{path}: truncated record header")
            length, crc = head[:8], struct.unpack("<I", head[8:])[0]
            if masked_crc32c(length) != crc:
                raise ValueError(f"{path}: corrupted record length (CRC mismatch)")
            n = struct.unpack("<Q", length)[0]
            body = f.read(n + 4)
            if len(body) != n + 4:
                raise ValueError(f"{path}: truncated record")
            payload = memoryview(body)[:n]
            if masked_crc32c(payload) != struct.unpack("<I", body[n:])[0]:
                raise ValueError(f"{path}: corrupted record (CRC mismatch)")
            yield payload


def write_shards(
    samples: Iterable[dict[str, np.ndarray]],
    out_dir: str,
    prefix: str = "stereo",
    samples_per_shard: int = 256,
) -> list[str]:
    """Pack samples into ``<out_dir>/<prefix>-NNNNN.tfrecord`` shards."""
    os.makedirs(out_dir, exist_ok=True)
    paths, f, count = [], None, 0
    try:
        for s in samples:
            if f is None or count >= samples_per_shard:
                if f is not None:
                    f.close()
                paths.append(os.path.join(out_dir, f"{prefix}-{len(paths):05d}.tfrecord"))
                f = open(paths[-1], "wb")
                count = 0
            h, w = s["disparity"].shape

            def b(a):
                return _feature_bytes(np.ascontiguousarray(a, "<f4").tobytes())

            _write_record(f, encode_example({
                "left": b(s["left"]),
                "right": b(s["right"]),
                "disparity": b(s["disparity"]),
                "shape": _feature_int64([h, w]),
            }))
            count += 1
    finally:
        if f is not None:
            f.close()
    return paths


def _shuffled(records: Iterator, seed: int) -> Iterator:
    """A buffer of ``SHUFFLE_BUFFER`` records: each draw takes a uniform
    slot and refills it from the stream; at the end the rest in random
    order."""
    rng = np.random.default_rng(seed)
    buf = []
    for rec in records:
        if len(buf) < SHUFFLE_BUFFER:
            buf.append(rec)
            continue
        i = int(rng.integers(len(buf)))
        yield buf[i]
        buf[i] = rec
    while buf:
        i = int(rng.integers(len(buf)))
        buf[i], buf[-1] = buf[-1], buf[i]
        yield buf.pop()


def _sample(payload: memoryview) -> dict[str, np.ndarray]:
    ex = decode_example(payload)
    shape = ex.get("shape", [])
    if len(shape) != 2 or any(len(ex.get(k, [])) != 1 for k in ("left", "right", "disparity")):
        raise ValueError(f"record does not hold the stereo schema: {sorted(ex)}")
    h, w = shape
    return {
        "left": np.frombuffer(ex["left"][0], "<f4").reshape(h, w, 3),
        "right": np.frombuffer(ex["right"][0], "<f4").reshape(h, w, 3),
        "disparity": np.frombuffer(ex["disparity"][0], "<f4").reshape(h, w),
    }


def read_shards(
    paths: list[str], shuffle: bool = False, seed: int = 0
) -> Iterator[dict[str, np.ndarray]]:
    """Stream samples back from TFRecord shards (numpy dicts)."""
    records = (rec for p in paths for rec in read_records(p))
    if shuffle:
        records = _shuffled(records, seed)
    for rec in records:
        yield _sample(rec)
