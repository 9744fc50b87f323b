"""The built-in MessagePack codec: msgpack-python's default bytes for every
type the checkpoint serializer emits."""
import zlib

import numpy as np
import pytest

from yag_slam_tpu.slam import msgpack_lite

CASES = [
    (None, "c0"),
    (True, "c3"),
    (False, "c2"),
    (127, "7f"),
    (-32, "e0"),
    (128, "cc80"),
    (-33, "d0df"),
    (65535, "cdffff"),
    (-32769, "d2ffff7fff"),
    (2**32, "cf0000000100000000"),
    (1.5, "cb3ff8000000000000"),
    ("a" * 31, "bf" + "61" * 31),
    ("é" * 16, "d920" + "c3a9" * 16),
    (b"\x00\x01", "c4020001"),
    ([1, [2.0], {}], "9301" + "91cb4000000000000000" + "80"),
    ((1, 2), "920102"),
    ({"k": None, "a": -1}, "82a16bc0a161ff"),
    (list(range(16)), "dc0010" + "".join(f"{i:02x}" for i in range(16))),
]


@pytest.mark.parametrize("obj,hexbytes", CASES,
                         ids=[repr(c[0])[:20] for c in CASES])
def test_packb_bytes(obj, hexbytes):
    blob = msgpack_lite.packb(obj)
    assert blob.hex() == hexbytes
    back = msgpack_lite.unpackb(blob)
    assert back == (list(obj) if isinstance(obj, tuple) else obj)


def test_unpackb_rejects_bad_input():
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(bytes.fromhex("92c0"))        # truncated
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(bytes.fromhex("c0c0"))        # trailing data
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(bytes.fromhex("810101"))      # int map key
    with pytest.raises(TypeError):
        msgpack_lite.packb(object())


def test_checkpoint_bytes_match_msgpack():
    """A GraphSlam checkpoint is byte-identical through either codec."""
    msgpack = pytest.importorskip("msgpack")
    from yag_slam_tpu.core.scan import LocalizedRangeScan
    from yag_slam_tpu.slam.serde import _serialize

    rng = np.random.default_rng(0)
    scan = LocalizedRangeScan(rng.uniform(0.5, 9.0, 90), -1.5, 1.5,
                              3.0 / 90, 0.0, 10.0, 8.0, 1.25, -3.5, 0.4)
    payload = {"scans": [_serialize(scan)], "edges": [[0, 1, None]],
               "big": list(range(70000)), "neg": [-2**40, -129, 2**63]}
    assert msgpack_lite.packb(payload) == msgpack.packb(payload)
    blob = zlib.compress(msgpack_lite.packb(payload))
    assert msgpack.unpackb(zlib.decompress(blob)) == payload
