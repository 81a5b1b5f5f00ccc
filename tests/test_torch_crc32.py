"""The port's CRC-32 (``ops/crc32.py``) and host fingerprints against zlib and JAX.

Random byte rows, masks and membership rows from numpy seeds go through
``zlib.crc32``, the JAX package's functions and the port's; every result
is equal as an unsigned 32-bit value.
"""

import importlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaboodle_tpu.oracle import fingerprint as jfp
from kaboodle_tpu_torch.ops import crc32
from kaboodle_tpu_torch.oracle import fingerprint as tfp

# The JAX package's ops/__init__ re-exports a function named crc32 over
# the module's name.
jcrc = importlib.import_module("kaboodle_tpu.ops.crc32")


@pytest.mark.parametrize("width", [1, 8, 37])
def test_crc32_rows_match_zlib_and_jax(width):
    rng = np.random.default_rng(width)
    data = rng.integers(0, 256, size=(16, width), dtype=np.uint8)
    mask = rng.random((16, width)) < 0.6
    got = crc32.crc32(torch.from_numpy(data)).numpy()
    assert got.dtype == np.int64
    assert list(got) == [zlib.crc32(bytes(r)) for r in data]
    np.testing.assert_array_equal(got, np.asarray(jcrc.crc32(jnp.asarray(data))))
    masked = crc32.crc32(torch.from_numpy(data), torch.from_numpy(mask)).numpy()
    assert list(masked) == [zlib.crc32(bytes(r[m])) for r, m in zip(data, mask)]
    np.testing.assert_array_equal(
        masked, np.asarray(jcrc.crc32(jnp.asarray(data), jnp.asarray(mask))))
    assert [int(v) for v in crc32.CRC_TABLE] == [int(v) for v in jcrc.CRC_TABLE]


def test_crc32_update_bytes_continues_a_running_crc():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, size=(4, 5), dtype=np.uint8)
    b = rng.integers(0, 256, size=(4, 7), dtype=np.uint8)
    s = torch.full((4,), 0xFFFFFFFF, dtype=torch.int64)
    s = crc32.crc32_update_bytes(crc32.crc32_update_bytes(s, torch.from_numpy(a)),
                                 torch.from_numpy(b))
    assert list((s ^ 0xFFFFFFFF).numpy()) == [zlib.crc32(bytes(y), zlib.crc32(bytes(x)))
                                             for x, y in zip(a, b)]


@pytest.mark.parametrize("n", [1, 12, 40])
def test_membership_crc32_and_records_match(n):
    rng = np.random.default_rng(n)
    member = rng.random((n, n)) < 0.5
    ids = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    tids = torch.from_numpy(ids.view(np.int32).copy())
    recs = crc32.record_bytes(torch.arange(n), tids).numpy()
    np.testing.assert_array_equal(
        recs, np.asarray(jcrc.record_bytes(jnp.arange(n), jnp.asarray(ids))))
    got = crc32.membership_crc32(torch.from_numpy(member), tids).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcrc.membership_crc32(jnp.asarray(member), jnp.asarray(ids))))
    for i in range(n):
        js = np.flatnonzero(member[i])
        want = zlib.crc32(b"".join(bytes(recs[j]) for j in js))
        assert got[i] == want
        # crc_fingerprint over the same records: int addresses, 4-byte identities.
        assert tfp.crc_fingerprint({int(j): int(ids[j]) for j in js}) == want
        assert jfp.crc_fingerprint({int(j): int(ids[j]) for j in js}) == want


def test_crc_fingerprint_socket_order_matches_jax():
    members = {"10.0.0.2:80": b"b", "10.0.0.10:80": b"c", "[::1]:9": b"d", 3: b"e",
               "10.0.0.2:7": b"f", "not-an-addr": b"g"}
    assert tfp.crc_fingerprint(members) == jfp.crc_fingerprint(members)
    keys = sorted(members, key=tfp.socket_addr_sort_key)
    assert keys == sorted(members, key=jfp.socket_addr_sort_key)
    assert keys[0] == 3 and keys[-1] == "not-an-addr"
    assert tfp.default_addr_bytes(5) == jfp.default_addr_bytes(5) == b"\x00\x00\x00\x05"
