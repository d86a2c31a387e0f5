"""rANS 4x8 codec roundtrips (CRAM block method 4)."""

import random

import pytest

from demuxlet_jax.io import rans


CASES = [
    b"",
    b"A",
    b"AAAA",
    b"hello world, hello world, hello",
    bytes(range(256)) * 3,
    b"\x00" * 1000,
    bytes([0, 1, 2, 3] * 250),
]


@pytest.mark.parametrize("order", [0, 1])
def test_roundtrip_fixed(order):
    for data in CASES:
        blob = rans.compress(data, order=order)
        assert rans.decompress(blob) == data, (order, data[:20])


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_roundtrip_random(order, seed):
    rng = random.Random(seed)
    for n in (5, 63, 64, 1000, 4097):
        # skewed alphabet like quality strings
        data = bytes(rng.choice(b"##$%&'FFFFFFFFFJJJJJ:,") for _ in range(n))
        blob = rans.compress(data, order=order)
        assert rans.decompress(blob) == data
        # dense alphabet
        data = bytes(rng.randrange(256) for _ in range(n))
        blob = rans.compress(data, order=order)
        assert rans.decompress(blob) == data


def test_compression_ratio():
    data = b"F" * 10000  # constant quals compress hard
    assert len(rans.compress(data, 0)) < 600
