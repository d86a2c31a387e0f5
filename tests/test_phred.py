"""Phred table parity with PhredHelper.cpp:24-40."""

import numpy as np

from demuxlet_jax.utils.phred import PHRED2ERR, PHRED2MAT, PHRED2PROB, to_prob


def test_q0_q1_quirk():
    assert PHRED2ERR[0] == 0.75
    assert PHRED2ERR[1] == 0.75
    assert PHRED2MAT[0] == 0.25
    assert PHRED2PROB[0] == 1.0


def test_values():
    for i in range(2, 256):
        assert PHRED2ERR[i] == 0.1 ** (i * 0.1)
        assert PHRED2MAT[i] == 1.0 - PHRED2ERR[i]


def test_to_prob_clamps():
    # negative int32 sentinels (htslib missing) wrap to >255 -> prob[255]
    assert to_prob(-2147483648) == PHRED2PROB[255]
    assert to_prob(-1) == PHRED2PROB[255]
    assert to_prob(300) == PHRED2PROB[255]
    assert to_prob(20) == PHRED2PROB[20]
    assert to_prob(0) == 1.0
