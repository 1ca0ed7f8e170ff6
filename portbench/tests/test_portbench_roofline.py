"""The roofline arithmetic, pinned at the kernel table's shapes."""

import pytest

from portbench import roofline


def test_row1_int8_block_conv_at_b32():
    t, by = roofline.bound_s(*roofline.block_conv_q(32, 128, 160, 256, 256))
    assert by == "operations" and t * 1e3 == pytest.approx(0.3906, abs=1e-4)


@pytest.mark.parametrize("row", [roofline.block_dgrad, roofline.block_wgrad])
def test_rows5_6_backward_at_b8(row):
    t, by = roofline.bound_s(*row(8, 128, 160, 256))
    assert by == "operations" and t * 1e3 == pytest.approx(0.1954, abs=1e-4)


def test_int8_conv_counts_bytes_once():
    ops, nbytes, peak = roofline.conv_int8(1, 512, 640, 128, 64, out_bytes=4, addend=True)
    npix = 512 * 640
    assert ops == 2 * npix * 9 * 128 * 64 and peak == roofline.PEAK_INT8
    assert nbytes == npix * 128 + 9 * 128 * 64 + 64 * 4 + npix * 64 * 4 + npix * 64 * 4
    assert roofline.bound_s(ops, nbytes, peak)[1] == "bytes"
    v_ops, _, _ = roofline.conv_int8(1, 34, 34, 8, 8, out_bytes=2, pad="valid")
    assert v_ops == 2 * 32 * 32 * 9 * 8 * 8
