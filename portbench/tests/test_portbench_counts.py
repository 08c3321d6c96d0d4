"""The yardstick's operation, byte and FLOP counts against hand counts."""

import pytest

from portbench import common


def test_resnet50_forward_flops_by_hand():
    # the convolutions of ResNet-50 v1.5 at 224, (cin, cout, k, hout) each
    convs = [(3, 64, 7, 112)]
    cin, h = 64, 56
    for stage, (blocks, planes) in enumerate(zip((3, 4, 6, 3),
                                                 (64, 128, 256, 512))):
        for b in range(blocks):
            hout = h // 2 if (stage > 0 and b == 0) else h
            convs += [(cin, planes, 1, h), (planes, planes, 3, hout),
                      (planes, 4 * planes, 1, hout)]
            if b == 0:
                convs.append((cin, 4 * planes, 1, hout))
            cin, h = 4 * planes, hout
    macs = sum(ci * co * k * k * ho * ho for ci, co, k, ho in convs)
    assert len(convs) == 53
    assert macs == 4_087_136_256          # ~4.09 GMACs, the published size
    assert common.resnet50_fwd_flops(224) == 2 * macs
    assert common.resnet50_stem_flops(224) == 2 * 3 * 64 * 49 * 112 * 112


def test_head_and_contact_counts():
    # fc1 (2048 + 157 -> 1024), fc2, decoders (144 + 10 + 3), 3 IEF rounds
    assert common.hmr_head_flops(2048) == 2 * 3 * (
        2205 * 1024 + 1024 * 1024 + 1024 * 157)
    assert common.winding_ops(64, 6890, 13776) == 67 * 64 * 6890 * 13776
    assert common.masked_min_ops(2, 10, 30) == 2 * (100 + 9 * 30)


def test_spread():
    # quartiles 1.5 and 4.5 of 1..5 by the exclusive method, median 3
    assert common.quartile_spread([1, 2, 3, 4, 5]) == pytest.approx(1.0)
    assert common.quartile_spread([10, 10, 10, 10]) == 0.0
