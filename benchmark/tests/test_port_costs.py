"""The frozen analytic counts against hand counts at tiny shapes."""

import pytest

from benchmark import costs

TINY = {"d": 1, "depth": 2, "nk": 3, "nl": 3, "scale": 2, "pairs": 1}
MB = 3.35e12 / 1e3          # bytes a millisecond
FL = 67e12 / 1e3            # float32 operations a millisecond


def test_bound_takes_the_larger_time():
    assert costs.bound_ms(0.0, 3.35e9) == (1.0, "bytes")
    assert costs.bound_ms(67e9, 0.0) == (1.0, "operations")


def test_k1_bound():
    # [2,3,5] x [3,4,5] -> [2,4,5]: 120 complex multiply-adds; operands
    # 8·5·(6 + 12) bytes, output 8·5·8, bias 4·4
    ms, kind = costs.k1_bound(2, 3, 4, 5, bias=True)
    assert kind == "bytes"
    assert ms == pytest.approx((720 + 320 + 16) / MB)
    assert costs.k1_bound(2, 3, 4, 5, op_bytes=4)[0] == pytest.approx(
        (360 + 320) / MB)


def test_k2_and_wgrad_bounds():
    # [1,1,5,5] x [1,1,3,3] -> [1,1,3,3]: 81 multiply-adds
    ms, kind = costs.k2_bound(1, 1, 1, 5, 5, 3, 3)
    assert kind == "bytes" and ms == pytest.approx(4 * (25 + 9 + 9) / MB)
    ms, kind = costs.k2_bound(64, 64, 64, 130, 130, 3, 3)
    flops = 2.0 * 64 * 64 * 64 * 9 * 128 * 128
    assert kind == "operations" and ms == pytest.approx(flops / FL)
    assert costs.wgrad_bound(1, 1, 1, 5, 5, 3, 3)[0] == pytest.approx(
        4 * (25 + 9 + 9) / MB)


def test_fft_flops():
    # 6 real transforms of 8·16 = 128 points: 2.5·128·7 each
    assert costs.fft_flops((2, 3, 8, 16), (2, 3)) == 6 * 2240
    assert costs.fft_flops((4, 8), (1,), complex_input=True) == 4 * 120
    assert costs.fft_flops((3, 1), (1,)) == 0.0


def test_byte_bounds():
    # x 64 + X 2·96 + kernel 2·96 + Y 2·96 + out 64
    assert costs.spectral_conv_bytes(1, 1, 1, 4, 4) == 704
    # forward: x and recon 128, one stage at 2×2 (2 bins a row): 2·64
    assert costs.fft_step_bytes(1, 1, 1, 4, 4, 1) == 3 * 256


def test_stages():
    st = costs.stages(TINY, 8, 8)
    assert st == [costs.Stage(2, 1, 4, 4, 3, 3, True),
                  costs.Stage(1, 2, 4, 4, 3, 3, False)]
    cfg = dict(TINY, depth=10, d=3, pairs=3)
    grids = [(s.d, s.m, s.nx) for s in costs.stages(cfg, 64, 64)]
    assert grids == [(3, 10, 32), (10, 10, 16), (10, 10, 8),
                     (10, 10, 8), (10, 10, 16), (10, 3, 32)]


def test_step_flops():
    # fft: three 8×8 real transforms (2.5·64·6 each); 12 bins a stage;
    # encoder forward + weight grad, decoder three products, 8 flops each
    assert costs.step_flops(TINY, "fft", 1, 8, 8) == 3 * 960 + 8 * 12 * (
        2 * 2 + 3 * 2)
    # coord: 9 taps × 16 pixels × M·D = 2, two products and three
    assert costs.step_flops(TINY, "coord", 1, 8, 8) == 2 * 9 * 16 * 2 * 5
    with pytest.raises(ValueError):
        costs.step_flops(TINY, "dft", 1, 8, 8)


def test_layer_bounds():
    w = 12
    fwd_e = 8 * w * (1 + 2) + 8 * w * 2 + 4 * 2      # [1,1] x [1,2], bias
    dc_e = 8 * w * (2 + 1) + 8 * w * 2               # [2,1] x [1,1]
    fwd_d = 8 * w * (2 + 2) + 8 * w * 1 + 4          # [1,2] x [2,1], bias
    dc_d = 8 * w * (1 + 2) + 8 * w * 2               # [1,1] x [1,2]
    dx_d = 8 * w * (1 + 2) + 8 * w * 2               # [1,1] x [1,2]
    assert costs.spectral_conv_bound_ms(TINY, 1, 8, 8) == pytest.approx(
        (fwd_e + dc_e + fwd_d + dc_d + dx_d) / MB)
    # padded 6×6 inputs, 9 taps a channel pair, 4×4 outputs (floats)
    enc = 36 + 18 + 32            # 1 → 2: forward, and the weight grad
    dec = 72 + 18 + 16            # 2 → 1: forward, and the weight grad
    dgrad = 36 + 18 + 32          # the decoder's data grad, 1 → 2
    assert costs.coord_conv_bound_ms(TINY, 1, 8, 8) == pytest.approx(
        4 * (2 * enc + 2 * dec + dgrad) / MB)
