"""The plain reference against direct computations, on the CPU."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import autoencoder as ref

CFG = {"d": 2, "depth": 3, "nk": 3, "nl": 3, "scale": 2, "lr": 0.2,
       "alpha": 0.9}


def _leaves(pairs=1, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    shapes, d = [], CFG["d"]
    for _ in range(pairs):
        shapes.append((CFG["depth"], d))
        d = CFG["depth"]
    shapes += [(b, a) for a, b in reversed(shapes)]
    out = []
    for m, d in shapes:
        out += [torch.rand(m, d, 3, 3, generator=g, dtype=dtype) - 0.5,
                torch.rand(m, generator=g, dtype=dtype) - 0.5]
    return out


def test_axis_maps():
    idx, keep = ref._axis_map(8, 4, False)
    assert idx.tolist() == [0, 1, 4, 7] and keep.all()
    idx, keep = ref._axis_map(4, 8, False)
    assert keep.tolist() == [1, 1, 0, 0, 1, 0, 0, 1]
    assert idx[keep].tolist() == [0, 1, 2, 3]
    idx, keep = ref._axis_map(5, 3, True)
    assert idx.tolist() == [0, 1, 4] and keep.all()
    idx, keep = ref._axis_map(3, 5, True)
    assert keep.tolist() == [1, 1, 0, 0, 1]
    assert idx[keep].tolist() == [0, 1, 2]


def test_spectral_stage_is_a_circular_convolution():
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 2, 8, 8, generator=g, dtype=torch.float64)
    c = torch.rand(3, 2, 3, 3, generator=g, dtype=torch.float64)
    b = torch.rand(3, generator=g, dtype=torch.float64)
    X = ref.contract(torch.fft.rfft2(x) / 3, ref.kernel_spectrum(c, 8, 8))
    X[..., 0, 0] += b * 64
    got = torch.fft.irfft2(X, s=(8, 8))
    want = F.conv2d(F.pad(x / 3, (1, 1, 1, 1), mode="circular"),
                    torch.flip(c, (-2, -1))) + b[None, :, None, None]
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_coord_stage_against_the_sum():
    leaves = _leaves()
    x = torch.rand(1, 2, 8, 8, dtype=torch.float64)
    cfg = dict(CFG, scale=1)
    c, b = leaves[0], leaves[1]
    got = ref.forward_coord([(c, b)], x, cfg)    # one stage, no pooling
    xs, cs = x.numpy()[0] / 3, c.numpy()
    want = np.zeros((3, 8, 8))
    for m in range(3):
        for i in range(8):
            for j in range(8):
                acc = b[m].item()
                for d in range(2):
                    for k in range(3):
                        for l_ in range(3):
                            ii, jj = i + 1 - k, j + 1 - l_
                            if 0 <= ii < 8 and 0 <= jj < 8:
                                acc += cs[m, d, k, l_] * xs[d, ii, jj]
                want[m, i, j] = acc
    np.testing.assert_allclose(got.numpy()[0], want, rtol=1e-12, atol=1e-12)


def test_resize_round_trip_keeps_the_band():
    X = torch.fft.rfft2(torch.rand(1, 1, 4, 4, dtype=torch.float64))
    up = ref.resize(X, 4, 4, 8, 8)
    torch.testing.assert_close(ref.resize(up, 8, 8, 4, 4), X)


@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_gradients_match_finite_differences(domain):
    leaves = [t.requires_grad_() for t in _leaves()]
    x = torch.rand(2, 2, 8, 8, dtype=torch.float64) * 4
    fwd = ref.FORWARDS[domain]

    def loss(*ws):
        out = fwd(list(zip(ws[0::2], ws[1::2])), x, CFG)
        return 0.5 * torch.mean((out - x) ** 2)
    assert torch.autograd.gradcheck(loss, tuple(leaves))
    got, grads = ref.loss_and_grads(leaves, x, CFG, domain, rows=1)
    want = torch.autograd.grad(loss(*leaves), leaves)
    torch.testing.assert_close(got, loss(*leaves).detach())
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b)


def test_update_rule():
    w = torch.tensor([1.0, 1.0, 1.0], dtype=torch.float64)
    g = torch.tensor([20.0, -5.0, 0.0], dtype=torch.float64)
    mom = torch.tensor([0.1, 0.0, 0.0], dtype=torch.float64)
    new, dw = ref.update(w, g, mom, 0.2, 0.9)
    torch.testing.assert_close(dw, torch.tensor([0.11, -0.01, 0.0],
                                                dtype=torch.float64))
    torch.testing.assert_close(new, w - dw)


@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_train_follows_the_update(domain):
    leaves = _leaves(pairs=2)
    cfg = dict(CFG, pairs=2)
    xs = [torch.rand(2, 2, 16, 16, dtype=torch.float64) * 9
          for _ in range(2)]
    out = ref.train(leaves, xs, cfg, domain, rows=1)
    w, mom = list(leaves), [torch.zeros_like(t) for t in leaves]
    for k, x in enumerate(xs):
        loss, grads = ref.loss_and_grads(w, x, cfg, domain, rows=2)
        assert out["losses"][k] == pytest.approx(float(loss), rel=1e-12)
        if k == 0:
            for a, b in zip(out["grad1"], grads):
                torch.testing.assert_close(a, b)
        new = [ref.update(*t, 0.2, 0.9) for t in zip(w, grads, mom)]
        w, mom = [t for t, _ in new], [d for _, d in new]
    for a, b in zip(out["params"][-1], w):
        torch.testing.assert_close(a, b)
    assert len(out["params"]) == len(xs) + 1


@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_follow_takes_each_step_from_the_given_weights(domain):
    leaves = _leaves(pairs=2)
    cfg = dict(CFG, pairs=2)
    xs = [torch.rand(2, 2, 16, 16, dtype=torch.float64) * 9
          for _ in range(3)]
    chain = ref.train(leaves, xs, cfg, domain, rows=1)
    out = ref.follow(chain["params"][:3], xs, cfg, domain, rows=2)
    assert out["losses"] == pytest.approx(chain["losses"], rel=1e-12)
    for k in range(3):
        for a, b, dw in zip(chain["params"][k], chain["params"][k + 1],
                            out["updates"][k]):
            torch.testing.assert_close(a - b, dw)
    moved = [[t + 0.01 for t in chain["params"][1]]]
    alone = ref.follow(moved, xs[1:2], cfg, domain, rows=2)
    loss, _ = ref.loss_and_grads(moved[0], xs[1], cfg, domain, rows=2)
    assert alone["losses"][0] == pytest.approx(float(loss), rel=1e-12)
