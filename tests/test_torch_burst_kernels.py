"""The omega-space burst kernels K5-K8 against their plain versions, on the
card (``csrc/omega_burst.cu``).

Every test here is marked ``cuda``, skips without an NVIDIA GPU, and
imports no JAX, so it runs on a machine that has none::

    python -m pytest tests/test_torch_burst_kernels.py -m cuda --noconftest

Shapes: the default net's pair 0 (D=3, M=10, 5x5) at the JAX benchmark's
headline (one 256² frame, W = 33,024) and smaller, a small net (D=2,
M=4, 3x3), at one and several frames, and 7x7 and 13x13 kernels (49 and
169 taps: the contraction over taps in chunks of 32); W = 840 and 220 leave a masked tail
in the kernels' 64-bin tiles, W = 2,112 and 33,024 fill whole tiles (516
at the headline: K8's grid strides over them).  Tolerances,
norm-relative: 1e-5 for g, O and the MSE sums (the same float32 products
summed in another order, the projection over up to 33,024 bins); for the
bf16 operands 2e-3 (a sum that lands across a bf16 rounding boundary in one
version and not in the other moves that operand by 2^-9); K8's weights,
momenta and MSEs after 3 iterations 1e-4 (the inertia's g/max(|g|, 10)
passes the gradients' error on).
"""

import pytest
import torch

from spectralae_torch import _kernels
from spectralae_torch.ops import burst_kernels as bk

TOL, TOL_BF16, TOL_ITER = 1e-5, 2e-3, 1e-4

SHAPES = [  # (nb, D, M, nk, n): W = n·(n/2+1)
    (1, 3, 10, 5, 256),    # W = 33,024, the headline
    (1, 3, 10, 5, 64),     # W = 2,112
    (4, 3, 10, 5, 40),     # W = 840
    (3, 2, 4, 3, 20),      # W = 220
    # more than 32 taps, the contraction in chunks of 32: 7x7 (two chunks),
    # 13x13 (six) at a masked tail and at the headline
    (2, 3, 10, 7, 40),
    (1, 3, 10, 13, 32),    # W = 544
    (1, 3, 10, 13, 256),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm())


def _problem(dev, nb, D, M, nk, n, seed=0):
    """planes, basis, wv, cf, b, p and the burst constants of one random
    pair-shaped problem (pixel-scale frames, the output of other weights)."""
    from spectralae_torch.train import fft_pallas as fp
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * s
    x = torch.rand(nb, D, n, n, device=dev, generator=gen) * 255
    c, f = rnd(M, D, nk, nk, s=0.3), rnd(D, M, nk, nk, s=0.3)
    b, p = rnd(M, s=0.5), rnd(D, s=0.5)
    out0 = x * 0.9 + rnd(nb, D, n, n, s=5.0)
    s = fp._prepare(x, x, out0, c, True, torch.float32)
    cf = fp._stack(c, f, M * D, nk * nk)
    return s, cf, b, p


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_grad_project_matches_plain(cuda_device, shape, bf16):
    s, cf, b, p = _problem(cuda_device, *shape)
    kw = dict(norm=s.consts["norm"], scale=s.consts["scale"], mxu_bf16=bf16)
    before = _kernels.LAUNCHES["grad_project"]
    got = bk.grad_project(s.planes, s.basis, s.wv, cf, b, **kw)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["grad_project"] == before + 1
    want = bk.grad_project_plain(s.planes, s.basis, s.wv, cf, b, **kw)
    for g, w in zip(got, want):
        assert _rel(g, w) < (TOL_BF16 if bf16 else TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_respectra_and_fused_step_match_plain(cuda_device, shape, bf16):
    s, cf, b, p = _problem(cuda_device, *shape)
    k = dict(s.consts, mxu_bf16=bf16)
    tol = TOL_BF16 if bf16 else TOL
    before = _kernels.LAUNCHES.copy()
    O, mse = bk.respectra_conv(s.planes, s.basis, s.wv, cf, b, p,
                               **{n: k[n] for n in ("norm", "inv_m", "inv_d",
                                                    "mxu_bf16")})
    fused = bk.fused_step(s.planes, s.basis, s.wv, cf, b, p, **k)
    torch.cuda.synchronize()
    assert (_kernels.LAUNCHES["respectra_conv"]
            == before["respectra_conv"] + 1)
    assert _kernels.LAUNCHES["fused_step"] == before["fused_step"] + 1
    wO, wmse = bk.respectra_conv_plain(
        s.planes, s.basis, s.wv, cf, b, p,
        **{n: k[n] for n in ("norm", "inv_m", "inv_d", "mxu_bf16")})
    assert _rel(O, wO) < tol and _rel(mse, wmse) < tol
    for g, w in zip(fused, bk.fused_step_plain(s.planes, s.basis, s.wv, cf,
                                               b, p, **k)):
        assert _rel(g, w) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_itergrid_matches_plain_in_one_launch(cuda_device, shape, bf16):
    s, cf, b, p = _problem(cuda_device, *shape)
    mom = [torch.randn_like(t) * 0.01 for t in (cf, b, p)]
    kw = dict(s.consts, iters=3, lr_eff=0.02, alpha=0.9, mxu_bf16=bf16)
    before = _kernels.LAUNCHES["itergrid"]
    got = bk.itergrid(s.planes, s.basis, s.wv, cf, b, p, *mom, **kw)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["itergrid"] == before + 1
    want = bk.itergrid_plain(s.planes, s.basis, s.wv, cf, b, p, *mom, **kw)
    assert got[-1].shape == (4,)
    for g, w in zip(got, want):
        assert _rel(g, w) < (TOL_BF16 if bf16 else TOL_ITER)


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit(cuda_device):
    """No float atomics: two runs of each kernel agree exactly."""
    s, cf, b, p = _problem(cuda_device, 2, 3, 10, 5, 64, seed=3)
    runs = []
    for _ in range(2):
        mom = [torch.zeros_like(t) for t in (cf, b, p)]
        runs.append(torch.cat([t.reshape(-1) for t in (
            *bk.grad_project(s.planes, s.basis, s.wv, cf, b,
                             norm=s.consts["norm"], scale=s.consts["scale"]),
            *bk.fused_step(s.planes, s.basis, s.wv, cf, b, p, **s.consts),
            *bk.itergrid(s.planes, s.basis, s.wv, cf, b, p, *mom, iters=20,
                         lr_eff=0.02, alpha=0.9, **s.consts))]))
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_tensor_core_kernels_repeat_bit_for_bit_at_the_headline(cuda_device,
                                                                bf16):
    """K5 and K7 at W = 33,024 (516 tiles, 33 groups of the fixed-order
    sum): the tiles finish in another order each run, the sums do not."""
    s, cf, b, p = _problem(cuda_device, 1, 3, 10, 5, 256, seed=5)
    runs = []
    for _ in range(3):
        runs.append(torch.cat([t.reshape(-1) for t in (
            *bk.grad_project(s.planes, s.basis, s.wv, cf, b,
                             norm=s.consts["norm"], scale=s.consts["scale"],
                             mxu_bf16=bf16),
            *bk.fused_step(s.planes, s.basis, s.wv, cf, b, p, mxu_bf16=bf16,
                           **s.consts))]))
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


@pytest.mark.cuda
def test_tensor_core_kernels_on_two_streams_at_once(cuda_device):
    """K5 on one stream and K7 on another, their launches side by side,
    give bit for bit what each gives alone: the tickets of the fixed-order
    sum are a stream's own.  Both streams wait behind ~25 ms of spinning on
    the main one, so that each holds its 20 launches queued when the card
    turns to them (enqueued one by one, a launch ends before the next)."""
    s, cf, b, p = _problem(cuda_device, 1, 3, 10, 5, 256, seed=7)

    def k5():
        return torch.cat([t.reshape(-1) for t in bk.grad_project(
            s.planes, s.basis, s.wv, cf, b, norm=s.consts["norm"],
            scale=s.consts["scale"])])

    def k7():
        return torch.cat([t.reshape(-1) for t in bk.fused_step(
            s.planes, s.basis, s.wv, cf, b, p, **s.consts)])
    want = (k5(), k7())
    main = torch.cuda.current_stream()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda._sleep(50_000_000)
    for st in streams:
        st.wait_stream(main)
    got = []
    for _ in range(20):
        for st, run in zip(streams, (k5, k7)):
            with torch.cuda.stream(st):
                got.append(run())
    for st in streams:
        main.wait_stream(st)
    torch.cuda.synchronize()
    assert all(torch.equal(g, want[i % 2]) for i, g in enumerate(got))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    s, cf, b, p = _problem(cuda_device, 1, 3, 10, 5, 16)
    with pytest.raises(TypeError, match="float32"):
        bk.grad_project(s.planes.double(), s.basis, s.wv, cf, b, norm=1.0,
                        scale=1.0)
    basis17 = torch.zeros(2, 289, s.planes.shape[-1], device=cuda_device)
    with pytest.raises(ValueError, match="P <= 256"):   # 17x17 kernels
        bk.grad_project(s.planes, basis17, s.wv,
                        torch.zeros(60, 289, device=cuda_device), b,
                        norm=1.0, scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_k6_and_k8_repeat_bit_for_bit_at_the_headline(cuda_device, bf16):
    """K6 and K8 at W = 33,024 (516 tiles, 33 groups of the fixed-order
    sum; K8's blocks stride over ~2 tiles an iteration): three runs of each
    agree exactly."""
    s, cf, b, p = _problem(cuda_device, 1, 3, 10, 5, 256, seed=9)
    k = dict(s.consts, mxu_bf16=bf16)
    k6 = {n: k[n] for n in ("norm", "inv_m", "inv_d", "mxu_bf16")}
    runs = []
    for _ in range(3):
        mom = [torch.zeros_like(t) for t in (cf, b, p)]
        runs.append(torch.cat([t.reshape(-1) for t in (
            *bk.respectra_conv(s.planes, s.basis, s.wv, cf, b, p, **k6),
            *bk.itergrid(s.planes, s.basis, s.wv, cf, b, p, *mom, iters=10,
                         lr_eff=0.02, alpha=0.9, **k))]))
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


@pytest.mark.cuda
def test_k6_on_two_streams_at_once(cuda_device):
    """K6 on two streams, their launches side by side, gives bit for bit
    what it gives alone: its tickets, like K5's and K7's, are a stream's
    own.  Both streams wait behind ~25 ms of spinning on the main one, so
    that each holds its 20 launches queued when the card turns to them."""
    s, cf, b, p = _problem(cuda_device, 1, 3, 10, 5, 256, seed=13)
    k6 = {n: s.consts[n] for n in ("norm", "inv_m", "inv_d")}

    def k6_run(scale):
        O, mse = bk.respectra_conv(s.planes, s.basis, s.wv, cf * scale, b,
                                   p, **k6)
        return torch.cat([O.reshape(-1), mse.reshape(-1)])
    scales = (1.0, 0.5)       # two problems, so a mix-up shows
    want = [k6_run(c) for c in scales]
    main = torch.cuda.current_stream()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda._sleep(50_000_000)
    for st in streams:
        st.wait_stream(main)
    got = []
    for _ in range(20):
        for st, c in zip(streams, scales):
            with torch.cuda.stream(st):
                got.append(k6_run(c))
    for st in streams:
        main.wait_stream(st)
    torch.cuda.synchronize()
    assert all(torch.equal(g, want[i % 2]) for i, g in enumerate(got))


@pytest.mark.cuda
def test_itergrid_burst_repeats_bit_for_bit(cuda_device):
    """B9 (``fft_burst_itergrid``, one K8 launch) twice over 100 iterations
    of one 256² frame: weights, momenta and MSEs agree exactly."""
    from spectralae_torch.train import fft_iter
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    x = torch.rand(3, 256, 256, device=cuda_device, generator=gen) * 255
    out0 = x * 0.9 + torch.randn(3, 256, 256, device=cuda_device,
                                 generator=gen) * 5
    c = torch.randn(10, 3, 5, 5, device=cuda_device, generator=gen) * 0.3
    f = torch.randn(3, 10, 5, 5, device=cuda_device, generator=gen) * 0.3
    b = torch.randn(10, device=cuda_device, generator=gen) * 0.5
    p = torch.randn(3, device=cuda_device, generator=gen) * 0.5
    before = _kernels.LAUNCHES["itergrid"]
    runs = [fft_iter.fft_burst_itergrid(x, x, out0, c, f, b, p, iters=100)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["itergrid"] == before + 2
    a, z = runs
    for n in ("c", "f", "b", "p", "mses"):
        assert torch.equal(getattr(a, n), getattr(z, n)), n
    assert all(torch.equal(u, v) for u, v in zip(a.mom, z.mom))
