"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU every wrapper runs its kernel's plain PyTorch version, and the
JAX kernels run in Pallas interpret mode (``_on_tpu()`` is false), as the
JAX package's own tests run them.  Tolerance: norm-relative 1e-6 — the same
float32 products, summed in another order.

Tests marked ``cuda`` launch the hand-written kernels and need an NVIDIA
GPU; they skip without one.  JAX is imported inside the tests that compare
with it, so that the card-only tests also run where JAX is not installed::

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from spectralae_torch import _kernels
from spectralae_torch.ops import coord_kernels as ck
from spectralae_torch.ops import spectral_kernels as sk

torch.set_num_threads(1)

TOL = 1e-6


def rel(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def cplx(rng, *shape):
    return (rng.normal(size=shape)
            + 1j * rng.normal(size=shape)).astype(np.complex64)


def _jax():
    """jax.numpy and the JAX package's Pallas kernel modules."""
    import jax.numpy as jnp
    from spectralae.ops import pallas_conv, pallas_kernels
    return jnp, pallas_kernels, pallas_conv


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("a,k,b,w", [(2, 3, 5, 40), (1, 4, 1, 7),
                                     (3, 2, 17, 33)])
def test_cmul_contract_matches_pallas(a, k, b, w):
    jnp, jpk, _ = _jax()
    rng = np.random.default_rng(0)
    p, q = cplx(rng, a, k, w), cplx(rng, k, b, w)
    before = sk.LAUNCHES
    got = sk.cmul_contract(torch.from_numpy(p), torch.from_numpy(q))
    assert sk.LAUNCHES == before     # the CPU takes the plain version
    wr, wi = jpk._cmul_contract(jnp.asarray(p.real), jnp.asarray(p.imag),
                                jnp.asarray(q.real), jnp.asarray(q.imag),
                                interpret=True)
    assert rel(got, np.asarray(wr) + 1j * np.asarray(wi)) < TOL


def test_cmul_contract_fuses_scale_and_dc_bias():
    rng = np.random.default_rng(1)
    p, q = cplx(rng, 2, 3, 20), cplx(rng, 3, 4, 20)
    bias = rng.normal(size=4).astype(np.float32)
    got = sk.cmul_contract(torch.from_numpy(p), torch.from_numpy(q),
                           p_scale=0.25, bias=torch.from_numpy(bias),
                           bias_scale=64.0).numpy()
    want = np.einsum("akw,kbw->abw", p.astype(np.complex128) * 0.25, q)
    want[:, :, 0] += bias * 64.0
    assert rel(got, want) < TOL


@pytest.mark.parametrize("nx,ny,m,d,nb", [(16, 16, 4, 3, 2), (12, 10, 3, 5, 1)])
def test_spectral_conv_fused_matches_pallas(nx, ny, m, d, nb):
    jnp, jpk, _ = _jax()
    rng = np.random.default_rng(2)
    X = np.fft.rfft2(rng.normal(size=(nb, d, nx, ny))).astype(np.complex64)
    C = np.fft.rfft2(rng.normal(size=(m, d, nx, ny))).astype(np.complex64)
    b = rng.normal(size=m).astype(np.float32)
    got = sk.spectral_conv_fused(torch.from_numpy(X), torch.from_numpy(C),
                                 torch.from_numpy(b), nx, ny)
    want = jpk.spectral_conv_fused(jnp.asarray(X), jnp.asarray(C),
                                   jnp.asarray(b), nx, ny)
    assert got.shape == (nb, m, nx, ny // 2 + 1)
    assert rel(got, want) < TOL


@pytest.mark.parametrize("scale_by_dm", [True, False])
def test_spectral_conv_pallas_matches_pallas(scale_by_dm):
    jnp, jpk, _ = _jax()
    rng = np.random.default_rng(3)
    nx = ny = 16
    X = np.fft.rfft2(rng.normal(size=(3, nx, ny))).astype(np.complex64)
    C = np.fft.rfft2(rng.normal(size=(4, 3, nx, ny))).astype(np.complex64)
    b = rng.normal(size=4).astype(np.float32)
    got = sk.spectral_conv_pallas(torch.from_numpy(X), torch.from_numpy(C),
                                  torch.from_numpy(b), nx, ny,
                                  scale_by_dm=scale_by_dm)
    want = jpk.spectral_conv_pallas(jnp.asarray(X), jnp.asarray(C),
                                    jnp.asarray(b), nx, ny,
                                    scale_by_dm=scale_by_dm, interpret=True)
    assert rel(got, want) < TOL


@pytest.mark.parametrize("shape", [(2, 3, 4, 12, 12, 5, 5),
                                   (1, 2, 3, 9, 14, 3, 3)])
def test_conv_valid_matches_pallas(shape):
    jnp, _, jconv = _jax()
    b, d, m, h, w, nk, nl = shape
    rng = np.random.default_rng(4)
    xpad = rng.normal(size=(b, d, h + nk - 1, w + nl - 1)).astype(np.float32)
    wt = rng.normal(size=(m, d, nk, nl)).astype(np.float32)
    before = ck.LAUNCHES
    got = ck.conv_valid(torch.from_numpy(xpad), torch.from_numpy(wt))
    assert ck.LAUNCHES == before     # the CPU takes the plain version
    want = jconv.conv_valid_pallas(jnp.asarray(xpad), jnp.asarray(wt))
    assert got.shape == (b, m, h, w)
    assert rel(got, want) < TOL


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "bias"])
def test_cmul_contract_rejects_what_the_kernel_does_not_take(case):
    p = torch.zeros(2, 3, 8, dtype=torch.complex64)
    q = torch.zeros(3, 4, 8, dtype=torch.complex64)
    bias = None
    if case == "dtype":
        p = p.to(torch.complex128)
    elif case == "shape":
        q = q[:2]
    elif case == "device":
        p, q = p.to("meta"), q.to("meta")   # neither cpu nor cuda
    else:
        bias = torch.zeros(5)
    with pytest.raises((TypeError, ValueError)):
        sk.cmul_contract(p, q, bias=bias)


@pytest.mark.parametrize("case", ["dtype", "channels", "small", "device"])
def test_conv_valid_rejects_what_the_kernel_does_not_take(case):
    xpad = torch.zeros(1, 2, 10, 10)
    w = torch.zeros(3, 2, 5, 5)
    if case == "dtype":
        xpad = xpad.double()
    elif case == "channels":
        w = torch.zeros(3, 4, 5, 5)
    elif case == "small":
        xpad = torch.zeros(1, 2, 4, 10)
    else:
        xpad, w = xpad.to("meta"), w.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ck.conv_valid(xpad, w)


def test_fused_conv_reduced_precision_raises():
    """bf16 operands are K1's bf16 mode; any other reduced type raises."""
    X = torch.zeros(1, 2, 8, 5, dtype=torch.complex64)
    C = torch.zeros(3, 2, 8, 5, dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="bf16 operands only"):
        sk.spectral_conv_fused(X, C, torch.zeros(3), 8, 8,
                               compute_dtype=torch.float16)


def test_kernel_build_is_keyed_by_sources_and_targets_hopper():
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
    names = {s.name for s in _kernels._sources()}
    assert {"cmul_contract.cu", "conv_valid.cu"} <= names
    assert len(_kernels._digest()) == 16
    # the build lands in a directory git ignores
    assert _kernels.BUILD_DIR.parts[-2:] == ("build", "spectralae_torch")


@pytest.mark.cuda
@pytest.mark.parametrize("a,k,b,n", [(8, 3, 10, 128), (8, 10, 10, 64),
                                     (8, 10, 3, 128), (2, 3, 20, 16)])
def test_cmul_contract_kernel_matches_plain_on_card(cuda_device, a, k, b, n):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = n * (n // 2 + 1)
    p = torch.randn(a, k, w, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    C = torch.randn(b, k, w, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    bias = torch.randn(b, device=cuda_device, generator=gen)
    kw = dict(p_scale=1.0 / b, bias=bias, bias_scale=float(n * n))
    before = sk.LAUNCHES
    got = sk.cmul_contract(p, C.transpose(0, 1), **kw)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + 1
    want = sk.cmul_contract_plain(p, C.transpose(0, 1), **kw)
    assert rel(got.cpu(), want.cpu()) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,m,n", [(8, 3, 10, 128), (8, 10, 3, 128),
                                     (2, 2, 20, 37)])
def test_conv_valid_kernel_matches_plain_on_card(cuda_device, b, d, m, n):
    # held against the plain version in float64, where cuDNN uses no TF32
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    xpad = torch.randn(b, d, n + 4, n + 7, device=cuda_device, generator=gen)
    w = torch.randn(m, d, 5, 5, device=cuda_device, generator=gen)
    before = ck.LAUNCHES
    got = ck.conv_valid(xpad, w)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before + 1
    want = ck.conv_valid_plain(xpad.double(), w.double())
    assert rel(got.cpu(), want.cpu()) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("a,k,b,n", [(8, 10, 3, 128), (10, 8, 10, 32),
                                     (3, 2, 17, 16)])
def test_cmul_contract_conj_and_strided_p_on_card(cuda_device, a, k, b, n):
    """The backward's two forms: ``q`` conjugated, and ``p`` a transposed
    view (``gᵀ`` for the kernel-spectrum gradient), against the plain
    version."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    w = n * (n // 2 + 1)
    g = torch.randn(k, a, w, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    q = torch.randn(k, b, w, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    p = g.transpose(0, 1)                        # [a, k, w], strided
    before = sk.LAUNCHES
    got = sk.cmul_contract(p, q, p_scale=0.1, conj_q=True)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + 1
    want = sk.cmul_contract_plain(p.contiguous(), q, p_scale=0.1,
                                  conj_q=True)
    assert rel(got.cpu(), want.cpu()) < TOL


@pytest.mark.cuda
def test_cmul_contract_resolves_lazy_conjugates_on_card(cuda_device):
    """A lazily conjugated view flags unconjugated storage; the wrapper
    materialises it before the launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    p = torch.randn(2, 3, 40, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    q = torch.randn(3, 4, 40, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    for pv, qv in ((p.conj(), q), (p, q.conj())):
        assert pv.is_conj() or qv.is_conj()
        got = sk.cmul_contract(pv, qv)
        want = sk.cmul_contract_plain(pv.resolve_conj(), qv.resolve_conj())
        assert rel(got.cpu(), want.cpu()) < TOL


@pytest.mark.cuda
def test_spectral_conv_fused_grads_on_card(cuda_device):
    """The Function's backward (two K1 launches) against autograd through
    the plain einsum, on the card."""
    from spectralae_torch.ops import dft
    from spectralae_torch.ops import spectral
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    n, nb, d, m = 64, 4, 3, 10
    x = torch.randn(nb, d, n, n, device=cuda_device, generator=gen)
    c0 = torch.randn(m, d, 5, 5, device=cuda_device, generator=gen)
    b0 = torch.randn(m, device=cuda_device, generator=gen)
    dy = torch.randn(nb, m, n, n, device=cuda_device, generator=gen)
    grads = []
    for conv in (sk.spectral_conv_fused, spectral.spectral_conv_einsum):
        X = torch.fft.rfft2(x.clone().requires_grad_())
        leaves = [X, c0.clone().requires_grad_(), b0.clone().requires_grad_()]
        C = dft.kernel_spectrum(leaves[1], n, n)
        y = torch.fft.irfft2(conv(X, C, leaves[2], n, n), s=(n, n))
        before = sk.LAUNCHES
        grads.append(torch.autograd.grad(y, [X] + leaves[1:], dy))
        if conv is sk.spectral_conv_fused:
            assert sk.LAUNCHES == before + 2     # dX and dC
    for got, want in zip(*grads):
        assert rel(got.cpu(), want.cpu()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("data_grad_kernel", [False, True])
def test_conv_valid_grads_on_card(cuda_device, monkeypatch,
                                  data_grad_kernel):
    """dx (through K2 with the flag) and dw against autograd through the
    plain version in float64.  cuDNN runs without TF32; dw sums 16384
    products per weight in float32, hence 1e-5 for it."""
    monkeypatch.setattr(ck, "PALLAS_DATA_GRAD", data_grad_kernel)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    xpad = torch.randn(4, 10, 68, 68, device=cuda_device, generator=gen)
    w = torch.randn(3, 10, 5, 5, device=cuda_device, generator=gen)
    dy = torch.randn(4, 3, 64, 64, device=cuda_device, generator=gen)
    xt, wt = xpad.clone().requires_grad_(), w.clone().requires_grad_()
    before = ck.LAUNCHES
    ck.conv_valid(xt, wt).backward(dy)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before + 1 + int(data_grad_kernel)
    x64 = xpad.double().requires_grad_()
    w64 = w.double().requires_grad_()
    ck.conv_valid_plain(x64, w64).backward(dy.double())
    assert rel(xt.grad.cpu(), x64.grad.cpu()) < TOL
    assert rel(wt.grad.cpu(), w64.grad.cpu()) < 1e-5


# ---- the launch plans (pure host functions, checked on the CPU) ----------

K1_SHAPES = [  # (A, K, B, W) of the 256^2 b8 and 1024^2 b4 steps, and edges
    (8, 3, 10, 8320), (8, 10, 10, 2112), (8, 10, 10, 544), (10, 8, 10, 544),
    (8, 10, 3, 8320), (3, 8, 10, 8320), (4, 3, 10, 131584),
    (4, 10, 3, 131584), (1, 3, 10, 8320), (1, 1, 1, 1), (2, 17, 20, 33),
    (70000, 2, 2, 64)]


@pytest.mark.parametrize("a,k,b,w", K1_SHAPES)
@pytest.mark.parametrize("vec", [1, 2, 4])
def test_k1_plan_covers_every_output_within_the_grid(a, k, b, w, vec):
    """Of the design the plan takes (K = 17: the blocked one)."""
    op_bytes = 4 if vec == 4 else 8
    plan = sk.k1_plan(a, k, b, w, vec, op_bytes)
    if isinstance(plan, sk.K1BlockedPlan):
        _check_blocked_plan(plan, a, b, w, vec, op_bytes)
        return
    tiles, groups, chunks = plan.grid
    assert plan.vec == vec
    assert tiles * 32 * vec >= w > (tiles - 1) * 32 * vec
    assert 1 <= plan.group <= 8 and groups * plan.group == b
    assert chunks * plan.rows >= a > (chunks - 1) * plan.rows
    assert plan.rows <= 4 or chunks * 4 > 65535
    assert max(groups, chunks) <= 65535


def test_k1_plan_large_grid_reads_q_once_for_every_row():
    """1024^2 b4, stage 0's forward: a thread takes all four rows a (q read
    once); a grid this large takes the ten channels two warps a block, the
    three of stage 5 three a block (B's smallest factors)."""
    plan = sk.k1_plan(4, 3, 10, 131584, 2, 8)
    assert plan.rows == 4 and plan.group == 2
    assert plan.grid == (2056, 5, 1)
    assert sk.k1_plan(4, 10, 3, 131584, 2, 8).group == 3


def test_k1_plan_small_grid_shares_p_among_the_channel_warps():
    """32^2 b8 (W = 544): one row a thread, five channel warps a block
    sharing each p vector, and still over two blocks for every SM."""
    plan = sk.k1_plan(8, 10, 10, 544, 2, 8)
    tiles, groups, chunks = plan.grid
    assert plan.rows == 1 and chunks == 8 and plan.group == 5
    assert tiles * groups * chunks >= sk.NUM_SMS


def test_k1_plan_chunks_rows_while_the_grid_stays_full():
    """128^2 b8: four rows a thread at stage 0's forward (ten channels), one
    at stage 5's (three channels, one block of three warps a tile: two rows
    would leave under 384 threads an SM), two in stage 0's and stage 5's
    dC; at most four."""
    assert sk.k1_plan(8, 3, 10, 8320, 2, 8) == sk.K1Plan(2, 5, 4,
                                                         (130, 2, 2))
    assert sk.k1_plan(8, 10, 3, 8320, 2, 8) == sk.K1Plan(2, 3, 1,
                                                         (130, 1, 8))
    assert sk.k1_plan(10, 8, 3, 8320, 2, 8).rows == 2
    assert sk.k1_plan(3, 8, 10, 8320, 2, 8).rows == 2
    assert sk.k1_plan(10, 4, 10, 33024, 2, 8).rows == 4
    assert sk.k1_plan(8, 10, 10, 2112, 2, 8).rows == 1


def test_k1_plan_lifts_the_row_limit_and_ignores_k():
    """A is unbounded; within the lane design's range (K <= 16, which it
    unrolls) K never changes the plan, and past it the blocked design
    takes every launch."""
    plan = sk._lane_plan(200000, 4, 64, 2)
    assert plan.grid[2] <= 65535 and plan.rows * plan.grid[2] >= 200000
    for shape in ((8, 10, 8320), (1, 10, 544), (4, 3, 131584)):
        a, b, w = shape
        plans = {sk.k1_plan(a, k, b, w, 2, 8) for k in range(1, 17)}
        assert len(plans) == 1 and isinstance(plans.pop(), sk.K1Plan)
        assert isinstance(sk.k1_plan(a, 17, b, w, 2, 8), sk.K1BlockedPlan)


def _step_launches(n, batch, m, pairs=3):
    """(A, K, B, W) of every K1 launch of a fft train step of the net with
    D 3 and M output channels at every stage: per stage the forward, the
    weight gradient (dC: A = M, K = batch) and, past stage 0, the data
    gradient (dX)."""
    sizes = [n // 2 ** (1 + min(i, 2 * pairs - 1 - i)) for i in
             range(2 * pairs)]
    chans = [(3, m)] + [(m, m)] * (2 * pairs - 2) + [(m, 3)]
    out = []
    for s, (nx, (d, mm)) in enumerate(zip(sizes, chans)):
        w = nx * (nx // 2 + 1)
        out += [(batch, d, mm, w), (mm, batch, d, w)]
        if s:
            out.append((batch, mm, d, w))
    return out


# the benchmark's fft cells: M = 50 at 1024^2 b16, M = 10 at 1024^2 b64
M50_B16 = sorted(set(_step_launches(1024, 16, 50)))
M10_B64_DC = sorted({s for s in _step_launches(1024, 64, 10) if s[1] == 64})
# the lane design's launches: the 10-wide net at 256^2 b8 and 1024^2 b4, a
# model-axis slice (M = 5 a rank), A = 1 (B2's unbatched conv)
NARROW = sorted(set(_step_launches(256, 8, 10) + _step_launches(1024, 4, 10)
                    + [s for s in _step_launches(256, 8, 10)
                       if s[2] == 10 and s[0] == 8]
                    + [(8, 3, 5, 8320), (8, 10, 5, 2112), (8, 5, 10, 2112),
                       (5, 8, 10, 2112), (5, 8, 3, 8320), (8, 5, 3, 8320),
                       (1, 3, 10, 8320), (1, 10, 10, 2112),
                       (1, 10, 3, 131584)]))


def test_step_launches_count_seventeen():
    assert len(_step_launches(1024, 16, 50)) == 17
    assert (16, 50, 50, 33024) in M50_B16 and (50, 16, 3, 131584) in M50_B16
    assert len(M10_B64_DC) == 4


@pytest.mark.parametrize("a,k,b,w", M50_B16 + M10_B64_DC)
def test_k1_plan_takes_the_blocked_design_for_wide_launches(a, k, b, w):
    """Every launch of the M = 50 b16 step, and the b64 step's weight
    gradients (K = 64), whose lane plan would read an operand from memory
    again (or loop over K at run time)."""
    assert isinstance(sk.k1_plan(a, k, b, w, 2, 8), sk.K1BlockedPlan)


@pytest.mark.parametrize("a,k,b,w", NARROW)
@pytest.mark.parametrize("vec", [1, 2, 4])
def test_k1_plan_keeps_the_lane_design_for_narrow_launches(a, k, b, w, vec):
    assert isinstance(sk.k1_plan(a, k, b, w, vec, 4 if vec == 4 else 8),
                      sk.K1Plan)


K1_BLOCKED_SHAPES = M50_B16 + M10_B64_DC + [  # and edges: K = 17, A = 1,
    # W not a multiple of the bin tile, B under a thread's 5, A over 2^16
    (1, 17, 1, 1), (1, 50, 50, 1000), (16, 64, 50, 33), (50, 17, 7, 2112),
    (3, 20, 2, 8320), (70000, 17, 2, 64), (16, 50, 3, 131584)]


@pytest.mark.parametrize("a,k,b,w", K1_BLOCKED_SHAPES)
@pytest.mark.parametrize("vec,op_bytes", [(1, 8), (2, 8), (1, 4), (4, 4)])
def test_k1_blocked_plan_covers_every_output_within_the_grid(a, k, b, w, vec,
                                                             op_bytes):
    _check_blocked_plan(sk._blocked_plan(a, k, b, w, vec, op_bytes), a, b, w,
                        vec, op_bytes)


def _check_blocked_plan(plan, a, b, w, vec, op_bytes):
    bins, at, bt = plan.tiles
    ta, tb = plan.na * 4, plan.nb * 5
    assert plan.vec == vec and 1 <= plan.na * plan.nb <= 20
    assert bins * 32 >= w > (bins - 1) * 32
    assert at * ta >= a > (at - 1) * ta and bt * tb >= b > (bt - 1) * tb
    assert bins * at * bt < 2**31
    assert 1 <= plan.grid <= min(bins * at * bt, 32 * sk.NUM_SMS)
    assert plan.kc in (4, 8) and plan.stages in (2, 3)
    assert plan.smem == plan.stages * (ta + tb) * plan.kc * 32 * op_bytes
    assert plan.smem <= 232448


def test_k1_blocked_plan_reads_q_once_at_the_m50_widths():
    """[16, 50] x [50, 50] at 256^2: all 16 rows a tile (q read once), two
    tiles of 25 channels (p twice, the second from L2), 20 warps a block,
    one block resident on each SM, 8 values of k a stage in 2 buffers; at
    A = 64 two tiles of 32 rows, none padded."""
    plan = sk.k1_plan(16, 50, 50, 33024, 2, 8)
    assert (plan.na, plan.nb) == (4, 5) and plan.tiles == (1032, 1, 2)
    assert plan.grid == sk.NUM_SMS and (plan.kc, plan.stages) == (8, 2)
    assert sk.k1_plan(64, 10, 10, 33024, 2, 8).tiles == (1032, 2, 1)
    assert sk.k1_plan(64, 3, 10, 131584, 2, 8).na == 8


@pytest.mark.parametrize("args", [(0, 3, 4, 64, 2, 8), (2, 3, 4, 0, 2, 8),
                                  (2, 3, 4, 64, 3, 8),
                                  (2, 3, 4 * 65537, 64, 1, 8),
                                  (2, 3, 4, 64, 2, 16)])
def test_k1_plan_refuses_what_no_launch_can_run(args):
    with pytest.raises(ValueError):
        sk.k1_plan(*args)


@pytest.mark.parametrize("w,strides,ptrs,wide,want", [
    (544, (5440, 544, 5440, 544), (0, 256), 2, 2),
    (544, (5440, 544, 5440, 544), (0, 256), 4, 4),
    (545, (5450, 545, 5450, 545), (0, 256), 2, 1),      # odd W
    (544, (5440, 544, 5440, 546), (0, 256), 4, 1),     # stride % 4
    (544, (5440, 544, 5440, 544), (8, 256), 2, 1)])     # p off 16 bytes
def test_k1_vec_takes_16_byte_loads_only_on_aligned_rows(w, strides, ptrs,
                                                         wide, want):
    assert sk.k1_vec(w, strides, ptrs, wide) == want


K2_SHAPES = [  # (B, D, M, Hp, Wp, nk, nl): the stage shapes of both steps,
    # their data grads, and edges
    (8, 3, 10, 132, 132, 5, 5), (8, 10, 3, 132, 132, 5, 5),
    (8, 10, 10, 68, 68, 5, 5), (8, 10, 10, 36, 36, 5, 5),
    (8, 10, 3, 136, 136, 5, 5), (8, 10, 10, 72, 72, 5, 5),
    (4, 3, 10, 516, 516, 5, 5), (4, 10, 3, 516, 516, 5, 5),
    (2, 2, 20, 41, 44, 5, 5), (2, 10, 10, 39, 47, 3, 3),
    (1, 3, 4, 26, 29, 7, 7), (1, 1, 1, 5, 5, 5, 5)]


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_plan_covers_every_output_within_the_grid(shape):
    b, d, m, hp, wp, nk, nl = shape
    plan = ck.k2_plan(*shape)
    h, wo = hp - nk + 1, wp - nl + 1
    tj, ti, z = plan.grid
    assert plan.tx * plan.ty <= 128 and plan.ty == 8
    assert tj * 4 * plan.tx >= wo > (tj - 1) * 4 * plan.tx
    assert ti * plan.ty >= h > (ti - 1) * plan.ty
    groups = -(-m // plan.mb)
    assert 1 <= plan.mb <= 16 and z == b * groups
    assert (groups - 1) * plan.mb < m
    cw = -(-(4 * plan.tx + nl - 1) // 4) * 4
    assert plan.smem == 4 * (d * (plan.ty + nk - 1) * cw
                             + d * nk * nl * (-(-plan.mb // 4) * 4))


def test_k2_plan_keeps_all_channels_on_a_full_grid():
    """128^2 b8, stage 0 (3 -> 10): all ten channels a thread, 64-wide
    tiles, a block for every SM; under 48 KB of shared memory."""
    plan = ck.k2_plan(8, 3, 10, 132, 132, 5, 5)
    assert (plan.tx, plan.mb) == (16, 10) and plan.grid == (2, 16, 8)
    assert plan.smem <= 48 * 1024
    assert ck.k2_plan(8, 10, 3, 132, 132, 5, 5).mb == 3
    assert ck.k2_plan(4, 10, 3, 516, 516, 5, 5).grid == (8, 64, 4)


@pytest.mark.parametrize("wo,tx", [(32, 8), (36, 16), (64, 16), (68, 8),
                                   (128, 16), (132, 8), (512, 16)])
def test_k2_plan_tile_width_pads_the_output_least(wo, tx):
    """64-wide tiles unless 32-wide ones pad the output's width less."""
    assert ck.k2_plan(1, 3, 10, 132, wo + 4, 5, 5).tx == tx


@pytest.mark.parametrize("n,pad,mb", [(32, 4, 2), (32, 8, 2), (64, 4, 2),
                                      (64, 8, 5), (128, 8, 10)])
def test_k2_plan_splits_channels_on_small_grids(n, pad, mb):
    """b8 at D = M = 10: under 6 warps an SM the channels split into the
    largest equal groups that give 6, else two a thread (the first port
    launched 32 and 64 blocks at 32^2 and 64^2); the 128^2 data grad's grid
    is large enough as it is."""
    plan = ck.k2_plan(8, 10, 10, n + pad, n + pad, 5, 5)
    assert plan.mb == mb and 10 % plan.mb == 0
    warps = plan.grid[0] * plan.grid[1] * plan.grid[2] * plan.tx * plan.ty \
        // 32
    assert warps >= 6 * ck.NUM_SMS or plan.mb == 2


def test_k2_plan_groups_more_than_sixteen_channels():
    plan = ck.k2_plan(64, 3, 40, 260, 260, 5, 5)
    assert plan.mb == 14 and plan.grid[2] == 64 * 3


@pytest.mark.parametrize("args", [(1, 400, 10, 20, 20, 5, 5),
                                  (70000, 3, 10, 20, 20, 5, 5),
                                  (1, 3, 10, 600000, 20, 5, 5),
                                  (1, 3, 10, 4, 20, 5, 5)])
def test_k2_plan_refuses_what_no_launch_can_run(args):
    with pytest.raises(ValueError):
        ck.k2_plan(*args)


# ---- the redesigned kernels on the card, every branch of their plans -----

def _k1_operands(gen, dev, a, k, b, w, strided, bf16):
    """p [A,K,W] (a transposed view of [K,A,W] when ``strided``, as dC's
    gᵀ), q [K,B,W] (a transposed view of [B,K,W], as the forward's Cᵀ) and
    bias [B]; bf16 planes when ``bf16``."""
    def c(*shape):
        return torch.randn(*shape, dtype=torch.complex64, device=dev,
                           generator=gen)
    p = c(k, a, w).transpose(0, 1) if strided else c(a, k, w)
    q = c(b, k, w).transpose(0, 1)
    bias = torch.randn(b, device=dev, generator=gen)
    if bf16:
        p = sk.bf16_planes(p.transpose(0, 1)).transpose(0, 1) if strided \
            else sk.bf16_planes(p)
        q = sk.bf16_planes(q.transpose(0, 1)).transpose(0, 1)
    return p, q, bias


K1_CARD = [  # (A, K, B, W): A = 1 and A > 8, K and B 1..17, odd W, W not a
    # multiple of the tile, rows chunked (large W), A over the old limit
    (1, 3, 10, 8320), (12, 10, 10, 544), (8, 1, 1, 2112), (3, 16, 16, 200),
    (2, 17, 17, 96), (5, 7, 9, 33), (4, 3, 10, 131584), (8, 10, 3, 8320),
    (70000, 2, 2, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("a,k,b,w", K1_CARD)
@pytest.mark.parametrize("form", ["forward", "dC"])
@pytest.mark.parametrize("bf16", [False, True])
def test_cmul_contract_plans_on_card(cuda_device, a, k, b, w, form, bf16):
    """Each plan branch against the plain version: the forward's form (q a
    transposed view, the 1/M scale, the DC bias) and dC's (p a transposed
    view, conj q), complex64 and bf16 planes; twice, bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(a + k + b + w)
    p, q, bias = _k1_operands(gen, cuda_device, a, k, b, w, form == "dC",
                              bf16)
    kw = (dict(p_scale=1.0 / b, bias=bias, bias_scale=64.0)
          if form == "forward" else dict(p_scale=0.1, conj_q=True))
    before = sk.LAUNCHES_BF16 if bf16 else sk.LAUNCHES
    got = sk.cmul_contract(p, q, **kw)
    again = sk.cmul_contract(p, q, **kw)
    torch.cuda.synchronize()
    assert (sk.LAUNCHES_BF16 if bf16 else sk.LAUNCHES) == before + 2
    assert torch.equal(got, again)
    want = sk.cmul_contract_plain(p, q, **kw)
    assert rel(got.cpu(), want.cpu()) < (1e-5 if bf16 else TOL)


@pytest.mark.cuda
def test_cmul_contract_unaligned_view_on_card(cuda_device):
    """p starting 8 bytes past a 16-byte boundary takes one bin a lane."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    base = torch.randn(2, 3, 65, dtype=torch.complex64, device=cuda_device,
                       generator=gen)
    p = base[..., 1:]                           # W = 64, off by one bin
    q = torch.randn(3, 4, 64, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    assert p.data_ptr() % 16 == 8
    got = sk.cmul_contract(p, q, conj_q=True)
    want = sk.cmul_contract_plain(p.contiguous(), q, conj_q=True)
    assert rel(got.cpu(), want.cpu()) < TOL


def _k1_design(monkeypatch, design):
    """Make every K1 launch take ``design`` ("lane" or "blocked"), whatever
    its shape."""
    def plan(a, k, b, w, vec, op_bytes):
        if design == "lane":
            return sk._lane_plan(a, b, w, vec)
        return sk._blocked_plan(a, k, b, w, vec, op_bytes)
    monkeypatch.setattr(sk, "k1_plan", plan)


def _bits(t):
    """A complex64 tensor's bits, for comparisons bit for bit."""
    return torch.view_as_real(t).view(torch.int32)


K1_BLOCKED_CARD = [  # (A, K, B, W): K in {17, 50, 64} x A in {1, 16, 50};
    # W not a multiple of the 32-bin tile, B under a thread's 5 channels
    (1, 17, 50, 2112), (16, 17, 50, 2112), (50, 17, 50, 2112),
    (1, 50, 50, 2112), (16, 50, 50, 2112), (50, 50, 50, 2112),
    (1, 64, 10, 2112), (16, 64, 10, 2112), (50, 64, 10, 2112),
    (16, 50, 50, 1000), (5, 20, 3, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("a,k,b,w", K1_BLOCKED_CARD)
@pytest.mark.parametrize("form", ["forward", "dC"])
@pytest.mark.parametrize("bf16", [False, True])
def test_cmul_contract_blocked_matches_lane_on_card(cuda_device, monkeypatch,
                                                    a, k, b, w, form, bf16):
    """The blocked design against the lane design bit for bit (each output
    the same fixed-order chain of fmaf over k, then the scale and the DC
    bias), and against the plain version: the forward's form (q a
    transposed view, the DC bias) and dC's (p the strided gᵀ view, conj
    q), complex64 and bf16 planes; three runs bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(a * k + b + w)
    p, q, bias = _k1_operands(gen, cuda_device, a, k, b, w, form == "dC",
                              bf16)
    kw = (dict(p_scale=1.0 / b, bias=bias, bias_scale=64.0)
          if form == "forward" else dict(p_scale=0.1, conj_q=True))
    _k1_design(monkeypatch, "blocked")
    runs = [sk.cmul_contract(p, q, **kw) for _ in range(3)]
    _k1_design(monkeypatch, "lane")
    lane = sk.cmul_contract(p, q, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(runs[0]), _bits(r)) for r in runs[1:])
    assert torch.equal(_bits(runs[0]), _bits(lane))
    want = sk.cmul_contract_plain(p, q, **kw)
    assert rel(runs[0].cpu(), want.cpu()) < (1e-5 if bf16 else TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("domain", ["fft", "coord"])
def test_k1_blocked_counts_in_the_m50_step_on_card(cuda_device, domain):
    """One train step of the benchmark's M = 50 net at 1024^2 b16: the fft
    step's 17 K1 calls (``kernel.cmul_contract``), 15 to 17 of them on
    the blocked design (``k1.blocked``); the coord step calls no K1."""
    from spectralae_torch.core import profiling
    from spectralae_torch.core import types as ttypes
    from spectralae_torch.train import modern
    rng = np.random.default_rng(0)
    params = ttypes.params_from_numpy(
        [(rng.uniform(-1, 1, (m, d, 5, 5)), rng.uniform(-1, 1, m))
         for m, d in [(50, 3)] + [(50, 50)] * 4 + [(3, 50)]],
        device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = 255 * torch.rand(16, 3, 1024, 1024, device=cuda_device,
                         generator=gen)
    profiling.enable()
    try:
        modern.train_step(params, ttypes.init_opt_state(params), x,
                          (2, 2, 2, -2, -2, -2), domain=domain)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
    kernels = sum(v for n, v in counters.items() if n.startswith("kernel."))
    if domain == "fft":
        assert counters["kernel.cmul_contract"] == kernels == 17
        assert 15 <= counters["k1.blocked"] <= 17
    else:
        assert kernels == 0 and "k1.blocked" not in counters


K2_CARD = [  # (B, D, M, H, W, nk, nl): widths 32^2..512^2, D = 10 at 3x3
        # and 5x5, M above the channel group, ragged H and W, other tap widths
    (8, 10, 10, 32, 32, 5, 5), (8, 10, 10, 64, 64, 5, 5),
    (8, 3, 10, 128, 128, 5, 5), (8, 10, 3, 128, 128, 5, 5),
    (4, 3, 10, 512, 512, 5, 5), (4, 10, 3, 512, 512, 5, 5),
    (2, 10, 10, 37, 45, 3, 3), (2, 10, 10, 33, 29, 5, 5),
    (2, 2, 20, 37, 40, 5, 5), (2, 3, 40, 70, 66, 5, 5),
    (1, 3, 4, 20, 23, 7, 7), (2, 3, 5, 30, 31, 5, 3),
    (4, 10, 3, 509, 510, 3, 3), (4, 3, 4, 515, 300, 7, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K2_CARD)
def test_conv_valid_plans_on_card(cuda_device, shape):
    """Each plan branch against the plain version in float64 (no TF32), and
    twice, bit for bit."""
    b, d, m, h, w, nk, nl = shape
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    xpad = torch.randn(b, d, h + nk - 1, w + nl - 1, device=cuda_device,
                       generator=gen)
    wt = torch.randn(m, d, nk, nl, device=cuda_device, generator=gen)
    before = ck.LAUNCHES
    got = ck.conv_valid(xpad, wt)
    again = ck.conv_valid(xpad, wt)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before + 2
    assert got.shape == (b, m, h, w) and torch.equal(got, again)
    want = ck.conv_valid_plain(xpad.double(), wt.double())
    assert rel(got.cpu(), want.cpu()) < TOL


@pytest.mark.cuda
def test_conv_valid_unaligned_input_on_card(cuda_device):
    """An input whose rows do not start on 16 bytes is staged one float at
    a time."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    base = torch.randn(2 * 3 * 40 * 41 + 1, device=cuda_device,
                       generator=gen)
    xpad = base[1:].view(2, 3, 40, 41)          # 4 bytes off, Wp odd
    wt = torch.randn(10, 3, 5, 5, device=cuda_device, generator=gen)
    got = ck.conv_valid(xpad, wt)
    want = ck.conv_valid_plain(xpad.double(), wt.double())
    assert rel(got.cpu(), want.cpu()) < TOL


def _bench_script():
    """scripts/torch_k1k2_bench.py loaded as a module, from its file."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_k1k2_bench.py"
    spec = importlib.util.spec_from_file_location("torch_k1k2_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k1k2_bench_reads_registers_and_spills_of_k1_and_k2():
    k1 = "_Z20cmul_contract_kernelI6float2Li2ELi3EEvv"
    k2 = "_Z17conv_valid_kernelILi15ELi5EEvv"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{k1}' for 'sm_90a'",
        f"ptxas info    : Function properties for {k1}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers",
        f"ptxas info    : Compiling entry function '{k2}' for 'sm_90a'",
        f"ptxas info    : Function properties for {k2}",
        "    24 bytes stack frame, 12 bytes spill stores, 12 bytes spill "
        "loads",
        "ptxas info    : Used 96 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'",
        "ptxas info    : Used 8 registers"])
    got = _bench_script().ptxas_report(log)
    assert got == {k1: {"spill": 0, "regs": 40},
                   k2: {"spill": 24, "regs": 96}}


def test_k1k2_bench_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _bench_script().main(["--check"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
