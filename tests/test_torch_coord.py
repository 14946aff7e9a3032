"""spectralae_torch.ops.coord against the JAX package (CPU).

The JAX ``conv2d`` runs through ``lax.conv_general_dilated`` by default and
through the Pallas kernel in interpret mode with ``pallas=True``; the port
runs ``F.conv2d`` and, with ``pallas=True``, the K2 wrapper's plain version.
Tolerance: norm-relative 1e-6 for the convs (float32 sums in another
order); pooling, upsampling, cropping and padding maps are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spectralae.ops import coord as jcoord
from spectralae_torch import _kernels
from spectralae_torch.ops import coord as tcoord

torch.set_num_threads(1)

TOL = 1e-6


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def inputs(seed, b=2, d=3, m=4, h=12, w=10, nk=5, nl=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, size=(b, d, h, w)).astype(np.float32)
    c = rng.uniform(-3, 3, size=(m, d, nk, nl)).astype(np.float32)
    bias = rng.uniform(-3, 3, size=m).astype(np.float32)
    return x, c, bias


@pytest.mark.parametrize("tap", ["centered", "ref_cpu", "ref_gpu"])
@pytest.mark.parametrize("nk", [3, 5])
def test_conv2d_matches_jax_in_every_tap_mode(tap, nk):
    x, c, b = inputs(0, nk=nk, nl=nk)
    got = tcoord.conv2d(torch.from_numpy(x), torch.from_numpy(c),
                        torch.from_numpy(b), tap_mode=tap)
    want = jcoord.conv2d(jnp.asarray(x), jnp.asarray(c), jnp.asarray(b),
                         tap_mode=tap)
    assert got.shape == want.shape
    assert rel(got, want) < TOL


@pytest.mark.parametrize("tap", ["centered", "ref_cpu", "ref_gpu"])
def test_conv2d_kernel_route_matches_pallas(tap):
    """``pallas=True`` on both sides: the port's K2 wrapper (its plain
    version on the CPU) against the JAX Pallas kernel in interpret mode —
    each tap mode is only another padding handed to the kernel."""
    x, c, b = inputs(1, b=1, d=2, m=3, h=9, w=11)
    got = tcoord.conv2d(torch.from_numpy(x), torch.from_numpy(c),
                        torch.from_numpy(b), tap_mode=tap, pallas=True)
    want = jcoord.conv2d(jnp.asarray(x), jnp.asarray(c), jnp.asarray(b),
                         tap_mode=tap, pallas=True)
    assert rel(got, want) < TOL


def test_conv2d_without_dm_scale_or_bias_and_with_act():
    x, c, _ = inputs(2)
    got = tcoord.conv2d(torch.from_numpy(x), torch.from_numpy(c), None,
                        scale_by_dm=False, act=tcoord.leaky_relu)
    want = jcoord.conv2d(jnp.asarray(x), jnp.asarray(c), None,
                         scale_by_dm=False, act=jcoord.leaky_relu)
    assert rel(got, want) < TOL


@pytest.mark.parametrize("nk,nl", [(5, 5), (3, 7), (7, 3)])
@pytest.mark.parametrize("tap", ["centered", "ref_cpu", "ref_gpu"])
def test_conv_padding_is_the_jax_padding(nk, nl, tap):
    assert tcoord._conv_padding(nk, nl, tap) == jcoord._conv_padding(nk, nl,
                                                                     tap)


def test_routing_keeps_the_kernel_off_the_cpu():
    """The kernel route is taken only for CUDA tensors; on the CPU the
    default route is ``F.conv2d`` and launches nothing."""
    x = torch.zeros(1, 3, 8, 8)
    assert not tcoord._auto_conv_kernel(x, (10, 3, 5, 5))
    before = _kernels.LAUNCHES["conv_valid"]
    tcoord.conv2d(x, torch.zeros(10, 3, 5, 5))
    assert _kernels.LAUNCHES["conv_valid"] == before


@pytest.mark.parametrize("scale", [2, 3, -2, -3, 1])
@pytest.mark.parametrize("quantize", [False, True])
def test_pool_matches_jax(scale, quantize):
    rng = np.random.default_rng(3)
    x = rng.normal(scale=4.0, size=(2, 3, 12, 18)).astype(np.float32)
    got = tcoord.pool(torch.from_numpy(x), scale, quantize=quantize)
    want = jcoord.pool(jnp.asarray(x), scale, quantize=quantize)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("q", [1, 2, 3])
def test_center_crop_and_leaky_relu_match_jax(q):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 2, 13, 17)).astype(np.float32)
    np.testing.assert_array_equal(
        tcoord.center_crop(torch.from_numpy(x), q).numpy(),
        np.asarray(jcoord.center_crop(jnp.asarray(x), q)))
    np.testing.assert_array_equal(
        tcoord.leaky_relu(torch.from_numpy(x)).numpy(),
        np.asarray(jcoord.leaky_relu(jnp.asarray(x))))
