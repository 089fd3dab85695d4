"""The port's dense delivery matrix against the JAX package's.

``delivery_matrix_reference`` (plain PyTorch) must equal the JAX
reference and the Pallas kernel run in interpret mode, bit for bit (the
output is boolean, tolerance 0). The CUDA kernel is compared with the
plain version on the card in ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pushcdn_tpu.ops.delivery_kernel import (
    delivery_matrix_pallas,
    delivery_matrix_reference as jax_reference,
)
from pushcdn_tpu_torch.ops import delivery_kernel as dk
from pushcdn_tpu_torch.proto.message import KIND_BROADCAST, KIND_DIRECT
from pushcdn_tpu_torch.testing import kernel_cases as kc


def _inputs(seed, U, N, W, all_invalid=False):
    rng = np.random.default_rng(seed)
    ushape = (U,) if W == 1 else (U, W)
    nshape = (N,) if W == 1 else (N, W)
    umask = rng.integers(0, 2**32, ushape, dtype=np.uint64).astype(np.uint32)
    # sparse frame masks, so both hits and misses occur
    tmask = (rng.integers(0, 2**32, nshape, dtype=np.uint64)
             & rng.integers(0, 2**32, nshape, dtype=np.uint64)
             & rng.integers(0, 2**32, nshape, dtype=np.uint64)
             ).astype(np.uint32)
    local = rng.random(U) < 0.6
    kind = rng.choice([0, KIND_BROADCAST, KIND_DIRECT, 6, 77],
                      N).astype(np.int32)
    if all_invalid:
        kind[:] = 0
    # dests of -1 and past U on purpose
    dest = rng.integers(-3, U + 5, N).astype(np.int32)
    return umask, local, tmask, kind, dest


def _port(umask, local, tmask, kind, dest, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (umask.view(np.int32), local, tmask.view(np.int32),
                           kind, dest))


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("all_invalid", [False, True])
@pytest.mark.parametrize("W", [1, 8])
def test_reference_matches_jax_reference_and_pallas(W, all_invalid):
    arrays = _inputs(W, 64, 256, W, all_invalid)
    got = dk.delivery_matrix_reference(*_port(*arrays)).numpy()
    want = np.asarray(jax_reference(*_jax(*arrays)))
    pallas = np.asarray(delivery_matrix_pallas(*_jax(*arrays),
                                               interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    if all_invalid:
        assert not got.any()
    else:
        assert got.any() and not got.all()


@pytest.mark.parametrize("W", [1, 8])
def test_ragged_shapes_match_jax_reference(W):
    """A U and N that are not multiples of 8 and 128 (the TPU tiling)."""
    arrays = _inputs(10 + W, 37, 301, W)
    got = dk.delivery_matrix_reference(*_port(*arrays)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_reference(
        *_jax(*arrays))))


@pytest.mark.parametrize("name", list(kc.DENSE_CASES))
def test_edge_cases_match_jax_reference(name):
    """The cases the CUDA kernel is held to on the card: unaligned rows,
    N = 1 and 64, partial tiles, 0..W mask words, users with no or every
    topic, a direct-only tile with dests at -3, -1, U and U + 5."""
    arrays = kc.dense_case(name)
    got = dk.delivery_matrix_reference(*kc.as_torch(arrays)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_reference(
        *_jax(*arrays))))
    assert got.any()


def test_out_of_range_dests_never_deliver():
    umask, local, tmask, kind, dest = _inputs(3, 16, 32, 1)
    kind[:] = KIND_DIRECT
    dest[:16] = -1
    dest[16:] = 16 + np.arange(16)
    assert not dk.delivery_matrix_reference(
        *_port(umask, local, tmask, kind, dest)).any()


def test_dispatch_uses_the_plain_version_for_cpu_tensors():
    args = _port(*_inputs(5, 24, 40, 8))
    assert torch.equal(dk.delivery_matrix(*args),
                       dk.delivery_matrix_reference(*args))


def test_kernel_wrapper_refuses_cpu_tensors():
    args = _port(*_inputs(6, 8, 8, 1))
    launches = dk.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        dk.delivery_matrix_cuda(*args)
    assert dk.LAUNCHES == launches
