"""The port's ragged page walk against the JAX package's.

Three checks, all bit-exact:
- the port's copy of ``RaggedInterest`` packs the same walks, pages,
  groups and spills as the JAX package's for the same seeded sequence of
  ``set_mask`` / ``pack`` / ``release_transient`` calls, overflow and
  rebuild included;
- ``ragged_delivery_reference`` (plain PyTorch) equals the JAX reference
  and the Pallas kernel in interpret mode on uniform, zipf and garbage
  mixes (page-0 padding and out-of-range candidates included);
- ``ragged_pairs`` / ``ragged_pairs_grouped`` give identical arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pushcdn_tpu.ops import ragged_delivery as jrd
from pushcdn_tpu_torch.ops import ragged_delivery as trd
from pushcdn_tpu_torch.parallel.frames import mask_mirror_shape, split_mask
from pushcdn_tpu_torch.proto.message import KIND_BROADCAST, KIND_DIRECT
from pushcdn_tpu_torch.testing import kernel_cases as kc


def _walks_equal(a, b):
    np.testing.assert_array_equal(a.pages, b.pages)
    np.testing.assert_array_equal(a.walk_page, b.walk_page)
    np.testing.assert_array_equal(a.walk_frame, b.walk_frame)
    assert a.n_walk == b.n_walk
    assert a.spilled == b.spilled
    assert a.solo_rows == b.solo_rows
    assert len(a.groups) == len(b.groups)
    for ga, gb in zip(a.groups, b.groups):
        assert ga[:2] == gb[:2]
        np.testing.assert_array_equal(ga[2], gb[2])


def _index_equal(a, b):
    np.testing.assert_array_equal(a.page_users, b.page_users)
    assert a.free_pages == b.free_pages
    assert a.overflowed == b.overflowed
    assert a.high_water == b.high_water
    assert len(a) == len(b)


def _frames(rng, N, T, U, W):
    kind = rng.choice([0, KIND_BROADCAST, KIND_BROADCAST, KIND_DIRECT, 6],
                      N).astype(np.int32)
    tmask = np.zeros(mask_mirror_shape(N, W), np.uint32)
    for n in range(N):
        if kind[n] == KIND_BROADCAST:
            m = 1 << int(rng.integers(0, T))
            if rng.random() < 0.4:
                m |= 1 << int(rng.integers(0, T))
            tmask[n] = m if W == 1 else split_mask(m, W)
    dest = np.where(kind == KIND_DIRECT, rng.integers(-3, U + 5, N),
                    -1).astype(np.int32)
    valid = rng.random(N) < 0.9
    return kind, tmask, dest, valid


@pytest.mark.parametrize("W,T,max_pages", [(1, 24, 16), (8, 256, 12)])
def test_interest_index_packs_identically(W, T, max_pages):
    """Seeded churn + packing on both copies; the small pool forces
    transient spills, persistent overflow and rebuilds."""
    rng = np.random.default_rng(W)
    U, N = 300, 48
    ji = jrd.RaggedInterest(T, max_pages=max_pages)
    ti = trd.RaggedInterest(T, max_pages=max_pages)
    masks = {}
    saw_overflow = saw_rebuild = saw_spill = False
    for tick in range(30):
        # narrow phases (4 topics) fit the pool, wide ones overflow it
        width = 4 if tick % 10 < 4 else T
        for _ in range(int(rng.integers(5, 40))):
            slot = int(rng.integers(0, U))
            mask = 0
            for t in rng.integers(0, width, int(rng.integers(0, 4))):
                mask |= 1 << int(t)
            masks[slot] = mask
            ji.set_mask(slot, mask)
            ti.set_mask(slot, mask)
        saw_overflow |= ti.overflowed
        if ti.overflowed and tick % 10 == 9:
            # shrink to narrow interest on half the slots, then rebuild
            for slot, mask in masks.items():
                if slot % 2 or mask >> 4:
                    masks[slot] = 0
                    ji.set_mask(slot, 0)
                    ti.set_mask(slot, 0)
            ok = ti.rebuild()
            assert ji.rebuild() == ok
            saw_rebuild |= ok
        _index_equal(ji, ti)
        kind, tmask, dest, valid = _frames(rng, N, T, U, W)
        page_round = int(rng.choice([1, 64]))
        jw = ji.pack(kind, tmask, dest, valid, page_round=page_round)
        tw = ti.pack(kind, tmask, dest, valid, page_round=page_round)
        _walks_equal(jw, tw)
        saw_spill |= bool(tw.spilled)
        ji.release_transient()
        ti.release_transient()
        _index_equal(ji, ti)
        for t in range(T):
            np.testing.assert_array_equal(ji.topic_receivers(t),
                                          ti.topic_receivers(t))
    assert saw_overflow and saw_rebuild
    if W == 8:
        assert saw_spill


def _mix(seed, U, N, T, popularity, W):
    """A seeded broadcast/direct/control/garbage mix and its interest
    index (the port's copy), as the JAX suite builds it."""
    rng = np.random.default_rng(seed)
    if popularity == "zipf":
        p = 1.0 / np.arange(1, T + 1)
        p /= p.sum()
    else:
        p = np.full(T, 1.0 / T)
    masks = np.zeros(mask_mirror_shape(U, W), np.uint32)
    ri = trd.RaggedInterest(T, max_pages=1024)
    for u in range(U):
        m = 0
        for t in rng.choice(T, size=int(rng.integers(0, 4)), p=p):
            m |= 1 << int(t)
        masks[u] = m if W == 1 else split_mask(m, W)
        ri.set_mask(u, m)
    local = rng.random(U) < 0.8
    kind = rng.choice([0, KIND_BROADCAST, KIND_BROADCAST, KIND_DIRECT, 6,
                       9, 77], N).astype(np.int32)
    tmask = np.zeros(mask_mirror_shape(N, W), np.uint32)
    for n in range(N):
        if kind[n] == KIND_BROADCAST:
            m = 1 << int(rng.choice(T, p=p))
            if rng.random() < 0.3:
                m |= 1 << int(rng.choice(T, p=p))
            if rng.random() < 0.1:
                m = 0
            tmask[n] = m if W == 1 else split_mask(m, W)
    dest = np.where(kind == KIND_DIRECT, rng.integers(-3, U + 5, N),
                    -1).astype(np.int32)
    valid = rng.random(N) < 0.85
    # garbage direct dests, past the user table and negative
    kind[:2] = KIND_DIRECT
    dest[:2] = (U + 2, -2)
    valid[:2] = True
    inv = np.nonzero(~valid)[0]
    if len(inv):  # poisoned invalid slot: must never deliver
        tmask[inv[0]] = 0xFFFFFFFF
        kind[inv[0]] = KIND_BROADCAST
    kz = np.where(valid, kind, 0).astype(np.int32)
    walk = ri.pack(kz, tmask, dest, valid)
    ri.release_transient()
    return walk, local, masks, tmask, kz, dest


def _i32(a):
    return a.view(np.int32) if a.dtype == np.uint32 else a


@pytest.mark.parametrize("popularity,seed,W,T", [
    ("uniform", 0, 1, 24), ("zipf", 1, 1, 24), ("uniform", 2, 8, 256),
    ("zipf", 7, 8, 256)])
def test_reference_matches_jax_reference_and_pallas(popularity, seed, W, T):
    U, N = 150, 64
    walk, local, masks, tmask, kz, dest = _mix(seed, U, N, T, popularity, W)
    assert walk.n_walk < len(walk.walk_page)  # page-0 padding entries
    assert (walk.pages >= U).any()            # out-of-range candidates
    arrays = (walk.pages, walk.walk_page, walk.walk_frame, local, masks,
              tmask, kz, dest)
    out, cnt = trd.ragged_delivery_reference(
        *(torch.from_numpy(np.ascontiguousarray(_i32(a))) for a in arrays))
    j_args = tuple(jnp.asarray(a) for a in arrays)
    j_out, j_cnt = jrd.ragged_delivery_reference(*j_args)
    p_out, p_cnt = jrd.ragged_delivery_pallas(*j_args, interpret=True)
    for o, c in ((j_out, j_cnt), (p_out, p_cnt)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(o))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(c))
    assert int(cnt.sum()) > 0
    assert (out[walk.n_walk:] == -1).all()
    # the dispatch takes the plain version for CPU tensors
    d_out, d_cnt = trd.ragged_delivery(
        *(torch.from_numpy(np.ascontiguousarray(_i32(a))) for a in arrays))
    assert torch.equal(d_out, out) and torch.equal(d_cnt, cnt)

    # the pair extractors of both packages agree array for array
    o = out.numpy()
    for a, b in ((trd.ragged_pairs(o, walk.walk_frame, num_users=U),
                  jrd.ragged_pairs(o, walk.walk_frame, num_users=U)),
                 (trd.ragged_pairs_grouped(o, walk, num_users=U),
                  jrd.ragged_pairs_grouped(o, walk, num_users=U))):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(
        trd.ragged_to_dense(o, walk.walk_frame, U, N),
        jrd.ragged_to_dense(o, walk.walk_frame, U, N))


@pytest.mark.parametrize("name", kc.RAGGED_CASES)
def test_edge_case_oracle_matches_jax_reference(name):
    """The oracle the CUDA kernel is held to on the card: the JAX
    reference on rows whose page and frame indices are in range, an
    empty row with a count of 0 on every other row."""
    arrays = kc.ragged_case(name)
    out, cnt = kc.ragged_oracle(*kc.as_torch(arrays))
    G, N = arrays[0].shape[0], arrays[6].shape[0]
    ok = ((arrays[1] >= 0) & (arrays[1] < G)
          & (arrays[2] >= 0) & (arrays[2] < N))
    j_out, j_cnt = jrd.ragged_delivery_reference(
        *(jnp.asarray(a) for a in arrays))
    np.testing.assert_array_equal(out.numpy()[ok], np.asarray(j_out)[ok])
    np.testing.assert_array_equal(cnt.numpy()[ok], np.asarray(j_cnt)[ok])
    assert (out.numpy()[~ok] == -1).all() and (cnt.numpy()[~ok] == 0).all()
    assert int(cnt.sum()) > 0


def test_kernel_wrapper_refuses_cpu_tensors():
    walk, local, masks, tmask, kz, dest = _mix(3, 16, 8, 8, "uniform", 1)
    arrays = (walk.pages, walk.walk_page, walk.walk_frame, local, masks,
              tmask, kz, dest)
    launches = trd.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        trd.ragged_delivery_cuda(
            *(torch.from_numpy(np.ascontiguousarray(_i32(a)))
              for a in arrays))
    assert trd.LAUNCHES == launches
