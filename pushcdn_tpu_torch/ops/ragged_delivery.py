"""Ragged paged delivery: fan-out as a page walk, not a dense matrix.

The dense kernel (``ops.delivery_kernel``) computes ``deliver[u, n]`` for
EVERY (user, frame) cell — O(U x N) work per tick regardless of how many
deliveries happen. Under skewed (zipf) topic popularity most frames fan
out to a tiny receiver set. This module re-expresses delivery in the
*Ragged Paged Attention* layout: per-frame receiver lists packed into
fixed-size **pages**, a **page table** (the walk list) mapping frames to
pages, and ragged lengths — the kernel walks only real (user, frame)
candidate pairs, so per-tick device work scales with fan-out.

Layout
------
- **Page pool** ``page_users: int32[max_pages, PAGE]`` — each page holds up
  to ``PAGE`` candidate user slots (-1 = empty lane). Page 0 is the
  reserved null page (always all -1): walk padding points at it.
- **Walk list**: ``walk_page[w]`` / ``walk_frame[w]`` — walk entry ``w``
  says "frame ``walk_frame[w]``'s receivers include page ``walk_page[w]``'s
  candidates". Frames on the same topic SHARE pages.

The kernel confirms every candidate against device state — ``now_local``
ownership and the topic-mask AND — so stale or garbage pages can only
under- or exactly-deliver, never misdeliver. Output is the compact
``(out_user[w, lane], counts[w])`` pair list.

- :class:`RaggedInterest` (numpy, host) maintains the per-topic receiver
  pages incrementally and packs one tick's walk;
- :func:`ragged_delivery_cuda` launches the hand-written Hopper kernel
  (``csrc/ragged_delivery.cu``) on CUDA tensors;
- :func:`ragged_delivery_reference` is the plain PyTorch version;
- :func:`ragged_delivery` dispatches on the tensors' device;
- :func:`ragged_pairs` / :func:`ragged_pairs_grouped` turn the output into
  per-user ``(users, frames)`` listings for egress.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pushcdn_tpu_torch.ops import _build
from pushcdn_tpu_torch.ops.delivery_kernel import MAX_WORDS, mask_words
from pushcdn_tpu_torch.proto.message import KIND_BROADCAST, KIND_DIRECT

# One page = one row of candidates, confirmed by one warp at 4 lanes a
# thread (the page layout and walks are shared with the JAX package bit
# for bit).
PAGE = 128
_PAGE_SHIFT = 7  # log2(PAGE): flat walk-slot index -> walk row

# walk lists are padded up to this granule, so a tick's tensors take a
# few stable shapes instead of one per traffic mix
WALK_ROUND = 64


def _round_walk(n: int) -> int:
    if n <= 0:
        return WALK_ROUND
    return ((n + WALK_ROUND - 1) // WALK_ROUND) * WALK_ROUND


class RaggedWalk(NamedTuple):
    """One tick's packed page table (see module docstring)."""

    pages: np.ndarray       # int32[num_pages, PAGE] — pool snapshot
    walk_page: np.ndarray   # int32[Wp] (padded entries point at page 0)
    walk_frame: np.ndarray  # int32[Wp] (padded entries say frame 0 — page
    #                         0 is all -1, so they can never deliver)
    n_walk: int             # real entries (<= Wp)
    spilled: tuple          # frame indices the pool couldn't carry this
    #                         tick (transient-page exhaustion) — the
    #                         caller routes THOSE frames dense/host-side
    # mask-group factorization (pair-extraction accelerator): broadcast
    # frames sharing one topic-mask deliver to the IDENTICAL receiver
    # set, so one member's walk rows decide for the whole group.
    # Each entry: (rep_row, n_rows, frames) — the representative's walk
    # row range + every member frame (ascending). ``solo_rows`` are walk
    # rows that decide only for themselves (directs).
    groups: tuple = ()
    solo_rows: tuple = ()


class RaggedInterest:
    """Incremental per-topic receiver pages over a user-slot space.

    The host-side index half of the RPA layout: for every topic, the
    subscribed user slots packed into pages of ``PAGE`` entries (last page
    ragged). Mutations are O(topics changed); the per-tick ``pack`` emits
    walk entries referencing these pages directly for single-topic
    broadcasts — zero per-tick interest work for the hot path.
    """

    def __init__(self, num_topics: int, max_pages: int = 1024):
        if max_pages < 2:
            raise ValueError("max_pages must be >= 2 (page 0 is reserved)")
        self.num_topics = num_topics
        self.max_pages = max_pages
        self.page_users = np.full((max_pages, PAGE), -1, np.int32)
        # page 0 = the reserved null page; never allocated, always all -1
        self._free: List[int] = list(range(max_pages - 1, 0, -1))
        self._topic_pages: List[List[int]] = [[] for _ in range(num_topics)]
        self._topic_len: List[int] = [0] * num_topics
        self._pos: List[Dict[int, int]] = [dict() for _ in range(num_topics)]
        self._user_mask: Dict[int, int] = {}  # slot -> python-int mask
        # persistent (subscription) pages the pool couldn't hold: the
        # index is incomplete from here on — consumers must fall back to
        # the dense path until a rebuild succeeds
        self.overflowed = False
        self._transient: List[int] = []
        self._union_memo: Dict[int, List[int]] = {}
        # 1 + highest pool row ever touched — device uploads slice to it
        self.high_water = 1

    # ---- allocation -------------------------------------------------------

    def _alloc(self) -> Optional[int]:
        if not self._free:
            return None
        pg = self._free.pop()
        # clear-on-alloc: a recycled page may hold a previous tick's
        # candidates, and walk padding relies on vacated lanes being -1
        self.page_users[pg] = -1
        if pg + 1 > self.high_water:
            self.high_water = pg + 1
        return pg

    def _free_page(self, pg: int) -> None:
        self._free.append(pg)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def __len__(self) -> int:
        """Users with a (desired) non-empty mask — the membership size
        the device plane's overflow-recovery policy watches."""
        return len(self._user_mask)

    # ---- incremental topic index -----------------------------------------

    def _topic_add(self, t: int, slot: int) -> bool:
        n = self._topic_len[t]
        if n % PAGE == 0:
            pg = self._alloc()
            if pg is None:
                return False
            self._topic_pages[t].append(pg)
        pg = self._topic_pages[t][-1]
        self.page_users[pg, n % PAGE] = slot
        self._pos[t][slot] = n
        self._topic_len[t] = n + 1
        return True

    def _topic_remove(self, t: int, slot: int) -> None:
        i = self._pos[t].pop(slot, None)
        if i is None:
            return
        last = self._topic_len[t] - 1
        pages = self._topic_pages[t]
        if i != last:
            # swap-with-last keeps pages dense (receiver order within a
            # frame is set semantics — the dense matrix had none either)
            moved = int(self.page_users[pages[last // PAGE], last % PAGE])
            self.page_users[pages[i // PAGE], i % PAGE] = moved
            self._pos[t][moved] = i
        self.page_users[pages[last // PAGE], last % PAGE] = -1
        self._topic_len[t] = last
        if last % PAGE == 0 and pages:  # the tail page emptied
            self._free_page(pages.pop())

    def set_mask(self, slot: int, mask: int) -> None:
        """Update one user's subscription mask (a python int over the
        topic space); diffs against the stored mask and touches only the
        changed topics. ``mask == 0`` removes the user entirely."""
        mask &= (1 << self.num_topics) - 1
        old = self._user_mask.get(slot, 0)
        changed = old ^ mask
        if not changed:
            return
        t = 0
        while changed:
            if changed & 1:
                if mask & (1 << t):
                    if not self._topic_add(t, slot):
                        # pool exhausted: the pages are now INCOMPLETE —
                        # ``overflowed`` gates every consumer onto the
                        # dense path. The DESIRED mask is still stored,
                        # so :meth:`rebuild` can restore the index once
                        # membership shrinks.
                        self.overflowed = True
                        break
                else:
                    self._topic_remove(t, slot)
            changed >>= 1
            t += 1
        if mask:
            self._user_mask[slot] = mask
        else:
            self._user_mask.pop(slot, None)

    def rebuild(self) -> bool:
        """Re-derive every topic page from the stored masks (recovery path
        after an overflow once enough users left). Returns success."""
        masks = dict(self._user_mask)
        self._free = list(range(self.max_pages - 1, 0, -1))
        # the pool is empty again: let the high-water mark re-derive from
        # the rebuilt allocation, or every later pack() would snapshot and
        # upload a pool prefix sized to the historical peak forever
        self.high_water = 1
        self._topic_pages = [[] for _ in range(self.num_topics)]
        self._topic_len = [0] * self.num_topics
        self._pos = [dict() for _ in range(self.num_topics)]
        self._user_mask = {}
        self._transient = []
        self._union_memo = {}
        self.page_users[1:] = -1
        self.overflowed = False
        for slot, mask in masks.items():
            self.set_mask(slot, mask)
            if self.overflowed:
                return False
        return True

    def topic_receivers(self, t: int) -> np.ndarray:
        """The topic's current receiver slots (test/introspection aid)."""
        n = self._topic_len[t]
        out = np.empty(n, np.int32)
        for i, pg in enumerate(self._topic_pages[t]):
            take = min(PAGE, n - i * PAGE)
            out[i * PAGE:i * PAGE + take] = self.page_users[pg, :take]
        return out

    # ---- per-tick packing -------------------------------------------------

    def _union_pages(self, mask: int) -> Optional[List[int]]:
        """Transient deduplicated page run for a multi-topic mask
        (memoized per distinct mask until :meth:`release_transient`)."""
        pages = self._union_memo.get(mask)
        if pages is not None:
            return pages
        parts = []
        t = 0
        m = mask
        while m:
            if m & 1 and self._topic_len[t]:
                parts.append(self.topic_receivers(t))
            m >>= 1
            t += 1
        if not parts:
            self._union_memo[mask] = []
            return []
        cand = np.unique(np.concatenate(parts))  # dedup: one delivery max
        pages = []
        for off in range(0, len(cand), PAGE):
            pg = self._alloc()
            if pg is None:
                for p in pages:  # roll the partial union back
                    self._free_page(p)
                return None
            chunk = cand[off:off + PAGE]
            self.page_users[pg, :len(chunk)] = chunk
            pages.append(pg)
        self._transient.extend(pages)
        self._union_memo[mask] = pages
        return pages

    def pack(self, kind: np.ndarray, topic_mask: np.ndarray,
             dest: np.ndarray, valid: np.ndarray,
             page_round: int = 1) -> RaggedWalk:
        """Build one tick's walk list from frame metadata (the same
        columns the dense step consumes). Invalid slots and non-delivery
        kinds get no walk entries; broadcasts reference the live topic
        pages (single topic) or a transient union run; directs share
        transient dest pages, ``PAGE`` frames per page.

        ``page_round`` rounds the returned pool-snapshot row count up to a
        multiple (device callers pass a granule so the upload shape doesn't
        change every time a page is allocated).

        Call :meth:`release_transient` once the tick's consumers are done
        with the returned pool snapshot."""
        walk_page: List[int] = []
        walk_frame: List[int] = []
        spilled: List[int] = []
        direct_page = -1
        direct_used = 0
        multiword = topic_mask.ndim == 2
        # C-speed scalarization once, then dict-memoized mask decisions:
        # a tick's frames draw from a few distinct topic sets, so the
        # mask-int reconstruction and page-list resolution run once per
        # DISTINCT mask, not once per frame (the page-sharing property
        # that keeps packing O(frames + topics))
        kind_l = kind.tolist()
        valid_l = valid.tolist()
        dest_l = dest.tolist()
        if multiword:
            row_bytes = topic_mask.shape[1] * 4
            mask_buf = np.ascontiguousarray(topic_mask).tobytes()
        else:
            tmask_l = topic_mask.tolist()
        decisions: Dict = {}  # mask key -> page-id list | None (= spill)
        group_of: Dict = {}   # mask key -> [rep_row, n_rows, frames list]
        solo_rows: List[int] = []
        direct_seen: Dict[int, bool] = {}  # dests in the CURRENT page —
        # a repeated dest must not occupy a second lane, or every frame
        # sharing the page would match it twice (double delivery)
        allbits = (1 << self.num_topics) - 1
        for n in range(len(kind_l)):
            if not valid_l[n]:
                continue
            k = kind_l[n]
            if k == KIND_BROADCAST:
                if multiword:
                    key = mask_buf[n * row_bytes:(n + 1) * row_bytes]
                else:
                    key = tmask_l[n]
                pages = decisions.get(key, decisions)
                if pages is decisions:  # first sight of this mask
                    mask = (int.from_bytes(key, "little") if multiword
                            else key) & allbits
                    if mask == 0:
                        pages = []  # no valid topics: empty fan-out
                    elif mask & (mask - 1) == 0:  # single topic: live pages
                        pages = self._topic_pages[mask.bit_length() - 1]
                    else:
                        pages = self._union_pages(mask)
                    decisions[key] = pages
                    if pages:
                        group_of[key] = [len(walk_page), len(pages), [n]]
                elif pages:
                    group_of[key][2].append(n)
                if pages is None:
                    spilled.append(n)
                    continue
                walk_page.extend(pages)
                walk_frame.extend([n] * len(pages))
            elif k == KIND_DIRECT:
                d = dest_l[n]
                if d < 0:
                    continue  # garbage dest: nothing to deliver
                if d not in direct_seen:
                    if direct_used % PAGE == 0:
                        pg = self._alloc()
                        if pg is None:
                            spilled.append(n)
                            continue
                        direct_page = pg
                        self._transient.append(pg)
                        direct_used = 0
                        direct_seen = {}
                    self.page_users[direct_page, direct_used] = d
                    direct_seen[d] = True
                    direct_used += 1
                solo_rows.append(len(walk_page))
                walk_page.append(direct_page)
                walk_frame.append(n)
            # other kinds (control/garbage): no device delivery

        n_walk = len(walk_page)
        wp = _round_walk(n_walk)
        wpage = np.zeros(wp, np.int32)   # padding -> null page 0
        wframe = np.zeros(wp, np.int32)
        if n_walk:
            wpage[:n_walk] = walk_page
            wframe[:n_walk] = walk_frame
        # snapshot the referenced pool prefix: observers may mutate live
        # topic pages while a device step holds this tick's walk
        rows = self.high_water
        if page_round > 1:
            rows = min(((rows + page_round - 1) // page_round) * page_round,
                       self.max_pages)
        pages = self.page_users[:rows].copy()
        groups = tuple(
            (rep, n_rows, np.asarray(frames, np.int32))
            for rep, n_rows, frames in group_of.values())
        return RaggedWalk(pages, wpage, wframe, n_walk, tuple(spilled),
                          groups, tuple(solo_rows))

    def release_transient(self) -> None:
        """Return this tick's union/direct pages to the pool (wraparound:
        the next tick re-allocates them, cleared on alloc)."""
        for pg in self._transient:
            self._free_page(pg)
        self._transient = []
        self._union_memo = {}


# ---------------------------------------------------------------------------
# the kernel: plain PyTorch version + Hopper walk
# ---------------------------------------------------------------------------

# launches of the CUDA kernel in this process
LAUNCHES = 0

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p])
_fn = None


def ragged_delivery_reference(pages, walk_page, walk_frame, local,
                              user_masks, frame_tmask, kind, dest):
    """Plain PyTorch version: confirm every packed candidate pair against
    device state. Shapes: pages int32[G, PAGE]; walk_* int32[Wp] (indices
    in range); local bool[U]; user_masks int32[U] or [U, W]; frame_tmask
    int32[N] or [N, W]; kind/dest int32[N] (``kind`` already 0 on
    invalid slots). Returns ``(out_user int32[Wp, PAGE], counts
    int32[Wp])`` — -1 lanes are non-deliveries."""
    cand = pages[walk_page.long()]                # [Wp, PAGE]
    f = walk_frame.long()
    k = kind[f]                                   # [Wp]
    U = local.shape[0]
    # out-of-range candidates (garbage direct dests beyond the sliced
    # user table) are INVALID, never clamp-gathered onto a real slot
    cvalid = (cand >= 0) & (cand < U)
    if U == 0:
        ok = torch.zeros_like(cvalid)
    else:
        u = torch.where(cvalid, cand, 0).long()
        loc = local[u]                            # [Wp, PAGE]
        if user_masks.dim() == 1:
            hit_b = (user_masks[u] & frame_tmask[f][:, None]) != 0
        else:
            hit_b = ((user_masks[u] & frame_tmask[f][:, None, :]) != 0
                     ).any(dim=-1)
        is_b = (k == KIND_BROADCAST)[:, None]
        is_d = (k == KIND_DIRECT)[:, None]
        hit_d = cand == dest[f][:, None]
        ok = cvalid & loc & ((is_b & hit_b) | (is_d & hit_d))
    out_user = torch.where(ok, cand, -1)
    return out_user, ok.sum(dim=-1, dtype=torch.int32)


def ragged_delivery_cuda(pages, walk_page, walk_frame, local, user_masks,
                         frame_tmask, kind, dest):
    """The Hopper kernel: one warp per walk row, persistent blocks that
    keep the next rows' loads in flight. Same contract as the plain
    version; a walk row whose page or frame index is out of range yields
    an empty row."""
    global _fn, LAUNCHES
    G = pages.shape[0]
    Wp = walk_page.shape[0]
    U = local.shape[0]
    N = kind.shape[0]
    W = mask_words(user_masks)
    if not 1 <= W <= MAX_WORDS:
        raise ValueError(f"topic masks may have 1..{MAX_WORDS} words, got {W}")
    wshape = () if user_masks.dim() == 1 else (W,)
    dev = pages.device
    _build.check_args(dev, (
        ("pages", pages, torch.int32, (G, PAGE)),
        ("walk_page", walk_page, torch.int32, (Wp,)),
        ("walk_frame", walk_frame, torch.int32, (Wp,)),
        ("local", local, torch.bool, (U,)),
        ("user_masks", user_masks, torch.int32, (U,) + wshape),
        ("frame_tmask", frame_tmask, torch.int32, (N,) + wshape),
        ("kind", kind, torch.int32, (N,)),
        ("dest", dest, torch.int32, (N,))))
    out_user = torch.empty((Wp, PAGE), dtype=torch.int32, device=dev)
    counts = torch.empty((Wp,), dtype=torch.int32, device=dev)
    if Wp == 0:
        return out_user, counts
    if _fn is None:
        _fn = _build.load("ragged_delivery", "ragged_delivery_launch",
                          _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn(pages.data_ptr(), G, walk_page.data_ptr(),
             walk_frame.data_ptr(), Wp, local.data_ptr(),
             user_masks.data_ptr(), U, frame_tmask.data_ptr(),
             kind.data_ptr(), dest.data_ptr(), N, W, out_user.data_ptr(),
             counts.data_ptr(), dev.index, stream)
    _build.check(rc, "ragged_delivery_cuda")
    LAUNCHES += 1
    return out_user, counts


def ragged_delivery(pages, walk_page, walk_frame, local, user_masks,
                    frame_tmask, kind, dest):
    """Dispatch on the device: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors. There is no fallback between them."""
    dev = pages.device.type
    args = (pages, walk_page, walk_frame, local, user_masks, frame_tmask,
            kind, dest)
    if dev == "cuda":
        return ragged_delivery_cuda(*args)
    if dev == "cpu":
        return ragged_delivery_reference(*args)
    raise ValueError(f"no ragged_delivery for device {pages.device}")


# ---------------------------------------------------------------------------
# output adapters
# ---------------------------------------------------------------------------


def ragged_pairs(out_user: np.ndarray, walk_frame: np.ndarray,
                 num_users: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Compact (users, frames) delivery pairs grouped per user (frames
    ascending within each user) — one run per user, as egress walks
    them. Cost scales with delivered candidates, never O(U x N).

    The walk emits pairs frame-major (pack scans frames in order), so a
    STABLE sort on the user key alone preserves per-user frame order —
    and with ``num_users`` < 65536 the key casts to uint16, where
    numpy's stable sort is a radix pass."""
    flat = out_user.ravel()
    idx = np.flatnonzero(flat >= 0)
    users = flat[idx]
    frames = walk_frame[idx >> _PAGE_SHIFT]
    if num_users is not None and num_users <= 0xFFFF:
        order = np.argsort(users.astype(np.uint16), kind="stable")
    else:
        order = np.argsort(users, kind="stable")
    return users[order], frames[order]


def ragged_pairs_grouped(out_user: np.ndarray, walk: RaggedWalk,
                         num_users: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Mask-group-factorized twin of :func:`ragged_pairs`: extract each
    group's receiver set ONCE from its representative walk rows, then
    broadcast it to every member frame with vectorized segment expansion.
    Extraction cost is O(unique (user, mask) pairs + total pairs) with
    small constants — at skewed fan-out (hot topics carrying both the
    subscriptions and the traffic) this is the difference between the
    pair sort dominating the tick and it vanishing.

    Output is grouped per user; within a user, frames ascend inside each
    mask group and groups follow first-staged order (the dense nonzero
    listing interleaves a multi-topic user's groups by frame index
    instead — same pair SET, one documented ordering difference).
    """
    if not walk.groups and not walk.solo_rows:
        return ragged_pairs(out_user, walk.walk_frame, num_users)
    u_parts: List[np.ndarray] = []  # (user, group) incidence entries
    g_parts: List[np.ndarray] = []
    frames_per_group: List[np.ndarray] = []
    for gi, (rep, n_rows, frames) in enumerate(walk.groups):
        rows = out_user[rep:rep + n_rows].ravel()
        receivers = rows[rows >= 0]
        if len(receivers):
            u_parts.append(receivers)
            g_parts.append(np.full(len(receivers), gi, np.int32))
            frames_per_group.append(frames)
        else:
            frames_per_group.append(frames)
    if walk.solo_rows:
        solo = np.asarray(walk.solo_rows, np.int64)
        srows = out_user[solo]                       # [D, PAGE]
        d_idx, lane = np.nonzero(srows >= 0)
        if len(d_idx):
            base = len(walk.groups)
            u_parts.append(srows[d_idx, lane])
            g_parts.append((base + np.arange(len(d_idx))).astype(np.int32))
            for i in d_idx:
                frames_per_group.append(
                    walk.walk_frame[solo[i]:solo[i] + 1])
    if not u_parts:
        return (np.empty(0, np.int32), np.empty(0, np.int32))
    u2 = np.concatenate(u_parts)
    g2 = np.concatenate(g_parts)
    # stable user sort over the SMALL incidence listing (radix for u16)
    key = u2.astype(np.uint16) if num_users <= 0xFFFF else u2
    order = np.argsort(key, kind="stable")
    u2, g2 = u2[order], g2[order]
    flen = np.asarray([len(f) for f in frames_per_group], np.int64)
    fstart = np.cumsum(flen) - flen
    frames_table = np.concatenate(frames_per_group) if frames_per_group \
        else np.empty(0, np.int32)
    lens = flen[g2]
    total = int(lens.sum())
    out_users = np.repeat(u2, lens)
    # segment gather: entry i contributes frames_table[fstart[g2[i]] : +len]
    seg_cum = np.cumsum(lens) - lens
    pos = (np.arange(total, dtype=np.int64)
           - np.repeat(seg_cum, lens) + np.repeat(fstart[g2], lens))
    return out_users, frames_table[pos].astype(np.int32, copy=False)


def ragged_to_dense(out_user: np.ndarray, walk_frame: np.ndarray,
                    num_users: int, num_frames: int) -> np.ndarray:
    """Scatter the compact output back to ``bool[U, N]`` (equivalence
    tests against the dense kernel; never on the hot path)."""
    deliver = np.zeros((num_users, num_frames), bool)
    w_idx, lane = np.nonzero(out_user >= 0)
    deliver[out_user[w_idx, lane], walk_frame[w_idx]] = True
    return deliver
