"""The device router: one routing step per tick, on one shard or on every
shard of a broker mesh.

One step does, for a whole batch of frames at once:

- **CRDT sync**: the per-shard DirectMap claims are folded with the
  versioned dominance rule (``parallel.crdt``), and user topic masks
  travel with the ownership claim; a shard declared dead by ``liveness``
  has its slots tombstoned with a version bump;
- **broadcast routing**: a topic-bitmask AND between every frame and
  every local user;
- **direct routing**: equality of the frame's destination user slot with
  a locally-owned user — delivery-iff-owner, nothing is re-forwarded;
- **eviction**: locally-owned users the merge hands to another owner.

The delivery decision comes from one of the two kernels: the dense
``[U, N]`` matrix (``ops.delivery_kernel``) or the ragged page walk
(``ops.ragged_delivery``). Both dispatch on the tensors' device: the
Hopper kernel for CUDA tensors, the plain version for CPU tensors.

On a mesh (``parallel.mesh.BrokerMesh``) a step has two halves. The
exchange moves every shard's state rows and frame columns to every
shard (an ``all_gather``; direct buckets go only to their owner, an
``all_to_all``), either one array at a time or packed into ONE buffer
(the fused tick). Then each shard routes against the gathered rows on
its own device, exactly as a single shard routes against its own rows
with a leading axis of one. The exchange is copies between the shards'
devices (``Tensor.to``): on one card folded into several shards it is
device-to-device copies, not interconnect traffic.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence

import torch

from pushcdn_tpu_torch._device import DeviceLike, resolve_device
from pushcdn_tpu_torch.ops.delivery_kernel import delivery_matrix
from pushcdn_tpu_torch.ops.ragged_delivery import ragged_delivery
from pushcdn_tpu_torch.parallel.crdt import (
    ABSENT,
    VERSION_MASK,
    CrdtState,
    bump,
    empty_state,
    merge_all_gathered_with_payload,
)
from pushcdn_tpu_torch.parallel.mesh import BrokerMesh

# The selected delivery implementation by name (None = auto, which is
# dense). "ragged" switches consumers (DevicePlane) onto the page walk.
DELIVERY_IMPL: Optional[str] = None


def set_delivery_impl(impl: str) -> None:
    """One switch for every delivery-impl consumer: 'auto' restores the
    default (dense), 'dense' or 'ragged' select a kernel. Which version of
    a kernel runs follows the tensors' device, never this switch."""
    global DELIVERY_IMPL
    if impl not in ("auto", "dense", "ragged"):
        raise ValueError(f"unknown delivery impl {impl!r}")
    DELIVERY_IMPL = None if impl == "auto" else impl


# ---------------------------------------------------------------------------
# collective accounting (the one-collective-per-tick invariant)
# ---------------------------------------------------------------------------
#
# Every exchange between shards goes through the two helpers below, which
# count it: ``trace_collectives()`` deltas around a step count that
# step's collectives. The JAX package also has ``count_collectives``,
# which counts collective ops in a lowered StableHLO program; an eager
# torch step lowers to no program text, so it has no counterpart here and
# the counted helpers are the one count.

_COLLECTIVES = [0]


def trace_collectives() -> int:
    """Collectives issued so far in this process (diff around a step)."""
    return _COLLECTIVES[0]


def _all_gather(xs: Sequence[torch.Tensor],
                mesh: BrokerMesh) -> List[torch.Tensor]:
    """``xs[j]`` is shard ``j``'s tensor on its device. Every shard gets
    ``stack(xs)`` ([B, ...], rows in mesh order) on its own device;
    shards that share a device share one stacked result."""
    _COLLECTIVES[0] += 1
    stacked = {dev: torch.stack([x.to(dev) for x in xs])
               for dev in mesh.distinct_devices()}
    return [stacked[dev] for dev in mesh.devices]


def _all_to_all(xs: Sequence[torch.Tensor],
                mesh: BrokerMesh) -> List[torch.Tensor]:
    """``xs[j]`` is shard ``j``'s [B, ...] tensor whose axis 0 is the
    destination shard. Shard ``i`` gets ``stack([x_j[i] for j])``: what
    every source shard addressed to it, axis 0 now the source shard."""
    _COLLECTIVES[0] += 1
    return [torch.stack([x[i].to(dev) for x in xs])
            for i, dev in enumerate(mesh.devices)]


class RouterState(NamedTuple):
    """Per-shard routing state: the DirectMap twin + per-user topic masks."""

    crdt: CrdtState            # owners/versions/identities [U]
    topic_masks: torch.Tensor  # int32[U] or int32[U, W] (u32 bit-views)


class IngressBatch(NamedTuple):
    """One step of packed ingress frames (see parallel.frames)."""

    frame_bytes: torch.Tensor  # uint8[S, F] (F may be 0: a byte stub)
    kind: torch.Tensor         # int32[S]
    length: torch.Tensor       # int32[S]
    topic_mask: torch.Tensor   # int32[S] or int32[S, W]
    dest: torch.Tensor         # int32[S]
    valid: torch.Tensor        # bool[S]


class DirectIngress(NamedTuple):
    """Per-destination-shard direct frames: axis 0 = destination shard.
    A mesh step exchanges them with one ``all_to_all``, so each frame
    travels once, to its owner. On a single shard axis 0 has length one
    and holds this shard's own buckets."""

    frame_bytes: torch.Tensor  # uint8[B, C, F]
    length: torch.Tensor       # int32[B, C]
    dest: torch.Tensor         # int32[B, C]
    valid: torch.Tensor        # bool[B, C]


class RouteResult(NamedTuple):
    gathered_bytes: Optional[torch.Tensor]  # uint8[B*S, F]
    gathered_length: torch.Tensor           # int32[B*S]
    deliver: torch.Tensor                   # bool[U, B*S]
    state: RouterState                      # merged CRDT + masks
    evictions: torch.Tensor                 # bool[U]
    direct_bytes: Optional[torch.Tensor] = None
    direct_length: Optional[torch.Tensor] = None
    direct_deliver: Optional[torch.Tensor] = None


class LaneDelivery(NamedTuple):
    """Per-lane router output: the frames + delivery matrix."""

    gathered_bytes: Optional[torch.Tensor]  # uint8[B*S_l, F_l] or None
    gathered_length: torch.Tensor           # int32[B*S_l]
    deliver: torch.Tensor                   # bool[U, B*S_l]


class MultiRouteResult(NamedTuple):
    lanes: tuple                # Tuple[LaneDelivery, ...] (broadcast lanes)
    direct_lanes: tuple         # Tuple[LaneDelivery, ...] (direct lanes)
    state: RouterState
    evictions: torch.Tensor     # bool[U]


class RaggedRouteResult(NamedTuple):
    """Compact per-candidate delivery output: row ``w`` of ``out_user``
    is a receiver run for frame ``walk_frame[w]`` (-1 lanes empty)."""

    out_user: torch.Tensor  # int32[Wp, PAGE]
    counts: torch.Tensor    # int32[Wp]
    state: RouterState
    evictions: torch.Tensor


def empty_router_state(num_users: int, topic_words: int = 1,
                       device: DeviceLike = None) -> RouterState:
    dev = resolve_device(device)
    shape = (num_users,) if topic_words == 1 else (num_users, topic_words)
    return RouterState(
        crdt=empty_state(num_users, device=dev),
        topic_masks=torch.zeros(shape, dtype=torch.int32, device=dev),
    )


def _merge_gathered(state: RouterState, g_owners, g_versions, g_ids,
                    g_masks, my_index: int, liveness):
    """The CRDT anti-entropy fold over already-gathered state rows
    ([B, U] each, [B, U, W] for multi-word masks), then the liveness
    tombstones. Returns (merged, masks, now_local, evictions)."""
    was_local = state.crdt.owners == my_index
    merged, masks, _changed = merge_all_gathered_with_payload(
        state.crdt, state.topic_masks,
        CrdtState(g_owners, g_versions, g_ids), g_masks)
    if liveness is not None:
        # release every slot owned by a dead shard (owner index is a mesh
        # coordinate; ABSENT maps to "live" so tombstones pass through).
        # An owner index past the mesh reads the last shard's flag, as a
        # clamped gather does.
        idx = merged.owners.clamp(0, liveness.shape[0] - 1).long()
        owner_live = torch.where(merged.owners == ABSENT, True,
                                 liveness[idx])
        merged = CrdtState(
            owners=torch.where(owner_live, merged.owners, ABSENT),
            versions=torch.where(owner_live, merged.versions,
                                 bump(merged.versions)),
            identities=merged.identities,
        )
        live_b = owner_live.reshape(
            owner_live.shape + (1,) * (masks.dim() - owner_live.dim()))
        masks = torch.where(live_b, masks, 0)
    now_local = merged.owners == my_index
    evictions = was_local & ~now_local
    return merged, masks, now_local, evictions


def _lane_deliver(masks, now_local, g_bytes, g_kind, g_length, g_tmask,
                  g_dest, g_valid, liveness) -> LaneDelivery:
    """One broadcast lane's delivery matrix from gathered frame columns."""
    B, S = g_kind.shape
    if liveness is not None:
        g_valid = g_valid & liveness[:, None]  # dead shards' frames
    valid_f = g_valid.reshape(B * S)
    kind_f = torch.where(valid_f, g_kind.reshape(B * S), 0).contiguous()
    tmask_f = g_tmask.reshape((B * S,) + tuple(g_tmask.shape[2:]))
    deliver = delivery_matrix(masks, now_local, tmask_f.contiguous(),
                              kind_f, g_dest.reshape(B * S).contiguous())
    return LaneDelivery(
        gathered_bytes=(None if g_bytes is None
                        else g_bytes.reshape(B * S, -1)),
        gathered_length=g_length.reshape(B * S),
        deliver=deliver)


def _direct_deliver(r_bytes, r_length, r_dest, r_valid, now_local,
                    liveness) -> LaneDelivery:
    """The local delivery mask from RECEIVED direct buckets (axis 0 =
    source shard): delivery iff the addressed slot is locally owned."""
    if liveness is not None:
        r_valid = r_valid & liveness[:, None]
    B, C = r_dest.shape
    dest_f = r_dest.reshape(B * C)
    valid_f = r_valid.reshape(B * C)
    U = now_local.shape[0]
    slots = torch.arange(U, dtype=torch.int32, device=now_local.device)
    deliver = (valid_f[None, :]
               & (dest_f[None, :] == slots[:, None])
               & now_local[:, None])
    return LaneDelivery(
        gathered_bytes=(None if r_bytes is None
                        else r_bytes.reshape(B * C, -1)),
        gathered_length=r_length.reshape(B * C),
        deliver=deliver)


def _route_exchanged(state: RouterState, my_index: int, liveness,
                     crdt_rows, lane_rows, direct_rows) -> MultiRouteResult:
    """One shard's routing after the exchange, against the gathered rows:
    ``crdt_rows`` = (owners, versions, identities, masks), each [B, U...];
    one (bytes or None, kind, length, tmask, dest, valid) per broadcast
    lane, each [B, S...]; one (bytes or None, length, dest, valid) per
    direct lane as RECEIVED, axis 0 the source shard. The CRDT merge runs
    ONCE and every lane is routed against the merged state."""
    merged, masks, now_local, evictions = _merge_gathered(
        state, *crdt_rows, my_index, liveness)
    lanes = tuple(_lane_deliver(masks, now_local, *rows, liveness)
                  for rows in lane_rows)
    direct_lanes = tuple(_direct_deliver(*rows, now_local, liveness)
                         for rows in direct_rows)
    return MultiRouteResult(
        lanes=lanes, direct_lanes=direct_lanes,
        state=RouterState(crdt=merged, topic_masks=masks),
        evictions=evictions)


def routing_step_lanes(state: RouterState, batches: tuple, my_index: int,
                       directs: tuple = (),
                       liveness: Optional[torch.Tensor] = None,
                       gather_bytes: bool = True) -> MultiRouteResult:
    """One single-shard routing step over any number of size-bucketed
    lanes. ``batches`` holds one :class:`IngressBatch` per broadcast lane,
    ``directs`` one :class:`DirectIngress` per direct lane.

    ``gather_bytes=False`` keeps frame bytes out of the step (broadcast
    lanes come back with ``gathered_bytes=None``): the device plane
    egresses payloads from its host ring snapshots. ``liveness``
    (bool[1]) is the dynamic-membership mask of the mesh of one."""

    def gather(x):
        return x[None]

    crdt_rows = (gather(state.crdt.owners), gather(state.crdt.versions),
                 gather(state.crdt.identities), gather(state.topic_masks))
    lane_rows = [(gather(b.frame_bytes) if gather_bytes else None,
                  gather(b.kind), gather(b.length), gather(b.topic_mask),
                  gather(b.dest), gather(b.valid)) for b in batches]
    # a single shard exchanges nothing, so its direct lanes keep their
    # byte views whatever ``gather_bytes`` says (as the JAX step does)
    direct_rows = [(d.frame_bytes, d.length, d.dest, d.valid)
                   for d in directs]
    return _route_exchanged(state, my_index, liveness, crdt_rows,
                            lane_rows, direct_rows)


def _route_result(r: MultiRouteResult) -> RouteResult:
    """The single-lane view of a lane step's result."""
    lane = r.lanes[0]
    d = r.direct_lanes[0] if r.direct_lanes else None
    return RouteResult(
        gathered_bytes=lane.gathered_bytes,
        gathered_length=lane.gathered_length,
        deliver=lane.deliver,
        state=r.state,
        evictions=r.evictions,
        direct_bytes=None if d is None else d.gathered_bytes,
        direct_length=None if d is None else d.gathered_length,
        direct_deliver=None if d is None else d.deliver,
    )


def routing_step(state: RouterState, batch: IngressBatch, my_index: int,
                 direct: Optional[DirectIngress] = None) -> RouteResult:
    """One routing step for one shard — the single-lane special case of
    :func:`routing_step_lanes`."""
    return _route_result(routing_step_lanes(
        state, (batch,), my_index,
        directs=() if direct is None else (direct,)))


def routing_step_ragged(state: RouterState, batch: IngressBatch,
                        pages: torch.Tensor, walk_page: torch.Tensor,
                        walk_frame: torch.Tensor,
                        my_index: int) -> RaggedRouteResult:
    """One single-shard step through the ragged page walk: the same CRDT
    fold as the dense step, then the walk instead of the U x N sweep.
    The walk inputs come from ``RaggedInterest.pack`` on the host."""
    merged, masks, now_local, evictions = _merge_gathered(
        state, state.crdt.owners[None], state.crdt.versions[None],
        state.crdt.identities[None], state.topic_masks[None],
        my_index, None)
    kind_f = torch.where(batch.valid, batch.kind, 0).contiguous()
    out_user, counts = ragged_delivery(
        pages, walk_page, walk_frame, now_local, masks.contiguous(),
        batch.topic_mask, kind_f, batch.dest)
    return RaggedRouteResult(
        out_user=out_user, counts=counts,
        state=RouterState(crdt=merged, topic_masks=masks),
        evictions=evictions)


# ---------------------------------------------------------------------------
# single-chip entry points (the mesh of one: shard index 0)
# ---------------------------------------------------------------------------


def routing_step_single(state: RouterState,
                        batch: IngressBatch) -> RouteResult:
    """Single-chip step: the path ``entry()`` returns."""
    return routing_step(state, batch, 0)


def routing_step_lanes_single(state: RouterState, batches: tuple,
                              directs: tuple = (),
                              gather_bytes: bool = True
                              ) -> MultiRouteResult:
    """Single-chip lane step. ``gather_bytes=False`` keeps frame bytes out
    of the step entirely: only the delivery decision comes back."""
    return routing_step_lanes(state, batches, 0, directs=directs,
                              gather_bytes=gather_bytes)


def routing_step_ragged_single(state: RouterState, batch: IngressBatch,
                               pages: torch.Tensor, walk_page: torch.Tensor,
                               walk_frame: torch.Tensor
                               ) -> RaggedRouteResult:
    """Single-chip ragged step."""
    return routing_step_ragged(state, batch, pages, walk_page, walk_frame, 0)


# ---------------------------------------------------------------------------
# the mesh half: one exchange, then every shard routes on its own device
# ---------------------------------------------------------------------------
#
# Inputs and outputs are per-shard sequences, element i on shard i's
# device (``parallel.mesh.shard_rows`` builds them from stacked leaves).
# The per-array exchange issues one collective per gathered array. The
# fused tick packs every gathered leaf of a shard into one int32 buffer
# and moves the whole tick with ONE all_gather; the direct all_to_all
# folds into it as a gather plus a local slice (each shard keeps column
# ``my_index`` of the gathered destination axis), at a B-fold redundancy
# on direct payload bytes that a plane keeping bytes on the host
# (gather_bytes=False) never pays.


class _WordPacker:
    """Leaf packer for the fused tick: :meth:`add` turns each tensor into
    int32 words, :meth:`pack` concatenates them, :meth:`unpack` slices a
    gathered [B, L] buffer back into [B, ...] leaves in :meth:`add` order.
    Words stay int32 (torch's uint32 has no ``>`` or ``+`` on the CPU)."""

    def __init__(self):
        self._parts: List[torch.Tensor] = []
        self._specs: list = []  # (kind, shape, pad)

    def add(self, x: torch.Tensor) -> None:
        pad = 0
        if x.dtype == torch.bool:
            kind, words = "bool", x.reshape(-1).to(torch.int32)
        elif x.dtype == torch.uint8:
            flat = x.reshape(-1)
            pad = (-flat.numel()) % 4
            # a fresh buffer: view(int32) needs a whole number of words
            # starting on a 4-byte boundary
            flat = torch.cat([flat, flat.new_zeros(pad)])
            kind, words = "u8", flat.view(torch.int32)
        elif x.dtype == torch.int64:
            # CRDT versions: u32 values carried in int64; the low 32 bits
            # travel as the int32 of the same bits
            low = x.reshape(-1) & VERSION_MASK
            kind = "u32"
            words = torch.where(low >= 2**31, low - 2**32, low).to(
                torch.int32)
        elif x.dtype == torch.int32:
            kind, words = "i32", x.reshape(-1)
        else:
            raise TypeError(f"unpackable dtype {x.dtype}")
        self._specs.append((kind, tuple(x.shape), pad))
        self._parts.append(words)

    def pack(self) -> torch.Tensor:
        return torch.cat(self._parts)

    def unpack(self, gathered: torch.Tensor) -> List[torch.Tensor]:
        B = gathered.shape[0]
        outs = []
        off = 0
        for (kind, shape, pad), part in zip(self._specs, self._parts):
            n = part.numel()
            words = gathered[:, off:off + n]
            off += n
            if kind == "bool":
                out = words != 0
            elif kind == "u8":
                out = words.contiguous().view(torch.uint8)
                if pad:
                    out = out[:, :-pad]
            elif kind == "u32":
                out = words.to(torch.int64) & VERSION_MASK
            else:
                out = words
            outs.append(out.reshape((B,) + shape))
        return outs


def _state_leaves(state: RouterState) -> tuple:
    return (*state.crdt, state.topic_masks)


def _exchange_per_array(mesh: BrokerMesh, states, batches, directs,
                        gather_bytes: bool) -> list:
    """One collective per array: 4 for the state, 5 per broadcast lane
    and 3 per direct lane (one more each with ``gather_bytes``). Returns
    each shard's (crdt_rows, lane_rows, direct_rows)."""
    B = mesh.size
    none = [None] * B
    crdt = [_all_gather([_state_leaves(s)[k] for s in states], mesh)
            for k in range(4)]
    lanes = []
    for li in range(len(batches[0])):
        lane = [b[li] for b in batches]
        first = 0 if gather_bytes else 1   # field 0 is frame_bytes
        cols = [none] * first + [_all_gather([b[k] for b in lane], mesh)
                                 for k in range(first, 6)]
        lanes.append(cols)
    dlanes = []
    for li in range(len(directs[0])):
        lane = [d[li] for d in directs]
        first = 0 if gather_bytes else 1
        cols = [none] * first + [_all_to_all([d[k] for d in lane], mesh)
                                 for k in range(first, 4)]
        dlanes.append(cols)
    return [(tuple(c[i] for c in crdt),
             [tuple(c[i] for c in cols) for cols in lanes],
             [tuple(c[i] for c in cols) for cols in dlanes])
            for i in range(B)]


def _exchange_fused(mesh: BrokerMesh, states, batches, directs,
                    gather_bytes: bool) -> list:
    """The one-collective tick: pack → all_gather → unpack, yielding the
    same rows as :func:`_exchange_per_array` (bit-identical routing)."""
    first = 0 if gather_bytes else 1
    packers = []
    for state, lanes, dlanes in zip(states, batches, directs):
        pk = _WordPacker()
        for x in _state_leaves(state):
            pk.add(x)
        for leaves in (*lanes, *dlanes):
            for x in leaves[first:]:
                pk.add(x)
        packers.append(pk)
    # the tick's ONE collective
    gathered = _all_gather([pk.pack() for pk in packers], mesh)
    out = []
    for i, (pk, g) in enumerate(zip(packers, gathered)):
        fields = iter(pk.unpack(g))

        def take(n):
            return (None,) * first + tuple(next(fields)
                                           for _ in range(n - first))

        crdt_rows = tuple(next(fields) for _ in range(4))
        lane_rows = [take(6) for _ in batches[i]]
        # the all_to_all re-expressed: column i of the gathered
        # destination axis is what each source staged for THIS shard
        direct_rows = [tuple(None if x is None else x[:, i]
                             for x in take(4)) for _ in directs[i]]
        out.append((crdt_rows, lane_rows, direct_rows))
    return out


class MeshLaneStep:
    """The multi-shard lane step (JAX: ``routing_step_lanes`` under
    ``shard_map`` over the broker axis). Called with per-shard sequences
    of :class:`RouterState`, of lane tuples of :class:`IngressBatch`, of
    lane tuples of :class:`DirectIngress` and, optionally, of bool[B]
    liveness rows (every shard carries the full membership mask; None
    means all live). Returns one :class:`MultiRouteResult` per shard. A
    call is :meth:`exchange` then :meth:`route`.

    ``gather_bytes=False`` keeps frame bytes out of the exchange (lanes
    come back with ``gathered_bytes=None``): every shard's staged frames
    live in one host's memory, so only the delivery decision needs the
    mesh.

    ``fused`` picks the exchange's schedule. None picks it from the mesh:
    per array when every shard shares one device, where the exchange is
    copies on that device and packing only adds work; ONE collective
    (the fused tick) when the shards span devices, where each collective
    is a transfer between them. True or False forces a schedule."""

    def __init__(self, mesh: BrokerMesh, gather_bytes: bool = True,
                 fused: Optional[bool] = None):
        self.mesh = mesh
        self.gather_bytes = gather_bytes
        self.fused = (len(mesh.distinct_devices()) > 1 if fused is None
                      else fused)

    def exchange(self, states: Sequence[RouterState], batches: Sequence,
                 directs: Sequence) -> list:
        """Every shard's gathered (crdt_rows, lane_rows, direct_rows)."""
        exchange = _exchange_fused if self.fused else _exchange_per_array
        return exchange(self.mesh, states, batches, directs,
                        self.gather_bytes)

    def route(self, states: Sequence[RouterState], rows: list,
              liveness: Optional[Sequence[torch.Tensor]] = None
              ) -> List[MultiRouteResult]:
        """Each shard's routing against its exchanged ``rows``, on its
        own device."""
        return [_route_exchanged(states[i], i,
                                 None if liveness is None else liveness[i],
                                 *rows[i])
                for i in range(self.mesh.size)]

    def __call__(self, states: Sequence[RouterState], batches: Sequence,
                 directs: Optional[Sequence] = None,
                 liveness: Optional[Sequence[torch.Tensor]] = None
                 ) -> List[MultiRouteResult]:
        B = self.mesh.size
        if directs is None:
            directs = [()] * B
        for name, seq in (("states", states), ("batches", batches),
                          ("directs", directs)):
            if len(seq) != B:
                raise ValueError(f"{name} has {len(seq)} shards, the mesh "
                                 f"has {B}")
        if liveness is not None and len(liveness) != B:
            raise ValueError(f"liveness has {len(liveness)} rows, the mesh "
                             f"has {B} shards")
        return self.route(states, self.exchange(states, batches, directs),
                          liveness)


# the JAX package's factory name for the step
make_mesh_lane_step = MeshLaneStep


def routing_step_mesh(mesh: BrokerMesh, states: Sequence[RouterState],
                      batches: Sequence[IngressBatch],
                      directs: Optional[Sequence[DirectIngress]] = None
                      ) -> List[RouteResult]:
    """One single-lane routing step on every shard of ``mesh``; with
    ``directs`` the one-hop ``all_to_all`` direct path runs in the same
    step. One :class:`RouteResult` per shard."""
    step = MeshLaneStep(mesh)
    return [_route_result(r) for r in step(
        states, [(b,) for b in batches],
        None if directs is None else [(d,) for d in directs])]


def make_mesh_routing_step(mesh: BrokerMesh):
    """The multi-shard single-lane step: ``step(states, batches,
    directs=None)``."""
    return functools.partial(routing_step_mesh, mesh)
