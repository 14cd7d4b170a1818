"""swshard planner: sharding -> sharding retiles as minimal-memory schedules.

The planner compiles a (source sharding, destination sharding) pair over
one global index space into a schedule of tagged point-to-point transfers
whose **peak per-host staging stays O(shard), never O(array)** -- the
construction of "Memory-efficient array redistribution through portable
collective communication" (arxiv 2112.01075) applied to starway's p2p
fabric instead of XLA collectives (DESIGN.md §20, ROADMAP item 2).

Everything here is **pure data + stdlib**: a sharding side is a
:class:`ShardSpec` (global shape, element size, and per-rank index-space
boxes), serialisable to/from plain JSON-able dicts so *different
processes on different meshes* can agree on one plan without sharing a
jax namespace -- the cross-process lingua franca.  jax enters only in
reshard/api.py, which lowers ``jax.sharding.NamedSharding`` into specs
(the layering twin of core/'s no-jax rule; analysis rule
``layering-reshard``).

The algorithm, in four deterministic steps (every participant computes
the identical plan from the identical specs):

1. **Dedup regions.**  Blocks of one spec either partition the index
   space or replicate it (several ranks holding the same box -- jax's
   partial replication).  Distinct boxes are deduped; each keeps the set
   of holder ranks.
2. **Intersect.**  Every (distinct src box x distinct dst box) overlap
   is one *piece*.  A piece whose destination rank also holds a source
   copy becomes a local copy (never touches the network); otherwise one
   source holder is chosen deterministically, least-loaded-first, so
   replicated sources spread the send load.
3. **Split.**  Pieces for one (src, dst) rank pair are packed into
   *transfers* of at most ``budget`` bytes each (default: the largest
   distinct shard of either side).  A transfer is ONE tagged message --
   its pieces concatenate in deterministic order, so the wire needs no
   per-piece header.
4. **Round-assign.**  Transfers are greedily placed (largest first)
   into rounds where each rank sends at most one and receives at most
   one transfer -- the all-to-all shape.  The executor puts a flush
   barrier between rounds, so per-host concurrent staging is bounded by
   one outgoing + one incoming transfer: **<= 2 x budget = O(shard)**.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

__all__ = [
    "Block",
    "ShardSpec",
    "Piece",
    "Transfer",
    "Plan",
    "build_plan",
    "box_nbytes",
    "box_overlap",
]

Box = tuple  # tuple[(lo, hi), ...] -- half-open per-dim intervals


def box_elems(box: Box) -> int:
    n = 1
    for lo, hi in box:
        n *= max(0, hi - lo)
    return n


def box_nbytes(box: Box, itemsize: int) -> int:
    return box_elems(box) * int(itemsize)


def box_overlap(a: Box, b: Box) -> Optional[Box]:
    """Intersection box of two half-open boxes, or None when empty."""
    out = []
    for (alo, ahi), (blo, bhi) in zip(a, b):
        lo, hi = max(alo, blo), min(ahi, bhi)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


@dataclass(frozen=True)
class Block:
    """One rank's claim on one index-space box (a device shard's global
    slice, lifted to the rank that owns the device)."""

    rank: int
    box: Box

    def to_dict(self) -> dict:
        return {"rank": self.rank, "box": [list(d) for d in self.box]}

    @classmethod
    def from_dict(cls, d: dict) -> "Block":
        return cls(int(d["rank"]),
                   tuple((int(lo), int(hi)) for lo, hi in d["box"]))


@dataclass
class ShardSpec:
    """One side of a redistribution: the global array plus who holds what.

    ``blocks`` may repeat a box across ranks (replication) and may list
    several boxes per rank (several local devices).  The spec must
    *cover* the global index space -- checked in :func:`build_plan` by
    the uncovered-volume test on the destination side.
    """

    shape: tuple
    itemsize: int
    blocks: list = field(default_factory=list)

    def __post_init__(self):
        self.shape = tuple(int(s) for s in self.shape)
        self.itemsize = int(self.itemsize)
        for b in self.blocks:
            if len(b.box) != len(self.shape):
                raise ValueError(
                    f"block {b} rank mismatch with shape {self.shape}")
            for (lo, hi), dim in zip(b.box, self.shape):
                if not (0 <= lo < hi <= dim):
                    raise ValueError(
                        f"block {b} outside the global shape {self.shape}")

    def ranks(self) -> set:
        return {b.rank for b in self.blocks}

    def distinct_boxes(self) -> dict:
        """{box: sorted holder ranks} -- replication collapsed."""
        out: dict = {}
        for b in sorted(self.blocks, key=lambda b: (b.box, b.rank)):
            out.setdefault(b.box, [])
            if b.rank not in out[b.box]:
                out[b.box].append(b.rank)
        return out

    def max_shard_nbytes(self) -> int:
        return max((box_nbytes(b.box, self.itemsize) for b in self.blocks),
                   default=0)

    def rank_nbytes(self, rank: int) -> int:
        """Distinct bytes resident on ``rank`` (replicated boxes counted
        once)."""
        seen = set()
        total = 0
        for b in self.blocks:
            if b.rank == rank and b.box not in seen:
                seen.add(b.box)
                total += box_nbytes(b.box, self.itemsize)
        return total

    # ------------------------------------------------------------- wire
    def to_dict(self) -> dict:
        return {
            "shape": list(self.shape),
            "itemsize": self.itemsize,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ShardSpec":
        return cls(tuple(d["shape"]), int(d["itemsize"]),
                   [Block.from_dict(b) for b in d["blocks"]])

    def merged(self, other: "ShardSpec") -> "ShardSpec":
        """Union of two partial specs (per-rank contributions exchanged
        over the fabric); shape/itemsize must agree."""
        if self.shape != other.shape or self.itemsize != other.itemsize:
            raise ValueError(
                f"spec mismatch: {self.shape}/{self.itemsize} vs "
                f"{other.shape}/{other.itemsize} -- all participants must "
                "describe the same global array")
        seen = {(b.rank, b.box) for b in self.blocks}
        extra = [b for b in other.blocks if (b.rank, b.box) not in seen]
        return ShardSpec(self.shape, self.itemsize, self.blocks + extra)


@dataclass(frozen=True)
class Piece:
    """One contiguous global box moving src_rank -> dst_rank (or copied
    locally when the ranks agree)."""

    src: int
    dst: int
    box: Box


@dataclass
class Transfer:
    """One tagged message: >=1 pieces between one (src, dst) rank pair.
    Pieces concatenate in list order, each flattened C-order -- both ends
    derive the identical layout from the plan, so no wire header."""

    src: int
    dst: int
    pieces: list
    nbytes: int
    tag_off: int = -1   # lease-relative tag (assigned once, plan order)
    round: int = -1     # flush-barrier round (assigned by round_assign)


@dataclass
class Plan:
    """The compiled schedule.  Deterministic given (src, dst) specs:
    every participant builds bit-identical transfers/tags/rounds."""

    shape: tuple
    itemsize: int
    transfers: list               # Transfer, tag_off order
    local_pieces: dict            # rank -> [Piece] (src == dst, no network)
    rounds: int
    budget: int

    def sends_for(self, rank: int, rnd: Optional[int] = None) -> list:
        return [t for t in self.transfers
                if t.src == rank and (rnd is None or t.round == rnd)]

    def recvs_for(self, rank: int, rnd: Optional[int] = None) -> list:
        return [t for t in self.transfers
                if t.dst == rank and (rnd is None or t.round == rnd)]

    def total_wire_nbytes(self) -> int:
        return sum(t.nbytes for t in self.transfers)

    def peak_staging(self, rank: int) -> int:
        """Upper bound on ``rank``'s concurrently staged bytes under the
        executor's round barriers: the worst round's one outgoing + one
        incoming transfer.  <= 2 x budget by construction."""
        peak = 0
        for rnd in range(self.rounds):
            here = sum(t.nbytes for t in self.transfers
                       if t.round == rnd and rank in (t.src, t.dst))
            peak = max(peak, here)
        return peak


def _choose_source(holders: list, dst: int, load: dict) -> int:
    """Deterministic source pick for one piece: the destination itself
    when it already holds a copy (local, free), else the least-loaded
    holder (ties to the lowest rank) so replicated sources share the
    send work."""
    if dst in holders:
        return dst
    return min(holders, key=lambda r: (load.get(r, 0), r))


def build_plan(src: ShardSpec, dst: ShardSpec,
               budget: Optional[int] = None) -> Plan:
    """Compile ``src -> dst`` into a round schedule.

    ``budget`` caps one transfer's bytes (default: the larger of the two
    sides' largest distinct shard -- the O(shard) unit the memory bound
    is stated in).  A single piece larger than the budget still travels
    whole (a piece is the indivisible unit); that only happens when one
    destination shard alone exceeds every source shard, where O(shard)
    is that piece's size anyway.
    """
    if src.shape != dst.shape or src.itemsize != dst.itemsize:
        raise ValueError(
            f"src {src.shape}/{src.itemsize} and dst {dst.shape}/"
            f"{dst.itemsize} describe different arrays")
    if budget is None:
        budget = max(src.max_shard_nbytes(), dst.max_shard_nbytes(), 1)
    budget = max(1, int(budget))

    src_boxes = src.distinct_boxes()
    dst_boxes = dst.distinct_boxes()

    # ---- steps 1+2: intersect distinct regions, choose sources --------
    pieces: list = []          # network pieces
    local: dict = {}           # rank -> [Piece]
    load: dict = {}            # src rank -> bytes already assigned
    covered = 0
    for dbox, dst_holders in dst_boxes.items():
        for sbox, src_holders in src_boxes.items():
            ov = box_overlap(dbox, sbox)
            if ov is None:
                continue
            nb = box_nbytes(ov, src.itemsize)
            # Every holder of the dst box needs these bytes; holders that
            # also hold the src copy it locally, the rest receive it.
            for dr in dst_holders:
                p = Piece(_choose_source(src_holders, dr, load), dr, ov)
                if p.src == dr:
                    local.setdefault(dr, []).append(p)
                else:
                    load[p.src] = load.get(p.src, 0) + nb
                    pieces.append(p)
            covered += nb
    dst_volume = sum(box_nbytes(b, dst.itemsize) for b in dst_boxes)
    if covered != dst_volume:
        raise ValueError(
            f"source spec does not cover the destination: {covered} of "
            f"{dst_volume} destination bytes have a source")

    # ---- step 3: pack pieces into <=budget transfers per pair ---------
    by_pair: dict = {}
    for p in sorted(pieces, key=lambda p: (p.src, p.dst, p.box)):
        by_pair.setdefault((p.src, p.dst), []).append(p)
    transfers: list = []
    for (s, d) in sorted(by_pair):
        group, size = [], 0
        for p in by_pair[(s, d)]:
            nb = box_nbytes(p.box, src.itemsize)
            if group and size + nb > budget:
                transfers.append(Transfer(s, d, group, size))
                group, size = [], 0
            group.append(p)
            size += nb
        if group:
            transfers.append(Transfer(s, d, group, size))

    # ---- step 4: largest-first greedy round assignment ----------------
    # Stable total order first (pair, then descending size) so ties
    # break identically everywhere; tags follow the same order.
    transfers.sort(key=lambda t: (-t.nbytes, t.src, t.dst,
                                  t.pieces[0].box if t.pieces else ()))
    busy_tx: list = []   # round -> set of sending ranks
    busy_rx: list = []   # round -> set of receiving ranks
    for t in transfers:
        rnd = 0
        while True:
            if rnd == len(busy_tx):
                busy_tx.append(set())
                busy_rx.append(set())
            if t.src not in busy_tx[rnd] and t.dst not in busy_rx[rnd]:
                busy_tx[rnd].add(t.src)
                busy_rx[rnd].add(t.dst)
                t.round = rnd
                break
            rnd += 1
    transfers.sort(key=lambda t: (t.round, t.src, t.dst,
                                  t.pieces[0].box if t.pieces else ()))
    for i, t in enumerate(transfers):
        t.tag_off = i

    for rank, ps in local.items():
        ps.sort(key=lambda p: p.box)
    return Plan(src.shape, src.itemsize, transfers, local,
                len(busy_tx), budget)
