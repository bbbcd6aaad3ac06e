"""Paged KV cache: fixed-size blocks + per-sequence block tables.

The serving engine's KV memory is a pool of ``num_blocks`` fixed-size blocks
(vLLM-style PagedAttention, arXiv:2309.06180 — see PAPERS.md); a sequence
owns an *ordered* list of block ids (its block table) covering its token
positions: position ``p`` lives in logical block ``p // block_size`` at slot
``p % block_size``.  Allocation is O(1) from a free list; freeing a finished
sequence returns every block immediately, so memory scales with *live*
tokens rather than ``slots × max_len`` as the ring layout does.

Two layers:

* :class:`BlockManager` — pure-Python bookkeeping (free list, block tables,
  live-token accounting), a copy of ``repro.serve.kv_cache``'s.
* :func:`pack_block_tables` — the host-side block-table packing.  The
  device-side K/V pools live in the session state (``models.sessions``);
  the engine owns one :class:`BlockManager` per block-pool session.

Block 0 is reserved as the **null block**: it is never allocated, and the
steps route padding-token writes (position ``-1``) into it, so fixed-shape
prefill/decode calls never write into a live sequence's memory.
"""
from __future__ import annotations

from typing import Sequence


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Number of blocks covering ``n_tokens`` positions."""
    return max(0, (n_tokens + block_size - 1) // block_size)


class BlockManager:
    """Free-list allocator over ``num_blocks`` blocks of ``block_size`` slots.

    Block 0 is reserved (the null block); ``num_free`` therefore starts at
    ``num_blocks - 1``.  All methods are O(blocks touched).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the reserved null block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))  # LIFO pop
        self._tables: dict[int, list[int]] = {}
        self._lens: dict[int, int] = {}

    # -- queries --------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    def can_allocate(self, n_tokens: int) -> bool:
        return blocks_for(n_tokens, self.block_size) <= self.num_free

    def table(self, seq_id: int) -> list[int]:
        return list(self._tables[seq_id])

    def seq_ids(self) -> list[int]:
        return list(self._tables)

    def seq_len(self, seq_id: int) -> int:
        return self._lens[seq_id]

    def live_tokens(self) -> int:
        """Total live (written) token positions across sequences."""
        return sum(self._lens.values())

    def allocated_slots(self) -> int:
        """Total capacity of blocks currently owned by sequences."""
        return sum(len(t) for t in self._tables.values()) * self.block_size

    def utilization(self) -> float:
        """live tokens / allocated slots (1.0 when every block is full)."""
        slots = self.allocated_slots()
        return self.live_tokens() / slots if slots else 0.0

    # -- mutation -------------------------------------------------------------
    def allocate(self, seq_id: int, n_tokens: int) -> bool:
        """Register ``seq_id`` with blocks covering ``n_tokens`` positions.

        Atomic: returns False (and allocates nothing) when the free list is
        short.  ``seq_id`` must not already be registered.
        """
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        need = blocks_for(n_tokens, self.block_size)
        if need > self.num_free:
            return False
        self._tables[seq_id] = [self._free.pop() for _ in range(need)]
        self._lens[seq_id] = n_tokens
        return True

    def ensure(self, seq_id: int, n_tokens: int) -> bool:
        """Grow ``seq_id``'s table to cover ``n_tokens`` positions.

        Atomic like :meth:`allocate`; never shrinks.  Returns False when the
        growth doesn't fit (state unchanged).
        """
        table = self._tables[seq_id]
        need = blocks_for(n_tokens, self.block_size) - len(table)
        if need > self.num_free:
            return False
        for _ in range(max(need, 0)):
            table.append(self._free.pop())
        self._lens[seq_id] = max(self._lens[seq_id], n_tokens)
        return True

    def free(self, seq_id: int) -> list[int]:
        """Release all of ``seq_id``'s blocks back to the pool."""
        blocks = self._tables.pop(seq_id)
        self._lens.pop(seq_id)
        self._free.extend(blocks)
        return blocks


def pack_block_tables(manager: BlockManager, seq_ids: Sequence[int | None],
                      table_width: int):
    """(B, table_width) int32 table; ``None`` rows / tail pad with the
    null block 0."""
    import numpy as np  # local: BlockManager itself stays numpy-free

    out = np.zeros((len(seq_ids), table_width), np.int32)
    for i, sid in enumerate(seq_ids):
        if sid is None:
            continue
        t = manager.table(sid)
        out[i, :len(t)] = t
    return out
