"""Host-side KV block allocator: the port of
``dlti_tpu/serving/block_manager.py``'s pure-Python free list.

Physical block 0 is reserved as a trash block: inactive decode slots write
their ignored K/V there, so the decode step needs no branch on liveness.
"""

from __future__ import annotations

from typing import List, Optional


class BlockManager:
    """Free-list allocator over ``num_blocks`` physical KV blocks."""

    TRASH_BLOCK = 0

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # Block 0 reserved; LIFO free list for locality.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        # Handed-out blocks: a double free would put one block on the free
        # list twice and hand it to two sequences.
        self._allocated: set = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def can_allocate(self, n: int) -> bool:
        return self.num_free >= n

    def allocate(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks, or None (allocating nothing) if they do not
        all fit — admission is all-or-nothing."""
        if len(self._free) < n:
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._allocated.update(blocks)
        return blocks

    def free(self, blocks: List[int]) -> None:
        """Return ``blocks`` to the pool. Raises on an invalid id or a double
        free, freeing none of the batch."""
        seen: set = set()
        for b in blocks:
            if b <= self.TRASH_BLOCK or b >= self.num_blocks:
                raise ValueError(f"freeing invalid block {b}")
            if b not in self._allocated or b in seen:
                raise ValueError(
                    f"double free of block {b} (not currently allocated); "
                    "freeing it again would hand the same block to two "
                    "sequences")
            seen.add(b)
        for b in blocks:
            self._allocated.discard(b)
            self._free.append(b)
