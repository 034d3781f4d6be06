"""Sequence packing: variable-length documents into fixed-length rows.

Port of ``horovod_tpu/data/packing.py``. Documents are packed back to back
into ``(rows, row_len)`` token matrices with per-token ``segment_ids``; the
models' attention, positions and packed loss then train each document as
if it were alone (``ops/attention.segment_mask`` / ``packed_positions``,
``models.gpt2.loss_fn(..., segment_ids=)``).

Rows are assigned first-fit-decreasing (within ~11/9 of the optimal row
count). This is the reference's NumPy path; its native C++ packer gives the
same rows (``horovod_tpu/data/packing.py:31-32``) and is not ported. Filler
positions at each row's tail get DISTINCT negative segment ids, so a packed
loss drops every filler target.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["pack_rows", "pack_documents"]


def _pack_rows_py(lengths: np.ndarray, row_len: int) -> np.ndarray:
    """First-fit-decreasing: decreasing length, ties by original index,
    the first open row with space."""
    order = sorted(range(len(lengths)), key=lambda i: (-lengths[i], i))
    row_of = np.empty(len(lengths), np.int32)
    space: List[int] = []
    for idx in order:
        ln = int(lengths[idx])
        placed = -1
        for r, s in enumerate(space):
            if s >= ln:
                placed = r
                break
        if placed < 0:
            space.append(row_len)
            placed = len(space) - 1
        space[placed] -= ln
        row_of[idx] = placed
    return row_of


def pack_rows(lengths: Sequence[int], row_len: int) -> np.ndarray:
    """Row index per document (first-fit-decreasing over ``row_len``).

    Raises ``ValueError`` if any document exceeds ``row_len`` — split
    long documents upstream; silent truncation would corrupt targets.
    """
    lengths = np.ascontiguousarray(lengths, np.int64)
    if lengths.size == 0:
        return np.empty(0, np.int32)
    if int(lengths.min()) < 0:
        raise ValueError(
            f"negative document length {int(lengths.min())} — lengths "
            "must be non-negative (caller bug, not a packing limit)")
    if int(lengths.max()) > row_len:
        raise ValueError(
            f"document of length {int(lengths.max())} cannot fit "
            f"row_len={row_len}; split long documents before packing")
    return _pack_rows_py(lengths, row_len)


def pack_documents(docs: Sequence[Sequence[int]], row_len: int, *,
                   pad_id: int = 0, max_rows: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack token documents into int32 ``(tokens, segment_ids)`` matrices.

    Both outputs are shaped ``(rows, row_len)`` with the row count chosen
    by first-fit-decreasing. Within a row, documents keep their original
    relative order; segment
    ids number documents globally in input order (so callers can map a
    segment back to its document); row tails are ``pad_id`` filler with
    distinct negative ids (exactness — see module docstring).
    ``max_rows`` bounds the packing: exceeding it raises (real pipelines
    spill the remainder into the next batch; silently dropping documents
    here would skew training data).
    """
    lengths = [len(d) for d in docs]
    row_of = pack_rows(lengths, row_len)
    n_rows = int(row_of.max()) + 1 if row_of.size else 0
    if max_rows is not None and n_rows > max_rows:
        raise ValueError(
            f"packing needs {n_rows} rows of {row_len} but max_rows="
            f"{max_rows}; spill {n_rows - max_rows} row(s) of documents "
            "to the next batch")
    tokens = np.full((n_rows, row_len), pad_id, np.int32)
    segs = np.empty((n_rows, row_len), np.int32)
    cursor = np.zeros(n_rows, np.int64)
    for i, doc in enumerate(docs):
        r = int(row_of[i])
        c = int(cursor[r])
        tokens[r, c:c + len(doc)] = np.asarray(doc, np.int32)
        segs[r, c:c + len(doc)] = i
        cursor[r] += len(doc)
    for r in range(n_rows):
        fill = row_len - int(cursor[r])
        segs[r, row_len - fill:] = np.arange(-1, -fill - 1, -1)
    return tokens, segs
