"""Carry the JAX package's planned state into the port.

A planned memory program crosses as the fixed-width instruction records
both packages share (``core.bytecode``: same opcodes, same layout) plus a
header of the program's fields, so neither side imports the other: the
JAX package's ``encode_chunk(program.instrs)`` produces ``rec``.

The garbler's state needs no converter: R and every fresh label come from
``numpy.random.default_rng(seed)`` in the same order in both packages.
"""

from __future__ import annotations

import numpy as np

from .core.bytecode import Program, decode_chunk

HEADER_FIELDS = ("page_shift", "phase", "num_frames", "prefetch_slots",
                 "vspace_slots", "meta")


def program_from_records(rec: np.ndarray, header: dict) -> Program:
    """Build the port's Program from ``rec``, an ``[n, RECORD_WORDS]``
    int64 record array, and ``header`` with the program's page_shift,
    phase, num_frames, prefetch_slots, vspace_slots and meta (protocol,
    worker and num_workers are optional: gc, 0 and 1)."""
    missing = [k for k in HEADER_FIELDS if k not in header]
    if missing:
        raise ValueError(f"header lacks {missing}")
    return Program(instrs=decode_chunk(np.asarray(rec, dtype=np.int64)),
                   page_shift=int(header["page_shift"]),
                   protocol=header.get("protocol", "gc"),
                   phase=header["phase"],
                   worker=int(header.get("worker", 0)),
                   num_workers=int(header.get("num_workers", 1)),
                   vspace_slots=int(header["vspace_slots"]),
                   num_frames=int(header["num_frames"]),
                   prefetch_slots=int(header["prefetch_slots"]),
                   meta=dict(header["meta"]))
