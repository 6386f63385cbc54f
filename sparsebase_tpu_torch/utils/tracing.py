"""The port's spans and counters.

``span(name)`` marks a stage of the program for ``torch.profiler``: while a
profiler runs it is a ``record_function`` range, an event of the profiler
on the device trace's clock, nested under whatever span the host had open;
otherwise it is one shared null context, and costs one check of the
profiler's flag. The profiler keeps the spans until its reader takes them.
Every span of the port carries the prefix ``sbtorch:``:

* ``sbtorch:op:<name>``: a dispatched operation (``dispatch.py``);
* ``sbtorch:convert:<From>-><To>`` and ``sbtorch:convert:<From>:to_context``:
  one edge of a conversion chain, and a move to another device
  (``convert/graph.py``);
* ``sbtorch:csr_to_dia:offsets`` and ``sbtorch:csr_to_dia:fill``: the CSR to
  DIA conversion's two stages (``convert/kernels.py``);
* ``sbtorch:pipeline:preprocess``, ``:partition``, ``:rcm``: a pipeline call,
  and inside it ``sbtorch:stage:indptr``, ``:rank``, ``:label_prop``,
  ``:rcm``, ``:spmv`` and ``:permute`` (``models/pipelines.py``);
* ``sbtorch:relocate:long_rows``: K4's route for rows over ``BLOCK_MAX``
  (``ops/kernels/relocate.py``);
* ``sbtorch:shard:ingest``: ``ShardedCSR.from_coo_blocks``, and inside it
  ``sbtorch:shard:route`` (the owner sort and buckets, the loads read
  back), ``:exchange`` (the entries' ``all_to_all``) and ``:local`` (each
  owner's sorts and ``indptr``); ``sbtorch:shard:halo``:
  ``ShardedCSR.with_halo`` (``parallel/sharded.py``);
* ``sbtorch:halo:exchange``: each ``all_to_all`` of halo lists or halo
  values (``with_halo``, ``parallel/halo.py::_exchange``).

On the device the profiler gives each kernel to the innermost
``record_function`` open when it was launched, so a span takes the device
range of any span around it that launches nothing of its own. A
conversion's spans (``sbtorch:convert:*``, ``sbtorch:csr_to_dia:*``) are
therefore ``host_span``s, host ranges alone: a caller that wraps a
conversion in a span of its own keeps the conversion's device time in it.

``count(name, n)`` adds to one process-wide table of counters, which
``counters()`` copies and ``reset_counters()`` clears: ``launch:<kernel>``
for each launch of a hand-written kernel (``_build.Kernel.launch``), and
``relocate.entries``, ``relocate.long_rows`` and
``relocate.long_row_entries`` for K4's CUDA route, counted from values the
host already holds, ``label_prop.split_rounds``, one a K7 round whose plan
includes its span pass for rows over ``SPLIT_ROWS`` (``ops/kernels/label_prop.py``),
``csr_to_dia.scatter`` and ``csr_to_dia.accumulate``,
one a call of the CSR to DIA conversion on each of its routes,
``shard.routed_entries`` and ``shard.crossed_entries``, the true entries
that ``from_coo_blocks`` routed and those of them bound for another shard,
from the loads it reads back anyway, and ``collectives.card_bytes``, the
bytes that ``all_to_all`` copies from one card to another inside a process.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch.profiler import record_function

_NULL = contextlib.nullcontext()
_COUNTERS: Dict[str, int] = {}


def span(name: str):
    """A ``record_function(name)`` while a profiler runs, else a shared
    null context."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _NULL


def host_span(name: str):
    """A range on the host alone while a profiler runs (the kernels it
    launches stay with the enclosing ``record_function`` on the device),
    else the shared null context."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_COUNTERS)


def reset_counters(prefix: str = "") -> None:
    """Clear the counters whose names start with ``prefix`` (all by default)."""
    for name in [k for k in _COUNTERS if k.startswith(prefix)]:
        del _COUNTERS[name]
