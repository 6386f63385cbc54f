"""Benchmark experiment harness.

Counterpart of ``sparsebase_tpu/experiment.py`` (reference
src/sparsebase/experiment/experiment_type.h:26-39, concrete_experiment.cc:34-91,
experiment_helper.h:19-100). Same shape: a cartesian product of data loaders
× file targets × preprocesses × kernels × repetitions, wall-clocking each
kernel run and recording run times, results and auxiliary data keyed by
``"file,...,preprocess_id,kernel_id,run_index"``.

Over the reference:

* each run's time is the host clock from before the kernel's call to after
  :func:`_sync`, which waits for every CUDA device the result holds and, once
  CUDA is initialised, for the current one: a kernel's work that was
  enqueued but not returned is waited for too. Nothing is caught there: an
  asynchronous CUDA error raised at the synchronise leaves :meth:`run`;
* a warm-up run (default 1) absorbs kernel builds and allocator growth;
* an optional ``torch.profiler`` trace per (preprocess, kernel, rep)
  (``trace_dir``), in which the port's spans (``sbtorch:op:*``,
  ``sbtorch:convert:*``, ``sbtorch:csr_to_dia:*``, ``sbtorch:pipeline:*``,
  ``sbtorch:stage:*``, ``sbtorch:relocate:*``; ``utils/tracing.py``) sit
  under a ``record_function`` of the run,
  and, on a card, the device's kernels; each traced run on a card holds
  the profiler open :data:`TRACE_MARGIN_S` seconds before and after it
  (:func:`trace_to`).

The loaders read onto the card unless given ``device="cpu"``
(``functools.partial(load_csr, device="cpu")``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .formats.base import Format
from .io.placement import DEFAULT_DEVICE

LoaderFn = Callable[[Sequence[str]], Any]
PreprocessFn = Callable[[Any, Any, Any], Any]
KernelFn = Callable[[Any, Any, Any, Any], Any]


def _tensors_of(x):
    """The tensors ``x`` holds: a tensor, a ``Format``, or a tuple, list or
    dict (its values) of them, nested."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, Format):
        yield from x._tensors()
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors_of(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors_of(v)


def _sync(x):
    """Wait for the work behind ``x``: each CUDA device its tensors are on,
    and the current device once CUDA is initialised (a kernel may enqueue
    work it does not return). Returns ``x``."""
    for device in {t.device for t in _tensors_of(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return x


class Experiment:
    """Interface parity with ``experiment::ExperimentType``
    (experiment_type.h:26-39)."""

    def add_data_loader(self, loader: LoaderFn, targets: Sequence[Tuple[Sequence[str], Any]]):
        raise NotImplementedError

    def add_preprocess(self, pid: str, fn: PreprocessFn, params: Any = None):
        raise NotImplementedError

    def add_kernel(self, kid: str, fn: KernelFn, params: Any = None):
        raise NotImplementedError

    def run(self, times: int = 1, store_auxiliary: bool = False):
        raise NotImplementedError


class ConcreteExperiment(Experiment):
    """Parity: ``experiment::ConcreteExperiment`` (concrete_experiment.cc)."""

    def __init__(self, warmup: int = 1, trace_dir: Optional[str] = None):
        self._loaders: List[Tuple[LoaderFn, List[Tuple[List[str], Any]]]] = []
        self._preprocesses: Dict[str, Tuple[PreprocessFn, Any]] = {}
        self._kernels: Dict[str, Tuple[KernelFn, Any]] = {}
        self._runtimes: Dict[str, float] = {}
        self._results: Dict[str, Any] = {}
        self._auxiliary: Dict[str, Any] = {}
        self.warmup = warmup
        self.trace_dir = trace_dir

    # -- construction --------------------------------------------------------
    def add_data_loader(self, loader, targets):
        self._loaders.append((loader, [(list(f), p) for f, p in targets]))

    def add_preprocess(self, pid, fn, params=None):
        self._preprocesses[pid] = (fn, params)

    def add_kernel(self, kid, fn, params=None):
        self._kernels[kid] = (fn, params)

    # -- execution (concrete_experiment.cc:34-91 loop) -----------------------
    def run(self, times: int = 1, store_auxiliary: bool = False):
        for loader, targets in self._loaders:
            for file_names, fparams in targets:
                data = loader(file_names)
                fkey = ",".join(file_names)
                if store_auxiliary:
                    self._auxiliary[f"data,{fkey}"] = data
                for pid, (pfn, pparams) in self._preprocesses.items():
                    pdata = pfn(data, fparams, pparams)
                    if store_auxiliary:
                        self._auxiliary[f"preprocess,{pid},{fkey}"] = pdata
                    for kid, (kfn, kparams) in self._kernels.items():
                        for _ in range(self.warmup):
                            _sync(kfn(pdata, fparams, pparams, kparams))
                        for i in range(times):
                            with _maybe_trace(self.trace_dir, f"{pid}-{kid}-{i}"):
                                t0 = time.perf_counter()
                                res = _sync(kfn(pdata, fparams, pparams, kparams))
                                dt = time.perf_counter() - t0
                            key = f"{fkey},{pid},{kid},{i}"
                            self._runtimes[key] = dt
                            self._results[key] = res
        return self

    # -- results (GetRunTimes/GetResults/GetAuxiliary) -----------------------
    def get_run_times(self) -> Dict[str, float]:
        return dict(self._runtimes)

    def get_results(self) -> Dict[str, Any]:
        return dict(self._results)

    def get_auxiliary(self) -> Dict[str, Any]:
        return dict(self._auxiliary)


# seconds the profiler's window stays open before and after a traced region
# where it records CUDA activity (see trace_to)
TRACE_MARGIN_S = 5.0


@contextlib.contextmanager
def trace_to(trace_dir, name, margin_s: float = TRACE_MARGIN_S):
    """``torch.profiler`` over what runs inside (CPU activity, and CUDA's
    where there is a card) under a ``record_function(name)``; the Chrome
    trace goes to ``trace_dir/<name>/trace.json``.

    Where it records CUDA activity, the window stays open ``margin_s``
    seconds before the region and after it (and after a synchronise). The
    profiler keeps only the device activity it places inside its window,
    and on an H100 it placed a short window's kernels outside it ("Out-of-
    range" records) in a process older than a minute: a margin of 50 ms kept
    them in 2 of 4 windows, one of 1 s after the region in 2 of 3, one of
    3 s on both sides in all 3 (``tools/torch_trace_probe.py``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out = os.path.join(str(trace_dir), str(name))
    os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    margin = 0.0
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        margin = margin_s
    with profile(activities=activities) as prof:
        time.sleep(margin)
        with record_function(str(name)):
            yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        time.sleep(margin)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


def _maybe_trace(trace_dir, name):
    """Per-kernel named profiler scope: each (preprocess, kernel, rep) traces
    into its own ``trace_dir/<name>`` directory (reference only
    wall-clocks, concrete_experiment.cc:57-70)."""
    return contextlib.nullcontext() if trace_dir is None else trace_to(trace_dir, name)


# -- canned loaders / preprocesses (experiment_helper.h:19-100 parity) -------


def load_csr(file_names, device=DEFAULT_DEVICE):
    from .bases import IOBase

    return IOBase.read_mtx_to_csr(file_names[0], device=device)


def load_coo(file_names, device=DEFAULT_DEVICE):
    from .bases import IOBase

    return IOBase.read_mtx_to_coo(file_names[0], device=device)


def load_csc(file_names, device=DEFAULT_DEVICE):
    from .bases import IOBase
    from .convert import csr_to_csc

    return csr_to_csc(IOBase.read_mtx_to_csr(file_names[0], device=device))


def load_format(fmt_cls, device=DEFAULT_DEVICE):
    """Generic loader factory: read MTX then convert to any registered
    format class (experiment_helper.h LoadFormat<T>)."""

    def fn(file_names):
        from .bases import IOBase

        return IOBase.read_mtx_to_csr(file_names[0], device=device).convert(fmt_cls)

    return fn


def pass_preprocess(data, fparams, pparams):
    """Identity preprocess (experiment_helper.h Pass)."""
    return data


def reorder_csr(reorderer_factory):
    """Returns a preprocess applying reorder+permute (ReorderCSR helper)."""

    def fn(data, fparams, pparams):
        from .bases import ReorderBase

        order = reorderer_factory().get_reorder(data)
        if data.shape[0] == data.shape[1]:
            return ReorderBase.permute2d(order, data)
        # rectangular: a row ordering cannot renumber columns
        return ReorderBase.permute2d_rowwise(order, data)

    return fn


def load_sharded_csr(mesh=None, axis: str = "x", halo: bool = True):
    """Returns a loader producing ``(ShardedCSR, mesh)`` over ``mesh``
    (default: ``make_mesh(axis=axis)``, the visible cards; it raises with
    none): the MTX file is read onto this process's first device of the
    mesh and sharded from there. On a mesh that spans processes
    (``multihost.global_mesh``) every process reads the file and keeps its
    own shards."""

    def fn(file_names):
        from .bases import IOBase
        from .parallel import ShardedCSR, make_mesh

        m = mesh if mesh is not None else make_mesh(axis=axis)
        csr = IOBase.read_mtx_to_csr(file_names[0], device=m.first_device)
        return ShardedCSR.from_csr(csr, m, axis=axis, halo=halo), m

    return fn


def distributed_reorder(kind: str = "rcm"):
    """Preprocess applying a distributed reorder (``"rcm"``: ``halo.rcm_reorder``,
    ``"degree"``: ``dist.degree_reorder``) to a ``(ShardedCSR, mesh)`` pair;
    returns ``(sharded, mesh, order)``."""

    def fn(data, fparams, pparams):
        from .parallel import degree_reorder
        from .parallel import halo as _halo

        sh, mesh = data
        if kind == "rcm":
            order = _halo.rcm_reorder(sh, mesh)
        elif kind == "degree":
            order = degree_reorder(sh, mesh)
        else:
            raise ValueError(f"unknown distributed reorder {kind!r}")
        return sh, mesh, order

    return fn


def distributed_spmv_kernel(data, fparams, pparams, kparams):
    """Kernel: the halo SpMV of a ones vector on the (possibly reordered)
    sharded matrix."""
    from .parallel import halo as _halo

    sh, mesh = data[0], data[1]
    x = torch.ones((sh.shape[1],), dtype=torch.float32, device=mesh.first_device)
    return _halo.spmv(sh, x, mesh)
