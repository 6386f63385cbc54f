"""sparsebase_tpu_torch — the PyTorch + CUDA port of ``sparsebase_tpu``.

It mirrors the JAX package's module paths and names, holds its data in
torch tensors, and runs the hand-written Hopper kernels of ``csrc/`` on
CUDA tensors (their plain PyTorch versions on CPU tensors). It imports
neither ``jax`` nor ``sparsebase_tpu``.

Layer map:

    experiment   benchmark harness: ConcreteExperiment, loaders, reorder_csr
    bench_suite  quality + throughput suite (loaded on first access; a CLI)
    bases        IOBase / ReorderBase / GraphFeatureBase façades (static one-liners)
    models       preprocess_pipeline (and _donating), rcm_pipeline, partition_pipeline, spmv
                 (format-polymorphic), spmv_csr (auto / segment / cumsum), spmv_ell
    io           MTX, edge list, SBFF, METIS, PaToH readers and writers; Pigo readers (fastio)
    objects      Graph / HyperGraph over a connectivity format
    native       graphkit: host C++ graph algorithms (ctypes, g++ at first use)
    ops          reorder (degree, RCM, Gray, BOBA, SlashBurn, AMD, nested dissection, Rabbit,
                 generic; the heatmap) / permute (2-D, 1-D) / feature (all 20 features, the
                 fused Extractor) / kernels (K1 DIA SpMV, K2 CSR SpMV, K3 indptr, K4 CSR
                 relocation, K5 stable radix sort, K6 common neighbours, K7 a label-propagation
                 round) / partition (Metis, Pulp, Patoh; edge cut, part sizes, balance)
    dispatch     Operation (auto-converting multi-format dispatch)
    convert      conversion graph + torch conversion functions
    formats      COO / CSR / CSC / DIA / ELL / DenseArray / PaddedCSR frozen dataclasses
    parallel     (imported on request) the mesh, ShardedCSR / Sharded2DCSR, the collectives and
                 the distributed functions (spmv, BFS, RCM, label propagation, refinement, ...)
    context      Host / Device / Mesh placement, read from the tensors' devices
    utils        exceptions, logger, checked dtype casts; visualizer (HTML dashboard, a CLI)
    config       process-wide dtype defaults and feature toggles
    _build       nvcc build + ctypes binding of csrc/*.cu; g++ build of the host libraries
    interop      carry reference formats and objects across (numpy arrays)
"""

__version__ = "0.1.0"

from . import bases, config, context, convert, dispatch, experiment, formats, io, models, native, objects, ops, utils
from .bases import GraphFeatureBase, IOBase, ReorderBase
from .config import Config, get_config, set_config
from .context import CPU_CONTEXT, Context, DeviceContext, HostContext, MeshContext, context_for, context_of
from .convert import can_convert, convert_cached, register_conversion
from .convert import convert as convert_format
from .dispatch import ClassMatcher, Operation
from .formats import COO, CSC, CSR, DIA, ELL, Array, DenseArray, Format, PaddedCSR, pad_csr
from .models import preprocess_pipeline, preprocess_pipeline_donating, rcm_pipeline, spmv, spmv_csr, spmv_ell
from .objects import Graph, HyperGraph, Object


def __getattr__(name):
    # bench_suite is a ``python -m`` entry point: importing it with the
    # package would import it twice when it runs as a script
    if name == "bench_suite":
        import importlib

        module = importlib.import_module(f".{name}", __name__)
        globals()[name] = module
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "__version__",
    "bases",
    "bench_suite",
    "config",
    "experiment",
    "io",
    "native",
    "objects",
    "IOBase",
    "ReorderBase",
    "GraphFeatureBase",
    "Config",
    "get_config",
    "set_config",
    "Object",
    "Graph",
    "HyperGraph",
    "preprocess_pipeline_donating",
    "context",
    "convert",
    "dispatch",
    "formats",
    "models",
    "ops",
    "utils",
    "Format",
    "COO",
    "CSR",
    "DIA",
    "CSC",
    "ELL",
    "DenseArray",
    "Array",
    "PaddedCSR",
    "pad_csr",
    "Context",
    "HostContext",
    "DeviceContext",
    "MeshContext",
    "CPU_CONTEXT",
    "context_for",
    "context_of",
    "can_convert",
    "convert_format",
    "convert_cached",
    "register_conversion",
    "Operation",
    "ClassMatcher",
    "preprocess_pipeline",
    "spmv",
    "spmv_csr",
    "spmv_ell",
    "rcm_pipeline",
]
