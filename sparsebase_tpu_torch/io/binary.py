"""SBFF (SparseBase Binary File Format) reader and writer.

Counterpart of ``sparsebase_tpu/io/binary.py``, byte for byte (reference:
src/sparsebase/io/sparse_file_format.h:29-330;
binary_reader_order_{one,two}.cc, binary_writer_order_{one,two}.cc), so
each package reads the other's files:

* object header: 1024-byte space-padded JSON
  ``{name, array_count, dimensions, endian}``;
* per array: 1024-byte space-padded JSON ``{name, type, type_size,
  array_size}`` and the raw data; ``type`` is "float", "signed" or
  "unsigned";
* a file of the other endianness is byteswapped on read.

Writers take formats on any device and copy each array to the host once;
readers put what they read on their device (CUDA unless the caller asks
for the CPU). Arrays keep the types they were written with.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List

import numpy as np
import torch

from ..formats.array import DenseArray
from ..formats.coo import COO
from ..formats.csr import CSR
from ..utils.exceptions import ReaderError, WriterError
from .placement import DEFAULT_DEVICE, target_device

_HEADER_BYTES = 1024
_UNSIGNED = {torch.uint8, torch.uint16, torch.uint32, torch.uint64}


def _native_endian() -> str:
    return "little" if sys.byteorder == "little" else "big"


def _type_tag(dtype: torch.dtype) -> str:
    if dtype.is_floating_point and dtype != torch.bfloat16:  # SBFF's 2-byte float is float16
        return "float"
    if dtype in _UNSIGNED:
        return "unsigned"
    if not dtype.is_floating_point and not dtype.is_complex and dtype != torch.bool:
        return "signed"
    raise WriterError(f"Type {dtype} is not supported by SBFF")


def _dtype_from_tag(tag: str, size: int) -> np.dtype:
    kind = {"float": "f", "signed": "i", "unsigned": "u"}.get(tag)
    if kind is None:
        raise ReaderError(f"Unknown SBFF type tag {tag!r}")
    return np.dtype(f"{kind}{size}")


def _pack_header(header: dict) -> bytes:
    raw = json.dumps(header).encode()
    if len(raw) > _HEADER_BYTES:
        raise WriterError("Header size exceeds 1 KB")
    return raw + b" " * (_HEADER_BYTES - len(raw))


def _read_header(f) -> dict:
    raw = f.read(_HEADER_BYTES)
    if len(raw) < _HEADER_BYTES:
        raise ReaderError("Truncated SBFF header")
    try:
        return json.loads(raw.decode())
    except json.JSONDecodeError as e:
        raise ReaderError(f"Bad SBFF header: {e}")


class SbffObject:
    """A named collection of typed 1-D CPU tensors and dimensions
    (SbffObject parity, sparse_file_format.h:203-330)."""

    def __init__(self, name: str):
        self.name = name
        self.dimensions: List[int] = []
        self._arrays: Dict[str, torch.Tensor] = {}

    def add_dimensions(self, dims) -> None:
        self.dimensions.extend(int(d) for d in dims)

    def add_array(self, name: str, arr: torch.Tensor) -> None:
        _type_tag(arr.dtype)  # validate
        self._arrays[name] = arr.detach().to("cpu").contiguous().reshape(-1)

    def get_array(self, name: str) -> torch.Tensor:
        try:
            return self._arrays[name]
        except KeyError:
            raise ReaderError(f"SBFF object has no array {name!r}")

    def has_array(self, name: str) -> bool:
        return name in self._arrays

    @property
    def array_count(self) -> int:
        return len(self._arrays)

    def write(self, filename: str) -> None:
        with open(filename, "wb") as f:
            f.write(_pack_header({"name": self.name, "array_count": len(self._arrays),
                                  "dimensions": self.dimensions, "endian": _native_endian()}))
            for name, arr in self._arrays.items():
                f.write(_pack_header({"name": name, "type": _type_tag(arr.dtype), "type_size": arr.element_size(),
                                      "array_size": arr.numel()}))
                f.write(memoryview(arr.numpy()).cast("B"))

    @staticmethod
    def read(filename: str) -> "SbffObject":
        with open(filename, "rb") as f:
            header = _read_header(f)
            obj = SbffObject(header["name"])
            obj.add_dimensions(header.get("dimensions", []))
            endian = header.get("endian", _native_endian())
            for _ in range(int(header["array_count"])):
                ah = _read_header(f)
                dtype = _dtype_from_tag(ah["type"], int(ah["type_size"]))
                data = np.empty(int(ah["array_size"]), dtype=dtype)
                if f.readinto(memoryview(data).cast("B")) != data.nbytes:
                    raise ReaderError(f"Truncated SBFF array {ah['name']!r}")
                if endian != _native_endian():
                    data = data.byteswap()
                obj._arrays[ah["name"]] = torch.from_numpy(data)
            return obj


def _on(obj: SbffObject, name: str, device):
    return obj.get_array(name).to(device) if obj.has_array(name) else None


class BinaryWriterOrderTwo:
    """Writes COO/CSR to SBFF (binary_writer_order_two.cc parity: objects
    "coo"/"csr", arrays row/col/vals and row_ptr/col/vals)."""

    def __init__(self, filename: str):
        self.filename = filename

    def write_coo(self, coo: COO) -> None:
        obj = SbffObject("coo")
        obj.add_dimensions(coo.shape)
        obj.add_array("row", coo.row)
        obj.add_array("col", coo.col)
        if coo.vals is not None:
            obj.add_array("vals", coo.vals)
        obj.write(self.filename)

    def write_csr(self, csr: CSR) -> None:
        obj = SbffObject("csr")
        obj.add_dimensions(csr.shape)
        obj.add_array("row_ptr", csr.indptr)
        obj.add_array("col", csr.indices)
        if csr.vals is not None:
            obj.add_array("vals", csr.vals)
        obj.write(self.filename)


class BinaryWriterOrderOne:
    """Writes a DenseArray to SBFF (binary_writer_order_one.cc parity)."""

    def __init__(self, filename: str):
        self.filename = filename

    def write_array(self, arr: DenseArray) -> None:
        obj = SbffObject("array")
        obj.add_dimensions(arr.shape)
        obj.add_array("array", arr.vals)
        obj.write(self.filename)


class BinaryReaderOrderTwo:
    """Reads SBFF "coo"/"csr" objects onto ``device``
    (binary_reader_order_two.cc parity)."""

    def __init__(self, filename: str, device=DEFAULT_DEVICE):
        self.filename = filename
        self.device = target_device(device)

    def _object(self, name: str) -> SbffObject:
        obj = SbffObject.read(self.filename)
        if obj.name != name:
            raise ReaderError(f"SBFF object is {obj.name!r}, expected {name!r}")
        return obj

    def read_coo(self) -> COO:
        obj = self._object("coo")
        shape = tuple(obj.dimensions) if obj.dimensions else None
        return COO.new(_on(obj, "row", self.device), _on(obj, "col", self.device), _on(obj, "vals", self.device),
                       shape=shape)

    def read_csr(self) -> CSR:
        obj = self._object("csr")
        shape = tuple(obj.dimensions) if obj.dimensions else None
        return CSR.new(_on(obj, "row_ptr", self.device), _on(obj, "col", self.device),
                       _on(obj, "vals", self.device), shape=shape)


class BinaryReaderOrderOne:
    """Reads an SBFF "array" object onto ``device``
    (binary_reader_order_one.cc parity)."""

    def __init__(self, filename: str, device=DEFAULT_DEVICE):
        self.filename = filename
        self.device = target_device(device)

    def read_array(self) -> DenseArray:
        obj = SbffObject.read(self.filename)
        if obj.name != "array":
            raise ReaderError(f"SBFF object is {obj.name!r}, expected 'array'")
        return DenseArray(obj.get_array("array").to(self.device))
