"""Build the CUDA kernels with nvcc and load them with ctypes.

Each kernel source is compiled on first use into a shared library with a
plain C interface, under ``build/triflow_tpu_torch/`` at the root of the
checkout.  The library's file name carries a hash of its source text, of
every header in ``csrc/`` and of the compiler flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  A build or load
failure raises: no kernel is ever skipped.

nvcc's own output (with ``-Xptxas -v``: registers, spills and shared
memory of every kernel) is kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "triflow_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: seconds spent in nvcc by this process, per library file stem
build_seconds = {}
_loaded = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or /usr/local/cuda/bin)")


def _digest(source: str) -> str:
    h = hashlib.sha256(source.encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load(name: str, source: str) -> ctypes.CDLL:
    """Compile ``source`` (CUDA C++ text) into ``<name>-<hash>.so`` unless
    that library exists already, and load it."""
    lib_path = BUILD_DIR / f"{name}-{_digest(source)}.so"
    if lib_path in _loaded:
        return _loaded[lib_path]
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src_path = lib_path.with_suffix(".cu")
        src_path.write_text(source)
        # build into a temporary name, then rename: concurrent builders
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src_path)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[lib_path.stem] = time.perf_counter() - start
        lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed building {name}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.tf_error_string.argtypes = [ctypes.c_int]
    lib.tf_error_string.restype = ctypes.c_char_p
    _loaded[lib_path] = lib
    return lib


#: the C entries' element-type suffixes, one library part each where a
#: library is built by dtype
SUFFIXES = ("f32", "f64")


class Library:
    """A CUDA library built at the first call of one of its entries;
    ``source()`` returns its text.  With ``by_dtype`` it is built as one
    library per element type (``<name>_f32``, ``<name>_f64``: the source
    with ``TF_ONLY_F32`` or ``TF_ONLY_F64`` defined, which keeps that
    type's entries only), two nvcc runs that ``builds`` lets a caller start
    together; an entry loads the part of its name's suffix."""

    def __init__(self, name: str, source, by_dtype: bool = False):
        self.name = name
        self.source = source
        self.by_dtype = by_dtype
        self.lib = None
        self._parts = {}
        self._fns = {}

    def load(self, sfx: str = None) -> ctypes.CDLL:
        """The library, or where it is built by dtype the part of entry
        suffix ``sfx`` (every part, without)."""
        if not self.by_dtype:
            if self.lib is None:
                self.lib = load(self.name, self.source())
            return self.lib
        for part in (sfx,) if sfx else SUFFIXES:
            if part not in self._parts:
                self._parts[part] = load(f"{self.name}_{part}",
                                         f"#define TF_ONLY_{part.upper()} 1\n"
                                         + self.source())
            self.lib = self._parts[part]
        return self.lib

    def builds(self):
        """One callable per nvcc run of the library, to start together."""
        if not self.by_dtype:
            return [self.load]
        return [functools.partial(self.load, sfx) for sfx in SUFFIXES]

    def fn(self, name: str, n_ptr: int, n_int: int, n_double: int = 0):
        if name not in self._fns:
            sfx = name.rsplit("_", 1)[-1] if self.by_dtype else None
            self._fns[name] = bind(self.load(sfx), name, n_ptr, n_int, n_double)
        return self._fns[name]

    def check(self, rc: int, what: str):
        check(self.lib, rc, what)


def csrc_library(filename: str, define: str = None,
                 by_dtype: bool = False) -> Library:
    """The library of one source file in ``csrc/``; with ``define``, a
    library of its own (``<stem>_<define in lower case>``) built from the
    same file with that macro defined to 1; ``by_dtype``: see ``Library``."""
    if define is None:
        return Library(Path(filename).stem,
                       lambda: (CSRC / filename).read_text(), by_dtype)
    return Library(f"{Path(filename).stem}_{define.lower().removeprefix('tf_')}",
                   lambda: f"#define {define} 1\n" + (CSRC / filename).read_text(),
                   by_dtype)


def bind(lib: ctypes.CDLL, fname: str, n_ptr: int, n_int: int,
         n_double: int = 0):
    """Declare a C entry ``int fname(ptr * n_ptr, int * n_int,
    double * n_double, stream)`` and return it."""
    fn = getattr(lib, fname)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_double] * n_double + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(lib: ctypes.CDLL, rc: int, what: str):
    """Raise when a C entry reported a CUDA error (its launch was refused
    or an earlier asynchronous fault surfaced)."""
    if rc:
        msg = lib.tf_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
