"""Build and load the CUDA kernels: `nvcc` into a shared library, `ctypes`.

Each source under ``csrc/`` is compiled at first use, for Hopper only
(``-gencode arch=compute_90a,code=sm_90a``, plus the source's own flags),
into its own shared library with a plain C interface under
``build/repro_torch_kernels/`` at the root of the checkout.  The sources include no PyTorch header, so a build takes
seconds.  All stale sources build at once, one `nvcc` each, in parallel.
A library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source is rebuilt and an
unchanged one is reused.

A build failure raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Each source with its own flags.  -fmad=false for the server updates: every
# multiply and add rounds on its own, as PyTorch's separate elementwise ops
# do, so a kernel computes what its plain version computes.  A fused
# n - b·b moves the literal variant's ill-conditioned (1-β)/√(max(n - b², 0)
# + ε) by percents where n ≈ b².  Those kernels are bound by bytes, so the
# lost FMAs should cost little; a build with contraction on has not been
# timed against this one.  flash_attention keeps contraction on and needs no
# flag of its own: its sums are well-conditioned, and its `wgmma`, `cp.async`
# and `griddepcontrol` instructions are inline PTX for the sm_90a target
# above, with no CUTLASS header (see its source note).
SOURCE_FLAGS = {
    "fasgd_update": ("-fmad=false",),
    "fused_event_apply": ("-fmad=false",),
    "batched_update": ("-fmad=false",),
    "flash_attention": (),
}
SOURCES = tuple(SOURCE_FLAGS)

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# The most leaves one launch of a tree kernel takes (kMaxLeaves in
# csrc/common.cuh).
MAX_LEAVES = 32


def leaf_table(n_ptrs: int):
    """The ctypes mirror of ``repro::LeafTable<n_ptrs>`` (csrc/common.cuh),
    passed to the entry points by value."""
    class LeafTable(ctypes.Structure):
        _fields_ = [("ptr", (_P * n_ptrs) * MAX_LEAVES),
                    ("size", _I64 * MAX_LEAVES),
                    ("first_block", _I64 * (MAX_LEAVES + 1)),
                    ("num_leaves", ctypes.c_int32),
                    ("pad", ctypes.c_int32)]
    return LeafTable


FASGD_TABLE = leaf_table(9)       # θ g n b v θ' n' b' v'
BATCHED_TABLE = leaf_table(7)     # θ g v coeffs τ masks θ'
FUSED_TABLE = leaf_table(13)      # θ g n b v w wmean τ has_push θ' n' b' v'
# Each tree kernel's table and the entry point that gives its C size; the
# loader holds the two equal.
TABLES = {"fasgd_update": (FASGD_TABLE, "repro_fasgd_update_table_bytes"),
          "fused_event_apply": (FUSED_TABLE,
                                "repro_fused_event_apply_table_bytes"),
          "batched_update": (BATCHED_TABLE,
                             "repro_batched_scale_apply_table_bytes")}
# C entry point of each source, with its argument types (pointers and the
# stream as c_void_p: ctypes would otherwise pass them as 32-bit ints).
SIGNATURES = {
    "fasgd_update": ("repro_fasgd_update", [
        _I, _I, FASGD_TABLE, _P,                  # dtype, literal, leaves, τ
        _F, _F, _F, _F, _F, _F,                   # lr γ 1-γ β 1-β ε
        _P]),                                     # stream
    "fused_event_apply": ("repro_fused_event_apply", [
        _I, _I, _I, _I, FUSED_TABLE,              # dtype, fasgd, track,
                                                  # literal, leaves
        _F, _F, _F, _F, _F, _F,                   # lr γ 1-γ β 1-β ε
        _I, _I, ctypes.c_uint, _P]),              # K tile, terms leaves,
                                                  # stream
    "batched_update": ("repro_batched_scale_apply", [
        _I, _I, _I, BATCHED_TABLE,                # dtype, fasgd, has_mask, leaves
        _F, _F, _I, _I, ctypes.c_uint, _P]),      # lr ε K tile, terms leaves,
                                                  # stream
    "flash_attention": ("repro_flash_attention", [
        _I, _I, _P, _P, _P, _P,                   # dtype, head_dim, q k v o
        _I, _I, _I, _I, _I,                       # B Hq Hkv Lq Lk
        ctypes.POINTER(_I64),                     # strides (host, 12)
        _I, _I, _F,                               # causal window scale
        _P, _I64, _P]),                           # scratch, its floats, stream
}

# what the last build printed (ptxas register and spill report), by source
BUILD_LOG: Dict[str, str] = {}
_FUNCS: Dict[str, Any] = {}


def nvcc() -> str:
    """Path of the CUDA compiler PyTorch was set up with (raises if none)."""
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(name: str):
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all() -> float:
    """Compile every stale source at once; returns the wall seconds spent
    (0.0 when all were built already).  Raises on any failure."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def kernel(name: str):
    """The C entry point of source `name`, built and loaded at first use."""
    fn = _FUNCS.get(name)
    if fn is None:
        build_all()
        symbol, argtypes = SIGNATURES[name]
        lib = ctypes.CDLL(str(_lib_path(name)))
        if name in TABLES:
            table, size_symbol = TABLES[name]
            c_bytes = getattr(lib, size_symbol)()
            if c_bytes != ctypes.sizeof(table):
                raise RuntimeError(
                    f"{name}: the leaf table is {c_bytes} bytes in C and "
                    f"{ctypes.sizeof(table)} in ctypes")
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn
