"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point.  On first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``kernels/build/`` (listed in
``.gitignore``), named by a hash of the source and of the ``*.cuh``
headers beside it, so an edited kernel is rebuilt, and loaded with
``ctypes``.  ``build(*names)`` starts one ``nvcc`` per missing library,
all at once, so a caller that needs several kernels waits for the
slowest build rather than their sum.  Only sources in this package are
built.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

# per-kernel flags on top of NVCC_FLAGS: the thresholds of nbr_adjacency
# and pairdist must be bit-exact (and equal to each other), so nvcc may not
# contract their products and sums into FMAs; flash_attention and ssd_scan
# are held to a tolerance and keep nvcc's contraction
KERNEL_FLAGS = {"nbr_adjacency": ("-fmad=false",),
                "pairdist": ("-fmad=false",)}

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict = {}                  # (name, symbol) -> bound C function
BUILD_LOGS: dict[str, str] = {}   # name -> nvcc/ptxas output of the build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def _cuda_tool(tool: str) -> str | None:
    """A CUDA toolkit program beside nvcc, or None where it is missing."""
    cand = Path(_nvcc()).with_name(tool)
    return str(cand) if cand.exists() else shutil.which(tool)


def sass_counts(name: str, mnemonics=("HGMMA", "HMMA")) -> dict | None:
    """Per kernel of the built ``csrc/<name>.cu``, how many SASS
    instructions start with each of ``mnemonics`` (``cuobjdump -sass``):
    HGMMA is wgmma, HMMA mma.sync; under ``"all"`` every instruction of
    the kernel.  Static counts: each instruction once, whether it runs
    once, in a loop or never.  None where the toolkit has no cuobjdump."""
    tool = _cuda_tool("cuobjdump")
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", str(library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    counts: dict = {}
    current = None
    for line in out.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            counts[current] = {**dict.fromkeys(mnemonics, 0), "all": 0}
        elif current is not None:
            if re.match(r"\s*/\*[0-9a-f]{4,}\*/\s", line):
                counts[current]["all"] += 1
            for m in mnemonics:
                if f" {m}." in line or f" {m} " in line:
                    counts[current][m] += 1
    return counts


def ptx_counts(name: str, ops=("wgmma.mma_async", "mma.sync")) -> dict:
    """Per kernel (``.entry``) of ``csrc/<name>.cu`` compiled to PTX with
    the build's flags, how many lines hold each of ``ops``: the evidence of
    tensor-core products where the toolkit has no cuobjdump."""
    src = _SRC_DIR / f"{name}.cu"
    out = library_path(name).with_suffix(".ptx")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _flags(name)
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")]
    flags[flags.index("arch=compute_90a,code=sm_90a")] = \
        "arch=compute_90a,code=compute_90a"
    subprocess.run([_nvcc(), *flags, "-ptx", "-o", str(out), str(src)],
                   capture_output=True, text=True, check=True)
    counts: dict = {}
    current = None
    for line in out.read_text().splitlines():
        if ".entry " in line:
            current = line.split(".entry ", 1)[1].split("(", 1)[0].strip()
            counts[current] = dict.fromkeys(ops, 0)
        elif current is not None:
            for op in ops:
                if op in line:
                    counts[current][op] += 1
    return counts


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """The build's path, named by a hash of the source, the headers beside
    it and the flags."""
    src = _SRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(_SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return _BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict:
    """The loaded libraries for ``csrc/<name>.cu`` of each name; the
    missing ones are compiled first, one ``nvcc`` each, concurrently."""
    procs = {}
    for name in names:
        out = library_path(name)
        if name in _LIBS or name in procs or out.exists():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp),
               str(_SRC_DIR / f"{name}.cu")]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        BUILD_LOGS[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit "
                          f"{proc.returncode}):\n{BUILD_LOGS[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return {name: _LIBS[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build(name)[name]


def function(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, bound once with
    ``argtypes``; it returns the launch's ``cudaError_t`` as a C int."""
    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(name, symbol)] = fn
    return fn
