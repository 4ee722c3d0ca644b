"""Builds the CUDA sources under ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, compiled with ``nvcc`` for ``sm_90a`` and loaded through ``ctypes``
(seconds per file; no PyTorch headers).  Shared device helpers live in
``csrc/*.cuh``.  Libraries go to ``build/repro_torch`` at the root of the
checkout (``REPRO_TORCH_BUILD_DIR`` overrides), named by a hash of the source
and the headers, so an unchanged source is built once per directory.

Nothing here runs at import time: a machine without ``nvcc`` can import every
module of the package.  A build that fails raises; there is no other path for
a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention", "flash_attention_bwd", "tsmm", "ssd_scan",
           "ssd_scan_bwd", "matmul_epilogue", "causal_conv")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output of each source built with ``verbose``: ptxas' registers,
# shared memory and spills of every kernel
logs: Dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    """The library's path, named by a hash of the source, the headers it may
    include (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return build_dir() / f"lib{name}_{digest}.so"


def _compile(jobs: Dict[str, List[str]]) -> Dict[str, str]:
    """Run one ``nvcc`` for each job (a name and nvcc's arguments), all at
    once.  Returns each job's output; raises with the output of those that
    failed."""
    procs = {name: subprocess.Popen([_nvcc(), *args], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, args in jobs.items()}
    out, failures = {}, []
    for name, proc in procs.items():
        out[name], _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}:\n{out[name]}")
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> float:
    """Compile the named sources that have no library yet, all at once (one
    ``nvcc`` process each).  Returns the seconds it took.  With ``verbose``
    nvcc's output goes to :data:`logs` and to standard output."""
    t0 = time.perf_counter()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    jobs, targets = {}, {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        jobs[name] = [*(["-Xptxas=-v"] if verbose else []), *NVCC_FLAGS,
                      "-o", str(tmp), str(CSRC / f"{name}.cu")]
        targets[name] = (tmp, target)
    for name, log in _compile(jobs).items():
        if verbose and log:
            logs[name] = log
            print(log)
        os.replace(*targets[name])
    return time.perf_counter() - t0


def build_variants(name: str, sources: Dict[str, str]) -> Dict[str, Path]:
    """Compile variants of ``csrc/<name>.cu`` (each a variant's name and its
    source text) into ``<build dir>/<name>_variants``, all at once, with
    ``csrc`` on the include path.  Returns each variant's library.  For the
    tools that time a kernel's variants."""
    out = build_dir() / f"{name}_variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for variant, text in sources.items():
        (out / f"{variant}.cu").write_text(text)
        jobs[variant] = [*NVCC_FLAGS, "-I", str(CSRC), "-o",
                         str(out / f"lib{variant}.so"),
                         str(out / f"{variant}.cu")]
    _compile(jobs)
    return {variant: out / f"lib{variant}.so" for variant in sources}


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if need be."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str, error_string: str) -> None:
    """Raise if a kernel's C entry point returned an error code."""
    if code != 0:
        fn = getattr(lib, error_string)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: {fn(code).decode()} (code {code})")
