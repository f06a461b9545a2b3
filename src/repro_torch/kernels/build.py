"""Build and load the CUDA kernels, and count their launches.

Each source in ``csrc/`` is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface, loaded with
``ctypes``.  Libraries are cached under ``build/kernels/<hash>/`` at the repo
root, keyed by a hash of the sources and the flags, so a changed source rebuilds and an unchanged one is
loaded as it is.  The build runs at first use, never at import.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("expert_gemm", "decode_attention", "flash_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# launches per kernel wrapper: each wrapper adds one where it launches
# (``expert_gate_up``, ``grouped_matmul``, ``decode_attention``,
# ``flash_attention`` and ``ssd_scan`` count every launch of K1-K5 and
# ``decode_attention_paged`` every launch of K3p, the ``_wgmma``, ``_split``
# and ``_mma`` names those of their redesigns, the
# ``_prev`` names first designs launched only as a yardstick).  A CUDA graph
# runs its kernels without Python: the capture records each key's launches
# (``launches_held``) and every replay adds them (``add_launches``)
LAUNCHES: Dict[str, int] = {"expert_gate_up": 0, "expert_gate_up_wgmma": 0,
                            "expert_gate_up_prev": 0, "grouped_matmul": 0,
                            "grouped_matmul_wgmma": 0, "grouped_matmul_prev": 0,
                            "decode_attention": 0, "decode_attention_split": 0,
                            "decode_attention_prev": 0, "decode_attention_paged": 0,
                            "decode_attention_paged_split": 0, "decode_attention_lse": 0,
                            "flash_attention": 0,
                            "flash_attention_wgmma": 0, "flash_attention_prev": 0,
                            "ssd_scan": 0, "ssd_scan_mma": 0, "ssd_scan_prev": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
_c_int, _ptr = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = {
    "repro_expert_gate_up": [_ptr, _ptr, _ptr, _ptr, _ptr] + [_c_int] * 5 + [_ptr],
    "repro_expert_gate_up_wgmma": [_ptr, _ptr, _ptr, _ptr, _ptr] + [_c_int] * 4 + [_ptr],
    "repro_grouped_matmul": [_ptr, _ptr, _ptr, _ptr] + [_c_int] * 5 + [_ptr],
    "repro_grouped_matmul_wgmma": [_ptr, _ptr, _ptr, _ptr] + [_c_int] * 4 + [_ptr],
    "repro_decode_attention": [_ptr] * 6 + [_c_int] * 6 + [_ptr],
    "repro_decode_attention_split": [_ptr] * 8 + [_c_int] * 6 + [_ptr],
    "repro_decode_attention_paged": [_ptr] * 8 + [_c_int] * 9 + [_ptr],
    "repro_decode_attention_paged_split": [_ptr] * 10 + [_c_int] * 9 + [_ptr],
    "repro_flash_attention": [_ptr] * 5 + [_c_int] * 8 + [_ptr],
    "repro_flash_attention_wgmma": [_ptr] * 5 + [_c_int] * 7 + [_ptr],
    "repro_ssd_scan": [_ptr] * 8 + [_c_int] * 7 + [_ptr],
    "repro_ssd_scan_mma": [_ptr] * 8 + [_c_int] * 6 + [_ptr],
}
_SYMBOLS = {"expert_gemm": ("repro_expert_gate_up", "repro_expert_gate_up_wgmma",
                            "repro_grouped_matmul", "repro_grouped_matmul_wgmma"),
            "decode_attention": ("repro_decode_attention", "repro_decode_attention_split",
                                 "repro_decode_attention_paged",
                                 "repro_decode_attention_paged_split"),
            "flash_attention": ("repro_flash_attention", "repro_flash_attention_wgmma"),
            "ssd_scan": ("repro_ssd_scan", "repro_ssd_scan_mma")}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


@contextlib.contextmanager
def launches_held() -> Iterator[Dict[str, int]]:
    """Launches made inside the block leave the counts as they were; the
    yielded dict is filled, on exit, with what they would have added (the
    launches a CUDA graph capture recorded, or an uncounted warm-up's)."""
    before = dict(LAUNCHES)
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        delta.update({k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]})
        LAUNCHES.update(before)


def add_launches(delta: Dict[str, int], times: int = 1) -> None:
    """Count ``times`` runs of a recorded set of launches (graph replays)."""
    for k, v in delta.items():
        LAUNCHES[k] += v * times


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in cands:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest(name: str) -> str:
    """Hash of the flags, source ``name`` and every shared header, so that a
    changed header rebuilds the libraries that include it."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / _digest(name) / f"lib{name}.so"


def ptxas_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said about source ``name``'s kernels
    (registers, shared memory, spills) when it was built."""
    return (_lib_path(name).parent / "ptxas.log").read_text()


def build_all() -> float:
    """Compile every source whose library is not cached, one ``nvcc`` per
    source, all running at once.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        out = _lib_path(name)
        if out.is_file():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        (out.parent / "ptxas.log").write_text(log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name`` (built at first use)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.is_file():
        build_all()
    lib = ctypes.CDLL(str(path))
    for sym in _SYMBOLS[name]:
        fn = getattr(lib, sym)
        fn.argtypes = _ARGTYPES[sym]
        fn.restype = _c_int
    _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a kernel's C entry point reported a CUDA error."""
    if err != 0:
        msg = _cuda_error_string(err)
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} ({msg})")


def _cuda_error_string(err: int) -> str:
    import torch

    try:
        cudart = torch.cuda.cudart()
        return str(cudart.cudaGetErrorString(err))
    except (AttributeError, RuntimeError, TypeError):
        return "see cudaError_t"


def ptr(t: Optional["object"]) -> Optional[int]:
    """A tensor's device pointer for ctypes (``None`` passes a null)."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
